"""kalignfmt-equivalent reformatter (reference: src/run_reformat.c); a
copy of kalign_tpu/reformat.py, installed as ``kalignfmt-tpu-torch``.

Reads any supported alignment format and rewrites it:
  --rename   rename sequences to SEQ1..SEQN
  --unalign  strip gaps and emit FASTA
  --clean    duplicate-name / checksum checks (appends _N on clashes)
"""

import argparse
import sys

from kalign_tpu_torch.core import io as kio
from kalign_tpu_torch.core.msa import gcg_checksum
from kalign_tpu_torch.utils.sorting import glibc_msort


def clean_names(msa):
    """kalign_check_msa semantics (msa_check.c:143-245): sort by name,
    flag duplicate names; append _N to clashing entries."""
    recs = list(range(msa.numseq))
    chks = [gcg_checksum(sq.seq[:sq.len]) for sq in msa.sequences]

    order = glibc_msort(recs, lambda x, y: -1 if
                        msa.sequences[x].name[:256] < msa.sequences[y].name[:256]
                        else 1)
    action = [False] * msa.numseq
    for k in range(1, len(order)):
        i, j = order[k - 1], order[k]
        if msa.sequences[i].name[:256] == msa.sequences[j].name[:256]:
            action[i] = True
            action[j] = True
    c = 1
    for k in order:
        if action[k]:
            msa.sequences[k].name = f"{msa.sequences[k].name}_{c}"
            c += 1
    return msa


def main(argv=None):
    p = argparse.ArgumentParser(prog="kalignfmt-tpu-torch")
    p.add_argument("-i", "--input", "--infile", "--in", dest="infile",
                   action="append")
    p.add_argument("-o", "--output", "--outfile", "--out", dest="outfile",
                   default=None)
    p.add_argument("-f", "--format", "--reformat", dest="format",
                   default=None)
    p.add_argument("--rename", "--changename", action="store_true",
                   dest="rename")
    p.add_argument("--unalign", action="store_true")
    p.add_argument("--clean", action="store_true")
    p.add_argument("-n", "--nthreads", type=int, default=1)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-v", "-V", "--version", action="store_true",
                   dest="version")
    p.add_argument("files", nargs="*")
    args = p.parse_args(argv)
    if args.version:
        from kalign_tpu_torch.version import __version__
        print(f"kalignfmt-tpu-torch {__version__}")
        return 0

    infiles = list(args.infile or []) + list(args.files)
    if not infiles:
        p.print_help()
        return 1
    infiles = [None if f == "-" else f for f in infiles]
    msa = kio.read_inputs(infiles)

    if args.rename:
        for i, sq in enumerate(msa.sequences):
            sq.name = f"SEQ{i + 1}"
    fmt = args.format
    if args.unalign:
        msa.dealign()
        fmt = None
    if args.clean:
        clean_names(msa)

    if msa.aligned == 2:
        msa.finalise()
    elif msa.aligned != 3:
        # unaligned: emit residues as-is (FASTA only)
        msa.alnlen = 0
        msa.aligned = 3
        if fmt and "fa" not in fmt:
            print("Input sequences are not aligned - cannot write "
                  f"MSA format: {fmt}", file=sys.stderr)
            return 1
    kio.write_alignment_file(msa, args.outfile, fmt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
