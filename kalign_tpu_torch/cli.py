"""Command line of the PyTorch/CUDA port:

    python -m kalign_tpu_torch.cli -i IN -o OUT [-f fasta|msf|clu] [--fast]
        [--consistency K] [--consistency-weight W] [--device cuda|cpu]

The flags are kalign_tpu/cli.py's (and so the reference binary's,
src/run_kalign.c) for what this package runs: the default mode (anchor
consistency with K = 5 anchors) or, with --fast, none.
"""

import argparse
import sys

from kalign_tpu_torch import engine as E
from kalign_tpu_torch.core import io as kio
from kalign_tpu_torch.version import KALIGN_COMPAT_VERSION, __version__

def build_parser():
    p = argparse.ArgumentParser(prog="kalign-tpu-torch")
    p.add_argument("-i", "--input", "--infile", "--in", dest="infile",
                   action="append", default=None)
    p.add_argument("-o", "--output", "--outfile", "--out", dest="outfile",
                   default=None)
    p.add_argument("-f", "--format", dest="format", default=None)
    p.add_argument("--consistency", type=int, default=5)
    p.add_argument("--consistency-weight", type=float, default=2.0)
    p.add_argument("--fast", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-v", "-V", "--version", action="store_true",
                   dest="version")
    p.add_argument("files", nargs="*")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"kalign-tpu-torch {__version__} "
              f"(kalign {KALIGN_COMPAT_VERSION} compatible)")
        return 0
    infiles = list(args.infile or []) + list(args.files)
    if not infiles:
        build_parser().print_help()
        print("No input files", file=sys.stderr)
        return 0
    infiles = [None if f == "-" else f for f in infiles]
    msa = kio.read_inputs(infiles)
    msa.quiet = args.quiet
    # mode preset (run_kalign.c:370-383): --fast turns the default
    # consistency off
    consistency = args.consistency
    if args.fast and consistency == 5:
        consistency = 0
    msa = E.align_msa(msa, consistency_anchors=consistency,
                      consistency_weight=args.consistency_weight,
                      device=args.device)
    kio.write_alignment_file(msa, args.outfile, args.format)
    return 0


if __name__ == "__main__":
    sys.exit(main())
