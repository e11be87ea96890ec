"""Command line of the PyTorch/CUDA port:

    python -m kalign_tpu_torch.cli -i IN -o OUT [-f fasta|msf|clu] [--fast]
        [--consistency K] [--consistency-weight W] [--type T] [--gpo X]
        [--gpe X] [--tgpe X] [--vsm-amax X] [--refine MODE]
        [--engine gpu-fast|gpu|host] [--no-autoroute] [--device cuda|cpu]

The flags are kalign_tpu/cli.py's (and so the reference binary's,
src/run_kalign.c) for what this package runs: the default mode (anchor
consistency with K = 5 anchors) or, with --fast, none; the scoring
model; refinement (--refine all or confident; any other value,
"inline" among them, is none, as kalign_tpu/cli.py:189-191 parses it);
and the engine (kalign_tpu/cli.py:87 --engine; here gpu-fast, gpu or
host), with --no-autoroute to keep a divergent family on gpu-fast.
"""

import argparse
import sys

from kalign_tpu_torch import engine as E
from kalign_tpu_torch.core import io as kio
from kalign_tpu_torch.core import params as P
from kalign_tpu_torch.version import KALIGN_COMPAT_VERSION, __version__

# kalign_tpu/cli.py:16-25
TYPES = {
    None: 0, "rna": P.KALIGN_TYPE_RNA, "dna": P.KALIGN_TYPE_DNA,
    "internal": P.KALIGN_TYPE_DNA_INTERNAL, "protein": P.KALIGN_TYPE_PROTEIN,
    "divergent": P.KALIGN_TYPE_PROTEIN_DIVERGENT,
    "pfasum43": P.KALIGN_TYPE_PROTEIN_PFASUM43,
    "pfasum60": P.KALIGN_TYPE_PROTEIN_PFASUM60,
    "pfasum": P.KALIGN_TYPE_PROTEIN_PFASUM_AUTO,
}
REFINES = {None: P.REFINE_NONE, "none": P.REFINE_NONE, "all": P.REFINE_ALL,
           "confident": P.REFINE_CONFIDENT}


def _resolve_type(s):
    """kalign_tpu/cli.py::_resolve_type: the first type name the value
    contains."""
    if s is None:
        return 0
    for key in ("rna", "dna", "internal", "protein", "divergent",
                "pfasum43", "pfasum60", "pfasum"):
        if key in s:
            return TYPES[key]
    raise SystemExit(f"Type {s} not recognized.")


def _resolve_refine(s):
    """kalign_tpu/cli.py:189-191: all, confident, else none."""
    return REFINES.get(s if s is None else
                       ("all" if "all" in s else
                        "confident" if "confident" in s else "none"))


def build_parser():
    p = argparse.ArgumentParser(prog="kalign-tpu-torch")
    p.add_argument("-i", "--input", "--infile", "--in", dest="infile",
                   action="append", default=None)
    p.add_argument("-o", "--output", "--outfile", "--out", dest="outfile",
                   default=None)
    p.add_argument("-f", "--format", dest="format", default=None)
    p.add_argument("--type", dest="type", default=None)
    p.add_argument("--gpo", type=float, default=-1.0)
    p.add_argument("--gpe", type=float, default=-1.0)
    p.add_argument("--tgpe", type=float, default=-1.0)
    p.add_argument("--refine", default=None)
    p.add_argument("--vsm-amax", type=float, default=-1.0)
    p.add_argument("--consistency", type=int, default=5)
    p.add_argument("--consistency-weight", type=float, default=2.0)
    p.add_argument("--fast", action="store_true")
    p.add_argument("--engine", default="gpu-fast", choices=E.ENGINES,
                   help="gpu-fast (default), gpu (bit-exact, the host "
                        "engine's bytes) or host (native only)")
    p.add_argument("--no-autoroute", action="store_true",
                   help="keep divergent families on gpu-fast")
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
    type_ = _resolve_type(args.type)
    refine = _resolve_refine(args.refine)
    msa = kio.read_inputs(infiles)
    msa.quiet = args.quiet
    # mode preset (run_kalign.c:370-383): --fast turns the default
    # consistency off
    consistency = args.consistency
    if args.fast and consistency == 5:
        consistency = 0
    msa = E.align_msa(msa, type_=type_, gpo=args.gpo, gpe=args.gpe,
                      tgpe=args.tgpe, refine=refine,
                      vsm_amax=args.vsm_amax,
                      consistency_anchors=consistency,
                      consistency_weight=args.consistency_weight,
                      engine=args.engine, device=args.device,
                      autoroute=not args.no_autoroute)
    kio.write_alignment_file(msa, args.outfile, args.format)
    return 0


if __name__ == "__main__":
    sys.exit(main())
