"""Command line of the PyTorch/CUDA port:

    python -m kalign_tpu_torch.cli -i IN -o OUT [-f fasta|msf|clu|sto]
        [--fast | --precise] [--consistency K] [--consistency-weight W]
        [--type T] [--gpo X] [--gpe X] [--tgpe X] [--vsm-amax X]
        [--refine MODE] [--realign N] [--adaptive-budget]
        [--ensemble [N]] [--ensemble-seed S] [--min-support M]
        [--save-poar F] [--load-poar F] [--ensemble-scratch DIR
        --ensemble-worker W --ensemble-workers K | --ensemble-merge]
        [--save-checkpoint DIR] [--resume-checkpoint DIR] [-n N]
        [--engine gpu-fast|gpu|gpu-mesh|host|auto] [--no-autoroute]
        [--device cuda|cpu] [--trace DIR] [--server[=SOCKET]
        [--server-start]]

The flags are kalign_tpu/cli.py's (and so the reference binary's,
src/run_kalign.c): the default mode (anchor consistency with K = 5
anchors), --fast (none) and --precise (an ensemble of 3 runs with one
realign pass, cli.py:195-203); the scoring model; refinement (--refine
all or confident; any other value, "inline" among them, is none, as
kalign_tpu/cli.py:189-191 parses it); the ensemble, its distributed
worker and merge steps and its POAR files; checkpoints; --set (parsed,
unused) and --showw; and the engine (kalign_tpu/cli.py:87 --engine;
here gpu-fast, gpu, gpu-mesh (every visible card), host or auto,
engine.resolve_auto_engine's choice),
with --no-autoroute to keep a divergent family on gpu-fast.
--adaptive-budget reaches the native runtime of "host" and "gpu";
"gpu-fast" ignores it, as kalign_tpu's "tpu-fast" does.  --trace DIR
writes a torch.profiler trace of the alignment into DIR, in which the
program's spans are ranges named "layer.<span>" or "progressive.<part>"
(utils/logging.py); utils/devtime.py reads its device time
(busy_seconds: the card's busy time, the union over its streams;
device_seconds: per stream, kalign_tpu's sum).  --server[=SOCKET] sends the
invocation to a warm server (serve.py) instead of running it here;
--server-start spawns that server first when the socket does not answer.
"""

import argparse
import contextlib
import sys

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
    p.add_argument("--adaptive-budget", action="store_true")
    p.add_argument("--ensemble", nargs="?", const=5, type=int, default=0)
    p.add_argument("--ensemble-seed", type=int, default=42)
    # distributed ensemble: each worker process aligns runs
    # k % workers == worker into --ensemble-scratch; a final
    # --ensemble-merge invocation combines POAR tables and finalises
    p.add_argument("--ensemble-scratch", default=None,
                   help="shared directory for distributed ensemble "
                        "partials (worker + merge modes)")
    p.add_argument("--ensemble-worker", type=int, default=None,
                   help="this process's worker id (0-based)")
    p.add_argument("--ensemble-workers", type=int, default=None,
                   help="total number of worker processes")
    p.add_argument("--ensemble-merge", action="store_true",
                   help="merge worker partials from --ensemble-scratch "
                        "and write the final alignment")
    p.add_argument("--min-support", type=int, default=0)
    p.add_argument("--save-poar", default=None)
    p.add_argument("--load-poar", default=None)
    p.add_argument("--save-checkpoint", default=None, metavar="DIR",
                   help="persist distance/guide-tree artifacts")
    p.add_argument("--resume-checkpoint", default=None, metavar="DIR",
                   help="resume from --save-checkpoint artifacts")
    p.add_argument("--consistency", type=int, default=5)
    p.add_argument("--consistency-weight", type=float, default=2.0)
    p.add_argument("--fast", action="store_true")
    p.add_argument("--precise", action="store_true")
    p.add_argument("--realign", type=int, default=0)
    p.add_argument("--vsm-amax", type=float, default=-1.0)
    p.add_argument("-n", "--nthreads", type=int, default=1)
    p.add_argument("--set", dest="param_set", type=int, default=-1,
                   help="parameter-set id (parsed for reference CLI "
                        "compatibility; unused, run_kalign.c:158,206)")
    p.add_argument("--showw", action="store_true",
                   help="print the warranty disclaimer and exit")
    p.add_argument("--engine", default="gpu-fast", choices=P.ENGINES,
                   help="gpu-fast (default), gpu (bit-exact, the host "
                        "engine's bytes), gpu-mesh (sharded over every "
                        "visible card), host (native only) or auto "
                        "(host without a card or below 256 sequences, "
                        "else gpu-mesh on several cards, gpu-fast on "
                        "one)")
    p.add_argument("--no-autoroute", action="store_true",
                   help="keep divergent families on gpu-fast")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the alignment "
                        "into DIR (Chrome-trace JSON; open with "
                        "TensorBoard or chrome://tracing), the "
                        "program's spans in it as layer.* and "
                        "progressive.* ranges")
    p.add_argument("--server", default=None, metavar="SOCKET",
                   help="send this invocation to a running warm "
                        "alignment server (python -m kalign_tpu_torch.serve)"
                        " instead of paying the process's start-up; bare "
                        "--server uses the default socket, "
                        "--server=SOCKET an explicit one (the separate-"
                        "token form is rejected so an input file can "
                        "never be mistaken for a socket path)")
    p.add_argument("--server-start", action="store_true",
                   help="with --server: spawn the warm server in the "
                        "background if the socket is not answering, "
                        "wait for it, then submit")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-v", "-V", "--version", action="store_true",
                   dest="version")
    p.add_argument("files", nargs="*")
    return p


def _ensure_server(sock: str, timeout: float = 900.0) -> None:
    """Spawn the warm server detached if the socket is not answering,
    then wait for it to come up (kalign_tpu/cli.py::_ensure_server
    :109-139; the socket is polled every 0.1 s)."""
    import socket as socklib
    import subprocess
    import time

    def _alive():
        try:
            with socklib.socket(socklib.AF_UNIX,
                                socklib.SOCK_STREAM) as s:
                s.settimeout(5.0)
                s.connect(sock)
            return True
        except OSError:
            return False

    if _alive():
        return
    subprocess.Popen(
        [sys.executable, "-m", "kalign_tpu_torch.serve", "--socket", sock],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)
    t0 = time.time()
    while time.time() - t0 < timeout:
        if _alive():
            return
        time.sleep(0.1)
    raise SystemExit(f"server on {sock} did not come up in {timeout:.0f}s")


def _via_server(raw, args) -> int:
    """Send the invocation, stripped of its --server flags, to the
    server on args.server (kalign_tpu/cli.py:143-161)."""
    from kalign_tpu_torch.serve import DEFAULT_SOCKET, request
    sock = DEFAULT_SOCKET if args.server == "__default__" else args.server
    out = [tok for tok in raw
           if tok != "--server-start" and not tok.startswith("--server=")]
    if args.server_start:
        _ensure_server(sock)
    resp = request(sock, out)
    if resp.get("error"):
        print(resp["error"], file=sys.stderr)
    return int(resp.get("rc", 1))


# kalign_tpu/cli.py:166-180 (run_kalign.c:306-310)
WARRANTY = ("Disclaimer of Warranty (Apache License, Version 2.0, "
            "Section 7):\n\n"
            "Unless required by applicable law or agreed to in writing, "
            "Licensor\nprovides the Work (and each Contributor provides "
            "its Contributions)\non an \"AS IS\" BASIS, WITHOUT "
            "WARRANTIES OR CONDITIONS OF ANY KIND,\neither express or "
            "implied, including, without limitation, any\nwarranties or "
            "conditions of TITLE, NON-INFRINGEMENT,\nMERCHANTABILITY, or "
            "FITNESS FOR A PARTICULAR PURPOSE.\n\n"
            "See the COPYING file for the full Apache License, "
            "Version 2.0.")


def resolve_modes(args):
    """(consistency, ensemble, realign) of the mode presets
    (kalign_tpu/cli.py:195-203, run_kalign.c:370-383)."""
    consistency, ensemble, realign = (args.consistency, args.ensemble,
                                      args.realign)
    if args.fast and consistency == 5:
        consistency = 0
    if args.precise:
        if ensemble == 0:
            ensemble = 3
        if realign == 0:
            realign = 1
    return consistency, ensemble, realign


def main(argv=None):
    raw = list(sys.argv[1:]) if argv is None else list(argv)
    # A bare --server means "the default socket".  Rewriting it to the
    # =-form before parsing keeps argparse from consuming a following
    # input file as the socket path (`--server in.fa -o out`).
    raw = ["--server=__default__" if tok == "--server" else tok
           for tok in raw]
    args = build_parser().parse_args(raw)
    if args.server is not None:
        return _via_server(raw, args)
    if args.version:
        print(f"kalign-tpu-torch {__version__} "
              f"(kalign {KALIGN_COMPAT_VERSION} compatible)")
        return 0
    if args.showw:
        print(WARRANTY)
        return 0
    infiles = list(args.infile or []) + list(args.files)
    if not infiles:
        build_parser().print_help()
        print("No input files", file=sys.stderr)
        return 0
    # the aligner's modules (torch among them) load here, after the
    # --server branch: a client of the warm server does not import them
    from kalign_tpu_torch.core import io as kio
    from kalign_tpu_torch.utils import devtime
    infiles = [None if f == "-" else f for f in infiles]
    type_ = _resolve_type(args.type)
    refine = _resolve_refine(args.refine)
    consistency, ensemble, realign = resolve_modes(args)
    msa = kio.read_inputs(infiles)
    msa.quiet = args.quiet
    run = dict(n_threads=args.nthreads, type_=type_, gpo=args.gpo,
               gpe=args.gpe, tgpe=args.tgpe, vsm_amax=args.vsm_amax,
               consistency_anchors=consistency,
               consistency_weight=args.consistency_weight,
               engine=args.engine, device=args.device,
               autoroute=not args.no_autoroute)
    with (devtime.trace(args.trace) if args.trace
          else contextlib.nullcontext()):
        msa = _run(msa, args, run, type_, refine, consistency, ensemble,
                   realign)
        if msa is None:
            return 0
    if args.trace and not args.quiet:
        print(f"device trace written to {args.trace}", file=sys.stderr)
    kio.write_alignment_file(msa, args.outfile, args.format)
    return 0


def _run(msa, args, run, type_, refine, consistency, ensemble, realign):
    """The alignment the flags ask for (kalign_tpu/cli.py:215-271): the
    aligned Msa, or None after an ensemble worker's step."""
    from kalign_tpu_torch import engine as E
    from kalign_tpu_torch import ensemble as ens
    if args.load_poar:
        msa = ens.consensus_from_poar(
            msa, args.load_poar,
            args.min_support if args.min_support > 0 else 2)
    elif ensemble > 0 and args.ensemble_worker is not None:
        if not args.ensemble_scratch:
            raise SystemExit("--ensemble-worker requires --ensemble-scratch")
        workers = args.ensemble_workers or 1
        done = ens.ensemble_worker(
            msa, args.ensemble_worker, workers, args.ensemble_scratch,
            n_runs=ensemble, seed=args.ensemble_seed, refine=refine,
            realign=realign, **run)
        if not args.quiet:
            print(f"worker {args.ensemble_worker}/{workers}: runs {done} "
                  f"written to {args.ensemble_scratch}", file=sys.stderr)
        return None
    elif ensemble > 0 and args.ensemble_merge:
        if not args.ensemble_scratch:
            raise SystemExit("--ensemble-merge requires --ensemble-scratch")
        msa = ens.ensemble_merge(msa, args.ensemble_scratch, n_runs=ensemble,
                                 seed=args.ensemble_seed,
                                 min_support=args.min_support,
                                 save_poar=args.save_poar, **run)
    elif ensemble > 0:
        msa = ens.ensemble_align(msa, n_runs=ensemble,
                                 seed=args.ensemble_seed,
                                 min_support=args.min_support,
                                 save_poar=args.save_poar, refine=refine,
                                 realign=realign, **run)
    else:
        msa = E.align_msa(msa, refine=refine,
                          adaptive_budget=int(args.adaptive_budget),
                          realign=realign,
                          save_checkpoint=args.save_checkpoint,
                          resume_checkpoint=args.resume_checkpoint, **run)
    return msa


if __name__ == "__main__":
    sys.exit(main())
