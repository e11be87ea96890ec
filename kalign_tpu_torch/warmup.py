"""Warm a process up before it serves alignments (counterpart of
kalign_tpu/warmup.py).

kalign_tpu seeds JAX's persistent compile cache; this package has no
compiled programs to cache but its libraries.  What a fresh process pays
before its first alignment is: building the CUDA and native libraries
(once per machine and source hash: utils/build.py keeps them in
``_build/``), loading them, creating the CUDA context, and each
kernel's first launch.  ``warmup`` pays all of it: it builds and loads
every library (gpu/_cuda.py's kernels on a card, native/ always),
launches the device k-means once per tree bucket
(``warmup_tree_programs``), and aligns DSSim families at
``DEFAULT_SIZES`` through the engines.  The warm server (serve.py) runs
it before it opens its socket.

Unlike kalign_tpu's, a failure is not caught and reported as "failed":
it raises (``main`` exits non-zero), so a build or launch that fails
does not hide behind a server that looks warm.

Usage:
    python -m kalign_tpu_torch.warmup                 # gpu-fast and gpu
    python -m kalign_tpu_torch.warmup --engines gpu-fast --sizes 64x200
"""

import argparse
import sys
import time

import numpy as np
import torch

# (n_seq, length) pairs of kalign_tpu/warmup.py:29
DEFAULT_SIZES = [(16, 120), (64, 200), (256, 200)]

# the padded tree sizes of kalign_tpu/warmup.py:32
DEFAULT_TREE_NP = (2048, 16384, 131072)


def _log(msg: str, t0: float, quiet: bool) -> None:
    if not quiet:
        print(f"{msg}: ok ({time.perf_counter() - t0:.1f}s)", file=sys.stderr)


def build_libraries(device) -> None:
    """Build (or find in _build/) and load the native library, and on a
    card the CUDA kernels' library."""
    from kalign_tpu_torch import native
    native.lib()
    if torch.device(device).type == "cuda":
        from kalign_tpu_torch.gpu import _cuda
        _cuda.lib()


def warmup_tree_programs(np_buckets=DEFAULT_TREE_NP, quiet=False,
                         device=None):
    """One root split of the device k-means tree per bucket, on a seeded
    [Np, 32] embedding: gpu/kmeans.py::fused_splits cut at depth 1,
    through the Lloyd kernel on a card (its plain version on the CPU).
    The rest of the tree is not built."""
    from kalign_tpu_torch import engine as E
    from kalign_tpu_torch.gpu import kmeans
    dev = E.resolve_device(device)
    for Np in np_buckets:
        t0 = time.perf_counter()
        emb = np.random.default_rng(7).random((Np, 32), dtype=np.float32)
        kmeans.fused_splits(torch.from_numpy(emb).to(dev), Np, Np,
                            kmeans.MAX_TRIES, 1,
                            Np // kmeans.UPGMA_THRESHOLD + 1,
                            kernel=dev.type == "cuda")
        _log(f"warmup tree Np={Np}", t0, quiet)


def warmup(engines=("gpu-fast", "gpu"), sizes=DEFAULT_SIZES,
           consistency=True, quiet=False, tree_np=DEFAULT_TREE_NP,
           device=None):
    """Build and load the libraries, run the tree buckets (when
    "gpu-fast" is among the engines), then align a DSSim family of each
    size through each engine on ``device`` (cuda by default); with
    consistency, the "gpu" engine's runs take 5 anchors
    (kalign_tpu/warmup.py:79-82)."""
    from kalign_tpu_torch import dssim
    from kalign_tpu_torch import engine as E
    from kalign_tpu_torch.core.msa import Msa
    dev = E.resolve_device(device)
    t0 = time.perf_counter()
    build_libraries(dev)
    _log("warmup libraries", t0, quiet)
    if "gpu-fast" in engines and tree_np:
        warmup_tree_programs(tree_np, quiet=quiet, device=dev)
    for engine in engines:
        for n_seq, length in sizes:
            t0 = time.perf_counter()
            seqs, names = dssim.generate_test_sequences(
                n_seq, n_obs=10, dna=False, length=length, seed=7)
            m = Msa.from_sequences(seqs, names)
            m.quiet = True
            E.align_msa(m, engine=engine, device=dev,
                        consistency_anchors=5 if consistency
                        and engine == "gpu" else 0)
            _log(f"warmup {engine} {n_seq}x{length}", t0, quiet)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="warm up kalign_tpu_torch: build and load its "
                    "libraries and launch its kernels")
    ap.add_argument("--engines", default="gpu-fast,gpu")
    ap.add_argument("--sizes", default=None,
                    help="comma list of NxL, e.g. 64x200,256x200")
    ap.add_argument("--no-consistency", action="store_true")
    ap.add_argument("--tree-np", default=None,
                    help="comma list of tree sizes to split once "
                         "(default 2048,16384,131072; 'none' disables)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    sizes = DEFAULT_SIZES
    if args.sizes:
        sizes = []
        for part in args.sizes.split(","):
            n, L = part.lower().split("x")
            sizes.append((int(n), int(L)))
    tree_np = DEFAULT_TREE_NP
    if args.tree_np is not None:
        tree_np = () if args.tree_np.lower() == "none" else \
            tuple(int(x) for x in args.tree_np.split(","))
    warmup(engines=tuple(args.engines.split(",")), sizes=sizes,
           consistency=not args.no_consistency, quiet=args.quiet,
           tree_np=tree_np, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
