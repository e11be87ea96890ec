"""Build and bind the package's CUDA kernels (kalign_tpu_torch/csrc).

The kernels compile with nvcc for Hopper (sm_90a) into one shared
library with a plain C interface, loaded with ctypes: every entry point
takes raw device pointers and the current stream and returns
cudaGetLastError(), which ``check`` turns into an exception.  The build
happens at the first launch, never at import (the CPU test suite imports
every module), under the lock of utils/build.py.

-fmad=false is part of the float contract: no multiply feeding an add
may contract into an FMA, or the kernels would round differently from
their plain PyTorch versions.
"""

import ctypes
import os
import shutil
from functools import lru_cache

import torch

from kalign_tpu_torch.utils.build import build_library

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
SOURCES = [os.path.join(CSRC, f) for f in
           ("gotoh_row.cu", "gotoh_row_wave.cu", "prepare_match.cu",
            "gotoh_lanewise.cu", "traceback.cu", "bpm.cu", "scan.cu",
            "kmeans.cu", "exact_sweep.cu", "gotoh_mesh.cu", "errors.cu")]
HEADERS = [os.path.join(CSRC, f) for f in ("kt_cuda.h",
                                           "gotoh_row_body.cuh")]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_p = ctypes.c_void_p
_i = ctypes.c_int


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the kalign_tpu_torch CUDA kernels")


def library_path(name: str = "libkt_cuda", sources=SOURCES,
                 headers=HEADERS) -> str:
    """The package's kernel library (or another library of CUDA sources
    with a plain C interface, built the same way)."""
    cc = nvcc()
    return build_library(
        name, sources, headers,
        compile_cmd=lambda src, obj: [cc, *NVCC_FLAGS, "-I", CSRC, "-c",
                                      "-o", obj, src],
        link_cmd=lambda objs, out: [cc, "-shared", "-gencode",
                                    "arch=compute_90a,code=sm_90a", "-o",
                                    out, *objs],
        flags=[cc, *NVCC_FLAGS])


@lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    L = ctypes.CDLL(library_path())
    L.kt_cuda_error_string.restype = ctypes.c_char_p
    L.kt_cuda_error_string.argtypes = [_i]
    L.kt_gotoh_row_smem_bytes.restype = ctypes.c_size_t
    L.kt_gotoh_row_smem_bytes.argtypes = [_i, _i]
    L.kt_gotoh_row_forward.restype = _i
    L.kt_gotoh_row_forward.argtypes = ([_p] * 8 + [_i] * 3 + [_p] * 3
                                       + [_i, _i, _p])
    L.kt_gotoh_row_wave_smem_bytes.restype = ctypes.c_size_t
    L.kt_gotoh_row_wave_smem_bytes.argtypes = [_i, _i]
    L.kt_gotoh_row_wave_max_active.restype = _i
    L.kt_gotoh_row_wave_max_active.argtypes = [_i, _i, _i, ctypes.c_size_t,
                                               _p]
    L.kt_gotoh_row_wave.restype = _i
    L.kt_gotoh_row_wave.argtypes = ([_p] * 11 + [_i] * 14
                                    + [ctypes.c_size_t, _p])
    L.kt_prepare_match.restype = _i
    L.kt_prepare_match.argtypes = [_p] * 8 + [_i] * 8 + [_p]
    L.kt_gotoh_row_cluster_smem_bytes.restype = ctypes.c_size_t
    L.kt_gotoh_row_cluster_smem_bytes.argtypes = [_i, _i]
    L.kt_gotoh_row_cluster_max_active.restype = _i
    L.kt_gotoh_row_cluster_max_active.argtypes = [_i, _i, _i, _p]
    L.kt_gotoh_row_cluster_forward.restype = _i
    L.kt_gotoh_row_cluster_forward.argtypes = ([_p] * 8 + [_i] * 3 + [_p] * 3
                                               + [_i, _i, _i, _p])
    L.kt_gotoh_lanewise_smem_bytes.restype = ctypes.c_size_t
    L.kt_gotoh_lanewise_smem_bytes.argtypes = [_i, _i, _i]
    L.kt_gotoh_lanewise_forward.restype = _i
    L.kt_gotoh_lanewise_forward.argtypes = [_p] * 9 + [_i] * 4 + [_p] * 4
    L.kt_gotoh_fused_forward.restype = _i
    L.kt_gotoh_fused_forward.argtypes = ([_p, _p, _i] + [_p] * 8 + [_i] * 4
                                         + [_p] * 4)
    L.kt_traceback.restype = _i
    L.kt_traceback.argtypes = ([_i] + [_p] * 4 + [_i] * 8 + [_p] * 3
                               + [_i, _p, _p])
    L.kt_bpm_table.restype = _i
    L.kt_bpm_table.argtypes = [_p, _i, _p, _i, _i, _p, _p]
    L.kt_bpm_batch.restype = _i
    L.kt_bpm_batch.argtypes = ([_p, ctypes.c_int64] + [_p] * 5
                               + [_i] * 2 + [_p, _p])
    L.kt_prefix_sums_f32.restype = _i
    L.kt_prefix_sums_f32.argtypes = [_i, _p, _p]
    L.kt_kmeans_lloyd.restype = _i
    L.kt_kmeans_lloyd.argtypes = ([_p, _i, ctypes.c_int64, _p, _p]
                                  + [_i] * 4 + [ctypes.c_float] + [_p] * 4
                                  + [_i, _p])
    L.kt_exact_sweep.restype = _i
    L.kt_exact_sweep.argtypes = [_p] * 11 + [_i] * 10 + [_p]
    L.kt_gotoh_band_smem_bytes.restype = ctypes.c_size_t
    L.kt_gotoh_band_smem_bytes.argtypes = [_i, _i]
    L.kt_gotoh_band_cluster_max_active.restype = _i
    L.kt_gotoh_band_cluster_max_active.argtypes = [_i, _i, _i, _p]
    L.kt_gotoh_band_wave_max_active.restype = _i
    L.kt_gotoh_band_wave_max_active.argtypes = [_i, _i, _i, ctypes.c_size_t,
                                                _p]
    L.kt_gotoh_band_cluster.restype = _i
    L.kt_gotoh_band_cluster.argtypes = [_p] * 9 + [_i] * 11 + [_p]
    L.kt_gotoh_band_wave.restype = _i
    L.kt_gotoh_band_wave.argtypes = ([_p] * 9 + [_i] * 8 + [_p] * 2
                                     + [_i] * 6 + [ctypes.c_size_t, _p])
    return L


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = lib().kt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, from torch's
    raw-stream query (no torch.cuda.Stream object is built on every
    launch).  A launch takes the stream of its inputs' device, which is
    not the current device's unless the wrapper entered it."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel inputs must be contiguous tensors on one CUDA device, and
    that device must be the current one: the entry points set kernel
    attributes and launch on the current device, so a wrapper runs them
    under ``torch.cuda.device(inputs' device)``."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    current = torch.cuda.current_device()
    if dev.index is not None and dev.index != current:
        raise ValueError(f"{name}: inputs on {dev} but the current device "
                         f"is cuda:{current}")
