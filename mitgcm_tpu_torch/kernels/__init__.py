"""Build, load and launch the port's hand-written CUDA kernels.

All sources under `csrc/` are compiled by nvcc for sm_90a into one shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds). The build happens at first use, keyed by a hash
of the sources and flags, into `build/` beside this file; nothing is built
or imported when the module is imported.

Each exported function is `mitgcm_<kernel>_f32` / `_f64`; it launches on the
stream it is given, allocates nothing and returns cudaGetLastError().
`launch` raises if that is not 0 and otherwise adds one to the kernel's
count in `launches`, which a run reads to prove that the main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from collections import Counter

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
# --fmad=false: no multiply-add contraction, so each kernel rounds exactly
# like its plain PyTorch twin (the stencils are memory-bound; FMA buys
# nothing measurable there)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_PP = ctypes.POINTER(ctypes.c_void_p)

# argument types of each kernel's C entry point (the stream comes last)
SIGNATURES = {
    # cW, cS, cC, y, out, dot_out, partials, counter; ny, nx, oly, olx,
    # center_first; stream
    "cg2d_stencil_dot": [_P] * 8 + [_I] * 5 + [_P],
    # q, s, eta_n, eta_nm1; ny, nx, oly, olx; stream
    "cg2d_s_update": [_P] * 4 + [_I] * 4 + [_P],
    # x, r, s, q, num, den, dot_out, partials, counter; ny, nx, oly, olx;
    # stream
    "cg2d_xr_update": [_P] * 9 + [_I] * 4 + [_P],
    # pointer table, its length; nr, ny, nx, oly, olx; viscAhD, viscAhZ,
    # sideDragFactor, rkSign; stream
    "mom_fluxform": [_PP, _I] + [_I] * 5 + [_D] * 4 + [_P],
    # pointer table, its length; nr, ny, nx, oly, olx; diffKh, rkSign;
    # stream
    "gad_calc_rhs_c2": [_PP, _I] + [_I] * 5 + [_D] * 2 + [_P],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

launches: Counter = Counter()
_lib = None


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into one .so (once per content hash); return its
    path. verbose prints nvcc's output (ptxas register/spill report)."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libmitgcm_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, *sources],
                          capture_output=True, text=True)
    if verbose or proc.returncode != 0:
        print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for kernel, argtypes in SIGNATURES.items():
            for suffix in _SUFFIX.values():
                fn = getattr(lib, f"mitgcm_{kernel}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.mitgcm_cg2d_num_partials.argtypes = [_I, _I]
        lib.mitgcm_cg2d_num_partials.restype = ctypes.c_int
        lib.mitgcm_error_string.argtypes = [ctypes.c_int]
        lib.mitgcm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def use_kernel(t: torch.Tensor, impl) -> bool:
    """The dispatch rule of every kernel wrapper: the kernel for CUDA
    tensors, the plain PyTorch twin for CPU tensors; impl="plain" runs the
    twin on any device (for comparisons). There is no fallback."""
    if impl == "plain":
        return False
    if impl is not None:
        raise ValueError(f"impl must be None or 'plain', not {impl!r}")
    return t.is_cuda


def check_tensors(dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of `dtype`
    (float32 or float64) on the current device."""
    if dtype not in _SUFFIX:
        raise TypeError(f"kernels take float32 or float64, not {dtype}")
    for name, t in tensors.items():
        if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()
                and t.device.index == torch.cuda.current_device()):
            raise ValueError(
                f"{name}: need a contiguous {dtype} tensor on the current "
                f"CUDA device, got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


def check_shape(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: shape {tuple(t.shape)}, need {tuple(shape)}")


def pointer_table(tensors) -> ctypes.Array:
    """Host array of device pointers, in the order of the C struct it
    fills (the caller keeps the tensors alive across the launch)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def launch(kernel: str, dtype: torch.dtype, *args) -> None:
    """Call mitgcm_<kernel>_<f32|f64> on the current stream; raise on a
    CUDA error, count the launch otherwise."""
    lib = library()
    fn = getattr(lib, f"mitgcm_{kernel}_{_SUFFIX[dtype]}")
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.mitgcm_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err}: {msg}")
    launches[kernel] += 1
