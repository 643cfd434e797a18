"""Build, load and launch the port's hand-written CUDA kernels.

All sources under `csrc/` are compiled by nvcc for sm_90a (one nvcc per
source, in parallel) and linked into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The build happens at first use, keyed by a hash
of the sources and flags, into `build/` beside this file; nothing is built
or imported when the module is imported.

Each exported function is `mitgcm_<kernel>_f32` / `_f64`; it launches on the
stream it is given, allocates nothing and returns cudaGetLastError().
`launch` raises if that is not 0 and otherwise adds one to the kernel's
count in `launches`, which a run reads to prove that the main path went
through the kernels; inside `counting_as(label)` the launch is also
counted under "<kernel>:<label>" (the adjoint cg2d solves are counted
apart from the forward ones so). `TwinVJP` differentiates a kernel that
has no backward kernel through its plain twin.
"""

from __future__ import annotations

import contextlib
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "--fmad=false", "-Xptxas=-v",
                     "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_PP = ctypes.POINTER(ctypes.c_void_p)
_PD = ctypes.POINTER(ctypes.c_double)

# argument types of each kernel's C entry point (the stream comes last)
SIGNATURES = {
    # kernel A, one cooperative launch a solve: aW, aS, aC, pW, pS, pC, b,
    # tol_sq, x, work, partials, scalars, ctrl; ny, nx, oly, olx,
    # max_iters, use_min; stream
    "cg2d_solve": [_P] * 13 + [_I] * 6 + [_P],
    # pointer table, its length; nr, ny, nx, oly, olx, no_slip_sides,
    # coriolis_3d; viscAhD, viscAhZ, sideDragFactor, rkSign, gravitySign;
    # stream
    "mom_fluxform": [_PP, _I] + [_I] * 7 + [_D] * 5 + [_P],
    # pointer table, its length; nr, ny, nx, oly, olx; diffKh, rkSign;
    # implicit_diffusion, calc_advection; df (the extra vertical flux, or
    # null); stream
    "gad_calc_rhs_c2": [_PP, _I] + [_I] * 5 + [_D] * 2 + [_I, _I, _P, _P],
    # its GM branch: the same, then the GM pointer table (Kux, Kvy, Kwx,
    # Kwy, Kuz, Kvz, maskW, maskS), its length, and the scalar Kux and Kvy;
    # stream
    "gad_calc_rhs_c2_gm": [_PP, _I] + [_I] * 5 + [_D] * 2 + [_I, _I, _P]
    + [_PP, _I, _D, _D, _P],
    # GM-Redi's kernels (gmredi.cu): pointer table, its length; parameter
    # array, its length; nr, nyp, nxp, taper scheme (gm_tensor: and
    # nonUnityDiagonal); stream
    "gm_tensor": [_PP, _I, _PD, _I] + [_I] * 5 + [_P],
    "gm_psi_b": [_PP, _I, _PD, _I] + [_I] * 4 + [_P],
    # pointer table, its length; nr, nyp, nxp; -gravitySign; stream
    "gm_residual_flow": [_PP, _I] + [_I] * 3 + [_D, _P],
    # kernel W: pointer table, its length; nr, nyp, nxp, coriolis_3d;
    # viscAhW, rkSign, gravitySign; stream
    "calc_gw": [_PP, _I] + [_I] * 4 + [_D] * 3 + [_P],
    # kernel H-cg3d: zMC, zML, zMU, maskC, r, q, dot_out, partials, counter,
    # ctrl; nr, ny, nx, oly, olx; stream
    "cg3d_precond_dot": [_P] * 10 + [_I] * 5 + [_P],
    # aW, aS, aV, aC, maskC, q, s_in, s_out, qa, eta_n, eta_nm1, dot_out,
    # partials, counter, ctrl; nr, ny, nx, oly, olx; stream
    "cg3d_s_stencil_dot": [_P] * 15 + [_I] * 5 + [_P],
    # x, r, s, q, num, den, maskC, dot_out, partials, counter, ctrl,
    # tol_sq; nr, ny, nx, oly, olx, max_iters, count_iter; stream
    "cg3d_xr_update": [_P] * 12 + [_I] * 7 + [_P],
    # the backward kernels take the arguments of their forward kernels
    # (B' without the flags and gravitySign, C' without the
    # implicit_diffusion flag)
    "mom_fluxform_adj": [_PP, _I] + [_I] * 5 + [_D] * 4 + [_P],
    "gad_calc_rhs_c2_adj": [_PP, _I] + [_I] * 5 + [_D] * 2 + [_P],
    # pointer table, its length; nr, ny, nx, oly, olx; selectVortScheme,
    # selectCoriScheme, implicitViscosity, no_slip_bottom; viscAh,
    # sideDragFactor, bottomDragLinear, rkSign; stream
    "mom_vecinv": [_PP, _I] + [_I] * 5 + [_I] * 4 + [_D] * 4 + [_P],
    # field, kappaR, recip_hFac, recip_drF, recip_drC, gam, out; nr,
    # nyp * nxp; deltaT; stream
    "impldiff": [_P] * 7 + [_I] * 2 + [_D, _P],
    # theta, salt, totPhiHyd, profile, rho; nr, nyp * nxp, eos kind,
    # use totPhiHyd; rhoConst, dp0, pressure scale; stream
    "eos_find_rho": [_P] * 5 + [_I] * 4 + [_D] * 3 + [_P],
    # pointer table, its length; parameter array, its length; nr, nyp, nxp,
    # eos kind, use totPhiHyd, KPP_SMOOTH_SHSQ; stream
    "kpp_pre": [_PP, _I, _PD, _I] + [_I] * 6 + [_P],
    # dbraw, maskC, kmtj, out; nr, nyp, nxp; stream
    "kpp_smooth": [_P] * 4 + [_I] * 3 + [_P],
    # pointer table, its length; parameter array, its length; nr, nyp, nxp,
    # LimitHblStable; stream
    "kpp_col": [_PP, _I, _PD, _I] + [_I] * 4 + [_P],
    # pointer table, its length; parameter array, its length; nr, nyp, nxp,
    # mxlMaxFlag, calcMeanVertShear, GGL90_dirichlet, useIDEMIX,
    # useLANGMUIR; stream
    "ggl90_col": [_PP, _I, _PD, _I] + [_I] * 8 + [_P],
    # kernel H-IDEMIX: pointer table, its length; parameter array, its
    # length; nr, nyp, nxp; stream
    **{f"idemix_{stage}": [_PP, _I, _PD, _I] + [_I] * 3 + [_P]
       for stage in ("prep", "hdiff", "col")},
    # kernel H-SOM: pointer table, its length; the pass's input volume,
    # content and moments, its output volume, content and moments, gTracer;
    # nr, nyp, nxp, limiter; deltaT; stream
    **{f"som_{d}": [_PP, _I] + [_P] * 7 + [_I] * 4 + [_D, _P]
       for d in "xyr"},
    # visctmp, maskW, maskS, viscU, viscV; nr, nyp, nxp; viscMax, viscAr;
    # stream
    "ggl90_visc": [_P] * 5 + [_I] * 3 + [_D] * 2 + [_P],
    # the sweeps of kernels M and O: pointer table, its length; the sweep's
    # input and output fields; nr, nyp, nxp, scheme; deltaT, rkSign; stream
    **{f"{k}_{d}": [_PP, _I, _P, _P] + [_I] * 4 + [_D] * 2 + [_P]
       for k in ("gad_multidim", "gad_os7mp") for d in "xyr"},
    # the sweeps of kernel P: the same with its coefficient scratch buffer
    # after the output field
    **{f"gad_ppm_{d}": [_PP, _I, _P, _P, _P] + [_I] * 4 + [_D] * 2 + [_P]
       for d in "xyr"},
    # the sea ice's seaice_lsr_prep (two launches) and seaice_thermo:
    # pointer table, its length; parameter array, its length; nyp, nxp
    # (seaice_thermo: and ol, multDim, IMAX_TICE); stream
    **{f"seaice_lsr_{s}": [_PP, _I, _PD, _I] + [_I] * 2 + [_P]
       for s in ("visc", "coeffs")},
    "seaice_thermo": [_PP, _I, _PD, _I] + [_I] * 5 + [_P],
    # seaice_lsr_tridiag's half-sweeps: the table A, B, C, Rt1, Rt2, rhs,
    # mask, its length; u, uTmp, cuu, ctrl, wf; nxp, ol, sNy, sNx, nSy,
    # nSx, k; stream
    **{f"seaice_lsr_tridiag_{d}": [_PP, _I] + [_P] * 5 + [_I] * 7 + [_P]
       for d in "uv"},
    # u, v, uTmp, vTmp, maskU, maskV, ctrl, wf, partials, counter; ny, nx,
    # ol, SOLV_NCHECK, linearIterMax; LSR_ERROR; stream
    "seaice_lsr_check": [_P] * 10 + [_I] * 5 + [_D, _P],
    # seaice_advect: pointer table, its length; the stacked fields (x: src,
    # dst; y: fld, localT, dst); nyp, nxp, ol, scheme; deltaT (y: and the
    # three diffKh); stream
    "seaice_advect_x": [_PP, _I, _P, _P] + [_I] * 4 + [_D, _P],
    "seaice_advect_y": [_PP, _I, _P, _P, _P] + [_I] * 4 + [_D] * 4 + [_P],
    # kernel H-seaice EVP: pointer table, its length; parameter array, its
    # length; seaice_evp_stress: nyp, nxp, adaptive, revised-or-adaptive
    # denominators; seaice_evp_uv: ny, nx, ol, the same two flags, last;
    # stream
    "seaice_evp_stress": [_PP, _I, _PD, _I] + [_I] * 4 + [_P],
    "seaice_evp_uv": [_PP, _I, _PD, _I] + [_I] * 6 + [_P],
    # seaice_freedrift: pointer table, its length; parameter array, its
    # length; ny, nx, ol; stream
    "seaice_freedrift": [_PP, _I, _PD, _I] + [_I] * 3 + [_P],
    # kernel F: src, dst; planes, ny, nx, oly, olx; stream
    "halo_fill": [_P] * 2 + [_I] * 5 + [_P],
    # kernel D: rho, drC, rF, rC, recip_dxC, recip_dyC, phiHydC, dPhiHydX,
    # dPhiHydY; nr, nyp, nxp; gravity, 1/rhoConst; stream
    "phihyd": [_P] * 9 + [_I] * 3 + [_D] * 2 + [_P],
    # kernel E's cg2d right-hand side: pointer table (uStar, vStar, hFacW,
    # hFacS, dyG, dxG, rA, etaN, drF, out, the non-hydrostatic 3-D div),
    # its length; nr, nyp, nxp, oly, olx, hydrostatic; implicDiv2Dflow,
    # deltaTMom, freeSurfFac, deltaTFreeSurf; stream
    "cg2d_rhs": [_PP, _I] + [_I] * 6 + [_D] * 4 + [_P],
    # kernel E's continuity: pointer table (u, v, hFacW, hFacS, maskC, dyG,
    # dxG, recip_rA, EmPmR, drF, w, PmEpR), its length; nr, nyp, nxp;
    # stream
    "continuity": [_PP, _I] + [_I] * 3 + [_P],
    # kernel G's mom_ab_step: pointer table (u's, v's and w's terms, see
    # step_glue.cu:MomAbArgs), its length; nr, nyp, nxp, AB order (2, 3),
    # non-hydrostatic; abFac, ab0, ab1, ab2, deltaTMom, deltaTMom/nh_Am2;
    # stream
    "mom_ab_step": [_PP, _I] + [_I] * 5 + [_D] * 6 + [_P],
    # kernel G's mom_correction: pointer table (uStar, vStar, maskW, maskS,
    # phi_nh, etaN, Bo_surf, recip_dxC, recip_dyC, u, v), its length; nr,
    # nyp, nxp, non-hydrostatic; deltaTMom*psFac, psFac, nhFac, deltaTMom;
    # stream
    "mom_correction": [_PP, _I] + [_I] * 4 + [_D] * 4 + [_P],
    # kernel G's tracer_step: pointer table (gTr, tracer, gNm1, gNm2, the
    # surface forcing, recip_hFacC[ksurf0], recip_drF, tracer', gNm1'), its
    # length; nr, nyp, nxp, ksurf0, AB order (0: none, 2, 3); abFac, ab0,
    # ab1, ab2, deltaTTracer; stream
    "tracer_step": [_PP, _I] + [_I] * 5 + [_D] * 5 + [_P],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

launches: Counter = Counter()
_labels: list = []
_lib = None


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into one .so (once per content hash); return its
    path. One nvcc per source, all started together, then one link.
    verbose prints nvcc's output (ptxas register/spill report)."""
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
    nvcc = nvcc_path()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [os.path.basename(src) for src, proc in zip(sources, procs)
              if proc.returncode != 0]
    if verbose or failed:
        print("".join(logs), flush=True)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}")
    proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, flush=True)
        raise RuntimeError(f"nvcc link failed with exit code "
                           f"{proc.returncode}")
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


def check_fields(dtype: torch.dtype, shape, **tensors: torch.Tensor) -> None:
    """check_tensors, and every tensor of `shape`."""
    check_tensors(dtype, **tensors)
    for name, t in tensors.items():
        check_shape(name, t, shape)


def check_int32(name: str, t: torch.Tensor, shape) -> None:
    """Raise unless t is a contiguous int32 CUDA tensor of `shape` (a
    per-column level count)."""
    if not (t.is_cuda and t.dtype == torch.int32 and t.is_contiguous()):
        raise ValueError(f"{name}: need a contiguous int32 CUDA tensor")
    check_shape(name, t, shape)


def doubles(vals) -> ctypes.Array:
    """Host array of a kernel's float parameters (read as doubles and cast
    to the kernel's type on the device, as a Python number is)."""
    return (ctypes.c_double * len(vals))(*[float(x) for x in vals])


def pointer_table(tensors) -> ctypes.Array:
    """Host array of device pointers, in the order of the C struct it
    fills, a null pointer for None (the caller keeps the tensors alive
    across the launch)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


@contextlib.contextmanager
def counting_as(label: str):
    """Count the launches made inside the block also under
    "<kernel>:<label>"."""
    _labels.append(label)
    try:
        yield
    finally:
        _labels.pop()


class TwinVJP(torch.autograd.Function):
    """A kernel without a backward kernel, made differentiable: forward
    runs `launch(*tensors)` (the kernel's wrapper, a tuple of fresh
    outputs); backward re-runs `twin(*tensors)`, the kernel's plain PyTorch
    twin, under autograd and returns its VJP for the tensors that need one,
    so the gradient is the plain path's bit for bit. Only the inputs are
    saved (None entries allowed)."""

    @staticmethod
    def forward(ctx, launch, twin, *tensors):
        outs = launch(*tensors)
        if any(ctx.needs_input_grad[2:]):
            ctx.twin = twin
            ctx.save_for_backward(*tensors)
        return outs

    @staticmethod
    def backward(ctx, *bars):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
            outs = ctx.twin(*xs)
            pairs = [(o, b) for o, b in zip(outs, bars) if o.requires_grad]
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [b for _, b in pairs],
                allow_unused=True) if pairs else [None] * len(wrt))
        return (None, None, *[next(grads) if n else None for n in need])


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
    if _labels:
        launches[f"{kernel}:{_labels[-1]}"] += 1
