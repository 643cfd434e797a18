"""Host check of the forward kernels of B and C (kernels/csrc/
mom_fluxform_tile.cuh, gad_calc_rhs_tile.cuh), of D (phihyd_tile.cuh), of
G's mom_correction (mom_correction.cuh), of H-cg3d's two passes
(cg3d_tile.cuh) and of H-seaice EVP's seaice_evp_uv (seaice_evp_uv.cuh):
their sources built by g++
against the mock CUDA runtime of tests/host_cuda, each launch run with one
thread per CUDA thread and a barrier for __syncthreads, and held bit for
bit against the plain twins on the CPU. The grid is random, 20 x 12 x 4 in
float64 (and float32) with halos of 2, with land, partial cells and every
metric distinct, so that a wrong neighbour or a wrong order of operations
shows; its tiles of 32 x 4 columns are ragged in x, so a grid of 40 x 10
runs too, whose first tile has an eastern neighbour and whose last row of
tiles is ragged in y. Every interior output of B and C must equal the
twin's, every halo output must be 0; D and mom_correction write every
padded cell, each equal to the twin's, also on grids whose padded rows are
not a multiple of 16 bytes (mom_correction's scalar path) and whose levels
are not a multiple of mom_correction's chunk. H-cg3d's passes write the
interior and leave every halo cell as it was; their dot products, reduced
through common.cuh:grid_reduce on the mock's sequential atomicAdd, and
`ctrl` equal the twins' too, with the iteration going on, stopping at the
cap and at the tolerance, and frozen. seaice_evp_uv writes every padded
cell of u, v and sigma12 (and of dwatn and the divergence on the last
subcycle), each equal to the twin's, in every variant of its template
flags, on the ice-gyre's walled grid at the same two sizes. W
(calc_gw_tile.cuh) and G9's ggl90_col (ggl90_col.cuh) write every padded
cell, each equal to the twin's, in every variant of their flags and at
2-12 levels (ggl90_col also at 70, above the 64 levels it once took).
The step glue's backward kernels F', D', E', G', L' and R' write every
padded cell, each equal to its plain VJP's, and the 16x16x4 gyre's
gradient runs through all nine on the mock (their forward kernels
replaced by their twins) against the plain path. TH (thsice.cuh) writes
every padded cell of its 13 outputs, each equal to the twin's
(model/thsice.py:ThSIce.step) under each of THSICE_VARIANTS. The sea ice's
advection with the ice tracers (seaice_advect.cuh), the legacy
advection LA (seaice_advect_legacy.cuh) and seaice_thermo with its tracer
variant TP (seaice_thermo.cuh) write every padded cell, each equal to the
twin's (model/seaice.py:advdiff and thermo), with and without ice tracers
and diffusion, under the legacy schemes with and without DIFF1."""

import ctypes
import ctypes.util
import dataclasses
import importlib.util
import math
import os
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.model import calc_gw, gad, ggl90, gmredi, phihyd, step
from mitgcm_tpu_torch.model import mom_fluxform as mom
from mitgcm_tpu_torch.model import mom_vecinv as vecinv
from mitgcm_tpu_torch.model import seaice, seaice_kernels, som
from mitgcm_tpu_torch.solver import cg3d
from mitgcm_tpu_torch.utils import synthetic

NR, OL = 4, 2
SIZES = ((12, 20), (10, 40))    # (ny, nx)
HERE = os.path.dirname(os.path.abspath(__file__))
MOCK = os.path.join(HERE, "host_cuda")
CSRC = os.path.join(HERE, os.pardir, "mitgcm_tpu_torch", "kernels", "csrc")
DTYPES = {"f64": torch.float64, "f32": torch.float32}
SUFFIX = {t: s for s, t in DTYPES.items()}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PP = ctypes.POINTER(ctypes.c_void_p)
SIGNATURES = {
    "host_mom_fluxform": [_PP, _I] + [_I] * 7 + [_D] * 5,
    "host_mom_fluxform_adj": [_PP, _I] + [_I] * 5 + [_D] * 4,
    "host_gad_calc_rhs_c2": [_PP, _I] + [_I] * 5 + [_D] * 2
    + [_I, _I, _P, _PP, _I, _D, _D],
    "host_phihyd": [_P] * 9 + [_I] * 3 + [_D] * 2 + [_I],
    "host_mom_correction": [_PP, _I] + [_I] * 4 + [_D] * 4 + [_I],
    "host_cg3d_s_stencil_dot": [_PP, _I] + [_I] * 5,
    "host_cg3d_xr_precond": [_PP, _I] + [_I] * 7 + [ctypes.c_longlong],
    "host_seaice_evp_uv": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 6,
    # the direction (0 X, 1 Y, 2 R), then the entry points' arguments but
    # the stream
    "host_mom_vecinv": [_PP, _I] + [_I] * 9 + [_D] * 4,
    "host_gad_multidim": [_I, _PP, _I, _P, _P, _P] + [_I] * 4 + [_D] * 2,
    "host_gad_os7mp": [_I, _PP, _I, _P, _P, _P] + [_I] * 4 + [_D] * 2,
    "host_gad_ppm": [_I, _PP, _I, _P, _P, _P] + [_I] * 4 + [_D] * 2,
    "host_som": [_I, _PP, _I] + [_P] * 8 + [_I] * 4 + [_D],
    "host_calc_gw": [_PP, _I] + [_I] * 4 + [_D] * 3,
    "host_ggl90_col": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 8 + [ctypes.c_longlong],
    "host_kappa_uv": [_PP, _I] + [_I] * 4 + [_D],
    "host_kappa_ts": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 6,
    "host_adv_flow": [_PP, _I] + [_I] * 3,
    "host_eos_find_rho": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 5,
    "host_eos_sigma_r": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 5,
    # the last glue: E's cg2d_rhs, G's mom_ab_step, N1, N2's three
    # launches, Q, S1 and S2, with their entry points' arguments but the
    # stream
    "host_cg2d_rhs": [_PP, _I] + [_I] * 6 + [_D] * 4,
    "host_mom_ab_step": [_PP, _I] + [_I] * 5 + [_D] * 6,
    "host_pre_cg3d": [_PP, _I] + [_I] * 3 + [_D] * 4,
    "host_cg3d_setup_scale": [_PP, _I] + [_I] * 4,
    "host_cg3d_setup_fill": [_PP, _I] + [_I] * 4,
    "host_surface_forcing": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 3,
    "host_seaice_dynforcing": [_PP, _I, ctypes.POINTER(ctypes.c_double),
                               _I] + [_I] * 3,
    "host_seaice_ocean_stress": [_PP, _I, ctypes.POINTER(ctypes.c_double),
                                 _I] + [_I] * 4,
    # X, Y and B's and V's dissipation variants, with their entry points'
    # arguments but the stream
    "host_mom_calc_visc": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 7,
    "host_mom_del2uv": [_PP, _I] + [_I] * 4 + [_D],
    "host_mom_fluxform_visc": [_PP, _I] + [_I] * 7 + [_D] * 5
    + [_PP, _I, ctypes.POINTER(ctypes.c_double), _I, _I, _I],
    "host_mom_vecinv_visc": [_PP, _I] + [_I] * 9 + [_D] * 4
    + [_PP, _I, ctypes.POINTER(ctypes.c_double), _I, _I, _I],
    # U and Z, with their entry points' arguments but the stream
    "host_vertmix_calc": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 7,
    "host_opps_col": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 6,
    # CD, SH-uv and SH-ts, with their entry points' arguments but the
    # stream
    "host_cd_scheme": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 3,
    "host_shap_uv": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 10,
    "host_shap_ts": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 10,
    # TH, with its entry point's arguments but the stream
    "host_thsice_step": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 5,
    # the sea ice's advection (with its tracers), LA, seaice_thermo and
    # TP: their entry points' arguments but the stream
    "host_seaice_advect_x": [_PP, _I, _P, _P, _P] + [_I] * 6 + [_D],
    "host_seaice_advect_y": [_PP, _I, _P, _P, _P, _P] + [_I] * 6
    + [_D] * 5,
    "host_seaice_advect_legacy": [_PP, _I, ctypes.POINTER(ctypes.c_double),
                                  _I] + [_I] * 4,
    "host_seaice_thermo": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I]
    + [_I] * 5,
    "host_seaice_thermo_tr": [_PP, _I, ctypes.POINTER(ctypes.c_double), _I,
                              ctypes.POINTER(ctypes.c_double), _I, _P, _P]
    + [_I] * 5,
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the host check needs a C++20 compiler")
    so = str(tmp_path_factory.mktemp("host_kernels") / "host_kernels.so")
    # no contraction into fused multiply-adds, as nvcc's --fmad=false
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", MOCK, "-I", CSRC, "-o", so,
                    os.path.join(MOCK, "host_kernels.cpp")], check=True,
                   timeout=300)
    lib = ctypes.CDLL(so)
    for name, argtypes in SIGNATURES.items():
        for suffix in DTYPES:
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def config_ns(**settings):
    """A stand-in configuration: Config's defaults (the switches that the
    momentum twins read, variable and biharmonic viscosity and the drags
    off, no-slip bottom; viscA4D and viscA4Z as finalize derives them from
    viscA4 0) with `settings`."""
    from mitgcm_tpu_torch.core.config import Config

    base = {f.name: f.default for f in dataclasses.fields(Config)
            if f.default is not dataclasses.MISSING}
    return SimpleNamespace(**{**base, "viscA4D": 0.0, "viscA4Z": 0.0,
                              **settings})


def table(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


class Fields:
    """A random padded grid and random inputs, numpy-seeded."""

    def __init__(self, dtype, seed, ny, nx, nr=NR, ol=OL):
        self.rng = np.random.default_rng(seed)
        self.dtype = dtype
        s3 = (nr, ny + 2 * ol, nx + 2 * ol)
        s2 = s3[1:]
        self.s3 = s3
        g = {}
        for name in ("maskC", "maskW", "maskS"):
            g[name] = self.mask(s3, 0.8)
        for c in "CWS":
            h = g[f"mask{c}"] * self.uniform(s3, 0.2, 1.0)
            g[f"hFac{c}"] = h
            g[f"recip_hFac{c}"] = torch.where(h > 0, 1.0 / h, 0.0)
        for name in ("dxF", "dyF", "dxG", "dyG", "dxV", "dyU", "dxC", "dyC",
                     "rA", "rAw", "rAs"):
            g[name] = self.uniform(s2, 0.5, 2.0)
            g[f"recip_{name}"] = 1.0 / g[name]
        for name in ("cosFacU", "cosFacV", "angleCosC"):
            g[name] = self.uniform(s2, 0.3, 1.0)
        g["fCori"] = self.uniform(s2, -1.5, 1.5)
        g["fCoriCos"] = self.uniform(s2, -1.5, 1.5)
        g["maskInC"] = self.mask(s2, 0.9)
        g["drF"] = self.uniform((nr,), 5.0, 50.0)
        g["recip_drF"] = 1.0 / g["drF"]
        g["drC"] = self.uniform((nr + 1,), 5.0, 50.0)
        g["recip_drC"] = 1.0 / g["drC"]
        # last, so that the fields above stay what they were
        g["maskInW"] = self.mask(s2, 0.9)
        g["maskInS"] = self.mask(s2, 0.9)
        self.grid = SimpleNamespace(**g)

    def tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype)

    def uniform(self, shape, lo, hi):
        return self.tensor(self.rng.uniform(lo, hi, shape))

    def normal(self, shape, scale=1.0):
        return self.tensor(scale * self.rng.standard_normal(shape))

    def mask(self, shape, wet):
        return self.tensor(self.rng.uniform(size=shape) < wet)


def check(got, want, label):
    """Equal on the interior, zero on the halo."""
    inner = (..., slice(OL, -OL), slice(OL, -OL))
    assert torch.equal(got[inner], want[inner]), (
        f"{label}: interior max abs diff "
        f"{float((got[inner] - want[inner]).abs().max()):.3e}")
    halo = got.clone()
    halo[inner] = 0.0
    assert not bool(halo.isnan().any()) and float(halo.abs().max()) == 0.0, (
        f"{label}: a halo output is not 0")


# (no-slip sides, the 3-D Coriolis term): the gyres run the first, the
# nh-convection box the last
@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("no_slip,cori3d", [(True, False), (True, True),
                                            (False, False), (False, True)])
def test_mom_fluxform_tile(lib, ny, nx, dtype, no_slip, cori3d):
    f = Fields(DTYPES[dtype], 10 + 2 * no_slip + cori3d, ny, nx)
    cfg = config_ns(nr=NR, oly=OL, olx=OL, rkSign=-1.0,
                    gravitySign=-1.0, viscAhD=430.0, viscAhZ=270.0,
                    sideDragFactor=2.0, no_slip_sides=no_slip,
                    select3dCoriScheme=int(cori3d))
    g = f.grid
    u = f.normal(f.s3, 0.1) * g.maskW
    v = f.normal(f.s3, 0.1) * g.maskS
    w = f.normal(f.s3, 1e-2) * g.maskC
    kshape = (NR + 1,) + f.s3[1:]
    kRU, kRV = f.normal(kshape, 1e-2).abs(), f.normal(kshape, 1e-2).abs()
    want = mom._mom_fluxform_plain(cfg, g, u, v, w, kRU, kRV)
    outs = [torch.full(f.s3, float("nan"), dtype=f.dtype) for _ in range(4)]
    ins = list(mom._kernel_inputs(g, u, v, w, kRU, kRV).values())
    tab = table(ins + outs)
    err = getattr(lib, f"host_mom_fluxform_{dtype}")(
        tab, len(tab), NR, ny, nx, OL, OL, int(no_slip), int(cori3d),
        cfg.viscAhD, cfg.viscAhZ, cfg.sideDragFactor, cfg.rkSign,
        cfg.gravitySign)
    assert err == 0
    for name, got in zip(mom.MomTend._fields, outs):
        check(got, getattr(want, name), name)


# Kernel B' (mom_fluxform_adj_tile.cuh) against autograd through B's plain
# twin (mom_fluxform_vjp_plain) on every padded cell, to chip_smoke.py's
# tolerance for it (TOL: a relative error of 1e-12 in float64, 1e-5 in
# float32), with the cotangents of the four tendencies seeded on interior
# cells only, as B's halo outputs are constant zeros: every padded cell
# written (NaN before), nonzero only up to one cell outside the interior.
# The gyre's variant (no-slip sides, no 3-D Coriolis), the only one the
# adjoint allows.
ADJ_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def close(got, want, label):
    """Within ADJ_TOL of the twin relative to its largest magnitude, the
    same cells non-finite."""
    assert torch.equal(got.isfinite(), want.isfinite()), (
        f"{label}: non-finite cells differ")
    diff = float((got - want).nan_to_num(0.0, 0.0, 0.0).abs().max())
    scale = float(want.nan_to_num(0.0, 0.0, 0.0).abs().max())
    assert diff <= ADJ_TOL[want.dtype] * scale, (
        f"{label}: max abs diff {diff:.3e} against a scale of {scale:.3e}")


def mom_adj_case(f):
    """As mom_case, for kernel B' (its outputs u_bar, v_bar, w_bar)."""
    ny, nx = f.s3[1] - 2 * OL, f.s3[2] - 2 * OL
    cfg = config_ns(nr=NR, oly=OL, olx=OL, rkSign=-1.0,
                    gravitySign=-1.0, viscAhD=430.0, viscAhZ=270.0,
                    sideDragFactor=2.0, no_slip_sides=True,
                    select3dCoriScheme=0)
    g = f.grid
    u = f.normal(f.s3, 0.1) * g.maskW
    v = f.normal(f.s3, 0.1) * g.maskS
    w = f.normal(f.s3, 1e-2) * g.maskC
    kshape = (NR + 1,) + f.s3[1:]
    kRU, kRV = f.normal(kshape, 1e-2).abs(), f.normal(kshape, 1e-2).abs()
    inner = torch.zeros(f.s3, dtype=f.dtype)
    inner[:, OL:-OL, OL:-OL] = 1.0
    bars = [f.normal(f.s3) * inner for _ in range(4)]
    want = list(mom.mom_fluxform_vjp_plain(cfg, g, u, v, w, kRU, kRV, bars))
    named = dict(mom._kernel_inputs(g, u, v, w, kRU, kRV),
                 **{n + "_bar": t for n, t in zip(mom.MomTend._fields, bars)})
    args = (NR, ny, nx, OL, OL)
    lib_fn = f"host_mom_fluxform_adj_{SUFFIX[f.dtype]}"

    def run(lib, ins):
        outs = [torch.full(f.s3, float("nan"), dtype=f.dtype)
                for _ in range(3)]
        tab = table(list(ins.values()) + outs)
        assert getattr(lib, lib_fn)(
            tab, len(tab), *args, cfg.viscAhD, cfg.viscAhZ,
            cfg.sideDragFactor, cfg.rkSign) == 0
        return outs

    return want, named, args, run


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mom_fluxform_adj_tile(lib, ny, nx, dtype):
    f = Fields(DTYPES[dtype], 60 + nx, ny, nx)
    want, named, _, run = mom_adj_case(f)
    outs = run(lib, named)
    ring = (..., slice(OL - 1, -OL + 1), slice(OL - 1, -OL + 1))
    for name, got, wanted in zip(("u_bar", "v_bar", "w_bar"), outs, want):
        close(got, wanted, name)
        beyond = got.clone()
        beyond[ring] = 0.0
        assert float(beyond.abs().max()) == 0.0, (
            f"{name}: nonzero more than one cell outside the interior")
        assert float(got[ring].abs().max()) > 0.0


def test_mom_fluxform_adj_refuses(lib):
    """A table of the wrong length, no halo, no level
    (cudaErrorInvalidValue, 1)."""
    f = Fields(torch.float64, 75, *SIZES[0])
    _, named, (nr, ny, nx, oly, olx), _ = mom_adj_case(f)
    outs = [torch.empty(f.s3, dtype=f.dtype) for _ in range(3)]
    tab = table(list(named.values()) + outs)
    for n, shape in ((len(tab) - 1, (nr, ny, nx, oly, olx)),
                     (len(tab), (nr, ny, nx, 0, olx)),
                     (len(tab), (nr, ny, nx, oly, 0)),
                     (len(tab), (0, ny, nx, oly, olx))):
        assert lib.host_mom_fluxform_adj_f64(tab, n, *shape, 430.0, 270.0,
                                             2.0, -1.0) == 1


# chip_smoke.py's footprint of B' (mom_adj_footprint: B's reach, the
# cotangents on the interior) holds every cell read and no cell unread
def test_mom_fluxform_adj_footprint(lib):
    f = Fields(torch.float64, 85, *FOOTPRINT_SIZE)
    smoke = chip_smoke()
    check_footprint(lib, mom_adj_case(f), smoke.mom_adj_footprint,
                    smoke.MOM_RINGS, same_as=close)


# GM's tensor: none, a constant Kux/Kvy ("const"), a 3-D one ("3d"), each
# with Kuz/Kvz ("+z")
GM_CASES = (None, "const", "3d", "const+z", "3d+z")


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gm", GM_CASES)
@pytest.mark.parametrize("implicit,advection,with_df",
                         [(False, True, False), (True, True, True),
                          (False, False, True), (True, False, False)])
def test_calc_rhs_tile(lib, ny, nx, dtype, gm, implicit, advection,
                      with_df):
    f = Fields(DTYPES[dtype], 40 + GM_CASES.index(gm), ny, nx)
    cfg = SimpleNamespace(nr=NR, oly=OL, olx=OL, rkSign=-1.0)
    g = f.grid
    rT = f.normal(f.s3, 5.0)
    flow = gad.AdvFlow(
        uTrans=f.normal(f.s3, 10.0), vTrans=f.normal(f.s3, 10.0), rTrans=rT,
        rTransKp=torch.cat([rT[1:], torch.zeros_like(rT[:1])]),
        maskUp=f.mask(f.s3, 0.8), xA=f.uniform(f.s3, 1.0, 3.0),
        yA=f.uniform(f.s3, 1.0, 3.0))
    tracer = (15.0 + f.normal(f.s3, 2.0)) * g.maskC
    kappaR = f.normal(f.s3, 1e-2).abs()
    df = f.normal(f.s3, 1e-1) * g.maskC if with_df else None
    tensor = None
    if gm is not None:
        K3 = gm.startswith("3d")
        tensor = gmredi.GMTensor(
            Kux=f.uniform(f.s3, 0.5, 2.0) if K3 else f.tensor(1.3),
            Kvy=f.uniform(f.s3, 0.5, 2.0) if K3 else f.tensor(0.7),
            Kwx=f.normal(f.s3, 0.1), Kwy=f.normal(f.s3, 0.1),
            Kwz=f.normal(f.s3, 0.1).abs(),
            Kuz=f.normal(f.s3, 0.1) if gm.endswith("+z") else None,
            Kvz=f.normal(f.s3, 0.1) if gm.endswith("+z") else None)
    diffKh = 0.37
    want = gad._calc_rhs_plain(cfg, g, flow, tracer, kappaR, diffKh,
                               implicit, df, advection, tensor)
    got = torch.full(f.s3, float("nan"), dtype=f.dtype)
    ins = list(gad._kernel_inputs(g, tracer, flow.uTrans, flow.vTrans, rT,
                                  flow.xA, flow.yA, flow.maskUp,
                                  kappaR).values())
    tab = table(ins + [got])
    gm_tab, scalars = None, (0.0, 0.0)
    if tensor is not None:
        scalar = tensor.Kux.dim() == 0
        gm_tab = table([None if scalar else tensor.Kux,
                        None if scalar else tensor.Kvy, tensor.Kwx,
                        tensor.Kwy, tensor.Kuz, tensor.Kvz, g.maskW, g.maskS])
        if scalar:
            scalars = (float(tensor.Kux), float(tensor.Kvy))
    err = getattr(lib, f"host_gad_calc_rhs_c2_{dtype}")(
        tab, len(tab), NR, ny, nx, OL, OL, diffKh, cfg.rkSign, int(implicit),
        int(advection), None if df is None else df.data_ptr(), gm_tab,
        0 if gm_tab is None else len(gm_tab), *scalars)
    assert err == 0
    check(got, want, "gTr")


# the launches' argument checks (cudaErrorInvalidValue, 1): a table of the
# wrong length, GM's table without a field it needs or with half of a pair
REFUSALS = {
    "mom table length": ("mom", -1, None),
    "gad table length": ("gad", -1, None),
    "gm table length": ("gad", 0, ("len",)),
    "gm without Kwx": ("gad", 0, ("Kwx",)),
    "gm without maskS": ("gad", 0, ("maskS",)),
    "gm Kux without Kvy": ("gad", 0, ("Kvy",)),
    "gm Kuz without Kvz": ("gad", 0, ("Kvz",)),
}


@pytest.mark.parametrize("case", REFUSALS)
def test_tile_launch_refuses(lib, case):
    kernel, extra, drop = REFUSALS[case]
    f = Fields(torch.float64, 70, *SIZES[0])
    ny, nx = SIZES[0]
    g = f.grid
    field = f.normal(f.s3)
    if kernel == "mom":
        ins = list(mom._kernel_inputs(g, field, field, field,
                                      f.normal((NR + 1,) + f.s3[1:]),
                                      f.normal((NR + 1,) + f.s3[1:])).values())
        tab = table(ins + [torch.empty_like(field) for _ in range(4)])
        err = lib.host_mom_fluxform_f64(
            tab, len(tab) + extra, NR, ny, nx, OL, OL, 1, 0, 1.0, 1.0, 2.0,
            -1.0, -1.0)
        assert err == 1
        return
    ins = list(gad._kernel_inputs(g, field, field, field, field, field,
                                  field, field, field).values())
    tab = table(ins + [torch.empty_like(field)])
    gm_tab, n_gm = None, 0
    if drop is not None:
        fields = dict(Kux=field, Kvy=field, Kwx=field, Kwy=field, Kuz=field,
                      Kvz=field, maskW=g.maskW, maskS=g.maskS)
        for name in drop:
            fields.pop(name, None)
        gm_tab = table([fields.get(n) for n in (
            "Kux", "Kvy", "Kwx", "Kwy", "Kuz", "Kvz", "maskW", "maskS")])
        n_gm = len(gm_tab) - ("len" in drop)
    err = lib.host_gad_calc_rhs_c2_f64(
        tab, len(tab) + extra, NR, ny, nx, OL, OL, 0.37, -1.0, 0, 1, None,
        gm_tab, n_gm, 0.0, 0.0)
    assert err == 1


def chip_smoke():
    """The chip script as a module (its footprints of B and C's inputs)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, os.pardir, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# The footprints that chip_smoke.py's bounds of B and C count: they hold
# every cell that the kernels read (with every other input cell NaN, the
# outputs still equal the twin's on the whole inputs), and no more than
# the function reads (scaling any ring side, the interior, or the first or
# last level counted of any input, or making it NaN, changes the outputs).
# One tile row, so that the many launches stay quick.
FOOTPRINT_SIZE = (4, 20)
def mom_case(f, no_slip, cori3d):
    """(twin's outputs, inputs by name, launch arguments, run(inputs) ->
    outputs) of kernel B on f's grid."""
    ny, nx = f.s3[1] - 2 * OL, f.s3[2] - 2 * OL
    cfg = config_ns(nr=NR, oly=OL, olx=OL, rkSign=-1.0,
                    gravitySign=-1.0, viscAhD=430.0, viscAhZ=270.0,
                    sideDragFactor=2.0, no_slip_sides=no_slip,
                    select3dCoriScheme=int(cori3d))
    g = f.grid
    u = f.normal(f.s3, 0.1) * g.maskW
    v = f.normal(f.s3, 0.1) * g.maskS
    w = f.normal(f.s3, 1e-2) * g.maskC
    kshape = (NR + 1,) + f.s3[1:]
    kRU, kRV = f.normal(kshape, 1e-2).abs(), f.normal(kshape, 1e-2).abs()
    want = list(mom._mom_fluxform_plain(cfg, g, u, v, w, kRU, kRV))
    args = (NR, ny, nx, OL, OL, int(no_slip), int(cori3d))

    def run(lib, ins):
        outs = [torch.full(f.s3, float("nan"), dtype=f.dtype)
                for _ in range(4)]
        tab = table(list(ins.values()) + outs)
        assert lib.host_mom_fluxform_f64(
            tab, len(tab), *args, cfg.viscAhD, cfg.viscAhZ,
            cfg.sideDragFactor, cfg.rkSign, cfg.gravitySign) == 0
        return outs

    return want, mom._kernel_inputs(g, u, v, w, kRU, kRV), args, run


def gad_case(f, gm, implicit, advection, with_df):
    """As mom_case, for kernel C (gm: a GM_CASES entry)."""
    ny, nx = f.s3[1] - 2 * OL, f.s3[2] - 2 * OL
    cfg = SimpleNamespace(nr=NR, oly=OL, olx=OL, rkSign=-1.0)
    g = f.grid
    rT = f.normal(f.s3, 5.0)
    flow = gad.AdvFlow(
        uTrans=f.normal(f.s3, 10.0), vTrans=f.normal(f.s3, 10.0), rTrans=rT,
        rTransKp=torch.cat([rT[1:], torch.zeros_like(rT[:1])]),
        maskUp=f.mask(f.s3, 0.8), xA=f.uniform(f.s3, 1.0, 3.0),
        yA=f.uniform(f.s3, 1.0, 3.0))
    tracer = (15.0 + f.normal(f.s3, 2.0)) * g.maskC
    kappaR = f.normal(f.s3, 1e-2).abs()
    df = f.normal(f.s3, 1e-1) * g.maskC if with_df else None
    tensor, gm_fields, scalars = None, {}, (0.0, 0.0)
    if gm is not None:
        K3 = gm.startswith("3d")
        tensor = gmredi.GMTensor(
            Kux=f.uniform(f.s3, 0.5, 2.0) if K3 else f.tensor(1.3),
            Kvy=f.uniform(f.s3, 0.5, 2.0) if K3 else f.tensor(0.7),
            Kwx=f.normal(f.s3, 0.1), Kwy=f.normal(f.s3, 0.1),
            Kwz=f.normal(f.s3, 0.1).abs(),
            Kuz=f.normal(f.s3, 0.1) if gm.endswith("+z") else None,
            Kvz=f.normal(f.s3, 0.1) if gm.endswith("+z") else None)
        gm_fields = dict(Kwx=tensor.Kwx, Kwy=tensor.Kwy, maskW=g.maskW,
                         maskS=g.maskS)
        if K3:
            gm_fields.update(Kux=tensor.Kux, Kvy=tensor.Kvy)
        else:
            scalars = (float(tensor.Kux), float(tensor.Kvy))
        if tensor.Kuz is not None:
            gm_fields.update(Kuz=tensor.Kuz, Kvz=tensor.Kvz)
    diffKh = 0.37
    want = [gad._calc_rhs_plain(cfg, g, flow, tracer, kappaR, diffKh,
                                implicit, df, advection, tensor)]
    main = gad._kernel_inputs(g, tracer, flow.uTrans, flow.vTrans, rT,
                              flow.xA, flow.yA, flow.maskUp, kappaR)
    named = dict(main, **gm_fields, **({} if df is None else {"df": df}))
    args = (NR, ny, nx, OL, OL, diffKh, cfg.rkSign, int(implicit),
            int(advection))

    def run(lib, ins):
        got = torch.full(f.s3, float("nan"), dtype=f.dtype)
        tab = table([ins[n] for n in main] + [got])
        gm_tab = None
        if gm is not None:
            gm_tab = table([ins.get(n) for n in (
                "Kux", "Kvy", "Kwx", "Kwy", "Kuz", "Kvz", "maskW", "maskS")])
        assert lib.host_gad_calc_rhs_c2_f64(
            tab, len(tab), *args,
            None if df is None else ins["df"].data_ptr(), gm_tab,
            0 if gm_tab is None else len(gm_tab), *scalars) == 0
        return [got]

    return want, named, args, run


def poisoned(named, footprint, args):
    """Copies of the inputs, NaN but on the cells that `footprint` says
    the launch reads (an integer input, whose every cell a footprint
    holds, as it is)."""
    nan = {n: torch.full_like(t, float("nan")) if t.is_floating_point()
           else t.clone() for n, t in named.items()}
    want = footprint(named, args)
    for n, view in footprint(nan, args).items():
        view.copy_(want[n])
    return nan


def parts(view, ring):
    """The parts of a footprint's view that the function must read: each
    ring side (south, north, west, east), the interior, and for a 3-D
    field its first and last level."""
    if view.dim() == 1:
        return {"first": view[:1], "last": view[-1:]}
    s, n, w, e = ring or (0, 0, 0, 0)
    rows, cols = view.shape[-2], view.shape[-1]
    out = {"interior": view[..., s:rows - n, w:cols - e]}
    for side, on, part in (("south", s, view[..., :1, :]),
                           ("north", n, view[..., -1:, :]),
                           ("west", w, view[..., :, :1]),
                           ("east", e, view[..., :, -1:])):
        if on:
            out[side] = part
    if view.dim() == 3:
        out.update(first=view[:1], last=view[-1:])
    return out


def identical(a, b):
    """Equal values and non-finite values in the same cells (NaN is NaN)."""
    return (all(torch.equal(test(a), test(b)) for test in (
        torch.isnan, torch.isposinf, torch.isneginf))
        and torch.equal(a.nan_to_num(0.0, 0.0, 0.0),
                        b.nan_to_num(0.0, 0.0, 0.0)))


def check_footprint(lib, case, footprint, rings, same_as=check):
    want, named, args, run = case
    for got, wanted in zip(run(lib, poisoned(named, footprint, args)), want):
        same_as(got, wanted, "an output, the inputs NaN off the footprint")
    base = run(lib, named)
    unread = []
    for name in footprint(named, args):
        copies = {n: t.clone() for n, t in named.items()}
        view = footprint(copies, args)[name]
        for label, part in parts(view, rings.get(name)).items():
            saved = part.clone()
            if not part.is_floating_point():    # a level count, one less
                part.sub_(1).clamp_(min=0)
            else:
                part.mul_(1.5).add_(0.25)
            same = all(identical(a, b) for a, b in zip(run(lib, copies),
                                                       base))
            if same and part.is_floating_point():
                # x * 0 hides a change but keeps a NaN
                part.fill_(float("nan"))
                same = all(torch.equal(a.isnan(), b.isnan())
                           for a, b in zip(run(lib, copies), base))
            if same:
                unread.append(f"{name} {label}")
            part.copy_(saved)
    assert not unread, f"counted but never read: {unread}"


@pytest.mark.parametrize("no_slip,cori3d", [(True, False), (True, True),
                                            (False, False), (False, True)])
def test_mom_fluxform_footprint(lib, no_slip, cori3d):
    f = Fields(torch.float64, 80 + 2 * no_slip + cori3d, *FOOTPRINT_SIZE)
    smoke = chip_smoke()
    check_footprint(lib, mom_case(f, no_slip, cori3d), smoke.mom_footprint,
                    smoke.MOM_RINGS)


@pytest.mark.parametrize("gm", GM_CASES)
@pytest.mark.parametrize("implicit,advection,with_df",
                         [(False, True, False), (True, True, True),
                          (False, False, True), (True, False, False)])
def test_calc_rhs_footprint(lib, gm, implicit, advection, with_df):
    f = Fields(torch.float64, 90 + GM_CASES.index(gm), *FOOTPRINT_SIZE)
    smoke = chip_smoke()
    rings = dict(smoke.GAD_RINGS)
    if gm is None or not gm.endswith("+z"):
        rings.pop("maskC", None)
    else:
        rings["maskC"] = smoke.RING4
    check_footprint(lib, gad_case(f, gm, implicit, advection, with_df),
                    smoke.gad_footprint, rings)


# Kernel D and G's mom_correction, which write every padded cell: (nr, ny,
# nx). Padded rows of 25 cells are no multiple of 16 bytes, so
# mom_correction runs its scalar path there (its 16-byte path elsewhere);
# 11 levels are no multiple of its chunk of 8; the tiles of D are ragged.
GLUE_SHAPES = ((4, 12, 20), (4, 10, 40), (11, 9, 21), (11, 12, 20))


def check_whole(got, want, label):
    """Equal on every padded cell."""
    assert torch.equal(got, want), (
        f"{label}: max abs diff {float((got - want).abs().max()):.3e}")


def glue_fields(dtype, seed, nr, ny, nx):
    """Fields with the surface and level fields that D and mom_correction
    read too."""
    f = Fields(dtype, seed, ny, nx, nr)
    g = f.grid
    g.Bo_surf = f.uniform(f.s3[1:], 9.0, 10.0)
    g.rF = -f.uniform((nr + 1,), 0.0, 500.0)
    g.rC = -f.uniform((nr,), 0.0, 500.0)
    return f


def phihyd_case(f, min_blocks=0):
    """As mom_case, for kernel D."""
    nr, nyp, nxp = f.s3
    cfg = SimpleNamespace(nr=nr, gravity=9.81, rhoConst=1035.0)
    g = f.grid
    rho = f.normal(f.s3, 0.5) * g.maskC
    want = list(phihyd._phi_hyd_plain(cfg, g, rho))
    named = dict(rho=rho, drC=g.drC, rF=g.rF, rC=g.rC,
                 recip_dxC=g.recip_dxC, recip_dyC=g.recip_dyC)
    args = (nr, nyp, nxp)

    def run(lib, ins):
        outs = [torch.full(f.s3, float("nan"), dtype=f.dtype)
                for _ in range(3)]
        assert getattr(lib, f"host_phihyd_{SUFFIX[f.dtype]}")(
            *[t.data_ptr() for t in (*ins.values(), *outs)], *args,
            cfg.gravity, 1.0 / cfg.rhoConst, min_blocks) == 0
        return outs

    return want, named, args, run


# mom_correction's launch halves its chunk of levels while it would launch
# fewer blocks than it asks for: 0 gives the longest chunks (8 levels), a
# huge count one level a thread, as on every grid of these tests on the card
MIN_BLOCKS = {"chunks of 8": 0, "a level": 1 << 30}
# D's launch takes 16-byte columns where the rows allow them and the tiles
# would be at least as many as it asks for, else one column a thread
PHIHYD_MIN_BLOCKS = {"16-byte columns": 0, "a column": 1 << 30}


def mom_correction_case(f, nh, min_blocks=0):
    """As mom_case, for G's mom_correction (nh: with phi_nh)."""
    nr, nyp, nxp = f.s3
    cfg = SimpleNamespace(deltaTMom=600.0, implicSurfPress=0.7,
                          implicitNHPress=0.9)
    g = f.grid
    eta = f.normal(f.s3[1:], 0.1)
    uStar = f.normal(f.s3, 0.1)
    vStar = f.normal(f.s3, 0.1)
    phi_nh = f.normal(f.s3, 1.0) if nh else None
    want = list(step._mom_correction_plain(cfg, g, eta, uStar, vStar,
                                           phi_nh))
    named = dict(uStar=uStar, vStar=vStar, maskW=g.maskW, maskS=g.maskS,
                 **({"phi_nh": phi_nh} if nh else {}), etaN=eta,
                 Bo_surf=g.Bo_surf, recip_dxC=g.recip_dxC,
                 recip_dyC=g.recip_dyC)
    args = (nr, nyp, nxp, int(nh))
    psFac = cfg.implicSurfPress

    def run(lib, ins):
        outs = [torch.full(f.s3, float("nan"), dtype=f.dtype)
                for _ in range(2)]
        # the wrapper's table: phi_nh's slot holds uStar without the flag
        tab = table([ins[n] for n in ("uStar", "vStar", "maskW", "maskS")]
                    + [ins.get("phi_nh", ins["uStar"])]
                    + [ins[n] for n in ("etaN", "Bo_surf", "recip_dxC",
                                        "recip_dyC")] + outs)
        assert getattr(lib, f"host_mom_correction_{SUFFIX[f.dtype]}")(
            tab, len(tab), *args, cfg.deltaTMom * psFac, psFac,
            cfg.implicitNHPress, cfg.deltaTMom, min_blocks) == 0
        return outs

    return want, named, args, run


@pytest.mark.parametrize("nr,ny,nx", GLUE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("columns", PHIHYD_MIN_BLOCKS)
def test_phihyd_tile(lib, nr, ny, nx, dtype, columns):
    f = glue_fields(DTYPES[dtype], 100 + nr + nx, nr, ny, nx)
    want, named, _, run = phihyd_case(f, PHIHYD_MIN_BLOCKS[columns])
    for name, got, wanted in zip(("phiHydC", "dPhiHydX", "dPhiHydY"),
                                 run(lib, named), want):
        check_whole(got, wanted, name)


@pytest.mark.parametrize("nr,ny,nx", GLUE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nh", (False, True))
@pytest.mark.parametrize("chunks", MIN_BLOCKS)
def test_mom_correction(lib, nr, ny, nx, dtype, nh, chunks):
    f = glue_fields(DTYPES[dtype], 120 + nr + nx + nh, nr, ny, nx)
    want, named, _, run = mom_correction_case(f, nh, MIN_BLOCKS[chunks])
    for name, got, wanted in zip("uv", run(lib, named), want):
        check_whole(got, wanted, name)


def test_glue_launch_refuses(lib):
    """mom_correction's table of the wrong length and D without levels
    (cudaErrorInvalidValue, 1)."""
    f = glue_fields(torch.float64, 140, *GLUE_SHAPES[0])
    _, named, args, _ = mom_correction_case(f, False)
    tab = table(list(named.values()) + [None] * 3)
    assert lib.host_mom_correction_f64(tab, len(tab) - 1, *args, 1.0, 1.0,
                                       1.0, 1.0, 0) == 1
    _, named, (nr, nyp, nxp), _ = phihyd_case(f)
    out = torch.empty(f.s3, dtype=f.dtype)
    assert lib.host_phihyd_f64(
        *[t.data_ptr() for t in (*named.values(), out, out, out)], 0, nyp,
        nxp, 9.81, 1.0 / 1035.0, 0) == 1


# chip_smoke.py's footprints of D and mom_correction (every padded cell of
# their 3-D and 2-D inputs, drC between the ends, rF and rC at them,
# phi_nh under its flag) hold every cell read and no cell unread
@pytest.mark.parametrize("kernel", ("phihyd", "mom_correction",
                                    "mom_correction(non-hydrostatic)"))
def test_glue_footprint(lib, kernel):
    f = glue_fields(torch.float64, 150, *GLUE_SHAPES[0])
    smoke = chip_smoke()
    if kernel == "phihyd":
        case, footprint = phihyd_case(f), smoke.phihyd_footprint
    else:
        case = mom_correction_case(f, kernel.endswith(")"))
        footprint = smoke.mom_correction_footprint
    check_footprint(lib, case, footprint, {}, same_as=check_whole)


# Kernel H-cg3d's two passes on the ragged grids, with land (maskC 0), the
# operator's and the preconditioner's arrays random (their halos too: the
# passes read aW's eastern and aS's northern halo cells as stored) and the
# interior wrapped; outputs start random, so that a halo cell written shows
CG3D_NR = 5
# the ctrl word [done, iterations], the cap and the tolerance of a pass B
# launch: going on, stopping at the cap, at the tolerance, and frozen
CG3D_STOPS = {"go": ((0, 5), 1 << 30, 0.0), "cap": ((0, 6), 7, 0.0),
              "tolerance": ((0, 2), 1 << 30, 1e30),
              "frozen": ((1, 3), 1 << 30, 0.0)}
# the card's shared memory that pass B's launch is told: enough for its
# staging, or none (forward values through q and r)
CG3D_STAGING = {"staged": 1 << 30, "through q": 0}


def cg3d_inputs(f):
    """(op, fields by name) of H-cg3d on f's grid."""
    g = f.grid
    op = SimpleNamespace(aW=f.normal(f.s3), aS=f.normal(f.s3),
                         aV=f.normal(f.s3), aC=f.uniform(f.s3, -6.0, -2.0),
                         zMC=f.uniform(f.s3, 0.2, 1.0),
                         zML=f.normal(f.s3, 0.3), zMU=f.normal(f.s3, 0.3))
    fields = dict(x=f.normal(f.s3), r=f.normal(f.s3), q=f.normal(f.s3),
                  s=f.normal(f.s3), maskC=g.maskC)
    return op, fields


def cg3d_scalars(f, *vals):
    return [f.tensor(v) for v in vals]


def cg3d_partials(f, ny, nx):
    tiles = -(-ny // 8) * -(-nx // 32)
    return (torch.zeros(2 * tiles, dtype=f.dtype),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(2, dtype=f.dtype))


def s_stencil_case(f, ctrl=(0, 5)):
    """As mom_case, for H-cg3d's pass A (its 0-d outputs last)."""
    ny, nx = f.s3[1] - 2 * OL, f.s3[2] - 2 * OL
    op, fl = cg3d_inputs(f)
    eta_n, eta_nm1 = cg3d_scalars(f, 0.7, 1.3)
    init = [f.normal(f.s3), f.normal(f.s3), f.tensor(0.25)]
    named = dict(aW=op.aW, aS=op.aS, aV=op.aV, aC=op.aC, maskC=fl["maskC"],
                 q=fl["q"], s_in=fl["s"])
    args = (CG3D_NR, ny, nx, OL, OL)
    want = [t.clone() for t in init]
    cg3d.s_stencil_dot(op, fl["maskC"], fl["q"], fl["s"], want[0], want[1],
                       eta_n, eta_nm1, want[2],
                       torch.tensor(ctrl, dtype=torch.int32), OL, OL)

    def run(lib, ins):
        outs = [t.clone() for t in init]
        partials, counter, _ = cg3d_partials(f, ny, nx)
        word = torch.tensor(ctrl, dtype=torch.int32)
        tab = table([ins[n] for n in ("aW", "aS", "aV", "aC", "maskC", "q",
                                      "s_in")] + outs[:2]
                    + [eta_n, eta_nm1, outs[2], partials, counter, word])
        assert getattr(lib, f"host_cg3d_s_stencil_dot_{SUFFIX[f.dtype]}")(
            tab, len(tab), *args) == 0
        return outs

    return want, named, args, run


def xr_precond_case(f, stop="go", max_shared=1 << 30):
    """As mom_case, for H-cg3d's pass B (x, r, q, then dot(r, r), dot(q,
    r) and ctrl as floats)."""
    ny, nx = f.s3[1] - 2 * OL, f.s3[2] - 2 * OL
    op, fl = cg3d_inputs(f)
    (done, it), max_iters, tol = CG3D_STOPS[stop]
    num, den, tol_sq = cg3d_scalars(f, 0.7, 1.1, tol)
    qa = f.normal(f.s3)
    init = [fl["x"], fl["r"], f.normal(f.s3), f.tensor(0.25),
            f.tensor(0.5)]
    named = dict(x=fl["x"], r=fl["r"], s=fl["s"], qa=qa, maskC=fl["maskC"],
                 zMC=op.zMC, zML=op.zML, zMU=op.zMU)
    args = (CG3D_NR, ny, nx, OL, OL, max_iters, 1)
    want = [t.clone() for t in init]
    ctrl = torch.tensor([done, it], dtype=torch.int32)
    cg3d.xr_precond(op, fl["maskC"], want[0], want[1], fl["s"], qa, want[2],
                    num, den, want[3], want[4], ctrl, tol_sq, max_iters, True,
                    OL, OL)
    want.append(ctrl.to(f.dtype))

    def run(lib, ins):
        outs = [ins["x"].clone(), ins["r"].clone()] + [
            t.clone() for t in init[2:]]
        partials, counter, pair = cg3d_partials(f, ny, nx)
        ctrl = torch.tensor([done, it], dtype=torch.int32)
        tab = table(outs[:2] + [ins[n] for n in ("s", "qa", "maskC", "zMC",
                                                 "zML", "zMU")]
                    + [outs[2], num, den, outs[3], outs[4], partials, counter,
                       pair, ctrl, tol_sq])
        assert getattr(lib, f"host_cg3d_xr_precond_{SUFFIX[f.dtype]}")(
            tab, len(tab), *args, max_shared) == 0
        return outs + [ctrl.to(f.dtype)]

    return want, named, args, run


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("frozen", (False, True))
def test_cg3d_s_stencil_dot(lib, ny, nx, dtype, frozen):
    f = Fields(DTYPES[dtype], 160 + nx + frozen, ny, nx, CG3D_NR)
    want, named, _, run = s_stencil_case(f, (1, 3) if frozen else (0, 5))
    for name, got, wanted in zip(("s_out", "qa", "dot"), run(lib, named),
                                 want):
        check_whole(got, wanted, name)


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stop", CG3D_STOPS)
@pytest.mark.parametrize("staging", CG3D_STAGING)
def test_cg3d_xr_precond(lib, ny, nx, dtype, stop, staging):
    f = Fields(DTYPES[dtype], 170 + nx + len(stop), ny, nx, CG3D_NR)
    want, named, _, run = xr_precond_case(f, stop, CG3D_STAGING[staging])
    if stop == "frozen":
        assert want[-1].tolist() == [1.0, 3.0]
    else:
        assert want[-1][0] == (stop != "go")
    for name, got, wanted in zip(("x", "r", "q", "dot(r, r)", "dot(q, r)",
                                  "ctrl"), run(lib, named), want):
        check_whole(got, wanted, name)


def check_interior(got, want, label):
    """Equal on the interior (a 0-d or 1-d output whole): the footprint
    checks leave NaN in halo cells that the passes keep as they found
    them."""
    if got.dim() == 3:
        inner = (..., slice(OL, -OL), slice(OL, -OL))
        got, want = got[inner], want[inner]
    check_whole(got, want, label)


# chip_smoke.py's footprints of H-cg3d's passes (the interior of every
# field, aW's eastern and aS's northern ring sides) hold every cell read
# and no cell unread
@pytest.mark.parametrize("kernel", ("cg3d_s_stencil_dot", "cg3d_xr_precond"))
def test_cg3d_footprint(lib, kernel):
    f = Fields(torch.float64, 180, *FOOTPRINT_SIZE, CG3D_NR)
    smoke = chip_smoke()
    case = (s_stencil_case(f) if kernel == "cg3d_s_stencil_dot"
            else xr_precond_case(f))
    check_footprint(lib, case, smoke.FOOTPRINTS[kernel][0], smoke.CG3D_RINGS,
                    same_as=check_interior)


# seaice_evp_uv's variants: SEAICE_PARM01 settings on the ice-gyre's, and
# the template flags (adaptive, revised-or-adaptive denominators) that the
# test forces, None where the settings give them; adaptive EVP with plain
# denominators exists only as a template instance
EVP_UV_VARIANTS = {
    "aEVP": ({"SEAICEaEVPcoeff": 0.5, "SEAICEnEVPstarSteps": 500}, None),
    "aEVP, plain denominators": (
        {"SEAICEaEVPcoeff": 0.5, "SEAICEnEVPstarSteps": 500}, (True, False)),
    "revised": ({"SEAICE_evpAlpha": 500.0, "SEAICEnEVPstarSteps": 500},
                None),
    "classic": ({"SEAICEuseEVPrev": False, "SEAICEuseEVPstar": False,
                 "SEAICE_deltaTevp": 60.0}, None),
    "EVP*": ({"SEAICEuseEVPrev": False, "SEAICE_deltaTevp": 60.0}, None),
}


def evp_uv_case(dtype, seed, ny, nx, variant):
    """(twin's u, v, sigma12, dwatn, divX, divY, the SeaIce, the launch's
    inputs) of seaice_evp_uv on the ice-gyre's walled grid with seeded ice,
    stresses, viscosities and ocean."""
    nml, flags = EVP_UV_VARIANTS[variant]
    cfg = synthetic.evp_ice_gyre_config(nx=nx, ny=ny, nr=4, deltaT=600.0)
    # 2 x 2 tiles (the LSR's, which EVP does not run) on a grid not square
    cfg = dataclasses.replace(cfg, sNy=ny // 2, nSy=2)
    grid = synthetic.gyre_grid(cfg, dtype=dtype, device="cpu")
    si = seaice.SeaIce(cfg, grid, seaice.params_from_namelists(
        cfg, {**synthetic.ICE_GYRE_SEAICE, **nml}))
    if flags is not None:
        factors = si._evp_factors()
        factors.adaptive, factors.rev_den = flags
        si._evp_factors = lambda: factors
    rng = np.random.default_rng(seed)
    shape = tuple(grid.rA.shape)

    def fld(lo, hi, mask=None):
        a = torch.as_tensor(rng.uniform(lo, hi, shape), dtype=dtype)
        return a * mask if mask is not None else a

    mU, mV, hm = si.seaiceMaskU, si.seaiceMaskV, si.HEFFM
    ice = si.init_state()._replace(AREA=fld(0.0, 1.0, hm))
    massU = fld(0.0, 3e3, mU)
    massU[::3, ::2] = 0.0        # cells without ice mass
    fixed = dict(uNm1=fld(-0.2, 0.2, mU), vNm1=fld(-0.2, 0.2, mV),
                 uVel0=fld(-0.3, 0.3), vVel0=fld(-0.3, 0.3),
                 forcex0=fld(-1.0, 1.0), forcey0=fld(-1.0, 1.0),
                 massC=fld(1e3, 3e3, hm), massU=massU,
                 massV=fld(0.0, 3e3, mV))
    setup = synthetic.evp_setup(si, ice.AREA, massU, fixed["massV"])
    u, v = fld(-0.2, 0.2, mU), fld(-0.2, 0.2, mV)
    s12, s1, s2 = fld(-1e3, 1e3), fld(-1e3, 1e3, hm), fld(-1e3, 1e3, hm)
    zeta, alpha = fld(1e6, 1e8, hm), fld(50.0, 500.0)
    ins = seaice_kernels._uv_ins(si, u, v, s12, s1, s2, zeta, alpha, fixed,
                                 setup)
    want = si._evp_uv_plain(u, v, s12, s1, s2, zeta, alpha,
                            *fixed.values(), setup)
    return want, si, ins


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", EVP_UV_VARIANTS)
@pytest.mark.parametrize("last", (False, True))
def test_seaice_evp_uv(lib, monkeypatch, ny, nx, dtype, variant, last):
    # the twin's drag through a correctly rounded sqrt, as the kernel's
    monkeypatch.setattr(torch, "sqrt", lambda t: torch.from_numpy(
        np.sqrt(t.numpy())))
    f = Fields(DTYPES[dtype], 190, ny, nx)
    want, si, ins = evp_uv_case(f.dtype, 190 + nx + last, ny, nx, variant)
    adaptive, rev_den, _, params = seaice_kernels._evp_variant(si)
    init = [f.normal(tuple(ins["u"].shape)) for _ in range(6)]
    outs = [t.clone() for t in init]
    tab = table(list(ins.values()) + outs)
    assert getattr(lib, f"host_seaice_evp_uv_{dtype}")(
        tab, len(tab), params, len(params), ny, nx, OL, adaptive, rev_den,
        int(last)) == 0
    names = ("u", "v", "sigma12", "dwatn", "divX", "divY")
    for n, name in enumerate(names):
        # dwatn and the divergence are written on the last subcycle only
        wanted = want[n] if last or n < 3 else init[n]
        check_whole(outs[n], wanted, f"{variant} {name}")


# Kernel O's three sweeps on halos of 4, each against its twin sweep
# (model/gad.py:MD_PLAIN) on every padded cell: (nr, ny, nx). X's tiles
# of 31 cells and 8 rows, Y's of 31 rows and 32 columns and R's of 32 x 8
# columns are ragged on each grid (the second has two tiles in x and in y,
# the first of them a full one); 11 levels hold the ring of 8 away from the
# column ends, 3 clamp both ends at once.
O_OL = 4
O_SHAPES = ((4, 12, 20), (11, 30, 24), (3, 10, 40))
O_SWEEPS = {"gad_os7mp_x": 0, "gad_os7mp_y": 1, "gad_os7mp_r": 2}


def os7mp_case(f, name, deltaT=600.0):
    """(twin's output, inputs by the wrapper's names, launch arguments
    after the table, run(inputs) -> outputs) of O's sweep `name` on f's
    grid (halos of 4): transports of both signs, a tenth of them exactly 0,
    Courant numbers up to about 1, a source with fronts."""
    return sweep_case(f, "gad_os7mp", O_SWEEPS[name], 7, deltaT)


def sweep_case(f, kernel, direction, scheme, deltaT=600.0):
    """os7mp_case for the sweep (0 X, 1 Y, 2 R) of `kernel` (gad_os7mp or
    gad_ppm) and a scheme it owns."""
    name = f"{kernel}_{'xyr'[direction]}"
    source = ("tracer", "localX", "localY")[direction]
    g = f.grid
    nr, nyp, nxp = f.s3
    cfg = SimpleNamespace(rkSign=-1.0)

    def trans(mask):
        t = f.normal(f.s3, 10.0) * mask
        return t * (f.uniform(f.s3, 0.0, 1.0) > 0.1)

    uT, vT, rT = trans(g.maskW), trans(g.maskS), trans(g.maskC)
    flow = gad.AdvFlow(
        uTrans=uT, vTrans=vT, rTrans=rT,
        rTransKp=torch.cat([rT[1:], torch.zeros_like(rT[:1])]),
        maskUp=g.maskC, xA=g.maskW, yA=g.maskS)
    u = f.normal(f.s3).clamp(-3.0, 3.0) * 2.5e-4 * g.maskW
    v = f.normal(f.s3).clamp(-3.0, 3.0) * 2.5e-4 * g.maskS
    w = f.normal(f.s3).clamp(-3.0, 3.0) * 2.5e-3 * g.maskC
    tracer = (15.0 + f.normal(f.s3, 2.0)) * g.maskC
    tracer[:, :, nxp // 2:] += 3.0
    tracer[nr // 2:, nyp // 2:, :] -= 2.0
    src = tracer if direction == 0 else (
        tracer + f.normal(f.s3, 0.5)) * g.maskC
    want = [gad.MD_PLAIN[name](cfg, g, flow, u, v, w, tracer, src, scheme,
                               scheme, deltaT)]
    named = dict(uTrans=uT, vTrans=vT, rTrans=rT, uVel=u, vVel=v, wVel=w,
                 tracer=tracer,
                 **{n: getattr(g, n) for n in gad._MD_GRID3
                    + gad._MD_GRID2 + gad._MD_GRID1})
    named[source] = src
    order = [n for n in named if n not in ("localX", "localY")]
    lib_fn = f"host_{kernel}_{SUFFIX[f.dtype]}"

    def run(lib, ins):
        out = torch.full(f.s3, float("nan"), dtype=f.dtype)
        tab = table([ins[n] for n in order])
        assert getattr(lib, lib_fn)(
            direction, tab, len(tab), ins[source].data_ptr(),
            out.data_ptr(), None, nr, nyp, nxp, scheme, deltaT,
            cfg.rkSign) == 0
        return [out]

    args = (named[source].data_ptr(), None, None, nr, nyp, nxp, scheme,
            deltaT, cfg.rkSign)
    return want, named, args, run


@pytest.mark.parametrize("nr,ny,nx", O_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", O_SWEEPS)
def test_os7mp_tile(lib, nr, ny, nx, dtype, name):
    f = Fields(DTYPES[dtype], 200 + nr + nx, ny, nx, nr, O_OL)
    want, named, _, run = os7mp_case(f, name)
    (got,) = run(lib, named)
    check_whole(got, want[0], name)


def test_os7mp_transports(lib):
    """The case's transports change sign within a warp's 32 faces and are
    exactly 0 on some of them; the velocities reach Courant numbers near
    1 and the fronts make the limiter clip."""
    f = Fields(torch.float64, 215, 30, 24, 11, O_OL)
    _, named, _, _ = os7mp_case(f, "gad_os7mp_x")
    rows = named["uTrans"].reshape(-1, 32)
    assert bool(((rows > 0).any(1) & (rows < 0).any(1)
                 & (rows == 0).any(1)).any())
    cfl = (named["uVel"] * 600.0 * named["recip_dxC"]).abs()
    assert 0.6 < float(cfl.max()) < 1.0


def test_os7mp_launch_refuses(lib):
    """A table of the wrong length and a scheme that is not 7
    (cudaErrorInvalidValue, 1)."""
    f = Fields(torch.float64, 216, 12, 20, 4, O_OL)
    _, named, args, _ = os7mp_case(f, "gad_os7mp_x")
    tab = table([named[n] for n in named])
    out = torch.empty(f.s3, dtype=f.dtype)
    for n, scheme in ((len(tab) - 1, 7), (len(tab), 33)):
        assert lib.host_gad_os7mp_f64(0, tab, n, args[0], out.data_ptr(),
                                      None, *args[3:6], scheme, 600.0,
                                      -1.0) == 1


# chip_smoke.py's footprints of O's sweeps (every padded cell of each field
# a sweep reads, R's wVel and recip_drC below the surface) hold every cell
# read and no cell unread
@pytest.mark.parametrize("name", O_SWEEPS)
def test_os7mp_footprint(lib, name):
    f = Fields(torch.float64, 220, 12, 20, 5, O_OL)
    smoke = chip_smoke()
    check_footprint(lib, os7mp_case(f, name), smoke.FOOTPRINTS[name][0], {},
                    same_as=check_whole)


# Kernel P's three sweeps on halos of 4, each against its twin sweep
# (model/gad.py:MD_PLAIN) on every padded cell, non-finite values in the
# same cells, for every scheme of PPM and PQM: (nr, ny, nx). X's rows of 30
# cells, Y's walks of 32 rows and R's 32 x 8 columns are ragged on each
# grid (the second has two walks a column, the last two X tiles a row, the
# second ragged); 3, 4 and 5 levels put R's ghost copies in every WENO
# window and edge stencil, 11 levels hold some of them away from both ends.
P_SHAPES = ((4, 12, 20), (11, 30, 24), (3, 10, 40), (5, 9, 31))
P_SWEEPS = {"gad_ppm_x": 0, "gad_ppm_y": 1, "gad_ppm_r": 2}
P_SCHEMES = (40, 41, 42, 50, 51, 52)


@pytest.fixture
def numpy_sqrt(monkeypatch):
    """The twins' sqrt correctly rounded, as the kernels' (PyTorch's CPU
    sqrt is not always)."""
    monkeypatch.setattr(torch, "sqrt", lambda t: torch.from_numpy(
        np.sqrt(t.numpy())))


@pytest.mark.parametrize("nr,ny,nx", P_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scheme", P_SCHEMES)
@pytest.mark.parametrize("name", P_SWEEPS)
def test_ppm_tile(lib, numpy_sqrt, nr, ny, nx, dtype, scheme, name):
    f = Fields(DTYPES[dtype], 300 + nr + nx + scheme, ny, nx, nr, O_OL)
    want, named, _, run = sweep_case(f, "gad_ppm", P_SWEEPS[name], scheme)
    (got,) = run(lib, named)
    check_same(got, want[0], f"{name} scheme {scheme}")


def test_ppm_launch_refuses(lib):
    """A table of the wrong length, a scheme that is not P's, an empty
    grid (cudaErrorInvalidValue, 1)."""
    f = Fields(torch.float64, 316, 12, 20, 4, O_OL)
    _, named, args, _ = sweep_case(f, "gad_ppm", 0, 51)
    tab = table([named[n] for n in named if n not in ("localX", "localY")])
    out = torch.empty(f.s3, dtype=f.dtype)
    nr, nyp, nxp = args[3:6]
    for d in P_SWEEPS.values():
        for n, scheme, shape in ((len(tab) - 1, 51, (nr, nyp, nxp)),
                                 (len(tab), 7, (nr, nyp, nxp)),
                                 (len(tab), 43, (nr, nyp, nxp)),
                                 (len(tab), 51, (0, nyp, nxp))):
            assert lib.host_gad_ppm_f64(d, tab, n, args[0], out.data_ptr(),
                                        None, *shape, scheme, 600.0,
                                        -1.0) == 1


# chip_smoke.py's footprints of P's sweeps (every padded cell of each field
# a sweep reads, R's wVel and recip_drC where it forms a flux or an edge)
# hold every cell read and no cell unread, for PPM and for PQM (which also
# reads the edge slopes' spacings)
@pytest.mark.parametrize("scheme", (41, 52))
@pytest.mark.parametrize("name", P_SWEEPS)
def test_ppm_footprint(lib, numpy_sqrt, scheme, name):
    f = Fields(torch.float64, 320 + scheme, 12, 20, 5, O_OL)
    smoke = chip_smoke()
    check_footprint(lib, sweep_case(f, "gad_ppm", P_SWEEPS[name], scheme),
                    smoke.FOOTPRINTS[name][0], {}, same_as=check_same)


# Kernel H-SOM's three passes against their twins (model/som.py) on every
# padded cell, each pass on its twin's previous output, schemes 80 and 81:
# (nr, ny, nx). X's rows of 30 updated cells, Y's walks of 32 rows and
# R's 32 x 8 columns are ragged on each grid (the third has two walks a
# column); a level alone walks no interface; 11 levels are two of X's
# chunks of 8.
SOM_SHAPES = ((4, 12, 20), (3, 10, 40), (4, 30, 24), (1, 12, 20),
              (11, 12, 20))
SOM_PASSES = {"som_x": 0, "som_y": 1, "som_r": 2}


def check_same(got, want, label):
    """Equal on every padded cell, non-finite values in the same cells."""
    assert identical(got, want), (
        f"{label}: non-finite cells {int((~got.isfinite()).sum())} / "
        f"{int((~want.isfinite()).sum())}, max abs diff of the rest "
        f"{float((got - want).nan_to_num(0.0, 0.0, 0.0).abs().max()):.3e}")


def som_case(f, name, scheme, deltaT=600.0):
    """As os7mp_case, for H-SOM's pass `name` (its outputs: volume,
    content and moments, or R's gTr and moments): velocities of both signs
    with Courant fractions up to about a half, a still block, moments up to
    about twice a cell's content so that the limiter clips."""
    g = f.grid
    nr, nyp, nxp = f.s3
    cfg = SimpleNamespace(nx=nxp - 2 * OL, ny=nyp - 2 * OL, olx=OL, oly=OL,
                          nFaces=1)
    u = f.normal(f.s3, 5e-4) * g.maskW
    v = f.normal(f.s3, 5e-4) * g.maskS
    w = f.normal(f.s3, 1e-2) * g.maskC
    for a in (u, v, w):
        a[:, 3:6, 3:6] = 0.0
    tracer = (15.0 + f.normal(f.s3, 2.0)) * g.maskC
    vol = g.rA * g.drF[:, None, None] * g.hFacC
    smTr = f.normal((9,) + f.s3, 2.0) * (tracer * vol)[None]
    named = dict(uVel=u, vVel=v, wVel=w, tracer=tracer,
                 **{n: getattr(g, n) for n in som._GRID3 + som._GRID2
                    + som._GRID1}, smTr=smTr)
    x = som._som_x_plain(cfg, g, u, tracer, smTr, scheme, deltaT)
    y = som._som_y_plain(cfg, g, v, *x, scheme, deltaT)
    state = {"som_y": dict(zip(("volX", "oX", "smX"), x)),
             "som_r": dict(zip(("volY", "oY", "smY"), y))}.get(name, {})
    named.update(state)
    want = {"som_x": x, "som_y": y,
            "som_r": som._som_r_plain(cfg, g, w, tracer, *y, scheme,
                                      deltaT)}[name]
    order = [n for n in named if n in ("uVel", "vVel", "wVel", "tracer")
             + som._GRID3 + som._GRID2 + som._GRID1]
    ins = {"som_x": (None, None, "smTr"), "som_y": ("volX", "oX", "smX"),
           "som_r": ("volY", "oY", "smY")}[name]
    lib_fn = f"host_som_{SUFFIX[f.dtype]}"

    def run(lib, named_in):
        outs = [torch.full(t.shape, float("nan"), dtype=f.dtype)
                for t in want]
        vol_out, o_out, sm_out, gtr = (
            (None, None, outs[1], outs[0]) if name == "som_r"
            else (*outs, None))
        tab = table([named_in[n] for n in order])

        def ptr(t):
            return None if t is None else t.data_ptr()
        assert getattr(lib, lib_fn)(
            SOM_PASSES[name], tab, len(tab),
            *[None if n is None else named_in[n].data_ptr() for n in ins],
            ptr(vol_out), ptr(o_out), ptr(sm_out), ptr(gtr), None, nr, nyp,
            nxp, scheme % 10, deltaT) == 0
        return outs

    return list(want), named, (nr, nyp, nxp, scheme % 10), run


@pytest.mark.parametrize("nr,ny,nx", SOM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scheme", (80, 81))
@pytest.mark.parametrize("name", SOM_PASSES)
def test_som_tile(lib, nr, ny, nx, dtype, scheme, name):
    f = Fields(DTYPES[dtype], 230 + nr + nx + scheme, ny, nx, nr)
    want, named, _, run = som_case(f, name, scheme)
    outs = run(lib, named)
    for n, (got, wanted) in enumerate(zip(outs, want)):
        check_same(got, wanted, f"{name} output {n}")
    # the first padded column (X) and row (Y) divide by the zero volume of
    # the zero-filled upwind cell: non-finite in the twin and the kernel
    bad = ~outs[-1].isfinite()
    assert bool(bad[..., :, 0].any()) and not bool(bad[..., 1:, 1:].any())


def test_som_launch_refuses(lib):
    """A table of the wrong length, a limiter that is not 0 or 1, Y
    without its input volume, R without gTr (cudaErrorInvalidValue, 1)."""
    f = Fields(torch.float64, 240, 12, 20)
    _, named, (nr, nyp, nxp, _), _ = som_case(f, "som_y", 81)
    order = [n for n in named if n in ("uVel", "vVel", "wVel", "tracer")
             + som._GRID3 + som._GRID2 + som._GRID1]
    tab = table([named[n] for n in order])
    out = torch.empty((9,) + f.s3, dtype=f.dtype)
    p = out.data_ptr()
    for d, n, vol_in, gtr, lim in ((1, len(tab) - 1, p, None, 1),
                                   (1, len(tab), p, None, 2),
                                   (1, len(tab), None, None, 1),
                                   (2, len(tab), p, None, 1)):
        assert lib.host_som_f64(d, tab, n, vol_in, p, p, p, p, p, gtr, None,
                                nr, nyp, nxp, lim, 600.0) == 1


# chip_smoke.py's footprints of H-SOM's passes (every padded cell of each
# field a pass reads) hold every cell read and no cell unread
@pytest.mark.parametrize("scheme", (80, 81))
@pytest.mark.parametrize("name", SOM_PASSES)
def test_som_footprint(lib, scheme, name):
    f = Fields(torch.float64, 250 + scheme, 12, 20)
    smoke = chip_smoke()
    check_footprint(lib, som_case(f, name, scheme),
                    smoke.FOOTPRINTS[name][0], {}, same_as=check_same)


# Kernel V (mom_vecinv_tile.cuh) against its twin (model/mom_vecinv.py:
# _mom_vecinv_plain): every interior output equal, every halo output 0, in
# each template variant (vorticity scheme 0, 1 or 2, Coriolis scheme 0 or
# 1, implicit or explicit viscosity) under each bottom drag: no-slip (the
# vi-gyre's), no-slip with a linear drag, a linear drag alone, none. The
# random grid's land and partial cells close corners (hFacZ 0), where the
# vorticity takes the side-drag factor and 1 / hFacZ is 0.
VI_SCHEMES = [(vort, cori, implicit) for vort in (1, 0, 2) for cori in (0, 1)
              for implicit in (True, False)]
VI_DRAGS = {"no-slip": (True, 0.0), "no-slip and linear": (True, 2e-3),
            "linear": (False, 2e-3), "none": (False, 0.0)}


def vecinv_case(f, vort, cori, implicit, drag, cd=False):
    """As mom_case, for kernel V on f's grid with its own recip_rAz and
    fCoriG (drag: a VI_DRAGS key; cd: the CD scheme's variant, Coriolis
    2)."""
    ny, nx = f.s3[1] - 2 * OL, f.s3[2] - 2 * OL
    no_slip, linear = VI_DRAGS[drag]
    g = f.grid
    g.recip_rAz = 1.0 / f.uniform(f.s3[1:], 0.5, 2.0)
    g.fCoriG = f.uniform(f.s3[1:], -1.5, 1.5)
    cfg = config_ns(nr=f.s3[0], rkSign=-1.0, viscAh=430.0, viscAhD=430.0,
                    viscAhZ=430.0, sideDragFactor=2.0,
                    implicitViscosity=implicit, no_slip_bottom=no_slip,
                    bottomDragLinear=linear, selectVortScheme=vort,
                    selectCoriScheme=cori, useCDscheme=cd)
    u = f.normal(f.s3, 0.1) * g.maskW
    v = f.normal(f.s3, 0.1) * g.maskS
    w = f.normal(f.s3, 1e-2) * g.maskC
    kshape = (f.s3[0] + 1,) + f.s3[1:]
    kRU, kRV = f.normal(kshape, 1e-2).abs(), f.normal(kshape, 1e-2).abs()
    want = list(vecinv._mom_vecinv_plain(cfg, g, u, v, w, kRU, kRV))
    args = (f.s3[0], ny, nx, OL, OL, vort, 2 if cd else cori, int(implicit),
            int(no_slip))
    fn = f"host_mom_vecinv_{SUFFIX[f.dtype]}"

    def run(lib, ins):
        outs = [torch.full(f.s3, float("nan"), dtype=f.dtype)
                for _ in range(4)]
        tab = table(list(ins.values()) + outs)
        assert getattr(lib, fn)(tab, len(tab), *args, cfg.viscAh,
                                cfg.sideDragFactor, linear, cfg.rkSign) == 0
        return outs

    return want, vecinv._kernel_inputs(g, u, v, w, kRU, kRV), args, run


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vort,cori,implicit", VI_SCHEMES)
@pytest.mark.parametrize("drag", VI_DRAGS)
def test_mom_vecinv_tile(lib, ny, nx, dtype, vort, cori, implicit, drag):
    f = Fields(DTYPES[dtype], 400 + VI_SCHEMES.index((vort, cori, implicit)),
               ny, nx)
    want, named, _, run = vecinv_case(f, vort, cori, implicit, drag)
    closed = int((mom.calc_hfacz(f.grid)[inner_of(f)] == 0).sum())
    assert closed > 0, "no closed corner in the interior"
    for name, got, wanted in zip(mom.MomTend._fields, run(lib, named), want):
        check(got, wanted, name)


def inner_of(f):
    return (..., slice(OL, f.s3[1] - OL), slice(OL, f.s3[2] - OL))


def test_mom_vecinv_refuses(lib):
    """A table of the wrong length, a vorticity scheme of 3, a Coriolis
    scheme of 3 (2 is the CD scheme's variant), flags that are not 0 or 1
    (cudaErrorInvalidValue, 1)."""
    f = Fields(torch.float64, 450, *SIZES[0])
    _, named, args, _ = vecinv_case(f, 1, 0, True, "no-slip")
    outs = [torch.empty(f.s3, dtype=f.dtype) for _ in range(4)]
    tab = table(list(named.values()) + outs)
    for extra, change in ((-1, {}), (0, {5: 3}), (0, {6: 3}), (0, {7: 2}),
                          (0, {8: -1})):
        bad = [change.get(n, a) for n, a in enumerate(args)]
        assert lib.host_mom_vecinv_f64(tab, len(tab) + extra, *bad, 430.0,
                                       2.0, 0.0, -1.0) == 1


# chip_smoke.py's footprint of V's inputs holds every cell read and no cell
# unread, in the vi-gyre's variant and in variants that read the kappas
# for the explicit flux only, for the drag only, or not at all
VI_FOOTPRINT_VARIANTS = ((1, 0, True, "no-slip"),
                         (0, 1, False, "no-slip and linear"),
                         (2, 0, False, "none"), (1, 1, True, "linear"))


@pytest.mark.parametrize("vort,cori,implicit,drag", VI_FOOTPRINT_VARIANTS)
def test_mom_vecinv_footprint(lib, vort, cori, implicit, drag):
    f = Fields(torch.float64, 460 + vort + 3 * cori, *SIZES[0])
    smoke = chip_smoke()
    check_footprint(lib, vecinv_case(f, vort, cori, implicit, drag),
                    smoke.vecinv_footprint, smoke.VECINV_RINGS)


# Kernel M's three sweeps, each against its twin sweep (model/gad.py:
# MD_PLAIN) on every padded cell, non-finite values in the same cells, for
# every scheme it owns in each direction, on halos of 2 and 3: (nr, ny,
# nx). X's rows of 31 cells, Y's walks of 32 rows and R's 32 x 8 columns
# are ragged on each grid (the second and last have two walks a column, the
# third two X tiles a row); 1, 2, 3 and 4 levels reach R's clamped
# neighbours and C4's maskBound at both ends at once, 11 hold them apart.
MD_SHAPES = ((4, 12, 20), (11, 30, 24), (3, 10, 40), (1, 9, 21),
             (2, 40, 33))
MD_SWEEPS = [(name, scheme)
             for name, schemes in (("gad_multidim_x", (1, 20, 30, 33, 77)),
                                   ("gad_multidim_y", (1, 20, 30, 33, 77)),
                                   ("gad_multidim_r", (1, 2, 3, 4, 20, 30,
                                                       33, 77)))
             for scheme in schemes]


def multidim_case(f, name, scheme):
    """os7mp_case for M's sweep `name` and a scheme it owns."""
    return sweep_case(f, "gad_multidim", "xyr".index(name[-1]), scheme)


@pytest.mark.parametrize("nr,ny,nx", MD_SHAPES)
@pytest.mark.parametrize("ol", (2, 3))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,scheme", MD_SWEEPS)
def test_multidim_tile(lib, nr, ny, nx, ol, dtype, name, scheme):
    f = Fields(DTYPES[dtype], 500 + nr + nx + ol, ny, nx, nr, ol)
    want, named, _, run = multidim_case(f, name, scheme)
    (got,) = run(lib, named)
    check_same(got, want[0], f"{name}({scheme})")


def test_multidim_transports(lib):
    """The case's transports change sign within a warp's 32 faces and are
    exactly 0 on some of them, in each direction (a warp runs 32 faces of
    a row in each sweep: the padded rows here are 32 cells); the
    velocities reach Courant numbers near 1."""
    f = Fields(torch.float64, 530, 30, 28, 11, 2)
    _, named, _, _ = multidim_case(f, "gad_multidim_x", 33)
    for trans in ("uTrans", "vTrans", "rTrans"):
        rows = named[trans].reshape(-1, 32)
        assert bool(((rows > 0).any(1) & (rows < 0).any(1)
                     & (rows == 0).any(1)).any()), trans
    cfl = (named["uVel"] * 600.0 * named["recip_dxC"]).abs()
    assert 0.6 < float(cfl.max()) < 1.0


def test_multidim_launch_refuses(lib):
    """A table of the wrong length, schemes M does not own in a direction
    (2 and 7 in X and Y, 7 and 41 in R) (cudaErrorInvalidValue, 1)."""
    f = Fields(torch.float64, 531, 12, 20)
    _, named, args, _ = multidim_case(f, "gad_multidim_x", 33)
    tab = table([named[n] for n in named])
    out = torch.empty(f.s3, dtype=f.dtype)
    for d, n, scheme in ((0, len(tab) - 1, 33), (2, len(tab) - 1, 33),
                         (0, len(tab), 2), (1, len(tab), 7),
                         (2, len(tab), 7), (2, len(tab), 41)):
        assert lib.host_gad_multidim_f64(d, tab, n, args[0], out.data_ptr(),
                                         None, *args[3:6], scheme, 600.0,
                                         -1.0) == 1


# chip_smoke.py's footprints of M's sweeps (every padded cell of each field
# a sweep's scheme reads; R's wVel and recip_drC below the surface, maskC
# above the bottom under schemes 1, 2 and 20) hold every cell read and no
# cell unread
@pytest.mark.parametrize("name,scheme", MD_SWEEPS)
def test_multidim_footprint(lib, name, scheme):
    f = Fields(torch.float64, 540, 12, 20, 5)
    smoke = chip_smoke()
    check_footprint(lib, multidim_case(f, name, scheme),
                    smoke.FOOTPRINTS[name][0], {}, same_as=check_same)


# Kernel W (calc_gw_tile.cuh), which writes every padded cell, against its
# twin (model/calc_gw.py:_calc_gw_plain) on every padded cell, in both
# variants of the 3-D Coriolis term, on SIZES (the padded planes of 16 x 24
# and 14 x 44 are ragged in the tiles of 32 x 4 columns, the second has two
# tiles in x) with 2, 5 and 12 levels. The grid has land and partial cells:
# the columns' and faces' bottoms and tops fall on the cell centres in
# places, so that recipThickC's guards (a closed cell above, a thickness of
# 0) and zero open thicknesses rThickW/S occur.
GW_LEVELS = (2, 5, 12)


def gw_case(f, cori3d):
    """As mom_case, for kernel W on f's grid with its vertical grid and
    the open depths of the cells and faces."""
    nr, nyp, nxp = f.s3
    g = f.grid
    drF = g.drF.double().numpy()
    rF = np.concatenate([[0.0], -np.cumsum(drF)])
    rC = 0.5 * (rF[:-1] + rF[1:])
    g.rC = f.tensor(rC)

    def surface_and_bottom():
        # tops mostly at 0, bottoms anywhere, some of both on a centre
        top = np.where(f.rng.uniform(size=(nyp, nxp)) < 0.8, 0.0,
                       f.rng.choice(rC, (nyp, nxp)))
        low = f.rng.uniform(rF[-1], 0.0, (nyp, nxp))
        on = f.rng.uniform(size=(nyp, nxp)) < 0.3
        low[on] = f.rng.choice(rC, int(on.sum()))
        return f.tensor(top), f.tensor(low)

    g.Ro_surf, g.R_low = surface_and_bottom()
    g.rSurfW, g.rLowW = surface_and_bottom()
    g.rSurfS, g.rLowS = surface_and_bottom()
    g.angleSinC = f.uniform((nyp, nxp), -0.5, 0.5)
    cfg = SimpleNamespace(nr=nr, viscAhW=430.0, gravitySign=-1.0,
                          select3dCoriScheme=int(cori3d))
    u = f.normal(f.s3, 0.1) * g.maskW
    v = f.normal(f.s3, 0.1) * g.maskS
    w = f.normal(f.s3, 1e-2) * g.maskC
    kshape = (nr + 1, nyp, nxp)
    kRU, kRV = f.normal(kshape, 1e-2).abs(), f.normal(kshape, 1e-2).abs()
    want = list(calc_gw._calc_gw_plain(cfg, g, u, v, w, kRU, kRV))
    named = dict(u=u, v=v, w=w,
                 **{n: getattr(g, n) for n in calc_gw._GRID3},
                 kappaRU=kRU, kappaRV=kRV,
                 **{n: getattr(g, n) for n in calc_gw._GRID2
                    + calc_gw._GRID1})
    args = (nr, nyp, nxp, int(cori3d))
    fn = f"host_calc_gw_{SUFFIX[f.dtype]}"

    def run(lib, ins):
        outs = [torch.full(f.s3, float("nan"), dtype=f.dtype)
                for _ in range(2)]
        tab = table(list(ins.values()) + outs)
        assert getattr(lib, fn)(tab, len(tab), *args, cfg.viscAhW, -1.0,
                                cfg.gravitySign) == 0
        return outs

    return want, named, args, run


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nr", GW_LEVELS)
@pytest.mark.parametrize("cori3d", (False, True))
def test_calc_gw_tile(lib, ny, nx, dtype, nr, cori3d):
    f = Fields(DTYPES[dtype], 600 + nr + nx, ny, nx, nr)
    want, named, _, run = gw_case(f, cori3d)
    for name, got, wanted in zip(("gW", "gwDiss"), run(lib, named), want):
        check_whole(got, wanted, name)
    # the guards and clamps the grid is built to reach
    g, rC = f.grid, f.grid.rC
    kk = slice(1, None)
    thick = (torch.minimum(g.Ro_surf[None], rC[:-1, None, None])
             - torch.maximum(g.R_low[None], rC[1:, None, None]))
    open_c = (g.maskC[:-1] > 0) & (g.maskC[1:] > 0)
    assert bool((open_c & (thick == 0)).any()), "no open cell of thickness 0"
    assert bool((g.maskC[:-1] == 0).any() & (g.maskC[kk] > 0).any())
    thick_w = (torch.minimum(g.rSurfW[None], rC[:-1, None, None])
               - torch.maximum(g.rLowW[None], rC[1:, None, None]))
    assert bool((thick_w <= 0).any() & (thick_w > 0).any())


def test_calc_gw_refuses(lib):
    """A table of the wrong length, a Coriolis flag that is not 0 or 1, no
    levels (cudaErrorInvalidValue, 1)."""
    f = Fields(torch.float64, 650, *SIZES[0], 5)
    _, named, args, _ = gw_case(f, False)
    outs = [torch.empty(f.s3, dtype=f.dtype) for _ in range(2)]
    tab = table(list(named.values()) + outs)
    for extra, change in ((-1, {}), (1, {}), (0, {3: 2}), (0, {3: -1}),
                          (0, {0: 0})):
        bad = [change.get(n, a) for n, a in enumerate(args)]
        assert lib.host_calc_gw_f64(tab, len(tab) + extra, *bad, 430.0,
                                    -1.0, -1.0) == 1


# chip_smoke.py's footprint of W's inputs holds every cell read and no cell
# unread, in both variants
@pytest.mark.parametrize("cori3d", (False, True))
def test_calc_gw_footprint(lib, cori3d):
    f = Fields(torch.float64, 660 + cori3d, *SIZES[0], 5)
    smoke = chip_smoke()
    check_footprint(lib, gw_case(f, cori3d), smoke.gw_footprint, {},
                    same_as=check_whole)


# G9's ggl90_col (ggl90_col.cuh) against its twin (model/ggl90.py:
# _ggl90_col_plain) on every padded cell of tke', diffKr and visctmp, with
# outputs NaN before the launch, for every mxlMaxFlag, both
# calcMeanVertShear branches and both bottoms, IDEMIX and Langmuir each on
# and off (Langmuir not at flag 0, which check_ggl90 refuses), with 2, 5,
# 12 and 70 levels (the last above the 64 it once took), float64 and
# float32. The grid has land, columns of 1, 2 and nr wet levels and
# partial bottom cells; a fifth of the interfaces are statically unstable,
# some columns have no vertical shear, the TKE sits at its floor in places.
# The twin takes libm's exp and a correctly rounded sqrt, as the kernel on
# the host does.
G9_LEVELS = (2, 5, 12, 70)
G9_VARIANTS = {"plain": (False, False), "idemix": (True, False),
               "langmuir": (False, True), "idemix+langmuir": (True, True)}
G9_CASES = [(flag, shear, dirichlet, variant)
            for flag in range(4) for shear in (False, True)
            for dirichlet in (True, False) for variant in G9_VARIANTS
            if not (flag == 0 and G9_VARIANTS[variant][1])]
_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.exp.argtypes, _LIBM.exp.restype = [ctypes.c_double], ctypes.c_double
_LIBM.expf.argtypes, _LIBM.expf.restype = [ctypes.c_float], ctypes.c_float


@pytest.fixture
def libm_math(monkeypatch):
    """The twins' sqrt correctly rounded and exp libm's, as the kernels'
    on the host."""
    def exp(t):
        fn = _LIBM.expf if t.dtype == torch.float32 else _LIBM.exp
        return torch.tensor([fn(x) for x in t.flatten().tolist()],
                            dtype=t.dtype).reshape(t.shape)
    monkeypatch.setattr(torch, "sqrt", lambda t: torch.from_numpy(
        np.sqrt(t.numpy())))
    monkeypatch.setattr(torch, "exp", exp)


def g9_case(dtype, seed, ny, nx, nr, flag, shear, dirichlet, variant):
    """As mom_case, for G9's ggl90_col on a random column grid."""
    f = Fields(dtype, seed, ny, nx, nr)
    rng = f.rng
    s3 = f.s3
    nyp, nxp = s3[1:]
    drF = rng.uniform(5.0, 50.0, nr)
    rF = np.concatenate([[0.0], -np.cumsum(drF)])
    rC = 0.5 * (rF[:-1] + rF[1:])
    drC = np.concatenate([[rF[0] - rC[0]], rC[:-1] - rC[1:],
                          [rC[-1] - rF[-1]]])
    klow = rng.integers(0, nr + 1, (nyp, nxp))
    klow.flat[:4] = (0, 1, 2, nr)
    kk = np.arange(nr)[:, None, None]
    mask = (kk < klow[None]).astype(float)
    hfac = mask * np.where(kk == klow[None] - 1,
                           rng.uniform(0.2, 1.0, s3), 1.0)
    bottom = np.take_along_axis(hfac, np.maximum(klow - 1, 0)[None], 0)[0]
    low = np.where(klow > 0, rF[np.maximum(klow - 1, 0)]
                   - bottom * drF[np.maximum(klow - 1, 0)], 0.0)
    top = np.where(rng.uniform(size=(nyp, nxp)) < 0.9, 0.0, -0.3 * drF[0])
    grid = SimpleNamespace(
        maskC=f.tensor(mask), hFacC=f.tensor(hfac),
        recip_hFacC=f.tensor(np.where(hfac > 0, 1.0 / np.where(
            hfac > 0, hfac, 1.0), 0.0)),
        drF=f.tensor(drF), recip_drF=f.tensor(1.0 / drF), rF=f.tensor(rF),
        recip_drC=f.tensor(1.0 / drC), Ro_surf=f.tensor(top),
        R_low=f.tensor(low), rA=f.uniform((nyp, nxp), 0.5, 2.0))
    cfg = SimpleNamespace(nr=nr, deltaTTracer=600.0, diffKrS=1e-5,
                          viscAr=1e-4, gravity=9.81, gravitySign=-1.0,
                          rhoConst=1027.5, usingPCoords=False,
                          usingZCoords=True)
    idemix, langmuir = G9_VARIANTS[variant]
    g9 = ggl90.GGL90(cfg, grid, {
        "mxlMaxFlag": flag, "calcMeanVertShear": shear,
        "GGL90_dirichlet": dirichlet, "useIDEMIX": idemix,
        "useLANGMUIR": langmuir})
    u = f.normal(s3, 0.1)
    v = f.normal(s3, 0.1)
    for a in (u, v):                  # no vertical shear in columns 3, 4
        a[:, :, 3:5] = a[:1, :, 3:5]
    tke = f.normal(s3, 3e-4).abs() * grid.maskC
    tke[:, nyp // 2:] = 1e-11 * grid.maskC[:, nyp // 2:]
    sigmaR = -1e-4 * (1.0 + 0.5 * f.normal(s3))
    sigmaR[f.uniform(s3, 0.0, 1.0) < 0.2] *= -0.3   # statically unstable
    sfU, sfV = f.normal((nyp, nxp), 1e-4), f.normal((nyp, nxp), 1e-4)
    gTKE = f.normal(s3, 1e-8).abs() if idemix else None
    want = ggl90._ggl90_col_plain(g9, u, v, tke, sigmaR, sfU, sfV, gTKE)
    want = [want[n] for n in ("tke", "diffKr", "visctmp")]
    named = ggl90._col_inputs(g9, u, v, tke, sigmaR, sfU, sfV, gTKE)
    params, flags = ggl90._col_params(g9)
    params = (ctypes.c_double * len(params))(*params)
    args = (params, len(params), nr, nyp, nxp, *flags)
    fn = f"host_ggl90_col_{SUFFIX[dtype]}"

    def run(lib, ins, max_shared=kernels.MAX_SHARED):
        outs = [torch.full(s3, float("nan"), dtype=dtype) for _ in range(3)]
        tab = table(list(ins.values()) + outs)
        err = getattr(lib, fn)(tab, len(tab), *args, max_shared)
        assert err == 0
        return outs

    return want, named, args, run


@pytest.mark.parametrize("nr", G9_LEVELS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("flag,shear,dirichlet,variant", G9_CASES)
def test_ggl90_col(lib, libm_math, nr, dtype, flag, shear, dirichlet,
                   variant):
    want, named, _, run = g9_case(DTYPES[dtype], 700 + nr, 12, 20, nr, flag,
                                  shear, dirichlet, variant)
    for name, got, wanted in zip(("tke", "diffKr", "visctmp"),
                                 run(lib, named), want):
        check_whole(got, wanted, name)
    klow = named["klowC"]
    assert {1, 2, nr} <= set(klow.flatten().tolist())
    assert bool((named["sigmaR"][1:] > 0).any())


def test_ggl90_col_refuses(lib):
    """A table or parameter list of the wrong length, a mxlMaxFlag of 4,
    and an nr whose two slots a level of a warp's columns exceed the
    launch's shared memory (cudaErrorInvalidValue, 1)."""
    _, named, args, _ = g9_case(torch.float64, 750, 12, 20, 12, 2, False,
                                True, "plain")
    outs = [torch.empty((12, 16, 24), dtype=torch.float64)
            for _ in range(3)]
    tab = table(list(named.values()) + outs)
    cases = ((-1, {}, 1 << 20), (0, {1: 17}, 1 << 20), (0, {5: 4}, 1 << 20),
             (0, {2: 1}, 1 << 20), (0, {}, 2 * 32 * 8 * 12 - 1))
    for extra, change, max_shared in cases:
        bad = [change.get(n, a) for n, a in enumerate(args)]
        assert lib.host_ggl90_col_f64(tab, len(tab) + extra, *bad,
                                      max_shared) == 1
    assert lib.host_ggl90_col_f64(tab, len(tab), *args,
                                  2 * 32 * 8 * 12) == 0


# chip_smoke.py's footprint of ggl90_col's inputs holds every cell read
# and no cell unread, for each limiter, with and without IDEMIX and
# Langmuir
@pytest.mark.parametrize("flag,variant", [(0, "plain"), (1, "langmuir"),
                                          (2, "idemix"),
                                          (3, "idemix+langmuir"),
                                          (1, "plain")])
def test_ggl90_col_footprint(lib, libm_math, flag, variant):
    smoke = chip_smoke()
    check_footprint(lib, g9_case(torch.float64, 760 + flag, 4, 20, 5, flag,
                                 flag % 2 == 1, flag < 2, variant),
                    smoke.ggl90_col_footprint, {}, same_as=check_whole)


# Kernels J-uv, J-ts, L and R's two kernels (mix_glue.cuh, adv_flow.cuh,
# eos.cuh): every padded cell equal to the twin's in every variant of their
# flags, on both SIZES grids, float64 and float32, outputs NaN before the
# launch; a NaN input lands in the same cells (torch.maximum's NaN in
# kappa_uv, w's at the surface in adv_flow). viscAr alone and the
# background diffusivity alone are fills that J-uv and J-ts refuse.
MIX_NR = 5
KAPPA_UV_MODES = {"KPP": 1, "GGL90": 2}
KAPPA_TS_OUTS = ("kapT", "kapS", "dfT", "dfS")
KAPPA_TS_VARIANTS = {"GM": (False, True, False),
                     "GGL90": (False, False, True),
                     "GGL90+GM": (False, True, True),
                     "KPP": (True, False, False),
                     "KPP+GM": (True, True, False)}
# (eosType, selectP_inEOS_Zc): the LINEAR kind, JMD95Z and MDJWF on the
# static profile and on totPhiHyd
EOS_KINDS = (("LINEAR", 0), ("JMD95Z", 0), ("JMD95Z", 2), ("MDJWF", 0),
             ("MDJWF", 2))


def check_same_cells(got, want, label):
    """Equal on every padded cell, NaN in the same cells."""
    assert identical(got, want), (
        f"{label}: max abs diff "
        f"{float((got - want).nan_to_num(0.0).abs().max()):.3e}")


def kappa_uv_case(f, mode):
    """As mom_case, for kernel J-uv (mode 1 KPP, 2 GGL90)."""
    nr, nyp, nxp = f.s3
    cfg = SimpleNamespace(nr=nr, viscAr=1e-3)
    g = f.grid
    if mode == 1:
        named = dict(maskW=g.maskW, maskS=g.maskS,
                     viscAz=f.uniform(f.s3, 0.0, 4e-3))
        named["viscAz"][1, 3, 4] = float("nan")
    else:
        named = dict(viscArU=f.uniform(f.s3, 0.0, 1e-2),
                     viscArV=f.uniform(f.s3, 0.0, 1e-2))

    def twin(ins):
        return list(step._kappa_uv_plain(
            cfg, SimpleNamespace(maskW=ins.get("maskW", g.maskW),
                                 maskS=ins.get("maskS", g.maskS)),
            ins.get("viscAz"), ins.get("viscArU"), ins.get("viscArV")))

    want = twin(named)
    args = (nr, nyp, nxp, mode, cfg.viscAr)
    fn = f"host_kappa_uv_{SUFFIX[f.dtype]}"

    def run(lib, ins):
        outs = [torch.full((nr + 1, nyp, nxp), float("nan"), dtype=f.dtype)
                for _ in range(2)]
        tab = table([ins.get("maskW", g.maskW), ins.get("maskS", g.maskS),
                     ins.get("viscAz", ins.get("viscArU")),
                     ins.get("viscArV")] + outs)
        assert getattr(lib, fn)(tab, len(tab), *args) == 0
        return outs

    return want, named, args, run


def kappa_ts_case(f, variant):
    """As mom_case, for kernel J-ts in a KAPPA_TS_VARIANTS variant."""
    from mitgcm_tpu_torch.model import thermodynamics as th

    kpp, gm, g9 = KAPPA_TS_VARIANTS[variant]
    nr, nyp, nxp = f.s3
    s2 = f.s3[1:]
    cfg = SimpleNamespace(nr=nr, diffKrT=1e-5, diffKrS=2e-5,
                          HeatCapacity_Cp=3994.0, rhoConst=1035.0)
    g = f.grid
    mC = g.maskC
    maskUp = torch.cat([torch.zeros_like(mC[:1]), mC[1:] * mC[:-1]])
    ins = dict(Kwz=f.uniform(f.s3, 0.0, 1e-3) if gm else None,
               diffKr=f.uniform(f.s3, 0.0, 1e-3) if g9 else None)
    if kpp:
        ins.update(diffKzT=f.uniform(f.s3, 0.0, 1e-2),
                   diffKzS=f.uniform(f.s3, 0.0, 1e-2),
                   ghat=f.normal(f.s3, 10.0), frac=f.uniform(s2, 0.0, 1.0),
                   sfT=f.normal(s2, 1e-4), sfS=f.normal(s2, 1e-4),
                   Qsw=f.normal(s2, 100.0), maskUp=maskUp)
        ins["sfS"][2, 3] = -0.0
    named = {n: t for n, t in ins.items() if t is not None}
    if gm:
        named["maskInC"] = g.maskInC
    if kpp:
        named["rA"] = g.rA

    def twin(given):
        grid = SimpleNamespace(maskInC=given.get("maskInC", g.maskInC),
                               rA=given.get("rA", g.rA))
        outs = dict(zip(KAPPA_TS_OUTS, th._kappa_ts_plain(
            cfg, grid, *[given.get(n) for n in th.KAPPA_TS_INPUTS])))
        return [outs[n] for n in written]

    # what the launch writes (model/thermodynamics.py:_kappa_ts_kernel
    # passes KPP's own diffusivities through without GM)
    written = (("kapT", "kapS") if gm or not kpp else ()) + (
        ("dfT", "dfS") if kpp else ())
    want = twin(named)
    params = (ctypes.c_double * 4)(cfg.diffKrT, cfg.diffKrS,
                                   1.0 / cfg.HeatCapacity_Cp,
                                   1.0 / cfg.rhoConst)
    args = (params, 4, nr, nyp, nxp, int(kpp), int(gm), int(g9))
    fn = f"host_kappa_ts_{SUFFIX[f.dtype]}"

    def run(lib, given):
        slots = {n: torch.full(f.s3, float("nan"), dtype=f.dtype)
                 for n in written}
        tab = table([given.get(n) for n in (
            "Kwz", "maskInC", "diffKr", "diffKzT", "diffKzS", "ghat",
            "maskUp", "rA", "sfT", "sfS", "Qsw", "frac")]
            + [slots.get(n) for n in ("kapT", "kapS", "dfT", "dfS")])
        assert getattr(lib, fn)(tab, len(tab), *args) == 0
        return list(slots.values())

    return want, named, args, run


def adv_flow_case(f):
    """As mom_case, for kernel L."""
    g = f.grid
    named = dict(u=f.normal(f.s3, 0.1), v=f.normal(f.s3, 0.1),
                 w=f.normal(f.s3, 1e-3), hFacW=g.hFacW, hFacS=g.hFacS,
                 maskC=g.maskC, dyG=g.dyG, dxG=g.dxG, rA=g.rA, drF=g.drF)
    named["w"][0, 2, 5] = float("nan")

    def twin(given):
        return list(gad._calc_adv_flow_plain(SimpleNamespace(**given),
                                             given["u"], given["v"],
                                             given["w"]))

    want = twin(named)
    args = f.s3
    fn = f"host_adv_flow_{SUFFIX[f.dtype]}"

    def run(lib, given):
        outs = [torch.full(f.s3, float("nan"), dtype=f.dtype)
                for _ in range(7)]
        tab = table(list(given.values()) + outs)
        assert getattr(lib, fn)(tab, len(tab), *args) == 0
        return outs

    return want, named, args, run


def eos_case(f, kind, select_p, masked=True, sigma=False):
    """As mom_case, for kernel R's eos_find_rho (times maskC when masked)
    or, with sigma, its eos_sigma_r, on the vi-gyre's configuration with
    the EOS and pressure of (kind, select_p)."""
    from mitgcm_tpu_torch.model import thermodynamics as th
    from mitgcm_tpu_torch.ops import eos

    nr, nyp, nxp = f.s3
    cfg = dataclasses.replace(
        synthetic.vi_gyre_config(nx=nxp - 2 * OL, ny=nyp - 2 * OL, nr=nr),
        eosType=kind, selectP_inEOS_Zc=select_p)
    g = f.grid
    theta = f.uniform(f.s3, -2.0, 28.0)
    salt = f.uniform(f.s3, 32.0, 37.0)
    salt[1, 2, 3] = -0.25           # the s * sqrt(max(s, 0)) guards
    phi = f.normal(f.s3, 20.0)
    extra, (code, use_phi, params) = eos.kernel_inputs(cfg, g, theta, phi)
    named = dict(theta=theta, salt=salt, **extra)
    if sigma:
        named.update(maskC=g.maskC, recip_drC=g.recip_drC,
                     rhoInSitu=f.normal(f.s3, 1.0))
        params = params + [cfg.rkSign]
    elif masked:
        named["maskC"] = g.maskC

    def twin(given):
        # the twin's tRef and sRef as given (LINEAR)
        grid = SimpleNamespace(maskC=given.get("maskC", g.maskC),
                               recip_drC=given.get("recip_drC", g.recip_drC),
                               rC=g.rC, rF=g.rF, tRef=given.get("tRef"),
                               sRef=given.get("sRef"))
        ph = given.get("totPhiHyd", phi)
        if "profile" in given:     # the profile as given, not recomputed
            saved = eos._pressure_terms
            eos._pressure_terms = lambda *a: (given["profile"], use_phi)
        try:
            if sigma:
                return list(th._calc_sigmaR_plain(
                    cfg, grid, given["rhoInSitu"], given["theta"],
                    given["salt"], ph))
            return [eos._find_rho_plain(cfg, grid, given["theta"],
                                        given["salt"], ph,
                                        given.get("maskC"))]
        finally:
            if "profile" in given:
                eos._pressure_terms = saved

    want = twin(named)
    params = (ctypes.c_double * len(params))(*params)
    if sigma:
        args = (params, len(params), nr, nyp, nxp, code, int(use_phi))
    else:
        args = (params, len(params), nr, nyp * nxp, code, int(use_phi),
                int(masked))
    fn = f"host_eos_{'sigma_r' if sigma else 'find_rho'}_{SUFFIX[f.dtype]}"

    def run(lib, given):
        out = torch.full(f.s3, float("nan"), dtype=f.dtype)
        head = [given["theta"], given["salt"]] + [given.get(n) for n in (
            "totPhiHyd", "profile", "tRef", "sRef", "maskC")]
        tail = ([given["recip_drC"], given["rhoInSitu"]] if sigma else [])
        tab = table(head + tail + [out])
        assert getattr(lib, fn)(tab, len(tab), *args) == 0
        return [out]

    return want, named, args, run


def mix_fields(dtype, seed, ny, nx, nr=MIX_NR):
    """Fields with rC and rF for the EOS's pressure, and no tRef or sRef
    (ops/eos.py:ref_profiles makes them from the configuration)."""
    f = Fields(dtype, seed, ny, nx, nr)
    f.grid.tRef = f.grid.sRef = None
    f.grid.rF = -torch.cumsum(torch.cat([f.grid.drF.new_zeros(1),
                                         f.grid.drF]), 0)
    f.grid.rC = 0.5 * (f.grid.rF[:-1] + f.grid.rF[1:])
    return f


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", KAPPA_UV_MODES)
def test_kappa_uv(lib, ny, nx, dtype, mode):
    f = mix_fields(DTYPES[dtype], 800 + nx, ny, nx)
    want, named, _, run = kappa_uv_case(f, KAPPA_UV_MODES[mode])
    for name, got, wanted in zip(("kappaRU", "kappaRV"), run(lib, named),
                                 want):
        check_same_cells(got, wanted, name)


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", KAPPA_TS_VARIANTS)
def test_kappa_ts(lib, ny, nx, dtype, variant):
    f = mix_fields(DTYPES[dtype], 820 + nx, ny, nx)
    want, named, _, run = kappa_ts_case(f, variant)
    for got, wanted in zip(run(lib, named), want):
        check_same_cells(got, wanted, variant)


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_adv_flow(lib, ny, nx, dtype):
    f = mix_fields(DTYPES[dtype], 840 + nx, ny, nx)
    want, named, _, run = adv_flow_case(f)
    for name, got, wanted in zip(gad.AdvFlow._fields, run(lib, named), want):
        check_same_cells(got, wanted, name)


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,select_p", EOS_KINDS)
@pytest.mark.parametrize("kernel", ("find_rho", "find_rho(no mask)",
                                    "sigma_r"))
def test_eos(lib, numpy_sqrt, ny, nx, dtype, kind, select_p, kernel):
    f = mix_fields(DTYPES[dtype], 860 + nx, ny, nx)
    want, named, _, run = eos_case(f, kind, select_p,
                                   masked=kernel == "find_rho",
                                   sigma=kernel == "sigma_r")
    check_same_cells(run(lib, named)[0], want[0], kernel)


def test_mix_launch_refuses(lib):
    """Tables of the wrong length, a kappa_uv mode of 0 (viscAr alone) or
    3, KPP without viscAz, kappa_ts without KPP, GM or GGL90 (the
    background alone) or with KPP and GGL90, LINEAR without tRef, a kind of
    3 (cudaErrorInvalidValue, 1)."""
    f = mix_fields(torch.float64, 880, *SIZES[0])
    nr, nyp, nxp = f.s3
    out = torch.empty((nr + 1, nyp, nxp), dtype=torch.float64)
    visc = torch.zeros(f.s3, dtype=torch.float64)
    tab = table([f.grid.maskW, f.grid.maskS, visc, visc, out, out])
    assert lib.host_kappa_uv_f64(tab, 5, nr, nyp, nxp, 2, 1e-3) == 1
    assert lib.host_kappa_uv_f64(tab, 6, nr, nyp, nxp, 0, 1e-3) == 1
    assert lib.host_kappa_uv_f64(tab, 6, nr, nyp, nxp, 3, 1e-3) == 1
    assert lib.host_kappa_uv_f64(tab, 6, nr, nyp, nxp, 2, 1e-3) == 0
    tab = table([f.grid.maskW, f.grid.maskS, None, None, out, out])
    assert lib.host_kappa_uv_f64(tab, 6, nr, nyp, nxp, 1, 1e-3) == 1
    _, named, args, _ = kappa_ts_case(f, "KPP")
    kap = torch.empty(f.s3, dtype=torch.float64)
    tab = table([None] * 12 + [kap, kap, None, None])
    assert lib.host_kappa_ts_f64(tab, 16, *args[:5], 0, 0, 0) == 1
    assert lib.host_kappa_ts_f64(tab, 16, *args[:5], 1, 0, 1) == 1
    assert lib.host_kappa_ts_f64(tab, 15, *args[:5], 0, 0, 1) == 1
    assert lib.host_adv_flow_f64(tab, 16, nr, nyp, nxp) == 1
    _, named, args, _ = eos_case(f, "LINEAR", 0)
    rho = torch.empty(f.s3, dtype=torch.float64)
    tab = table([named["theta"], named["salt"], None, None, None,
                 named["sRef"], None, rho])
    assert lib.host_eos_find_rho_f64(tab, 8, *args[:5], 0, 0) == 1
    tab = table([named["theta"], named["salt"], None, None, named["tRef"],
                 named["sRef"], None, rho])
    assert lib.host_eos_find_rho_f64(tab, 8, *args[:4], 3, 0, 0) == 1
    assert lib.host_eos_find_rho_f64(tab, 8, *args[:5], 0, 0) == 0


# chip_smoke.py's footprints of J-uv, J-ts, L and R's two kernels hold
# every cell read and no cell unread, in each variant
@pytest.mark.parametrize("case", ["kappa_uv:KPP", "kappa_uv:GGL90",
                                  *[f"kappa_ts:{v}" for v in
                                    KAPPA_TS_VARIANTS],
                                  "adv_flow", "find_rho:LINEAR",
                                  "find_rho:JMD95Z", "find_rho:MDJWF",
                                  "sigma_r:LINEAR", "sigma_r:JMD95Z",
                                  "sigma_r:MDJWF"])
def test_mix_footprint(lib, numpy_sqrt, case):
    f = mix_fields(torch.float64, 900, *FOOTPRINT_SIZE)
    smoke = chip_smoke()
    kernel, _, variant = case.partition(":")
    if kernel == "kappa_uv":
        built, footprint = (kappa_uv_case(f, KAPPA_UV_MODES[variant]),
                            smoke.kappa_uv_footprint)
    elif kernel == "kappa_ts":
        built, footprint = (kappa_ts_case(f, variant),
                            smoke.kappa_ts_footprint)
    elif kernel == "adv_flow":
        built, footprint = adv_flow_case(f), smoke.adv_flow_footprint
    else:
        built = eos_case(f, variant, 2 if variant != "LINEAR" else 0,
                         sigma=kernel == "sigma_r")
        footprint = (smoke.sigma_r_footprint if kernel == "sigma_r"
                     else smoke.find_rho_footprint)
    check_footprint(lib, built, footprint, {}, same_as=check_same_cells)


# The step glue's backward kernels F', D', E', G', L' and R' (halo_adj.cuh,
# phihyd_adj.cuh, step_scans_adj.cuh, step_glue_adj.cuh, adv_flow.cuh,
# eos.cuh): every padded cell equal to the plain VJP's (ops/stencil.py:
# halo_fold_vjp_plain, model/phihyd.py:phihyd_vjp_plain, model/step.py:
# cg2d_rhs_vjp_plain, continuity_vjp_plain, mom_ab_step_vjp_plain,
# mom_correction_vjp_plain, model/thermodynamics.py:tracer_step_vjp_plain,
# model/gad.py:adv_flow_vjp_plain, ops/eos.py:eos_linear_vjp_plain) on
# both SIZES grids with 5 levels, float64 and float32, outputs NaN before
# the launch; AB-2 and AB-3 on the cold-start, second and a later step;
# tracer_step with and without AB; F' also on a 2-D field and on halos
# wider than the interior.
ADJ_CASES = ("halo_fold", "halo_fold(2-D)", "phihyd_adj", "cg2d_rhs_adj",
             "continuity_adj", "mom_correction_adj", "adv_flow_adj",
             "eos_linear_adj", "eos_linear_adj(no mask)",
             *[f"mom_ab_step_adj(AB-{o}, step {it})" for o in (2, 3)
               for it in (0, 1, 2)],
             *[f"tracer_step_adj(AB-{o}, step {it})" for o in (2, 3)
               for it in (0, 1, 2)], "tracer_step_adj(no AB)")
for _name, _args in {
        "host_halo_fold": [_P, _P] + [_I] * 5,
        "host_phihyd_adj": [_PP, _I] + [_I] * 3 + [_D] * 2,
        "host_cg2d_rhs_adj": [_PP, _I] + [_I] * 5 + [_D] * 4,
        "host_continuity_adj": [_PP, _I] + [_I] * 3,
        "host_mom_ab_step_adj": [_PP, _I] + [_I] * 4 + [_D] * 5,
        "host_mom_correction_adj": [_PP, _I] + [_I] * 3 + [_D],
        "host_tracer_step_adj": [_PP, _I] + [_I] * 5 + [_D] * 5,
        "host_adv_flow_adj": [_PP, _I] + [_I] * 3,
        "host_eos_linear_adj": [_PP, _I] + [_I] * 2 + [_D] * 3}.items():
    SIGNATURES[_name] = _args


def adj_fields(dtype, seed, ny, nx, nr=MIX_NR):
    """mix_fields with Bo_surf."""
    f = mix_fields(dtype, seed, ny, nx, nr)
    f.grid.Bo_surf = f.uniform(f.s3[1:], 5.0, 15.0)
    return f


def adj_cfg(f, ab3=False):
    """The gyre's configuration of f's size, AB-3 with ab3."""
    nr, nyp, nxp = f.s3
    kw = {"alph_AB": 0.5, "beta_AB": 5.0 / 12.0} if ab3 else {}
    cfg = synthetic.gyre_config(nx=nxp - 2 * OL, ny=nyp - 2 * OL, nr=nr,
                                **kw)
    assert cfg.useAB3 == ab3
    return cfg


def adj_case(f, name):
    """(want, run) of a backward kernel on f's grid: the plain VJP's
    outputs (None where the launch writes nothing) and run(lib), the
    launch's, each output NaN before it."""
    from mitgcm_tpu_torch.model import thermodynamics as th
    from mitgcm_tpu_torch.ops import eos, stencil

    g = f.grid
    nr, nyp, nxp = f.s3
    s2 = f.s3[1:]
    suf = SUFFIX[f.dtype]
    order = 3 if "AB-3" in name else 2
    it = int(name[-2]) if "step " in name else 1
    cfg = adj_cfg(f, ab3=order == 3)

    def nan(shape):
        return torch.full(shape, float("nan"), dtype=f.dtype)

    if name.startswith("halo_fold"):
        g3 = f.normal(s2 if "2-D" in name else f.s3)
        want = [stencil.halo_fold_vjp_plain(g3, OL, OL)]

        def run(lib):
            out = nan(g3.shape)
            assert getattr(lib, f"host_halo_fold_{suf}")(
                g3.data_ptr(), out.data_ptr(), g3.numel() // (nyp * nxp),
                nyp - 2 * OL, nxp - 2 * OL, OL, OL) == 0
            return [out]
        return want, run
    if name == "phihyd_adj":
        bars = [f.normal(f.s3) for _ in range(3)]
        want = [phihyd.phihyd_vjp_plain(cfg, g, *bars)]

        def run(lib):
            out = nan(f.s3)
            tab = table(bars + [g.drC, g.rF, g.rC, g.recip_dxC, g.recip_dyC,
                                out])
            assert getattr(lib, f"host_phihyd_adj_{suf}")(
                tab, len(tab), nr, nyp, nxp, cfg.gravity,
                1.0 / cfg.rhoConst) == 0
            return [out]
        return want, run
    if name == "cg2d_rhs_adj":
        b_bar = f.normal(s2)
        want = list(step.cg2d_rhs_vjp_plain(cfg, g, b_bar))

        def run(lib):
            outs = [nan(f.s3), nan(f.s3), nan(s2)]
            tab = table([b_bar, g.hFacW, g.hFacS, g.dyG, g.dxG, g.rA, g.drF]
                        + outs)
            assert getattr(lib, f"host_cg2d_rhs_adj_{suf}")(
                tab, len(tab), nr, nyp, nxp, OL, OL, cfg.implicDiv2Dflow,
                cfg.deltaTMom, cfg.freeSurfFac, cfg.deltaTFreeSurf) == 0
            return outs
        return want, run
    if name == "continuity_adj":
        w_bar, pm_bar = f.normal(f.s3), f.normal(s2)
        want = list(step.continuity_vjp_plain(cfg, g, w_bar, pm_bar))

        def run(lib):
            outs = [nan(f.s3), nan(f.s3), nan(s2)]
            tab = table([w_bar, g.maskC, g.hFacW, g.hFacS, g.dyG, g.dxG,
                         g.recip_rA, g.drF, pm_bar] + outs)
            assert getattr(lib, f"host_continuity_adj_{suf}")(
                tab, len(tab), nr, nyp, nxp) == 0
            return outs
        return want, run
    if name.startswith("mom_ab_step_adj"):
        bars = [f.normal(f.s3) for _ in range(4)]   # gu, uStar, gv, vStar
        want = list(step.mom_ab_step_vjp_plain(cfg, g, it, *bars))
        ab = step.ab_params(cfg, it)

        def run(lib):
            outs = [None if w is None else nan(f.s3) for w in want]
            tab = table([bars[1], bars[0], bars[3], bars[2], g.maskW,
                         g.maskS] + outs)
            assert getattr(lib, f"host_mom_ab_step_adj_{suf}")(
                tab, len(tab), nr, nyp, nxp, *ab, cfg.deltaTMom) == 0
            return outs
        return want, run
    if name == "mom_correction_adj":
        u_bar, v_bar = f.normal(f.s3), f.normal(f.s3)
        want = list(step.mom_correction_vjp_plain(cfg, g, u_bar, v_bar))

        def run(lib):
            outs = [nan(s2), nan(f.s3), nan(f.s3)]
            tab = table([u_bar, v_bar, g.maskW, g.maskS, g.Bo_surf,
                         g.recip_dxC, g.recip_dyC, outs[1], outs[2],
                         outs[0]])
            assert getattr(lib, f"host_mom_correction_adj_{suf}")(
                tab, len(tab), nr, nyp, nxp,
                cfg.deltaTMom * cfg.implicSurfPress) == 0
            return outs
        return want, run
    if name.startswith("tracer_step_adj"):
        use_ab = "no AB" not in name
        tr_bar = f.normal(f.s3)
        g_bar = f.normal(f.s3) if use_ab else None
        gTr, _, nm1, nm2, sfc = th.tracer_step_vjp_plain(
            cfg, g, it, use_ab, tr_bar, g_bar)
        want = [gTr, nm1, nm2, sfc]
        ab = step.ab_params(cfg, it, use_ab)

        def run(lib):
            outs = [None if w is None else nan(w.shape) for w in want]
            tab = table([tr_bar, g_bar, g.recip_hFacC[cfg.ksurf0],
                         g.recip_drF] + outs)
            assert getattr(lib, f"host_tracer_step_adj_{suf}")(
                tab, len(tab), nr, nyp, nxp, cfg.ksurf0, *ab,
                cfg.deltaTTracer) == 0
            return outs
        return want, run
    if name == "adv_flow_adj":
        bars = [f.normal(f.s3) for _ in range(4)]
        bars[2][0, 2, 5] = float("nan")    # reaches only maskUp's 0
        want = list(gad.adv_flow_vjp_plain(g, *bars))

        def run(lib):
            outs = [nan(f.s3) for _ in range(3)]
            tab = table(bars + [g.hFacW, g.hFacS, g.maskC, g.dyG, g.dxG,
                                g.rA, g.drF] + outs)
            assert getattr(lib, f"host_adv_flow_adj_{suf}")(
                tab, len(tab), nr, nyp, nxp) == 0
            return outs
        return want, run
    assert name.startswith("eos_linear_adj")
    mask = None if "no mask" in name else g.maskC
    rho_bar = f.normal(f.s3)
    want = list(eos.eos_linear_vjp_plain(cfg, rho_bar, mask))

    def run(lib):
        outs = [nan(f.s3), nan(f.s3)]
        tab = table([rho_bar, mask] + outs)
        assert getattr(lib, f"host_eos_linear_adj_{suf}")(
            tab, len(tab), nr, nyp * nxp, cfg.rhoNil, cfg.tAlpha,
            cfg.sBeta) == 0
        return outs
    return want, run


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ADJ_CASES)
def test_glue_adj(lib, ny, nx, dtype, name):
    f = adj_fields(DTYPES[dtype], 940 + nx + ADJ_CASES.index(name), ny, nx)
    want, run = adj_case(f, name)
    for k, (got, wanted) in enumerate(zip(run(lib), want)):
        if wanted is None:
            assert got is None
        else:
            check_same_cells(got, wanted, f"{name} output {k}")


@pytest.mark.parametrize("ny,nx,ol", [(3, 5, 4), (2, 6, 3), (4, 4, 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_halo_fold_wide_halo(lib, ny, nx, ol, dtype):
    """F' on halos as wide as or wider than the interior, 3 planes: the
    fold's blocks span the halo more than once."""
    from mitgcm_tpu_torch.ops import stencil

    f = Fields(DTYPES[dtype], 990 + ny, ny, nx, 3, ol)
    g3 = f.normal(f.s3)
    out = torch.full(f.s3, float("nan"), dtype=f.dtype)
    assert getattr(lib, f"host_halo_fold_{dtype}")(
        g3.data_ptr(), out.data_ptr(), 3, ny, nx, ol, ol) == 0
    check_same_cells(out, stencil.halo_fold_vjp_plain(g3, ol, ol),
                     "halo_fold")


def test_glue_adj_launch_refuses(lib):
    """Tables of the wrong length, missing inputs, an AB order of 1 or an
    AB-2 gNm2 output, a ksurf0 outside the levels, gNm1 without AB, no
    planes (cudaErrorInvalidValue, 1)."""
    f = adj_fields(torch.float64, 995, *SIZES[0])
    g = f.grid
    nr, nyp, nxp = f.s3
    x3 = torch.zeros(f.s3, dtype=torch.float64)
    x2 = torch.zeros(f.s3[1:], dtype=torch.float64)
    assert lib.host_halo_fold_f64(x3.data_ptr(), x3.data_ptr(), 0,
                                  nyp - 4, nxp - 4, OL, OL) == 1
    assert lib.host_halo_fold_f64(None, x3.data_ptr(), nr, nyp - 4,
                                  nxp - 4, OL, OL) == 1
    tab = table([x3] * 3 + [g.drC, g.rF, g.rC, g.recip_dxC, g.recip_dyC,
                            x3])
    assert lib.host_phihyd_adj_f64(tab, 8, nr, nyp, nxp, 9.81, 1e-3) == 1
    tab = table([x3] * 3 + [g.drC, None, g.rC, g.recip_dxC, g.recip_dyC,
                            x3])
    assert lib.host_phihyd_adj_f64(tab, 9, nr, nyp, nxp, 9.81, 1e-3) == 1
    tab = table([x2, g.hFacW, g.hFacS, g.dyG, g.dxG, g.rA, g.drF, x3, x3,
                 x2])
    assert lib.host_cg2d_rhs_adj_f64(tab, 9, nr, nyp, nxp, OL, OL, 1.0, 1.0,
                                     1.0, 1.0) == 1
    assert lib.host_cg2d_rhs_adj_f64(tab, 10, nr, nyp, nxp, OL, OL, 1.0,
                                     1.0, 1.0, 1.0) == 0
    tab = table([x3, g.maskC, g.hFacW, g.hFacS, g.dyG, g.dxG, g.recip_rA,
                 g.drF, None, x3, x3, x2])
    assert lib.host_continuity_adj_f64(tab, 12, nr, nyp, nxp) == 1
    tab = table([x3] * 4 + [g.maskW, g.maskS] + [x3] * 8)
    assert lib.host_mom_ab_step_adj_f64(tab, 14, nr, nyp, nxp, 1, 0.6, 0.0,
                                        0.0, 0.0, 1.0) == 1
    # AB-2 reads no gNm2: its cotangents are refused
    assert lib.host_mom_ab_step_adj_f64(tab, 14, nr, nyp, nxp, 2, 0.6, 0.0,
                                        0.0, 0.0, 1.0) == 1
    assert lib.host_mom_ab_step_adj_f64(tab, 14, nr, nyp, nxp, 3, 0.0, 1.0,
                                        1.0, 1.0, 1.0) == 0
    tab = table([x3, x3, g.maskW, g.maskS, None, g.recip_dxC, g.recip_dyC,
                 x3, x3, x2])
    assert lib.host_mom_correction_adj_f64(tab, 10, nr, nyp, nxp, 1.0) == 1
    tab = table([x3, x3, x2, g.recip_drF, x3, x3, None, x2])
    assert lib.host_tracer_step_adj_f64(tab, 8, nr, nyp, nxp, nr, 2, 0.6,
                                        0.0, 0.0, 0.0, 1.0) == 1
    assert lib.host_tracer_step_adj_f64(tab, 8, nr, nyp, nxp, 0, 0, 0.0,
                                        0.0, 0.0, 0.0, 1.0) == 1
    assert lib.host_tracer_step_adj_f64(tab, 8, nr, nyp, nxp, 0, 2, 0.6,
                                        0.0, 0.0, 0.0, 1.0) == 0
    tab = table([x3, x3, None, x3, g.hFacW, g.hFacS, g.maskC, g.dyG, g.dxG,
                 g.rA, g.drF, x3, x3, x3])
    assert lib.host_adv_flow_adj_f64(tab, 14, nr, nyp, nxp) == 1
    assert lib.host_eos_linear_adj_f64(table([None, None, x3, x3]), 4, nr,
                                       nyp * nxp, 1.0, 1.0, 1.0) == 1


# the wrappers whose kernel path the gradient test below takes on the CPU
GLUE_WRAPPERS = ("calc_phi_hyd", "mom_ab_step", "cg2d_rhs",
                 "momentum_correction_step", "integr_continuity",
                 "tracer_step", "calc_adv_flow", "find_rho",
                 "cyclic_fill_halo")
# the backward launches of the 6-step gradient (2 checkpointed chunks of 3):
# the tracer's step once a step; the rest once a step but the last, whose
# flow, pressure and free surface reach no later theta; F' once a fill
# whose result reaches the cost; chip_smoke.py:ADJ_LAUNCHES holds the
# card's run of the same gradient to them
ADJ_GLUE_LAUNCHES = {"halo_fold": 35, "tracer_step_adj": 6,
                     **{k: 5 for k in ("phihyd_adj", "cg2d_rhs_adj",
                                       "continuity_adj", "mom_ab_step_adj",
                                       "mom_correction_adj", "adv_flow_adj",
                                       "eos_linear_adj")}}


def test_gyre_gradient_through_glue_adj(lib, monkeypatch):
    """The 16x16x4 gyre's 6-step gradient on the CPU with the step glue's
    wrappers on their kernel path (kernels.KernelVJP; the fill's backward
    kernel F'): their forward kernels replaced by their twins, their
    backward kernels run on the mock. The gradient agrees with the plain
    path's to 13 digits or more in float64 (the backward kernels add in
    other orders than autograd through the twins), no kernels.TwinVJP
    backward and no plain fold runs, and each backward kernel is
    launched."""
    from mitgcm_tpu_torch.ad import adjoint
    from mitgcm_tpu_torch.model import thermodynamics as th
    from mitgcm_tpu_torch.ops import eos, stencil
    from mitgcm_tpu_torch.utils.compare import digits

    use_kernel = kernels.use_kernel

    def host_use_kernel(t, impl):
        if sys._getframe(1).f_code.co_name in GLUE_WRAPPERS:
            return impl != "plain"
        return use_kernel(t, impl)

    def host_launch(kernel, dtype, *args):
        err = getattr(lib, f"host_{kernel}_{SUFFIX[dtype]}")(*args)
        assert err == 0, f"{kernel}: error {err}"
        kernels.launches[kernel] += 1

    def check_tensors(dtype, **tensors):
        for name, t in tensors.items():
            assert t.dtype == dtype and t.is_contiguous(), name

    monkeypatch.setattr(kernels, "use_kernel", host_use_kernel)
    monkeypatch.setattr(kernels, "launch", host_launch)
    monkeypatch.setattr(kernels, "check_tensors", check_tensors)
    monkeypatch.setattr(phihyd, "_phi_hyd_kernel", phihyd._phi_hyd_plain)
    monkeypatch.setattr(step, "_cg2d_rhs_kernel", step._cg2d_rhs_plain)
    monkeypatch.setattr(step, "_continuity_kernel", step._continuity_plain)
    monkeypatch.setattr(step, "_mom_ab_step_kernel", step._mom_ab_step_plain)
    monkeypatch.setattr(step, "_mom_correction_kernel",
                        step._mom_correction_plain)
    monkeypatch.setattr(th, "_tracer_step_kernel", th._tracer_step_plain)
    monkeypatch.setattr(gad, "_calc_adv_flow_kernel",
                        gad._calc_adv_flow_plain)
    monkeypatch.setattr(eos, "_find_rho_kernel", lambda *a: (
        eos._find_rho_plain(*a),))
    monkeypatch.setattr(stencil, "_halo_fill", stencil._gather)

    cfg = synthetic.gyre_config(nx=16, ny=16, nr=4, n_steps=6)
    grid, state, forcing, op = synthetic.gyre_setup(
        cfg, dtype=torch.float64, device="cpu")
    control = adjoint.Control(cfg, grid, field="theta")
    cost = adjoint.cost_boxmean_tracer(cfg, grid, "theta", box=(8, 12, 8, 12),
                                       k_range=(0, 2))
    grads = {}
    for impl in ("plain", None):
        J = adjoint.make_objective(cfg, grid, op, forcing, state, control,
                                   cost, 6, impl=impl)
        kernels.launches.clear()
        folds = stencil.plain_folds
        grads[impl] = adjoint.adjoint_gradient(J, control.zero())
        launches = dict(kernels.launches)
    assert stencil.plain_folds == folds
    assert not any(k.startswith("twin_vjp") for k in launches)
    for name in ("halo_fold", "phihyd_adj", "cg2d_rhs_adj",
                 "continuity_adj", "mom_ab_step_adj", "mom_correction_adj",
                 "tracer_step_adj", "adv_flow_adj", "eos_linear_adj"):
        assert launches.get(name, 0) == ADJ_GLUE_LAUNCHES.get(name, -1), name
    (c0, g0), (c1, g1) = grads["plain"], grads[None]
    assert float(c0) == float(c1)
    dig = digits(g1.numpy(), g0.numpy())
    assert dig >= 13.0, f"{dig:.2f} digits"


# ---------------------------------------------------------------------------
# The last glue: E's cg2d_rhs (the non-hydrostatic variant with pre_cg3d's
# surface term), G's mom_ab_step with the 2-D forcing, N1 (pre_cg3d), N2
# (cg3d_setup_scale, _fill), Q (surface_forcing), S1
# (seaice_dynforcing), S2 (seaice_ocean_stress) and the `+ gTr` addend of
# the last sweep of M, O, P and H-SOM. Each runs through its wrapper's
# kernel path on CPU tensors, the launch on the mock (`on_mock`), against
# the same wrapper with impl="plain" (the twin), every padded cell equal,
# NaN in the same cells, in float64 and float32.
# ---------------------------------------------------------------------------
_SWEEP_KERNEL = re.compile(r"(gad_multidim|gad_os7mp|gad_ppm|som)_([xyr])")


@pytest.fixture
def on_mock(lib, monkeypatch):
    """The wrappers' kernel path for CPU tensors (impl=None; "plain" runs
    the twins), each launch on the mock through the host entry point of
    its kernel (the sweeps' with their direction first, H-cg3d's passes
    with their pointers as a table); the halo fill as the gather."""
    from mitgcm_tpu_torch.ops import stencil

    def use_kernel(t, impl=None):
        if impl not in (None, "plain"):
            raise ValueError(impl)
        return impl is None

    def launch(kernel, dtype, *args):
        suf = SUFFIX[dtype]
        sweep = _SWEEP_KERNEL.fullmatch(kernel)
        if sweep:
            err = getattr(lib, f"host_{sweep[1]}_{suf}")(
                "xyr".index(sweep[2]), *args)
        elif kernel in ("cg3d_s_stencil_dot", "cg3d_xr_precond"):
            n = 15 if kernel == "cg3d_s_stencil_dot" else 18
            tab = (ctypes.c_void_p * n)(*args[:n])
            extra = () if n == 15 else (1 << 30,)
            err = getattr(lib, f"host_{kernel}_{suf}")(tab, n, *args[n:],
                                                        *extra)
        else:
            err = getattr(lib, f"host_{kernel}_{suf}")(*args)
        assert err == 0, f"{kernel}: error {err}"
        kernels.launches[kernel] += 1

    def check_tensors(dtype, **tensors):
        for name, t in tensors.items():
            assert t.dtype == dtype and t.is_contiguous(), name

    def check_int32(name, t, shape):
        assert t.dtype == torch.int32 and t.is_contiguous(), name
        assert tuple(t.shape) == tuple(shape), name

    host = SimpleNamespace(mitgcm_cg2d_num_partials=lambda ny, nx: (
        (nx + 31) // 32) * ((ny + 7) // 8))
    monkeypatch.setattr(kernels, "use_kernel", use_kernel)
    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(kernels, "check_tensors", check_tensors)
    monkeypatch.setattr(kernels, "check_int32", check_int32)
    monkeypatch.setattr(kernels, "library", lambda: host)
    monkeypatch.setattr(stencil, "_halo_fill", stencil._gather)
    kernels.launches.clear()
    return kernels.launches


def check_outputs(got, want, label):
    """Each output (None where the twin forms none) equal on every padded
    cell, NaN in the same cells."""
    assert len(got) == len(want), label
    for n, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), f"{label} output {n}"
        if g is not None:
            check_same_cells(g, w, f"{label} output {n}")


def last_fields(dtype, seed, ny, nx, nr=MIX_NR):
    """Fields with kSurfC from hFacC (a dry column's nr + 1; one column
    dry and one whose surface is the bottom level forced), recip_Bo and
    Bo_surf."""
    f = Fields(dtype, seed, ny, nx, nr)
    g = f.grid
    wet = g.hFacC != 0.0
    first = torch.argmax(wet.to(torch.int64), dim=0) + 1
    ks = torch.where(wet.any(dim=0), first, torch.full_like(first, nr + 1))
    ks[3, 4] = nr + 1
    ks[2, 5] = nr
    g.kSurfC = ks.to(dtype)
    g.Bo_surf = f.uniform(f.s3[1:], 5.0, 15.0)
    g.recip_Bo = 1.0 / g.Bo_surf
    return f


def glue_cfg(nr, **kw):
    return SimpleNamespace(
        nr=nr, oly=OL, olx=OL, implicDiv2Dflow=0.8, implicSurfPress=0.9,
        deltaTMom=600.0, freeSurfFac=1.0, deltaTFreeSurf=900.0, **kw)


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hydrostatic", (True, False))
def test_cg2d_rhs_surf_term(lib, on_mock, ny, nx, dtype, hydrostatic):
    """E's cg2d_rhs: the non-hydrostatic variant adds pre_cg3d's surface
    term (etaN + phi_nh at kSurfC - 1 over Bo) to the right-hand side and
    to the divergence of the surface level, a dry column's sum +0, a -0.0
    phi_nh at a surface level."""
    f = last_fields(DTYPES[dtype], 900 + nx, ny, nx)
    cfg = glue_cfg(MIX_NR)
    s2 = f.s3[1:]
    u, v, phi = f.normal(f.s3, 0.1), f.normal(f.s3, 0.1), f.normal(f.s3)
    phi[MIX_NR - 1, 2, 5] = -0.0         # the surface level of (2, 5)
    eta = f.normal(s2, 0.1)
    eta[2, 5] = 0.0

    def run(impl):
        return list(step.cg2d_rhs(cfg, f.grid, u, v, eta,
                                  hydrostatic=hydrostatic, impl=impl,
                                  phi_nh=None if hydrostatic else phi))
    check_outputs(run(None), run("plain"), f"cg2d_rhs {hydrostatic}")
    assert on_mock["cg2d_rhs"] == 1


# (configuration, iteration): AB-2 on the cold start and later, AB-3 on
# the cold start, the second and a later step, the box's non-hydrostatic
# AB-2
MOM_AB_CASES = {"AB-2 cold start": ("gyre", 0), "AB-2": ("gyre", 1),
                "AB-3 cold start": ("vi", 0), "AB-3 second": ("vi", 1),
                "AB-3": ("vi", 2), "non-hydrostatic": ("nh", 1)}


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MOM_AB_CASES)
def test_mom_ab_step_2d_forcing(lib, on_mock, ny, nx, dtype, case):
    """G's mom_ab_step reads the wind stress's surface level [nyp, nxp]
    and adds +0 below it, as the twin's 3-D forcing: a -0.0 tendency below
    the surface comes out +0.0."""
    from mitgcm_tpu_torch.model.mom_fluxform import MomTend

    kind, it = MOM_AB_CASES[case]
    f = last_fields(DTYPES[dtype], 920 + nx, ny, nx)
    make = {"gyre": synthetic.gyre_config, "vi": synthetic.vi_gyre_config,
            "nh": synthetic.nh_convection_config}[kind]
    cfg = make(nx=nx, ny=ny, nr=MIX_NR)
    s2 = f.s3[1:]
    t = {k: f.normal(f.s3, 1e-4) for k in (
        "gU", "gV", "guDiss", "gvDiss", "dPhiX", "dPhiY", "guNm1", "gvNm1",
        "guNm2", "gvNm2", "gW", "gwDiss", "gwNm1", "gwNm2")}
    t["gU"][2, 3, 4], t["dPhiX"][2, 3, 4], t["guDiss"][2, 3, 4] = (
        -0.0, 0.0, -0.0)
    state = SimpleNamespace(
        uVel=f.normal(f.s3, 0.1), vVel=f.normal(f.s3, 0.1),
        wVel=f.normal(f.s3, 1e-3), **{k: t[k] for k in (
            "guNm1", "gvNm1", "guNm2", "gvNm2", "gwNm1", "gwNm2")})
    tend = MomTend(t["gU"], t["gV"], t["guDiss"], t["gvDiss"])
    ext = f.normal(s2, 1e-5), f.normal(s2, 1e-5)
    gw = (t["gW"], t["gwDiss"]) if kind == "nh" else None

    def run(impl):
        out = step.mom_ab_step(cfg, f.grid, state, tend, t["dPhiX"],
                               t["dPhiY"], *ext, it, impl=impl, gw=gw)
        return list(out[:4]) + ([out[6]["wStar"], out[6]["gwNm1"]]
                                if gw else [])
    got = run(None)
    check_outputs(got, run("plain"), case)
    assert math.copysign(1.0, float(got[2][2, 3, 4])) == 1.0   # guNm1
    assert on_mock["mom_ab_step"] == 1


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pre_cg3d(lib, on_mock, ny, nx, dtype):
    """N1: the cg3d right-hand side from each level's divergence, the
    correction flow of the cg2d solution and w*'s vertical transport."""
    f = last_fields(DTYPES[dtype], 940 + nx, ny, nx)
    cfg = glue_cfg(MIX_NR)
    s2 = f.s3[1:]
    x2, eta = f.normal(s2, 10.0), f.normal(s2, 0.1)
    w, div = f.normal(f.s3, 1e-3), f.normal(f.s3, 1e-2)

    def run(impl):
        return [step.pre_cg3d(cfg, f.grid, x2, eta, w, div, impl=impl)]
    check_outputs(run(None), run("plain"), "pre_cg3d")
    assert on_mock["pre_cg3d"] == 1


# the right-hand sides of N2's cases: a random one with and without the
# normalisation, one of zeros (rhsMax 0, rhsNorm 1) and one with a NaN
CG3D_SETUP_CASES = ("normalise", "no normalise", "rhsMax 0", "NaN")


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CG3D_SETUP_CASES)
def test_cg3d_setup(lib, on_mock, ny, nx, dtype, case):
    """N2: cg3d_setup_scale and _fill against the twin (r, x, the four
    zero work fields, rhsNorm on the device; x divided by it at the
    solve's end as by the twin's)."""
    from mitgcm_tpu_torch.ops.stencil import interior_mask

    f = last_fields(DTYPES[dtype], 960 + nx, ny, nx)
    g = f.grid
    imask3 = interior_mask(f.s3, OL, OL, f.dtype, "cpu") * g.maskC
    op = SimpleNamespace(cg3dNorm=f.tensor(3.7e-3), imask3=imask3)
    b = f.normal(f.s3, 50.0)
    if case == "rhsMax 0":
        b.zero_()
    if case == "NaN":
        b[1, 0, 3] = float("nan")        # a halo cell: masked, still NaN
    x0 = f.normal(f.s3, 1.0)
    normalise = case != "no normalise"
    want = cg3d._setup_plain(op, b, x0, normalise)
    ws = cg3d.Workspace(f.s3, OL, OL, f.dtype, "cpu")
    got = cg3d._setup_kernel(op, b, x0, normalise, ws)
    check_outputs(got[:6], want[:6], case)
    if not normalise:
        assert got[6] is None and want[6] is None
        return
    check_same_cells(got[6].reshape(()), want[6], "rhsNorm")
    check_same_cells(got[1] / got[6], want[1] / want[6], "x / rhsNorm")
    assert int(ws.counter) == 0


@pytest.fixture(scope="module")
def nh_box():
    """{dtype: (cfg, grid, cg3d operator)} of the 16x16x12 box, a solve
    capped at 6 iterations."""
    cfg = synthetic.nh_convection_config(nx=16, ny=16, nr=12)
    cfg = dataclasses.replace(cfg, cg3dMaxIters=6)
    boxes = {}
    for name, dtype in DTYPES.items():
        grid, _, _, _, op3 = synthetic.nh_convection_setup(
            cfg, dtype=dtype, device="cpu")
        boxes[name] = cfg, grid, op3
    return boxes


@pytest.mark.parametrize("dtype", DTYPES)
def test_cg3d_solve_setup_on_mock(lib, nh_box, on_mock, monkeypatch,
                                  dtype):
    """A cg3d solve of the 16x16x12 box on the kernel path (N2 and H-cg3d
    on the mock, its control words on the CPU) against the plain path: the
    solution, the residuals and the iterations equal, the solve's set-up
    and end three launches."""
    monkeypatch.setattr(cg3d, "_check_ctrl", lambda ctrl: None)
    cfg, grid, op3 = nh_box[dtype]
    rng = np.random.default_rng(980)
    b = torch.as_tensor(rng.standard_normal(grid.hFacC.shape),
                        dtype=DTYPES[dtype])
    x0 = torch.as_tensor(rng.standard_normal(grid.hFacC.shape),
                         dtype=DTYPES[dtype])
    res = {impl: cg3d.cg3d(cfg, grid, op3, b, x0, impl=impl)
           for impl in (None, "plain")}
    check_same_cells(res[None].x, res["plain"].x, "x")
    for name in ("first_residual", "last_residual"):
        check_same_cells(getattr(res[None], name),
                         getattr(res["plain"], name), name)
    assert res[None].n_iters == res["plain"].n_iters == 6
    assert (on_mock["cg3d_setup_scale"], on_mock["cg3d_setup_fill"]) \
        == (1, 1)


# Q's flag variants: (relaxation of theta, of salt, the sea ice's open
# fraction, E-P-R of theta, of salt, the surface stress written for KPP)
FORCING_CASES = {"fluxes": (False, False, False, False, False, False),
                 "fluxes, KPP": (False, False, False, False, False, True),
                 "relaxation": (True, True, False, False, False, False),
                 "relaxation under ice": (True, True, True, False, False,
                                          True),
                 "theta's relaxation under ice": (True, False, True, False,
                                                  False, False),
                 "E-P-R": (False, False, False, True, True, False),
                 "every term": (True, True, True, True, True, True)}


def forcing_cfg(relaxT, relaxS, evT, evS, tau):
    return SimpleNamespace(
        ksurf0=0, tauThetaClimRelax=86400.0 * 30 if relaxT else 0.0,
        tauSaltClimRelax=86400.0 * 60 if relaxS else 0.0,
        HeatCapacity_Cp=3994.0, mass2rUnit=1.0 / 1035.0,
        temp_EvPrRn=0.5 if evT else None, salt_EvPrRn=0.0 if evS else None,
        tRef=[14.0], convertFW2Salt=35.0, useKPP=tau, useGGL90=False)


def forcing_args(f, ice):
    """Q's twin's arguments after the grid: theta, salt, AREA (with ice)
    and FORCING_INPUTS, two fluxes with a -0.0 cell."""
    s2 = f.s3[1:]
    forcing = [f.normal(s2, 1.0) + 10.0, f.normal(s2, 1.0) + 34.0,
               f.normal(s2, 100.0), f.normal(s2, 1e-4),
               f.normal(s2, 1e-5), f.normal(s2, 0.1), f.normal(s2, 0.1)]
    forcing[2][3, 3] = forcing[3][4, 4] = -0.0
    return [f.uniform(f.s3, -2.0, 20.0), f.uniform(f.s3, 33.0, 36.0),
            f.uniform(s2, 0.0, 1.0) if ice else None, *forcing]


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FORCING_CASES)
def test_surface_forcing(lib, on_mock, ny, nx, dtype, case):
    """Q: sfT, sfS, the surface stress (KPP's paths only) and the momentum
    forcing's surface level in each flag variant, -0.0 fluxes included."""
    from mitgcm_tpu_torch.model import thermodynamics as th

    relaxT, relaxS, ice, evT, evS, tau = FORCING_CASES[case]
    f = last_fields(DTYPES[dtype], 1000 + nx, ny, nx)
    cfg = forcing_cfg(relaxT, relaxS, evT, evS, tau)
    args = forcing_args(f, ice)
    got = th._surface_forcing_kernel(cfg, f.grid, *args)
    want = th._surface_forcing_plain(cfg, f.grid, *args)
    assert (got.tauU is None) == (not tau)
    check_outputs(list(got), list(want), case)
    assert on_mock["surface_forcing"] == 1


@pytest.mark.parametrize("relaxed", (True, False))
def test_surface_forcing_grad_through_twin(lib, on_mock, relaxed):
    """Q under kernels.TwinVJP: with the relaxation, theta and salt under
    a control get the plain path's gradient bit for bit, the twin's VJP
    run once; without it the tracers are not Q's inputs, and a theta that
    requires grad runs no twin."""
    from mitgcm_tpu_torch.model import thermodynamics as th

    f = last_fields(torch.float64, 1040, *SIZES[0])
    cfg = SimpleNamespace(**forcing_cfg(relaxed, relaxed, True, True,
                                        True).__dict__, useSEAICE=False)
    theta, salt, _, *forc = forcing_args(f, False)
    state = SimpleNamespace(theta=theta, salt=salt, siAREA=None)
    forcing = SimpleNamespace(**dict(zip(th.FORCING_INPUTS, forc)))
    w = [f.normal(f.s3[1:]) for _ in th.SurfaceForcing._fields]
    before = kernels.launches["twin_vjp"]
    grads = {}
    for impl in (None, "plain"):
        xs = [theta.clone().requires_grad_(True),
              salt.clone().requires_grad_(True)]
        st = SimpleNamespace(**{**state.__dict__, "theta": xs[0],
                                "salt": xs[1]})
        sf = th.surface_forcing(cfg, f.grid, st, forcing, impl=impl)
        loss = sum((o * wo).sum() for o, wo in zip(sf, w))
        assert loss.requires_grad == relaxed
        if relaxed:
            grads[impl] = torch.autograd.grad(loss, xs)
    assert on_mock["surface_forcing"] == 1
    assert kernels.launches["twin_vjp"] - before == int(relaxed)
    if relaxed:
        for g, w_ in zip(grads[None], grads["plain"]):
            check_same_cells(g, w_, "grad")
            assert bool(g.abs().sum() > 0)


def ice_case(dtype, seed, ny, nx, nml=None):
    """The ice-gyre's SeaIce on its walled grid with seeded ice and ocean
    (as evp_uv_case), the EVP settings of nml on top."""
    cfg = synthetic.evp_ice_gyre_config(nx=nx, ny=ny, nr=4, deltaT=600.0)
    cfg = dataclasses.replace(cfg, sNy=ny // 2, nSy=2)
    grid = synthetic.gyre_grid(cfg, dtype=dtype, device="cpu")
    si = seaice.SeaIce(cfg, grid, seaice.params_from_namelists(
        cfg, {**synthetic.ICE_GYRE_SEAICE, **(nml or {})}))
    rng = np.random.default_rng(seed)
    shape = tuple(grid.rA.shape)

    def fld(lo, hi, mask=None):
        a = torch.as_tensor(rng.uniform(lo, hi, shape), dtype=dtype)
        return a * mask if mask is not None else a

    hm = si.HEFFM
    ice = si.init_state()._replace(
        AREA=fld(0.0, 1.0, hm), HEFF=fld(0.0, 3.0, hm),
        HSNOW=fld(0.0, 0.4, hm), uIce=fld(-0.6, 0.6, si.seaiceMaskU),
        vIce=fld(-0.6, 0.6, si.seaiceMaskV))
    ice.HEFF[4, ::2] = 0.0           # cells without ice mass
    ocean = dict(uVel0=fld(-0.3, 0.3), vVel0=fld(-0.3, 0.3),
                 fu=fld(-0.2, 0.2), fv=fld(-0.2, 0.2),
                 etaN=fld(-0.5, 0.5))
    return si, ice, ocean, fld


# S1's flags: (SEAICEaddSnowMass, SEAICEscaleSurfStress, SEAICEuseTilt,
# EVP's masks)
DYNFORCING_CASES = {"ice-gyre": None, "no snow": (False, True, True, False),
                    "no stress scaling": (True, False, True, False),
                    "no tilt": (True, True, False, False),
                    "EVP": (True, True, True, True),
                    "bare EVP": (False, False, False, True)}


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DYNFORCING_CASES)
def test_seaice_dynforcing(lib, on_mock, libm_math, ny, nx, dtype, case):
    """S1: the step's set-up in each flag variant (the twin's exp libm's,
    as the kernel's on the host)."""
    si, ice, ocean, _ = ice_case(DTYPES[dtype], 1020 + nx, ny, nx)
    flags = DYNFORCING_CASES[case]
    evp = False
    if flags is not None:
        snow, scale, tilt, evp = flags
        si.p = dataclasses.replace(si.p, addSnowMass=snow,
                                   scaleSurfStress=scale, useTilt=tilt)

    def run(impl):
        d = si.dynforcing(ice, ocean["fu"], ocean["fv"], ocean["etaN"], evp,
                          impl=impl)
        return [d[k] for k in seaice.DYNFORCING_OUT[:11 + 2 * evp]]
    check_outputs(run(None), run("plain"), case)
    assert on_mock["seaice_dynforcing"] == 1


# S2's variants: (ocean stress mode, the no-dynamics drag, EVP's clip)
OCEAN_STRESS_CASES = {"LSR": (1, False, False),
                      "no dynamics": (1, True, False),
                      "EVP with clip": (1, False, True),
                      "HB87": (2, False, False),
                      "HB87 with clip": (2, False, True),
                      "clip alone": (0, False, True)}


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", OCEAN_STRESS_CASES)
def test_seaice_ocean_stress(lib, on_mock, libm_math, ny, nx, dtype, case):
    """S2: the ocean stress (with the drag formed where it is read without
    the dynamics; HB87's) and EVP's clip, velocities beyond the clip's
    0.4 m/s and a NaN ice velocity in the clip."""
    mode, drag, clip = OCEAN_STRESS_CASES[case]
    si, ice, ocean, fld = ice_case(DTYPES[dtype], 1040 + nx, ny, nx)
    if mode == 0:
        ice.uIce[5, 6] = float("nan")
    dwatn = None if drag else fld(0.0, 5.0, si.HEFFM)
    extra = dict(windTau=(fld(-0.2, 0.2), fld(-0.2, 0.2)),
                 stressDiv=(fld(-0.1, 0.1), fld(-0.1, 0.1)))

    def run(impl):
        return list(si.ocean_stress(ice, dwatn, ocean["uVel0"],
                                    ocean["vVel0"], ocean["fu"], ocean["fv"],
                                    mode=mode, drag=drag, clip=clip,
                                    impl=impl, **extra))
    check_outputs(run(None), run("plain"), case)
    assert on_mock["seaice_ocean_stress"] == 1


# the last sweep's addend: (owner, scheme, vertical scheme, halo)
ADDEND_CASES = {"M": (33, 33, OL), "M, vertical 2": (33, 2, OL),
                "O": (7, 7, O_OL), "P": (51, 51, O_OL), "P 41": (41, 41, O_OL)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ADDEND_CASES)
def test_multidim_addend(lib, on_mock, dtype, case):
    """The R sweep of M, O and P adds gTr as it writes gTracer: the
    advection's gTracer + gTr equal to the twin's sum, the X and Y sweeps
    refusing an addend."""
    scheme, vert, ol = ADDEND_CASES[case]
    f = Fields(DTYPES[dtype], 1060 + scheme + vert, 12, 20, 4, ol)
    want, named, _, _ = sweep_case(f, "gad_multidim", 0, 33)
    g = f.grid
    cfg = SimpleNamespace(rkSign=-1.0)
    flow = gad.AdvFlow(
        uTrans=named["uTrans"], vTrans=named["vTrans"],
        rTrans=named["rTrans"],
        rTransKp=torch.cat([named["rTrans"][1:],
                            torch.zeros_like(named["rTrans"][:1])]),
        maskUp=g.maskC, xA=g.maskW, yA=g.maskS)
    gTr = f.normal(f.s3, 1e-4)
    gTr[1, 2, 3] = -0.0

    def run(impl):
        return [gad.multidim_advection(
            cfg, g, flow, named["uVel"], named["vVel"], named["wVel"],
            named["tracer"], scheme, vert, 600.0, impl=impl, add=gTr)]
    check_outputs(run(None), run("plain"), case)
    r_sweep = gad.sweep_name(vert, "r")
    assert on_mock[r_sweep] == 1
    tab = table([named[n] for n in named if n not in ("localX", "localY")])
    out = torch.empty(f.s3, dtype=f.dtype)
    owner = r_sweep.rsplit("_", 1)[0]
    for d in (0, 1):
        assert getattr(lib, f"host_{owner}_{dtype}")(
            d, tab, len(tab), named["tracer"].data_ptr(), out.data_ptr(),
            gTr.data_ptr(), *f.s3, scheme, 600.0, -1.0) == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scheme", (80, 81))
def test_som_addend(lib, on_mock, dtype, scheme):
    """som_r adds gTr as it writes gTracer (gSom + gTr), som_x and som_y
    refusing an addend."""
    f = Fields(DTYPES[dtype], 1080 + scheme, 12, 20)
    _, named, _, _ = som_case(f, "som_x", scheme)
    cfg = SimpleNamespace(nx=20, ny=12, olx=OL, oly=OL, nFaces=1)
    gTr = f.normal(f.s3, 1e-4)

    def run(impl):
        return list(som.som_advect(cfg, f.grid, named["uVel"], named["vVel"],
                                   named["wVel"], named["tracer"],
                                   named["smTr"], scheme, 600.0, impl=impl,
                                   add=gTr))
    check_outputs(run(None), run("plain"), f"som {scheme}")
    assert on_mock["som_r"] == 1


def test_last_glue_launches_refuse(lib):
    """Each new launch refuses a table of the wrong length, a missing
    input its variant reads and an unknown flag or variant
    (cudaErrorInvalidValue, 1)."""
    f = last_fields(torch.float64, 1100, 12, 20)
    nr, nyp, nxp = f.s3
    a = f.normal(f.s3)

    def tab(n, null=()):
        return table([None if k in null else a for k in range(n)])
    d = (ctypes.c_double * 9)(*([1.0] * 9))
    # E: 14 pointers; the non-hydrostatic variant needs div, phi_nh,
    # kSurfC and recip_Bo
    assert lib.host_cg2d_rhs_f64(tab(13), 13, nr, nyp, nxp, OL, OL, 1,
                                 1.0, 1.0, 1.0, 1.0) == 1
    assert lib.host_cg2d_rhs_f64(tab(14, (12,)), 14, nr, nyp, nxp, OL, OL,
                                 0, 1.0, 1.0, 1.0, 1.0) == 1
    assert lib.host_cg2d_rhs_f64(tab(14, (12,)), 14, nr, nyp, nxp, OL, OL,
                                 1, 1.0, 1.0, 1.0, 1.0) == 0
    # G: 28 pointers, AB order 2 or 3
    assert lib.host_mom_ab_step_f64(tab(27), 27, nr, nyp, nxp, 2, 0, 0.5,
                                    0.0, 0.0, 0.0, 600.0, 0.0) == 1
    assert lib.host_mom_ab_step_f64(tab(28), 28, nr, nyp, nxp, 4, 0, 0.5,
                                    0.0, 0.0, 0.0, 600.0, 0.0) == 1
    # N1: 14 pointers, none null
    assert lib.host_pre_cg3d_f64(tab(13), 13, nr, nyp, nxp, 1.0, 1.0, 1.0,
                                 1.0) == 1
    assert lib.host_pre_cg3d_f64(tab(14, (3,)), 14, nr, nyp, nxp, 1.0, 1.0,
                                 1.0, 1.0) == 1
    # N2: 13 pointers; the normalisation needs its scratch and scal
    for name in ("scale", "fill"):
        fn = getattr(lib, f"host_cg3d_setup_{name}_f64")
        assert fn(tab(12), 12, nr, nyp, nxp, 0) == 1
        assert fn(tab(13, (12,)), 13, nr, nyp, nxp, 1) == 1
    # Q: 21 pointers, 6 parameters, flags 0-31, relaxation needs theta,
    # the surface stress tauU
    assert lib.host_surface_forcing_f64(tab(20), 20, d, 6, nyp, nxp, 0) == 1
    assert lib.host_surface_forcing_f64(tab(21), 21, d, 5, nyp, nxp, 0) == 1
    assert lib.host_surface_forcing_f64(tab(21), 21, d, 6, nyp, nxp, 32) == 1
    assert lib.host_surface_forcing_f64(tab(21, (17,)), 21, d, 6, nyp, nxp,
                                        16) == 1
    assert lib.host_surface_forcing_f64(tab(21, (0,)), 21, d, 6, nyp, nxp,
                                        1) == 1
    # S1: 26 pointers, 9 parameters, flags 0-15, EVP needs its masks
    assert lib.host_seaice_dynforcing_f64(tab(25), 25, d, 9, nyp, nxp,
                                          0) == 1
    assert lib.host_seaice_dynforcing_f64(tab(26), 26, d, 8, nyp, nxp,
                                          0) == 1
    assert lib.host_seaice_dynforcing_f64(tab(26, (24,)), 26, d, 9, nyp, nxp,
                                          8) == 1
    # S2: 21 pointers, 7 parameters; no stress without the clip, the drag
    # only with mode 1, mode 1 without dwatn only with the drag
    assert lib.host_seaice_ocean_stress_f64(tab(20), 20, d, 7, nyp, nxp, 1,
                                            0) == 1
    assert lib.host_seaice_ocean_stress_f64(tab(21), 21, d, 7, nyp, nxp, 0,
                                            0) == 1
    assert lib.host_seaice_ocean_stress_f64(tab(21), 21, d, 7, nyp, nxp, 2,
                                            2) == 1
    assert lib.host_seaice_ocean_stress_f64(tab(21, (4,)), 21, d, 7, nyp,
                                            nxp, 1, 0) == 1
    assert lib.host_seaice_ocean_stress_f64(tab(21), 21, d, 7, nyp, nxp, 3,
                                            0) == 1


# ---------------------------------------------------------------------------
# Kernels X (mom_calc_visc) and Y (mom_del2uv) and B's and V's dissipation
# variants (mom_fluxform_visc, mom_vecinv_visc, mom_visc.cuh and the tile
# headers): each wrapper's kernel path on the mock (`on_mock`) against the
# same wrapper with impl="plain", X and Y on every padded cell (NaN in the
# same cells), B and V on the interior with zero halo outputs, float64 and
# float32 on both SIZES grids with halos of 4, the twins' sqrt numpy's
# (correctly rounded, as the kernels'). The random grid's land and partial
# cells close corners, where the vorticity and strain take sideMaskFac; the
# configuration's viscAh is 0 and its time step 5 s, so that on the random
# grid's unit metrics the nonlinear viscosities, the grid caps and the
# Reynolds floors are all of one size and each limit binds somewhere.
# ---------------------------------------------------------------------------
VOL = 4
VISC_OFF = dict(viscC2smag=0.0, viscC2leith=0.0, viscC2leithD=0.0,
                viscC4leith=0.0, viscC4leithD=0.0, viscAhGridMax=1.0e21,
                viscA4GridMax=1.0e21, viscAhReMax=0.0, viscA4ReMax=0.0)
# X's variants: (Smagorinsky, Leith, full Leith, Reynolds limits,
# biharmonic output) over the visc-gyre's settings
VISC_VARIANTS = {
    "visc-gyre": {},
    "full leith": dict(useFullLeith=True),
    "smagorinsky, no biharmonic": {**VISC_OFF, "viscC2smag": 2.2},
    "smagorinsky 4, reynolds": {**VISC_OFF, "viscC2smag": 2.2,
                                "viscC4smag": 2.0, "viscAhReMax": 10.0,
                                "viscA4ReMax": 10.0},
    "grid, free slip": {**VISC_OFF, "viscAhGrid": 0.02, "viscA4Grid": 0.005,
                        "viscAhGridMin": 0.001, "viscA4GridMin": 0.0005,
                        "viscAhMax": 0.03, "no_slip_sides": False},
}


def visc_case(dtype, seed, ny, nx, vi=False, **settings):
    """(cfg, grid, u, v, w, kappaRU, kappaRV) of the visc-gyre's (or
    visc-vi-gyre's) configuration on a random grid with halos of 4."""
    f = Fields(dtype, seed, ny, nx, NR, VOL)
    g = f.grid
    g.rAz = f.uniform(f.s3[1:], 0.5, 2.0)
    g.recip_rAz = 1.0 / g.rAz
    g.fCoriG = f.uniform(f.s3[1:], -1.5, 1.5)
    config = synthetic.visc_vi_gyre_config if vi else \
        synthetic.visc_gyre_config
    cfg = dataclasses.replace(config(nx=nx, ny=ny, nr=NR, deltaT=5.0),
                              **{"viscAh": 0.0, "viscAhD": 0.0,
                                 "viscAhZ": 0.0, **settings})
    amp = f.tensor(10.0 ** f.rng.uniform(-3.0, -0.5, f.s3))
    u = f.normal(f.s3) * amp * g.maskW
    v = f.normal(f.s3) * amp * g.maskS
    w = f.normal(f.s3, 1e-2) * g.maskC
    kshape = (NR + 1,) + f.s3[1:]
    kRU, kRV = f.normal(kshape, 1e-2).abs(), f.normal(kshape, 1e-2).abs()
    return cfg, g, (u, v, w, kRU, kRV)


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VISC_VARIANTS)
def test_mom_calc_visc(lib, on_mock, numpy_sqrt, ny, nx, dtype, variant):
    """X's four outputs (two without biharmonic viscosity) on every padded
    cell; the launch count."""
    from mitgcm_tpu_torch.model import mom_visc

    cfg, g, (u, v, *_) = visc_case(DTYPES[dtype], 700 + nx, ny, nx,
                                   **VISC_VARIANTS[variant])
    got = mom_visc.calc_visc(cfg, g, u, v)
    want = mom_visc.calc_visc(cfg, g, u, v, impl="plain")
    assert on_mock["mom_calc_visc"] == 1
    check_outputs(list(got), list(want), f"calc_visc({variant})")
    if variant == "visc-gyre":
        scales = mom_visc.length_scales(cfg, g)
        cap = (0.25 / cfg.deltaTMom * scales["L2_D"])[VOL:-VOL, VOL:-VOL]
        AhD = got[1][:, VOL:-VOL, VOL:-VOL]
        assert bool((AhD == cap).any()) and bool((AhD < cap).any())


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["flux", "flux, free slip", "vi"])
def test_mom_del2uv(lib, on_mock, ny, nx, dtype, form):
    """Y's two outputs in each variant on every padded cell."""
    from mitgcm_tpu_torch.model import mom_visc

    cfg, g, (u, v, *_) = visc_case(DTYPES[dtype], 720 + nx, ny, nx,
                                   vi=form == "vi",
                                   no_slip_sides=form != "flux, free slip")
    got = mom_visc.del2uv(cfg, g, u, v)
    want = mom_visc.del2uv(cfg, g, u, v, impl="plain")
    assert on_mock["mom_del2uv"] == 1
    check_outputs(list(got), list(want), f"del2uv({form})")


# B's dissipation variant: its fields (X's viscosities, Y's Laplacian or
# neither) and its drags, no-slip and free-slip sides, the 3-D Coriolis term
MOM_VISC_VARIANTS = {
    "visc-gyre": {},
    "free slip, 3-D Coriolis": dict(no_slip_sides=False,
                                    select3dCoriScheme=1, fPrime=1e-4),
    "variable, no biharmonic": dict(viscC4leith=0.0, viscC4leithD=0.0),
    "constant biharmonic, linear drag": {**VISC_OFF, "viscA4": 0.3,
                                         "viscA4D": 0.2, "viscA4Z": 0.4,
                                         "viscAhD": 0.5, "viscAhZ": 0.7,
                                         "bottomDragLinear": 2e-3},
    "no drag": {**VISC_OFF, "viscAhD": 0.5, "no_slip_bottom": False,
                "selectBotDragQuadr": -1},
    # the CD scheme's variant (no 2-D Coriolis term), with the 3-D term
    "CD, free slip, 3-D Coriolis": dict(no_slip_sides=False,
                                        select3dCoriScheme=1, fPrime=1e-4,
                                        useCDscheme=True),
}


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", MOM_VISC_VARIANTS)
def test_mom_fluxform_visc(lib, on_mock, numpy_sqrt, ny, nx, dtype,
                           variant):
    """B's dissipation variant fed X's and Y's twins' fields: every interior
    output equal to the twin's, every halo output 0; and the whole
    mom_fluxform's kernel path (X, Y and B on the mock) equal to its
    plain path on the interior."""
    from mitgcm_tpu_torch.model import mom_visc

    cfg, g, ins = visc_case(DTYPES[dtype], 740 + nx, ny, nx,
                            **MOM_VISC_VARIANTS[variant])
    u, v = ins[:2]
    visc, del2 = mom_visc.fields(cfg, g, u, v, impl="plain")
    got = mom.mom_fluxform_visc(cfg, g, *ins, visc, del2)
    want = mom.mom_fluxform_visc(cfg, g, *ins, visc, del2, impl="plain")
    assert on_mock["mom_fluxform_visc"] == 1
    old = OL
    try:
        globals()["OL"] = VOL
        for name, a, b in zip(mom.MomTend._fields, got, want):
            check(a, b, f"{variant}: {name}")
        whole = mom.mom_fluxform(cfg, g, *ins)
        plain = mom.mom_fluxform(cfg, g, *ins, impl="plain")
        for name, a, b in zip(mom.MomTend._fields, whole, plain):
            check(a, b, f"{variant}, whole: {name}")
    finally:
        globals()["OL"] = old
    assert on_mock["mom_fluxform"] == 0


# V's dissipation variant: variable viscosity with and without the
# biharmonic term, full Leith or Leith, the strain-tension form with
# variable and constant viscosity, a constant biharmonic viscosity, the
# quadratic drag, across the vorticity and Coriolis schemes and explicit
# viscosity
VI_VISC_VARIANTS = {
    "visc-vi-gyre": {},
    "leith, quadratic drag, vort 0": dict(useFullLeith=False,
                                          bottomDragQuadratic=2.5e-3,
                                          selectVortScheme=0),
    "variable, no biharmonic, explicit, Coriolis 1": dict(
        viscC4leith=0.0, viscC4leithD=0.0, implicitViscosity=False,
        selectCoriScheme=1),
    "strain-tension": {**VISC_OFF, "useStrainTensionVisc": True,
                       "viscC2smag": 2.2, "viscAhGridMax": 1.0,
                       "selectVortScheme": 2},
    "strain-tension, constant, linear drag": {
        **VISC_OFF, "useStrainTensionVisc": True, "viscAhD": 0.3,
        "viscAhZ": 0.5, "bottomDragLinear": 2e-3,
        "bottomDragQuadratic": 2.5e-3},
    "constant biharmonic": {**VISC_OFF, "viscAh": 0.4, "viscAhD": 0.4,
                            "viscAhZ": 0.4, "viscA4": 0.3, "viscA4D": 0.3,
                            "viscA4Z": 0.3, "no_slip_bottom": False},
    # the CD scheme's variant (no planetary Coriolis term)
    "CD, leith, vort 2": dict(useFullLeith=False, selectVortScheme=2,
                              useCDscheme=True),
}


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VI_VISC_VARIANTS)
def test_mom_vecinv_visc(lib, on_mock, numpy_sqrt, ny, nx, dtype, variant):
    """As test_mom_fluxform_visc, for V's dissipation variant."""
    from mitgcm_tpu_torch.model import mom_visc

    cfg, g, ins = visc_case(DTYPES[dtype], 760 + nx, ny, nx, vi=True,
                            **VI_VISC_VARIANTS[variant])
    u, v = ins[:2]
    vecinv.check_branches_vecinv(cfg)
    visc, del2 = mom_visc.fields(cfg, g, u, v, impl="plain")
    got = vecinv.mom_vecinv_visc(cfg, g, *ins, visc, del2)
    want = vecinv.mom_vecinv_visc(cfg, g, *ins, visc, del2, impl="plain")
    assert on_mock["mom_vecinv_visc"] == 1
    old = OL
    try:
        globals()["OL"] = VOL
        for name, a, b in zip(mom.MomTend._fields, got, want):
            check(a, b, f"{variant}: {name}")
        whole = vecinv.mom_vecinv(cfg, g, *ins)
        plain = vecinv.mom_vecinv(cfg, g, *ins, impl="plain")
        for name, a, b in zip(mom.MomTend._fields, whole, plain):
            check(a, b, f"{variant}, whole: {name}")
    finally:
        globals()["OL"] = old
    assert on_mock["mom_vecinv"] == 0


def test_visc_launches_refuse(lib):
    """X: a table of the wrong length, a parameter array of the wrong
    length, a Leith flag of 3, biharmonic output without its fields; Y: a
    variant of 2, the flux form without its fields; B's and V's variants:
    a second table or a parameter array of the wrong length, a pair of
    viscosities or the Laplacian's broken, biharmonic viscosities without
    the Laplacian, the strain-tension form with a Laplacian
    (cudaErrorInvalidValue, 1)."""
    x = torch.zeros((NR, 6, 8), dtype=torch.float64)
    tab = table([x] * 27)
    params = kernels.doubles([0.0] * 22)
    f = lib.host_mom_calc_visc_f64
    assert f(tab, 26, params, 22, NR, 6, 8, 1, 0, 0, 0) == 1
    assert f(tab, 27, params, 21, NR, 6, 8, 1, 0, 0, 0) == 1
    assert f(tab, 27, params, 22, NR, 6, 8, 1, 3, 0, 0) == 1
    no_a4 = table([x] * 25 + [None, None])
    assert f(no_a4, 27, params, 22, NR, 6, 8, 1, 0, 0, 1) == 1
    tab34 = table([x] * 34)
    assert lib.host_mom_del2uv_f64(tab34, 34, NR, 6, 8, 2, 1.0) == 1
    assert lib.host_mom_del2uv_f64(table([x] * 2 + [None] * 30 + [x] * 2),
                                   34, NR, 6, 8, 0, 1.0) == 1
    f = Fields(torch.float64, 780, *SIZES[0])
    _, named, args, _ = vecinv_case(f, 1, 0, True, "no-slip")
    outs = [torch.empty(f.s3, dtype=f.dtype) for _ in range(4)]
    vtab = table(list(named.values()) + outs)
    p5 = kernels.doubles([0.0] * 5)
    for extra, pairs, st in ((-1, [None] * 8, 0),
                             (0, [None] * 4 + [outs[0], None]
                              + [None] * 2, 0),
                             (0, [None] * 4 + [outs[0], outs[1]]
                              + [outs[2], outs[3]], 1)):
        second = table(pairs)
        assert lib.host_mom_vecinv_visc_f64(
            vtab, len(vtab), *args, 430.0, 2.0, 0.0, -1.0, second,
            8 + extra, p5, 5, st, 1) == 1
    _, named, args, _ = mom_case(f, True, False)
    btab = table(list(named.values()) + outs)
    p4 = kernels.doubles([0.0] * 4)
    for nv, pairs, n_params in ((5, [None] * 6, 4), (6, [None] * 6, 3),
                                (6, [outs[0]] + [None] * 5, 4),
                                (6, [None] * 2 + [outs[0], outs[1]]
                                 + [None] * 2, 4)):
        assert lib.host_mom_fluxform_visc_f64(
            btab, len(btab), *args, 430.0, 270.0, 2.0, -1.0, -1.0,
            table(pairs), nv, p4, n_params, 1, 1) == 1


# Kernels U (vertmix_calc, vertmix.cuh) and Z (opps_col, opps.cuh), and
# J-uv's and J-ts's vertmix variants, through their wrappers' kernel path
# on CPU tensors (on_mock) against the same wrappers with impl="plain":
# every padded cell equal in float64 and float32 on both SIZES grids with
# 12 levels, whose columns hold 0 to 12 wet levels from the top; U in PP81
# (PPnRi 2 and 3) and MY82, Z with its defaults, useGCMwVel and two
# adjustment iterations, each under the LINEAR, JMD95Z (the static profile
# and totPhiHyd) and MDJWF equations of state; the twins with numpy's sqrt.
RIMIX_NR = 12
RIMIX_EOS = (("LINEAR", 0), ("JMD95Z", 0), ("JMD95Z", 2), ("MDJWF", 2))
U_SCHEMES = {"PP81": ("PP81", {}), "PP81, PPnRi 3": ("PP81", {"PPnRi": 3}),
             "MY82": ("MY82", {})}
Z_VARIANTS = {"defaults": {}, "useGCMwVel": {"useGCMwVel": True},
              "two adjustments": {"MAX_ABE_ITERATIONS": 2}}


def rimix_case(dtype, seed, ny, nx, config, kind, select_p, nr=RIMIX_NR):
    """(cfg, grid, u, v, theta, salt, w, totPhiHyd): mix_fields' grid with
    columns of 0 to nr wet levels from the top (one of one level and one
    full), cfg the configuration's with the EOS and pressure of (kind,
    select_p); velocities over three decades, theta unstable at about a
    third of the interfaces."""
    from mitgcm_tpu_torch.model import vertmix

    f = mix_fields(dtype, seed, ny, nx, nr)
    nr, nyp, nxp = f.s3
    kwet = f.rng.integers(0, nr + 1, size=(nyp, nxp))
    kwet[3, 3], kwet[4, 4] = 1, nr
    f.grid.maskC = f.tensor(np.arange(nr)[:, None, None] < kwet[None])
    cfg = dataclasses.replace(
        getattr(synthetic, config)(nx=nxp - 2 * OL, ny=nyp - 2 * OL, nr=nr),
        eosType=kind, selectP_inEOS_Zc=select_p)
    amp = f.tensor(10.0 ** f.rng.uniform(-3.0, 0.0, f.s3))
    u = f.normal(f.s3, 0.1) * amp * f.grid.maskW
    v = f.normal(f.s3, 0.1) * amp * f.grid.maskS
    theta = (f.tensor(np.linspace(20.0, 8.0, nr))[:, None, None]
             + f.normal(f.s3, 1.0))
    salt = 35.0 + f.normal(f.s3, 0.2)
    w = f.normal(f.s3, 1e-2)
    phi = f.normal(f.s3, 20.0)
    assert nr > RIMIX_NR or kernels.max_nr(vertmix.U_SHARED_VALUES,
                                           dtype) >= nr
    return cfg, f.grid, u, v, theta, salt, w, phi


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,select_p", RIMIX_EOS)
@pytest.mark.parametrize("scheme", U_SCHEMES)
def test_vertmix_calc(lib, on_mock, numpy_sqrt, ny, nx, dtype, kind,
                      select_p, scheme):
    from mitgcm_tpu_torch.model import vertmix

    cfg, g, u, v, theta, salt, _, phi = rimix_case(
        DTYPES[dtype], 1000 + nx, ny, nx, "pp81_gyre_config", kind,
        select_p)
    name, group = U_SCHEMES[scheme]
    vm = getattr(vertmix, name)(cfg, g, group)
    got = vm.calc(u, v, theta, salt, phi)
    assert on_mock["vertmix_calc"] == 1
    want = vm.calc(u, v, theta, salt, phi, impl="plain")
    check_outputs(got, want, f"{scheme} {kind}")
    # both branches of the closures: the background floor and above it
    wet = g.maskC[1:] > 0
    assert (got[0][1:][wet] == cfg.viscAr).any()
    assert (got[0][1:][wet] > 10 * cfg.viscAr).any()


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,select_p", RIMIX_EOS)
@pytest.mark.parametrize("variant", Z_VARIANTS)
def test_opps_col(lib, on_mock, numpy_sqrt, ny, nx, dtype, kind, select_p,
                  variant):
    from mitgcm_tpu_torch.model import opps

    cfg, g, _, _, theta, salt, w, phi = rimix_case(
        DTYPES[dtype], 1100 + nx, ny, nx, "opps_gyre_config", kind,
        select_p)
    op = opps.OPPS(cfg, g, Z_VARIANTS[variant])
    got = op.apply(theta, salt, w, phi)
    assert on_mock["opps_col"] == 1
    want = op.apply(theta, salt, w, phi, impl="plain")
    check_outputs(got, want, f"{variant} {kind}")
    # plumes launched and not launched, and the tracers moved
    assert 0 < int(got[2].sum()) < int((g.maskC[1:] > 0).sum())
    assert not torch.equal(got[0], theta)


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scheme", ("PP81", "MY82"))
def test_kappa_vertmix(lib, on_mock, numpy_sqrt, ny, nx, dtype, scheme):
    """J-uv's max-blend of PP81's or MY82's viscAr and J-ts's addend of
    their diffKr (model/step.py:kappa_uv, model/thermodynamics.py:
    kappa_ts with vmix_fields), fed U's twin's fields."""
    from mitgcm_tpu_torch.model import thermodynamics as th
    from mitgcm_tpu_torch.model import vertmix

    cfg, g, u, v, theta, salt, _, phi = rimix_case(
        DTYPES[dtype], 1200 + nx, ny, nx, f"{scheme.lower()}_gyre_config",
        "JMD95Z", 0)
    visc, diff = getattr(vertmix, scheme)(cfg, g, {}).calc(
        u, v, theta, salt, phi, impl="plain")
    fields = {"viscAr": visc, "diffKr": diff}
    for kernel, fn in (
            ("kappa_uv", lambda impl: list(step.kappa_uv(
                cfg, g, impl=impl, vmix_fields=fields))),
            ("kappa_ts", lambda impl: [t for t in th.kappa_ts(
                cfg, g, None, None, None, None, impl=impl,
                vmix_fields=fields) if t is not None])):
        got = fn(None)
        assert on_mock[kernel] == 1
        check_outputs(got, fn("plain"), f"{kernel} {scheme}")


def test_rimix_launches_refuse(lib):
    """U and Z refuse tables and parameter arrays of the wrong length, PP81
    with PPnRi 0, an EOS kind of 3, totPhiHyd asked for and not given, and
    more levels than a block's shared memory holds (cudaErrorInvalidValue,
    1); their wrappers refuse such nr by name."""
    from mitgcm_tpu_torch.model import opps, vertmix

    f = mix_fields(torch.float64, 1300, *SIZES[0], RIMIX_NR)
    nr, nyp, nxp = f.s3
    x = torch.zeros(f.s3, dtype=torch.float64)
    prof = torch.zeros(nr, dtype=torch.float64)
    rn = torch.zeros(nr + 1, dtype=torch.float64)
    params = (ctypes.c_double * 23)()
    tab = table([x, x, x, x, None, prof, None, None, x, rn, rn, x, x])
    for suf in ("f64", "f32"):
        fn = getattr(lib, f"host_vertmix_calc_{suf}")
        assert fn(tab, 13, params, 23, nr, nyp, nxp, 0, 0, 0, 2) == 0
        assert fn(tab, 12, params, 23, nr, nyp, nxp, 0, 0, 0, 2) == 1
        assert fn(tab, 13, params, 22, nr, nyp, nxp, 0, 0, 0, 2) == 1
        assert fn(tab, 13, params, 23, nr, nyp, nxp, 0, 0, 0, 0) == 1
        assert fn(tab, 13, params, 23, nr, nyp, nxp, 0, 3, 0, 2) == 1
        assert fn(tab, 13, params, 23, nr, nyp, nxp, 0, 0, 1, 2) == 1
        most = kernels.max_nr(vertmix.U_SHARED_VALUES, DTYPES[suf])
        assert fn(tab, 13, params, 23, most + 1, nyp, nxp, 1, 0, 0, 2) == 1
    kl = torch.zeros((nyp, nxp), dtype=torch.int32)
    zparams = (ctypes.c_double * 14)()
    tab = table([x, x, None, None, prof, x, prof, prof, kl, x, x, x])
    for suf in ("f64", "f32"):
        fn = getattr(lib, f"host_opps_col_{suf}")
        assert fn(tab, 12, zparams, 14, nr, nyp, nxp, 0, 0, 1) == 0
        assert fn(tab, 11, zparams, 14, nr, nyp, nxp, 0, 0, 1) == 1
        assert fn(tab, 12, zparams, 13, nr, nyp, nxp, 0, 0, 1) == 1
        assert fn(tab, 12, zparams, 14, nr, nyp, nxp, 3, 0, 1) == 1
        assert fn(tab, 12, zparams, 14, nr, nyp, nxp, 0, 1, 1) == 1
        most = kernels.max_nr(opps.Z_SHARED_VALUES, DTYPES[suf])
        assert fn(tab, 12, zparams, 14, most + 1, nyp, nxp, 0, 0, 1) == 1
    assert (kernels.max_nr(vertmix.U_SHARED_VALUES, torch.float64),
            kernels.max_nr(opps.Z_SHARED_VALUES, torch.float64)) == (302, 181)
    big = torch.zeros((303, 1, 1), dtype=torch.float64)
    none = SimpleNamespace(cfg=None, grid=None, scheme="MY82")
    with pytest.raises(ValueError, match="kernel U takes"):
        vertmix._vertmix_kernel(none, big, big, big, big, None)
    with pytest.raises(ValueError, match="kernel Z takes"):
        opps.opps_col(none, big[:182], big[:182], None, None)



# The CD scheme (kernel CD, cd_code.cuh; G's, B's and V's CD variants) and
# the Shapiro filter (kernels SH-uv and SH-ts, shap_filt.cuh): each
# through its wrapper's kernel path on the mock against the wrapper with
# impl="plain", every padded cell equal, in float64 and float32 on both
# SIZES grids.


def cd_shap_grid(f):
    """f's grid with Bo_surf, rAz and recip_rAz, which CD and SH-uv read."""
    g = f.grid
    s2 = f.s3[1:]
    g.Bo_surf = f.uniform(s2, 9.0, 10.0)
    g.rAz = f.uniform(s2, 0.5, 2.0)
    g.recip_rAz = 1.0 / g.rAz
    return g


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("it", (0, 5))
def test_cd_scheme(lib, on_mock, ny, nx, dtype, it):
    """Kernel CD on iteration 0 (forward D-grid step) and a later one."""
    from mitgcm_tpu_torch.model import cd_code

    f = Fields(DTYPES[dtype], 1400 + nx + it, ny, nx)
    g = cd_shap_grid(f)
    cfg = config_ns(nr=NR, deltaTMom=600.0, tauCD=321428.0, abEps=0.01,
                    epsAB_CD=0.01)
    gU, gV = f.normal(f.s3, 1e-4), f.normal(f.s3, 1e-4)
    u, v, uNM1, vNM1, uVelD, vVelD = (f.normal(f.s3, 0.1) for _ in range(6))
    eta, etaNm1 = f.normal(f.s3[1:], 0.1), f.normal(f.s3[1:], 0.1)
    cd = cd_code.CDState(uVelD, vVelD, uNM1, vNM1, etaNm1)

    def run(impl):
        return list(cd_code.cd_scheme(cfg, g, it, gU, gV, u, v, eta, cd,
                                      impl=impl))
    check_outputs(run(None), run("plain"), f"cd_scheme({it})")
    assert on_mock["cd_scheme"] == 1


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("no_slip,cori3d", [(True, False), (False, True)])
def test_mom_fluxform_tile_cd(lib, ny, nx, dtype, no_slip, cori3d):
    """B's CD variant (Coriolis flags bit 1): no 2-D Coriolis term, the
    3-D term kept."""
    f = Fields(DTYPES[dtype], 1420 + 2 * no_slip + cori3d, ny, nx)
    cfg = config_ns(nr=NR, oly=OL, olx=OL, rkSign=-1.0,
                    gravitySign=-1.0, viscAhD=430.0, viscAhZ=270.0,
                    sideDragFactor=2.0, no_slip_sides=no_slip,
                    select3dCoriScheme=int(cori3d), useCDscheme=True)
    g = f.grid
    u = f.normal(f.s3, 0.1) * g.maskW
    v = f.normal(f.s3, 0.1) * g.maskS
    w = f.normal(f.s3, 1e-2) * g.maskC
    kshape = (NR + 1,) + f.s3[1:]
    kRU, kRV = f.normal(kshape, 1e-2).abs(), f.normal(kshape, 1e-2).abs()
    want = mom._mom_fluxform_plain(cfg, g, u, v, w, kRU, kRV)
    outs = [torch.full(f.s3, float("nan"), dtype=f.dtype) for _ in range(4)]
    ins = list(mom._kernel_inputs(g, u, v, w, kRU, kRV).values())
    tab = table(ins + outs)
    err = getattr(lib, f"host_mom_fluxform_{dtype}")(
        tab, len(tab), NR, ny, nx, OL, OL, int(no_slip),
        mom.coriolis_flags(cfg), cfg.viscAhD, cfg.viscAhZ,
        cfg.sideDragFactor, cfg.rkSign, cfg.gravitySign)
    assert err == 0 and mom.coriolis_flags(cfg) == 2 + int(cori3d)
    for name, got in zip(mom.MomTend._fields, outs):
        check(got, getattr(want, name), name)
    assert lib.host_mom_fluxform_f64(
        tab, len(tab), NR, ny, nx, OL, OL, 1, 4, 1.0, 1.0, 1.0, -1.0,
        -1.0) == 1


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vort,implicit", [(1, True), (0, False), (2, True)])
def test_mom_vecinv_tile_cd(lib, ny, nx, dtype, vort, implicit):
    """V's CD variant (Coriolis 2): no planetary Coriolis term, the
    vorticity advection kept."""
    f = Fields(DTYPES[dtype], 1440 + vort, ny, nx)
    want, named, _, run = vecinv_case(f, vort, 0, implicit, "no-slip",
                                      cd=True)
    for name, got, wanted in zip(mom.MomTend._fields, run(lib, named), want):
        check(got, wanted, name)


# (configuration, iteration) of G's CD variant: AB-2 on the cold start and
# later, AB-3 on a later step
MOM_AB_CD_CASES = {"cd-gyre cold start": ("cd_gyre_config", 0),
                   "cd-gyre": ("cd_gyre_config", 1),
                   "cd-vi-gyre": ("cd_vi_gyre_config", 2)}


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MOM_AB_CD_CASES)
def test_mom_ab_step_cd(lib, on_mock, ny, nx, dtype, case):
    """G's CD variant (mode bit 1): the raw tendencies and gU_ab, gV_ab in
    the predictors' places."""
    from mitgcm_tpu_torch.model.mom_fluxform import MomTend

    config, it = MOM_AB_CD_CASES[case]
    f = last_fields(DTYPES[dtype], 1460 + nx + it, ny, nx)
    cfg = getattr(synthetic, config)(nx=nx, ny=ny, nr=MIX_NR)
    s2 = f.s3[1:]
    t = {k: f.normal(f.s3, 1e-4) for k in (
        "gU", "gV", "guDiss", "gvDiss", "dPhiX", "dPhiY", "guNm1", "gvNm1",
        "guNm2", "gvNm2")}
    state = SimpleNamespace(
        uVel=f.normal(f.s3, 0.1), vVel=f.normal(f.s3, 0.1), gwNm1=None,
        gwNm2=None, **{k: t[k] for k in ("guNm1", "gvNm1", "guNm2",
                                         "gvNm2")})
    tend = MomTend(t["gU"], t["gV"], t["guDiss"], t["gvDiss"])
    ext = f.normal(s2, 1e-5), f.normal(s2, 1e-5)

    def run(impl):
        return list(step.mom_ab_step(cfg, f.grid, state, tend, t["dPhiX"],
                                     t["dPhiY"], *ext, it, impl=impl)[:4])
    got = run(None)
    check_outputs(got, run("plain"), case)
    assert on_mock["mom_ab_step"] == 1
    # the predictor's slot holds the extrapolation, not u + dt g_ab maskW
    assert not torch.equal(got[1], step._mom_ab_step_plain(
        dataclasses.replace(cfg, useCDscheme=False), f.grid, it,
        t["gU"], t["dPhiX"], t["guDiss"], ext[0], t["guNm1"], t["guNm2"],
        state.uVel, t["gV"], t["dPhiY"], t["gvDiss"], ext[1], t["gvNm1"],
        t["gvNm2"], state.vVel)[1])


def shap_case(f, **shap):
    """(cfg, ShapParams): the shap-gyre's filter on f's grid, 4 passes on
    the velocities and on each tracer unless `shap` says otherwise."""
    from mitgcm_tpu_torch.model import shap_filt

    cfg = config_ns(nr=f.s3[0], oly=OL, olx=OL, deltaTMom=600.0,
                    deltaTTracer=900.0)
    shp = shap_filt.ShapParams(**{
        "nShapUV": 4, "nShapT": 4, "nShapS": 4, "Shap_uvtau": 1200.0,
        "Shap_Trtau": 2400.0, "shap_filt_uvStar": False, **shap})
    return cfg, shp


# SH-uv: index space (4 passes; 3, whose last pass fills; an exchange every
# pass), physical space with Shap_uvLength < 0, 0 and > 0
SHAP_UV_CASES = {
    "index": {}, "index, 3 passes": {"nShapUV": 3},
    "index, exchange every pass": {"Shap_alwaysExchUV": True},
    "physical, length < 0": {"nShapUVPhys": 4, "Shap_uvLength": -1.0},
    "physical, length 0": {"nShapUVPhys": 4},
    "physical, length > 0": {"nShapUVPhys": 4, "Shap_uvLength": 3.0}}


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SHAP_UV_CASES)
def test_shap_uv(lib, on_mock, ny, nx, dtype, case):
    """SH-uv's passes through shap_filt.apply_uv: one launch a pass."""
    from mitgcm_tpu_torch.model import shap_filt

    f = Fields(DTYPES[dtype], 1480 + nx + len(case), ny, nx)
    g = cd_shap_grid(f)
    cfg, shp = shap_case(f, **SHAP_UV_CASES[case])
    u, v = f.normal(f.s3, 0.1), f.normal(f.s3, 0.1)

    def run(impl):
        return list(shap_filt.apply_uv(cfg, g, shp, u, v, impl=impl))
    got = run(None)
    check_outputs(got, run("plain"), f"apply_uv({case})")
    assert on_mock["shap_uv"] == shp.nShapUV
    assert not torch.equal(got[0], u)


# SH-ts: index space, physical space with and without Shap_TrLength, and
# index passes followed by physical ones (4 and 5 passes)
SHAP_TS_CASES = {
    "index": {}, "physical": {"nShapTrPhys": 4},
    "physical, length": {"nShapTrPhys": 4, "Shap_TrLength": 2.0},
    "mixed": {"nShapTrPhys": 2},
    "mixed, 5 passes": {"nShapT": 5, "nShapS": 5, "nShapTrPhys": 3}}


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SHAP_TS_CASES)
def test_shap_ts(lib, on_mock, ny, nx, dtype, case):
    """SH-ts's passes on theta and salt through shap_filt.apply_ts: one
    launch a pass of each."""
    from mitgcm_tpu_torch.model import shap_filt

    f = Fields(DTYPES[dtype], 1500 + nx + len(case), ny, nx)
    g = cd_shap_grid(f)
    cfg, shp = shap_case(f, **SHAP_TS_CASES[case])
    theta, salt = f.normal(f.s3, 1.0), 35.0 + f.normal(f.s3, 0.1)

    def run(impl):
        return list(shap_filt.apply_ts(cfg, g, shp, theta, salt, impl=impl))
    got = run(None)
    check_outputs(got, run("plain"), f"apply_ts({case})")
    assert on_mock["shap_ts"] == 2 * shp.nShapT
    assert not torch.equal(got[0], theta)


def test_cd_shap_launches_refuse(lib):
    """CD refuses a table or parameter array of the wrong length and a null
    pointer; SH-uv and SH-ts a table or parameter array of the wrong
    length, flags out of range, SH-ts's first flag, and a physical pass
    without its metrics (cudaErrorInvalidValue, 1)."""
    f = Fields(torch.float64, 1520, *SIZES[0])
    nr, nyp, nxp = f.s3
    x, x2 = torch.zeros(f.s3, dtype=torch.float64), f.grid.rA
    cd = [x] * 10 + [x2] * 7 + [x] * 4
    p5 = (ctypes.c_double * 5)()
    assert lib.host_cd_scheme_f64(table(cd), 21, p5, 5, nr, nyp, nxp) == 0
    assert lib.host_cd_scheme_f64(table(cd), 20, p5, 5, nr, nyp, nxp) == 1
    assert lib.host_cd_scheme_f64(table(cd), 21, p5, 4, nr, nyp, nxp) == 1
    assert lib.host_cd_scheme_f64(table(cd[:20] + [None]), 21, p5, 5, nr,
                                  nyp, nxp) == 1
    shap = [x] * 11 + [x2] * 14 + [x] * 2
    index = [x] * 6 + [None] * 19 + [x] * 2
    p2, p3 = (ctypes.c_double * 2)(), (ctypes.c_double * 3)()
    uv = lib.host_shap_uv_f64
    assert uv(table(shap), 27, p2, 2, nr, nyp, nxp, OL, OL, 1, 1, 1, 1,
              -1) == 0
    assert uv(table(index), 27, p2, 2, nr, nyp, nxp, OL, OL, 1, 1, 1, 0,
              0) == 0
    assert uv(table(index), 27, p2, 2, nr, nyp, nxp, OL, OL, 1, 1, 1, 1,
              0) == 1
    assert uv(table(shap), 26, p2, 2, nr, nyp, nxp, OL, OL, 1, 1, 1, 1,
              0) == 1
    assert uv(table(shap), 27, p3, 3, nr, nyp, nxp, OL, OL, 1, 1, 1, 1,
              0) == 1
    assert uv(table(shap), 27, p2, 2, nr, nyp, nxp, OL, OL, 2, 1, 1, 1,
              0) == 1
    assert uv(table(shap), 27, p2, 2, nr, nyp, nxp, OL, OL, 1, 1, 1, 1,
              2) == 1
    ts = lib.host_shap_ts_f64
    tsi = [x, None, x, None] + [x] * 2 + [None] * 19 + [x, None]
    assert ts(table(tsi), 27, p3, 3, nr, nyp, nxp, OL, OL, 1, 0, 1, 0,
              0) == 0
    assert ts(table(tsi), 27, p3, 3, nr, nyp, nxp, OL, OL, 1, 1, 1, 0,
              0) == 1
    assert ts(table(tsi), 27, p2, 2, nr, nyp, nxp, OL, OL, 1, 0, 1, 0,
              0) == 1


@pytest.mark.parametrize("scheme", ("PP81", "MY82"))
def test_vertmix_calc_deep(lib, on_mock, numpy_sqrt, scheme):
    """U at 310 levels in float64, above the 302 that MY82's shared memory
    holds: PP81 keeps no level in shared memory and runs, every padded cell
    equal to its twin's; MY82 is refused by name."""
    from mitgcm_tpu_torch.model import vertmix

    nr = 310
    cfg, g, u, v, theta, salt, _, phi = rimix_case(
        torch.float64, 1540, 4, 6, "pp81_gyre_config", "JMD95Z", 0, nr=nr)
    assert kernels.max_nr(vertmix.U_SHARED_VALUES, torch.float64) < nr
    vm = getattr(vertmix, scheme)(cfg, g, {})
    if scheme == "MY82":
        with pytest.raises(ValueError, match="kernel U takes"):
            vm.calc(u, v, theta, salt, phi)
        assert on_mock["vertmix_calc"] == 0
        return
    got = vm.calc(u, v, theta, salt, phi)
    assert on_mock["vertmix_calc"] == 1
    check_outputs(got, vm.calc(u, v, theta, salt, phi, impl="plain"),
                  "PP81 at 310 levels")


# Kernel TH (thsice.cuh): one thsice step through model/thsice.py:
# ThSIce.advance's kernel path on the mock (`on_mock`) against the twin
# (impl="plain"), every padded cell of the nine th* fields and the four
# ocean fluxes equal, the twin with libm's exp and a correctly rounded sqrt
# (`libm_math`), in float64 and float32 on both SIZES grids, on
# utils/synthetic.py:thsice_inputs's seeded fields under each of
# THSICE_VARIANTS (the defaults, a daily step, two surface iterations).
@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", synthetic.THSICE_VARIANTS)
def test_thsice_step(lib, on_mock, libm_math, ny, nx, dtype, variant):
    from mitgcm_tpu_torch.model import thsice

    cfg = synthetic.thsice_gyre_config(nx=nx, ny=ny, nr=NR, depth=300.0)
    grid = synthetic.gyre_grid(cfg, dtype=DTYPES[dtype], device="cpu")
    p = dataclasses.replace(thsice.params_from_namelists(cfg, {}, {}),
                            **synthetic.THSICE_VARIANTS[variant])
    ts = thsice.ThSIce(cfg, grid, p)
    args = synthetic.thsice_inputs(cfg, grid, seed=ny + nx)
    got = ts.advance(*args)
    assert on_mock["thsice_step"] == 1
    want = ts.advance(*args, impl="plain")
    for g, w in zip(got, want):
        for name in w:
            check_whole(g[name], w[name], f"{name} ({variant})")


def test_thsice_launch_refuses(lib):
    """TH's launch refuses a table or a parameter array of another length,
    a null pointer, a halo of 0 and an interior of no cell."""
    from mitgcm_tpu_torch.model import thsice, thsice_kernels

    cfg = synthetic.thsice_gyre_config(nx=8, ny=8, nr=NR, depth=300.0)
    grid = synthetic.gyre_grid(cfg, dtype=torch.float64, device="cpu")
    ts = thsice.ThSIce(cfg, grid, thsice.params_from_namelists(cfg, {}, {}))
    vals = thsice_kernels.th_params(ts)
    params = (ctypes.c_double * len(vals))(*vals)
    bufs = [torch.zeros(12, 12, dtype=torch.float64) for _ in range(35)]
    fn = lib.host_thsice_step_f64
    ok = (table(bufs), 35, params, len(vals), 12, 12, 2, 2, 20)
    assert fn(*ok) == 0
    for k, bad in ((1, 34), (3, len(vals) - 1), (6, 0), (7, 0), (4, 4),
                   (8, -1)):
        args = list(ok)
        args[k] = bad
        assert fn(*args) != 0, (k, bad)
    assert fn(table(bufs[:34] + [None]), *ok[1:]) != 0


# the sea ice's settings under which SeaIce.advdiff and thermo run on the
# mock: SEAICE_PARM01 on the ice-gyre's, SEAICE_PARM03 (the ice tracers)
SEAICE_HOST_VARIANTS = {
    "fields": ({}, {}),
    "tracers": ({}, {"sitrnuminuse": 3, "sitrname(1)": "age",
                     "sitrmate(1)": "HEFF", "sitrname(2)": "one",
                     "sitrmate(2)": "AREA", "sitrname(3)": "salt",
                     "sitrmate(3)": "HEFF", "sitrfromocean0(3)": 4.0,
                     "sitrfromflood0(3)": 30.0, "sitrexpand0(3)": 2.0}),
    "tracers, scheme 33, diffKh": (
        {"SEAICEadvScheme": 33, "SEAICEdiffKhHeff": 300.0,
         "SEAICEdiffKhArea": 200.0, "SEAICEdiffKhSnow": 100.0},
        {"sitrnuminuse": 2, "sitrname(1)": "age", "sitrmate(1)": "AREA",
         "sitrname(2)": "one", "sitrmate(2)": "HEFF"}),
    "legacy, DIFF1": ({"SEAICEadvScheme": 2, "DIFF1": 4.0e-3}, {}),
    "legacy 4, DIFF1, diffKh": ({"SEAICEadvScheme": 4, "DIFF1": 2.0e-3,
                                 "SEAICEdiffKhArea": 200.0}, {}),
    "legacy 3": ({"SEAICEadvScheme": 3}, {}),
}


def seaice_host_case(dtype, seed, ny, nx, variant):
    """(SeaIce, ice, forcing, theta0, salt0) on the ice-gyre's walled grid
    (2 x 2 tiles) with seeded moving ice of thick, thin, negative and
    absent cover, tracers of a wide spread, ocean and atmosphere."""
    nml01, nml03 = SEAICE_HOST_VARIANTS[variant]
    cfg = synthetic.ice_gyre_config(nx=nx, ny=ny, nr=4, deltaT=600.0)
    cfg = dataclasses.replace(cfg, sNy=ny // 2, nSy=2)
    grid = synthetic.gyre_grid(cfg, dtype=dtype, device="cpu")
    si = seaice.SeaIce(cfg, grid, seaice.params_from_namelists(
        cfg, {**synthetic.ICE_GYRE_SEAICE, **nml01}, nml03))
    rng = np.random.default_rng(seed)
    shape = tuple(grid.rA.shape)

    def fld(lo, hi, mask=None):
        a = torch.as_tensor(rng.uniform(lo, hi, shape), dtype=dtype)
        return a * mask if mask is not None else a

    hm = si.HEFFM
    heff = fld(-0.2, 3.0, hm)
    heff[::3, ::2] = 0.0
    heff[1::4, ::3] = 5e-6
    hsnow = fld(-0.05, 0.4, hm)
    hsnow[::2, 1::3] = 0.0
    ntr = si.p.SItrNumInUse
    ice = si.init_state()._replace(
        uIce=si.fill(fld(-0.3, 0.3, si.seaiceMaskU), impl="plain"),
        vIce=si.fill(fld(-0.3, 0.3, si.seaiceMaskV), impl="plain"),
        HEFF=heff, HSNOW=hsnow, AREA=fld(-0.1, 1.1, hm),
        TICES=torch.stack([fld(240.0, 274.0) for _ in range(si.p.multDim)]),
        SItracer=torch.stack([fld(-1.0, 5.0) for _ in range(ntr)])
        if ntr else si.init_state().SItracer)
    forc = SimpleNamespace(
        atemp=fld(240.0, 275.0), aqh=fld(1e-4, 3e-3), precip=fld(0.0, 1e-7),
        swdown=fld(0.0, 300.0), lwdown=fld(150.0, 320.0),
        runoff=fld(0.0, 1e-8), wspeed=fld(0.0, 12.0),
        evap=fld(-1e-8, 1e-8), Qnet=fld(-200.0, 300.0) * hm,
        Qsw=fld(-200.0, 0.0) * hm, EmPmR=fld(-1e-5, 1e-5),
        saltFlux=fld(-1e-3, 1e-3))
    return si, ice, forc, fld(-2.2, 1.0), fld(30.0, 35.0)


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", SEAICE_HOST_VARIANTS)
def test_seaice_advdiff(lib, on_mock, ny, nx, dtype, variant):
    """SeaIce.advdiff's kernel path (seaice_advect's X and Y, with the
    tracers where there are any, or LA's three launches) against its twin,
    every padded cell of HEFF,
    AREA, HSNOW and the tracers."""
    si, ice, _, _, _ = seaice_host_case(DTYPES[dtype], 300 + nx, ny, nx,
                                        variant)
    got = si.advdiff(ice)
    launched = dict(on_mock)
    want = si.advdiff(ice, impl="plain")
    legacy = si.p.advScheme in seaice.LEGACY_SCHEMES
    assert launched == ({"seaice_advect_legacy": 3} if legacy else
                        {"seaice_advect_x": 1, "seaice_advect_y": 1})
    for name in ("HEFF", "AREA", "HSNOW", "SItracer"):
        check_whole(getattr(got, name), getattr(want, name),
                    f"{name} ({variant})")


@pytest.mark.parametrize("ny,nx", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ("fields", "tracers",
                                     "tracers, scheme 33, diffKh"))
def test_seaice_thermo(lib, on_mock, libm_math, ny, nx, dtype, variant):
    """SeaIce.thermo's kernel path (seaice_thermo, or TP with the tracers)
    against its twin (reg_ridge, growth and tracer_phys, with libm's exp
    and a correctly rounded sqrt, as the kernel's on the host), every
    padded cell of the ice, the tracers and the ocean's forcing."""
    si, ice, forc, theta0, salt0 = seaice_host_case(
        DTYPES[dtype], 310 + nx, ny, nx, variant)
    got, got_f = si.thermo(ice, forc, theta0, salt0)
    launched = dict(on_mock)
    want, want_f = si.thermo(ice, forc, theta0, salt0, impl="plain")
    tr = "_tr" if si.p.SItrNumInUse else ""
    assert launched == {f"seaice_thermo{tr}": 1}
    for name in ("HEFF", "HSNOW", "AREA", "TICES", "SItracer"):
        check_whole(getattr(got, name), getattr(want, name),
                    f"{name} ({variant})")
    for name in want_f:
        check_whole(got_f[name], want_f[name], f"{name} ({variant})")


def test_seaice_slice_launches_refuse(lib):
    """seaice_advect's launches take no tracer with a null tracer pointer
    and refuse a negative count of tracers, a null tracer pointer with
    tracers, a table of another length or an unknown scheme, LA's a
    parameter array of another length, a pass outside 1-3 and a halo of
    0, TP's a tracer parameter array of another length or a count of
    tracers outside 1-8."""
    bufs = [torch.zeros(12, 12, dtype=torch.float64) for _ in range(18)]
    f = torch.zeros(5, 12, 12, dtype=torch.float64)
    tab = table(bufs[:11])
    x = lib.host_seaice_advect_x_f64
    ok = (tab, 11, f.data_ptr(), f.data_ptr(), f.data_ptr(), 12, 12, 2, 77,
          2, 2, 600.0)
    assert x(*ok) == 0
    assert x(*ok[:3], None, *ok[4:9], 0, *ok[10:]) == 0
    for k, bad in ((9, -1), (3, None), (1, 10), (8, 7)):
        args = list(ok)
        args[k] = bad
        assert x(*args) != 0, (k, bad)
    la = lib.host_seaice_advect_legacy_f64
    vals = [600.0, 4e-3, 0.0, 0.0, 0.0, 0.0]
    params = (ctypes.c_double * 6)(*vals)
    stacks = [torch.zeros(3, 12, 12, dtype=torch.float64) for _ in range(5)]
    ok = (table(bufs[:13] + stacks), 18, params, 6, 12, 12, 2, 1)
    assert la(*ok) == 0
    for k, bad in ((3, 5), (7, 0), (7, 4), (6, 0), (1, 17)):
        args = list(ok)
        args[k] = bad
        assert la(*args) != 0, (k, bad)
    th = lib.host_seaice_thermo_tr_f64
    si, _, _, _, _ = seaice_host_case(torch.float64, 1, 12, 12, "tracers")
    tp = seaice_kernels.thermo_params(si)
    trp = seaice_kernels.tracer_params(si)
    p1 = (ctypes.c_double * len(tp))(*tp)
    p2 = (ctypes.c_double * len(trp))(*trp)
    tb = [torch.zeros(7, 12, 12, dtype=torch.float64) for _ in range(28)]
    ok = (table(tb), 28, p1, len(tp), p2, len(trp), f.data_ptr(),
          f.data_ptr(), 12, 12, 2, 7, 10)
    assert th(*ok) == 0
    for k, bad in ((5, len(trp) - 1), (6, None), (1, 27)):
        args = list(ok)
        args[k] = bad
        assert th(*args) != 0, (k, bad)
    trp[0] = 9
    p9 = (ctypes.c_double * len(trp))(*trp)
    assert th(*ok[:4], p9, *ok[5:]) != 0
