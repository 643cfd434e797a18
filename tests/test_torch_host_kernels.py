"""Host check of the forward kernels of B and C (kernels/csrc/
mom_fluxform_tile.cuh, gad_calc_rhs_tile.cuh): their sources built by g++
against the mock CUDA runtime of tests/host_cuda, each launch run with one
thread per CUDA thread and a barrier for __syncthreads, and held bit for
bit against the plain twins on the CPU. The grid is random, 20 x 12 x 4 in
float64 (and float32) with halos of 2, with land, partial cells and every
metric distinct, so that a wrong neighbour or a wrong order of operations
shows; its tiles of 32 x 4 columns are ragged in x, so a grid of 40 x 10
runs too, whose first tile has an eastern neighbour and whose last row of
tiles is ragged in y. Every interior output must equal the twin's, every
halo output must be 0."""

import ctypes
import importlib.util
import os
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mitgcm_tpu_torch.model import gad, gmredi
from mitgcm_tpu_torch.model import mom_fluxform as mom

NR, OL = 4, 2
SIZES = ((12, 20), (10, 40))    # (ny, nx)
HERE = os.path.dirname(os.path.abspath(__file__))
MOCK = os.path.join(HERE, "host_cuda")
CSRC = os.path.join(HERE, os.pardir, "mitgcm_tpu_torch", "kernels", "csrc")
DTYPES = {"f64": torch.float64, "f32": torch.float32}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PP = ctypes.POINTER(ctypes.c_void_p)
SIGNATURES = {
    "host_mom_fluxform": [_PP, _I] + [_I] * 7 + [_D] * 5,
    "host_gad_calc_rhs_c2": [_PP, _I] + [_I] * 5 + [_D] * 2
    + [_I, _I, _P, _PP, _I, _D, _D],
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


def table(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


class Fields:
    """A random padded grid and random inputs, numpy-seeded."""

    def __init__(self, dtype, seed, ny, nx):
        self.rng = np.random.default_rng(seed)
        self.dtype = dtype
        s3 = (NR, ny + 2 * OL, nx + 2 * OL)
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
        g["drF"] = self.uniform((NR,), 5.0, 50.0)
        g["recip_drF"] = 1.0 / g["drF"]
        g["recip_drC"] = 1.0 / self.uniform((NR + 1,), 5.0, 50.0)
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
    cfg = SimpleNamespace(nr=NR, oly=OL, olx=OL, rkSign=-1.0,
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


def poisoned(named, footprint, args):
    """Copies of the inputs, NaN but on the cells that `footprint` (of
    chip_smoke.py's bound) says the launch reads."""
    nan = {n: torch.full_like(t, float("nan")) for n, t in named.items()}
    want = footprint(named, args)
    for n, view in footprint(nan, args).items():
        view.copy_(want[n])
    return nan


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
    cfg = SimpleNamespace(nr=NR, oly=OL, olx=OL, rkSign=-1.0,
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
    the launch reads."""
    nan = {n: torch.full_like(t, float("nan")) for n, t in named.items()}
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


def check_footprint(lib, case, footprint, rings):
    want, named, args, run = case
    for got, wanted in zip(run(lib, poisoned(named, footprint, args)), want):
        check(got, wanted, "an output, the inputs NaN off the footprint")
    base = run(lib, named)
    unread = []
    for name in footprint(named, args):
        copies = {n: t.clone() for n, t in named.items()}
        view = footprint(copies, args)[name]
        for label, part in parts(view, rings.get(name)).items():
            saved = part.clone()
            part.mul_(1.5).add_(0.25)
            same = all(torch.equal(a, b) for a, b in zip(run(lib, copies),
                                                         base))
            if same:    # x * 0 hides a change but keeps a NaN
                part.fill_(float("nan"))
                same = not any(bool(a.isnan().any())
                               for a in run(lib, copies))
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
