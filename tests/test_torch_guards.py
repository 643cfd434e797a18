"""PyTorch port: guards. The port imports neither jax nor the JAX package
(mitgcm_tpu), its entry points put their tensors on the card unless asked
for the CPU, it has no CPU fallback for its GPU run, refuses configurations
and KPP and GGL90 options off its ported paths (GGL90 with more levels
than kernel G9 takes on the card among them, Langmuir under flux-form
momentum, and pickups that would drop IDEMIX's energy or the SOM moments),
its kernel wrappers refuse to differentiate what their kernels treat as
constants (and V, T, R, K, G9, M, O, P, H-IDEMIX, H-SOM and W, which have
no backward kernels yet, anything), its adjoint refuses the vi-gyre, KPP,
GGL90, every advection scheme but 2 and the non-hydrostatic path, and the
non-hydrostatic path runs under flux-form momentum only, without the NH
options it does not port, and writes no pickups (JAX's format drops
phi_nh and the w-tendency history); the sea ice runs with a SeaIce object
only, and check_seaice refuses by name each sea-ice option it does not
carry."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.ad import adjoint
from mitgcm_tpu_torch.core.grid import Grid, build_grid
from mitgcm_tpu_torch.model import gad, mom_fluxform, mom_vecinv
from mitgcm_tpu_torch.model import ggl90 as ggl90_mod
from mitgcm_tpu_torch.model import kpp as kpp_mod
from mitgcm_tpu_torch.model import som as som_mod
from mitgcm_tpu_torch.model.experiment import (Experiment, read_pickup,
                                               write_pickup)
from mitgcm_tpu_torch.model.step import check_supported
from mitgcm_tpu_torch.model.thermodynamics import impldiff
from mitgcm_tpu_torch.ops.eos import find_rho
from mitgcm_tpu_torch.solver import cg2d
from mitgcm_tpu_torch.utils import convert, synthetic

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ONE_STEP = """
import sys
import tempfile
import torch
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.model.experiment import (Experiment, read_pickup,
                                               write_pickup)
from mitgcm_tpu_torch.model.step import forward_step
from mitgcm_tpu_torch.utils import synthetic
cfg = synthetic.gyre_config(nx=12, ny=10, nr=3)
grid, state, forcing, op = synthetic.gyre_setup(cfg, dtype=torch.float64,
                                                device="cpu")
state, diag = forward_step(cfg, grid, op, state, forcing, 0)
assert diag.cg2d_iters > 0 and bool(torch.isfinite(state.uVel).all())
cfg = synthetic.vi_gyre_config(nx=12, ny=10, nr=3)
exp = Experiment(cfg, *synthetic.gyre_setup(cfg, dtype=torch.float64,
                                            device="cpu"))
rec, = exp.run(n_steps=1, collect_monitor=False)
assert rec["cg2d_iters"] > 0 and bool(torch.isfinite(exp.state.salt).all())
with tempfile.TemporaryDirectory() as tmp:
    write_pickup(exp, tmp, 1)
    back = Experiment(cfg, *synthetic.gyre_setup(cfg, dtype=torch.float64,
                                                 device="cpu"))
    read_pickup(back, tmp, 1)
assert torch.equal(back.state.guNm1[:, 2:-2, 2:-2],
                   exp.state.guNm1[:, 2:-2, 2:-2])
cfg = synthetic.kpp_gyre_config(nx=12, ny=10, nr=4, depth=300.0)
exp = Experiment(cfg, *synthetic.kpp_gyre_setup(cfg, dtype=torch.float64,
                                                device="cpu"))
rec, = exp.run(n_steps=1, collect_monitor=False)
assert rec["cg2d_iters"] > 0 and bool(torch.isfinite(exp.state.theta).all())
cfg = synthetic.ggl90_gyre_config(nx=12, ny=10, nr=4, depth=300.0)
g, s, f, op, g9 = synthetic.ggl90_gyre_setup(cfg, dtype=torch.float64,
                                             device="cpu")
exp = Experiment(cfg, g, s, f, op, ggl90=g9)
rec, = exp.run(n_steps=1, collect_monitor=False)
assert rec["cg2d_iters"] > 0 and bool(torch.isfinite(exp.state.GGL90TKE).all())
for config in (synthetic.os7mp_gyre_config, synthetic.pqm_gyre_config,
               synthetic.idemix_gyre_config, synthetic.som_gyre_config):
    cfg = config(nx=12, ny=10, nr=4, depth=300.0)
    g, s, f, op, g9 = synthetic.ggl90_gyre_setup(cfg, dtype=torch.float64,
                                                 device="cpu")
    exp = Experiment(cfg, g, s, f, op, ggl90=g9)
    rec, = exp.run(n_steps=1, collect_monitor=False)
    assert rec["cg2d_iters"] > 0 and bool(torch.isfinite(exp.state.salt).all())
cfg = synthetic.nh_convection_config(nx=8, ny=8, nr=4)
g, s, f, op, op3 = synthetic.nh_convection_setup(cfg, dtype=torch.float64,
                                                 device="cpu")
exp = Experiment(cfg, g, s, f, op, op3=op3)
rec, = exp.run(n_steps=1, collect_monitor=False)
assert rec["cg3d_iters"] > 0 and bool(torch.isfinite(exp.state.phi_nh).all())
cfg = synthetic.ice_gyre_config(nx=8, ny=8, nr=4, depth=300.0)
g, s, f, op, kpp, ice = synthetic.ice_gyre_setup(cfg, dtype=torch.float64,
                                                 device="cpu")
exp = Experiment(cfg, g, s, f, op, kpp=kpp, seaice=ice)
rec, = exp.run(n_steps=1, collect_monitor=False)
assert rec["lsr_iters"][0][0] > 0
assert bool(torch.isfinite(exp.state.siHEFF).all())
import chip_smoke
assert "jax" not in sys.modules, "the port imported jax"
jax_pkg = [m for m in sys.modules
           if m == "mitgcm_tpu" or m.startswith("mitgcm_tpu.")]
assert not jax_pkg, f"the port imported the JAX package: {jax_pkg}"
assert kernels._lib is None, "a CPU step touched the CUDA library"
print("one step ok")
"""


ADJOINT = """
import sys
import torch
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.ad import adjoint, grdchk
from mitgcm_tpu_torch.utils import synthetic
cfg = synthetic.gyre_config(nx=8, ny=8, nr=2)
grid, state, forcing, op = synthetic.gyre_setup(cfg, dtype=torch.float64,
                                                device="cpu")
control = adjoint.Control(cfg, grid)
cost = adjoint.cost_boxmean_tracer(cfg, grid, box=(2, 6, 2, 6))
J = adjoint.make_objective(cfg, grid, op, forcing, state, control, cost, 5)
r, = grdchk.grdchk(J, control.zero(), [(0, 5, 5)])
assert r["adj_grad"] != 0.0 and abs(r["rel_err"]) < 1e-5, r
assert "jax" not in sys.modules, "the port's adjoint imported jax"
assert not [m for m in sys.modules
            if m == "mitgcm_tpu" or m.startswith("mitgcm_tpu.")]
assert kernels._lib is None, "a CPU adjoint touched the CUDA library"
print("adjoint ok")
"""


def test_port_adjoint_imports_no_jax():
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", ADJOINT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "adjoint ok" in proc.stdout


@pytest.mark.parametrize("name", ["kappaRU", "kappaRV", "hFacW"])
def test_mom_fluxform_refuses_constant_grad(name):
    cfg = synthetic.gyre_config(nx=8, ny=8, nr=2)
    grid = synthetic.gyre_setup(cfg, dtype=torch.float64, device="cpu")[0]
    u = torch.zeros_like(grid.hFacC)
    kshape = (cfg.nr + 1,) + tuple(u.shape[1:])
    args = dict(kappaRU=torch.zeros(kshape, dtype=u.dtype),
                kappaRV=torch.zeros(kshape, dtype=u.dtype))
    if name in args:
        args[name].requires_grad_(True)
    else:
        grid = dataclasses.replace(grid, **{
            name: getattr(grid, name).clone().requires_grad_(True)})
    with pytest.raises(ValueError, match=name):
        mom_fluxform.mom_fluxform(cfg, grid, u, u, u, **args)


@pytest.mark.parametrize("name", ["xA", "yA", "maskUp", "kappaR", "rA"])
def test_calc_rhs_refuses_constant_grad(name):
    cfg = synthetic.gyre_config(nx=8, ny=8, nr=2)
    grid = synthetic.gyre_setup(cfg, dtype=torch.float64, device="cpu")[0]
    u = torch.zeros_like(grid.hFacC)
    kappaR = torch.zeros_like(u)
    if name == "rA":
        grid = dataclasses.replace(grid,
                                   rA=grid.rA.clone().requires_grad_(True))
    flow = gad.calc_adv_flow(grid, u, u, u)
    if name == "kappaR":
        kappaR.requires_grad_(True)
    elif name != "rA":
        flow = flow._replace(
            **{name: getattr(flow, name).clone().requires_grad_(True)})
    with pytest.raises(ValueError, match=name):
        gad.calc_rhs(cfg, grid, flow, u, kappaR, cfg.diffKhT)


def test_port_imports_no_jax():
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", ONE_STEP], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "one step ok" in proc.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    proc = subprocess.run([sys.executable, script], cwd=cwd,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("settings", [
    dict(eosType="TEOS10"), dict(vectorInvariantMomentum=True, viscAhZ=1e2),
    dict(nonlinFreeSurf=4), dict(implicitViscosity=True), dict(useKPP=True),
    dict(vectorInvariantMomentum=True, viscC2smag=2.0), dict(viscA4=1.0e9),
    dict(tempAdvScheme=33, multiDimAdvection=False),
    dict(usingSphericalPolarGrid=True)])
def test_check_supported_raises(settings):
    """implicitViscosity is ported under vector-invariant momentum only,
    scheme 33 under the multi-dimensional advection only."""
    cfg = synthetic.gyre_config(nx=8, ny=8, nr=2)
    check_supported(cfg)
    for flag, value in settings.items():
        setattr(cfg, flag, value)
    with pytest.raises(NotImplementedError):
        check_supported(cfg)


@pytest.mark.parametrize("eos", ["JMD95Z", "JMD95P", "UNESCO", "MDJWF"])
def test_check_supported_vi_gyre(eos):
    check_supported(synthetic.vi_gyre_config(nx=8, ny=8, nr=2, eosType=eos))


@pytest.mark.parametrize("kernel", ["V", "T", "R", "K", "G9", "M", "O", "P",
                                    "H-IDEMIX", "H-SOM"])
def test_vi_kernels_refuse_grad(kernel):
    """V, T, R, K, G9, M, O, P, H-IDEMIX and H-SOM have no backward kernels:
    any input that requires grad is refused, on every device."""
    cfg = synthetic.kpp_gyre_config(nx=8, ny=8, nr=2)
    grid, _, _, _, kpp = synthetic.kpp_gyre_setup(cfg, dtype=torch.float64,
                                                  device="cpu")
    x = torch.zeros_like(grid.hFacC).requires_grad_(True)
    k = torch.zeros((cfg.nr + 1,) + tuple(x.shape[1:]), dtype=x.dtype)
    x2 = x[0] + 1.0
    calls = {
        "V": lambda: mom_vecinv.mom_vecinv(cfg, grid, x, x, x, k, k),
        "T": lambda: impldiff(cfg, grid, x, k, grid.recip_hFacC, 600.0),
        "R": lambda: find_rho(cfg, grid, x + 10.0, x + 35.0),
        "K": lambda: kpp.calc(x, x, x + 10.0, x + 35.0, x, x2, x2, x2, x2,
                              x2, k[:2], k[:2]),
        "G9": lambda: ggl90_mod.GGL90(cfg, grid).calc(x, x, x.abs(), x, x2,
                                                      x2),
        **{k: (lambda s=s: gad.multidim_advection(
            cfg, grid, gad.calc_adv_flow(grid, x, x, x), x, x, x, x, s, s,
            600.0)) for k, s in (("M", 33), ("O", 7), ("P", 51))},
        "H-IDEMIX": lambda: ggl90_mod.GGL90(cfg, grid, {
            "useIDEMIX": True}).idemix(x.abs(), x),
        "H-SOM": lambda: som_mod.som_advect(
            cfg, grid, x, x, x, x + 10.0,
            torch.zeros((som_mod.NSOM,) + tuple(x.shape), dtype=x.dtype),
            81, 600.0),
    }
    with pytest.raises(ValueError, match=f"kernel {kernel}"):
        calls[kernel]()


@pytest.mark.parametrize("flag", ["vectorInvariantMomentum",
                                  "implicitDiffusion", "implicitViscosity",
                                  "eosType", "useAB3"])
def test_adjoint_refuses_vi_gyre(flag):
    cfg = synthetic.vi_gyre_config(nx=8, ny=8, nr=2)
    grid, state, forcing, op = synthetic.gyre_setup(cfg, dtype=torch.float64,
                                                    device="cpu")
    with pytest.raises(NotImplementedError, match=flag):
        adjoint.run_steps(cfg, grid, op, state, forcing, 1)


def test_no_silent_fallback():
    cfg = synthetic.gyre_config(nx=8, ny=8, nr=2)
    _, _, _, op = synthetic.gyre_setup(cfg, dtype=torch.float64, device="cpu")
    b = torch.zeros_like(op.aW)
    with pytest.raises(ValueError):
        cg2d.cg2d(cfg, op, b, b, impl="cuda")
    with pytest.raises(ValueError):   # what a kernel would be handed
        kernels.check_tensors(torch.float64, b=b)
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError):
            kernels.nvcc_path()


def test_adjoint_refuses_kpp():
    cfg = synthetic.kpp_gyre_config(nx=8, ny=8, nr=2)
    with pytest.raises(NotImplementedError, match="useKPP"):
        adjoint.check_adjoint_supported(cfg)


@pytest.mark.parametrize("settings,name", [
    (dict(useGGL90=True), "useGGL90"),
    (dict(tempAdvScheme=33), "tempAdvScheme=33"),
    (dict(saltAdvScheme=77), "saltAdvScheme=77"),
    (dict(tempVertAdvScheme=30), "tempVertAdvScheme=30"),
    (dict(tempAdvScheme=81), "tempAdvScheme=81"),
    (dict(saltAdvScheme=80), "saltAdvScheme=80"),
], ids=["useGGL90", "temp33", "salt77", "tempVert30", "som81", "som80"])
def test_adjoint_refuses_ggl90_and_schemes(settings, name):
    """The adjoint runs scheme 2 only, without GGL90 (so without IDEMIX and
    Langmuir) and without SOM."""
    cfg = synthetic.gyre_config(nx=8, ny=8, nr=2)
    adjoint.check_adjoint_supported(cfg)
    for flag, value in settings.items():
        setattr(cfg, flag, value)
    with pytest.raises(NotImplementedError, match=name):
        adjoint.check_adjoint_supported(cfg)


@pytest.mark.parametrize("group,name", [
    ({"useIDEMIX": True, "IDEMIX_include_GM": True}, "IDEMIX_include_GM"),
    ({"useLANGMUIR": True, "mxlMaxFlag": 0}, "useLANGMUIR with mxlMaxFlag=0"),
    ("p", "p-coordinates"),
    ({"useIDEMIX": True, "IDEMIX_include_GM_bottom": True},
     "IDEMIX_include_GM_bottom")],
    ids=["idemix", "langmuir", "p-coords", "idemix-gm-bottom"])
def test_check_supported_refuses_ggl90_options(group, name):
    """check_supported lets useGGL90 through only with a GGL90 object, and
    refuses, by name, IDEMIX's GM options (they need GM-Redi; JAX accepts
    them and never reads them), Langmuir with mxlMaxFlag 0 (JAX raises too)
    and p-coordinates."""
    cfg = synthetic.ggl90_gyre_config(nx=8, ny=8, nr=2)
    grid, _, _, _, ggl90 = synthetic.ggl90_gyre_setup(
        cfg, dtype=torch.float64, device="cpu")
    check_supported(cfg, ggl90=ggl90)
    with pytest.raises(NotImplementedError, match="useGGL90"):
        check_supported(cfg)
    if group == "p":
        ggl90.cfg = dataclasses.replace(cfg, usingPCoords=True,
                                        usingZCoords=False)
    else:
        ggl90 = ggl90_mod.GGL90(cfg, grid, group)
    with pytest.raises(NotImplementedError, match=name):
        ggl90_mod.check_ggl90(ggl90)
    with pytest.raises(NotImplementedError, match=name):
        check_supported(cfg, ggl90=ggl90)


@pytest.mark.parametrize("group", [
    {"useIDEMIX": True}, {"useLANGMUIR": True},
    {"useIDEMIX": True, "useLANGMUIR": True, "mxlMaxFlag": 3}],
    ids=["idemix", "langmuir", "both"])
def test_check_supported_passes_ggl90_options(group):
    """IDEMIX and Langmuir pass under vector-invariant momentum (the
    ggl90-gyre's), Langmuir with the ggl90-gyre's mxlMaxFlag 2 or any
    other flag but 0."""
    cfg = synthetic.ggl90_gyre_config(nx=8, ny=8, nr=2)
    grid = synthetic.ggl90_gyre_setup(cfg, dtype=torch.float64,
                                      device="cpu")[0]
    ggl90 = ggl90_mod.GGL90(cfg, grid, {"mxlMaxFlag": 2, **group})
    ggl90_mod.check_ggl90(ggl90)
    check_supported(cfg, ggl90=ggl90)


def test_check_supported_refuses_langmuir_under_flux_form():
    """The Coriolis-Stokes force that Langmuir adds is a term of flux-form
    momentum, which kernel B does not have: refused by name."""
    cfg = synthetic.ggl90_gyre_config(nx=8, ny=8, nr=2,
                                      vectorInvariantMomentum=False,
                                      implicitViscosity=False)
    grid = synthetic.ggl90_gyre_setup(cfg, dtype=torch.float64,
                                      device="cpu")[0]
    check_supported(cfg, ggl90=ggl90_mod.GGL90(cfg, grid, {"mxlMaxFlag": 2}))
    ggl90 = ggl90_mod.GGL90(cfg, grid, {"mxlMaxFlag": 2, "useLANGMUIR": True})
    with pytest.raises(NotImplementedError,
                       match="useLANGMUIR under flux-form momentum"):
        check_supported(cfg, ggl90=ggl90)


@pytest.mark.parametrize("config,name", [
    ("idemix", "useIDEMIX"), ("som", "tempAdvScheme=81")])
@pytest.mark.parametrize("io", ["write", "read"])
def test_pickups_refuse_idemix_and_som(config, name, io, tmp_path):
    """The JAX package's pickups hold neither IDEMIX_E nor the SOM moments
    (a restart there resets them to zero): the port refuses both pickups of
    such a run by name."""
    cfg = getattr(synthetic, f"{config}_gyre_config")(nx=8, ny=8, nr=4,
                                                      depth=300.0)
    g, s, f, op, g9 = synthetic.ggl90_gyre_setup(cfg, dtype=torch.float64,
                                                 device="cpu")
    exp = Experiment(cfg, g, s, f, op, ggl90=g9)
    call = write_pickup if io == "write" else read_pickup
    with pytest.raises(NotImplementedError, match=name):
        call(exp, str(tmp_path), 0)
    assert not list(tmp_path.iterdir())


class _OnTheCard:
    """A stand-in for a tensor on a CUDA device."""
    is_cuda = True


def test_check_supported_refuses_ggl90_above_kernel_cap():
    """Kernel G9 keeps at most ggl90.MAX_NR levels per column: with its
    tensors on the card check_supported names the refusal up front, on the
    plain path (CPU tensors, or impl="plain") any nr runs, as in JAX."""
    nr = ggl90_mod.MAX_NR + 1
    cfg = synthetic.ggl90_gyre_config(nx=4, ny=4, nr=nr, depth=300.0)
    ggl90 = synthetic.ggl90_gyre_setup(cfg, dtype=torch.float64,
                                       device="cpu")[4]
    check_supported(cfg, ggl90=ggl90)
    ggl90.klowC = _OnTheCard()
    with pytest.raises(NotImplementedError,
                       match=f"GGL90 with nr > {ggl90_mod.MAX_NR} on the "
                             "kernel path"):
        check_supported(cfg, ggl90=ggl90)
    check_supported(cfg, ggl90=ggl90, impl="plain")
    check_supported(dataclasses.replace(cfg, nr=ggl90_mod.MAX_NR),
                    ggl90=ggl90)


@pytest.mark.parametrize("name", list(kpp_mod.REFUSED_OPTIONS) + [
    "KPPuseDoubleDiff", "KPP_ghatUseTotalDiffus"])
def test_check_supported_refuses_kpp_options(name):
    """check_supported lets useKPP through only with a KPP object, and
    refuses, by name, each KPP option and parameter that is not ported."""
    cfg = synthetic.kpp_gyre_config(nx=8, ny=8, nr=2)
    grid, _, _, _, kpp = synthetic.kpp_gyre_setup(cfg, dtype=torch.float64,
                                                  device="cpu")
    check_supported(cfg, kpp)
    with pytest.raises(NotImplementedError, match="useKPP"):
        check_supported(cfg)
    if name in kpp_mod.REFUSED_OPTIONS:
        kpp = kpp_mod.KPP(cfg, grid, {}, options={"KPP_GHAT", name})
    else:
        kpp = kpp_mod.KPP(cfg, grid, {name: True})
    with pytest.raises(NotImplementedError, match=name):
        check_supported(cfg, kpp)


@pytest.mark.parametrize("entry", ["gyre_setup", "kpp_gyre_setup",
                                   "build_grid", "to_tensor", "from_arrays",
                                   "ggl90_gyre_setup", "nh_convection_setup",
                                   "ice_gyre_setup"])
def test_entry_points_default_to_the_card(entry):
    """Called without a device, an entry point puts its tensors on the
    card: here, without CUDA, it raises as torch does, and never falls back
    to the CPU."""
    cfg = synthetic.kpp_gyre_config(nx=8, ny=8, nr=2)
    grid = synthetic.gyre_setup(cfg, dtype=torch.float64, device="cpu")[0]
    calls = {
        "gyre_setup": lambda: synthetic.gyre_setup(cfg)[0].rA,
        "kpp_gyre_setup": lambda: synthetic.kpp_gyre_setup(cfg)[0].rA,
        "ggl90_gyre_setup": lambda: synthetic.ggl90_gyre_setup(cfg)[0].rA,
        "nh_convection_setup": lambda: synthetic.nh_convection_setup(
            synthetic.nh_convection_config(nx=8, ny=8, nr=2))[0].rA,
        "ice_gyre_setup": lambda: synthetic.ice_gyre_setup(
            synthetic.ice_gyre_config(nx=8, ny=8, nr=2))[0].rA,
        "build_grid": lambda: build_grid(cfg).rA,
        "to_tensor": lambda: convert.to_tensor(np.zeros(3)),
        "from_arrays": lambda: convert.from_arrays(
            Grid, convert.arrays_of(grid)).rA,
    }
    try:
        t = calls[entry]()
    except (AssertionError, RuntimeError) as err:
        assert not torch.cuda.is_available(), err
    else:
        assert t.is_cuda


def _nh_box(nr=4):
    cfg = synthetic.nh_convection_config(nx=8, ny=8, nr=nr)
    return cfg, synthetic.nh_convection_setup(cfg, dtype=torch.float64,
                                              device="cpu")


@pytest.mark.parametrize("settings,name", [
    (dict(vectorInvariantMomentum=True),
     "nonHydrostatic under vectorInvariantMomentum"),
    (dict(no_slip_sides=True), "no_slip_sides under nonHydrostatic"),
    (dict(selectNHfreeSurf=1), "selectNHfreeSurf=1"),
    (dict(useNHMTerms=True), "useNHMTerms"),
    (dict(viscA4W=1.0e3), "viscA4W"),
    (dict(implicitNHPress=0.5), "implicitNHPress=0.5"),
    (dict(implicitIntGravWave=True), "implicitIntGravWave"),
    (dict(deepAtmosphere=True), "deepAtmosphere")],
    ids=["vecinv", "no-slip", "nh-free-surf", "nhm-terms", "viscA4W",
         "implicitNHPress", "igw", "deep"])
def test_check_supported_refuses_nh_options(settings, name):
    """nonHydrostatic passes under flux-form momentum with a CG3DOperator;
    each NH option the port does not run is refused by name (under
    vector-invariant momentum: JAX's mom_vecinv has no 3-D Coriolis
    term)."""
    cfg, (_, _, _, _, op3) = _nh_box()
    check_supported(cfg, op3=op3)
    with pytest.raises(NotImplementedError,
                       match="nonHydrostatic without a CG3DOperator"):
        check_supported(cfg)
    cfg = dataclasses.replace(cfg, **settings)
    with pytest.raises(NotImplementedError, match=name):
        check_supported(cfg, op3=op3)


@pytest.mark.parametrize("io", ["write", "read"])
def test_pickups_refuse_nh(io, tmp_path):
    """JAX's pickups hold neither phi_nh nor gwNm1/2 (a restart there
    resets them): the port refuses both pickups of an NH run by name."""
    cfg, objs = _nh_box()
    exp = Experiment(cfg, *objs[:4], op3=objs[4])
    call = write_pickup if io == "write" else read_pickup
    with pytest.raises(NotImplementedError, match="nonHydrostatic"):
        call(exp, str(tmp_path), 0)
    assert not list(tmp_path.iterdir())


def test_nh_kernels_refuse_grad_and_the_adjoint():
    """W has no backward kernel (any input that requires grad is refused),
    B' refuses B's new flags, and the adjoint refuses the NH path."""
    from mitgcm_tpu_torch.model import calc_gw
    cfg, (grid, state, _, _, _) = _nh_box()
    k = torch.zeros((cfg.nr + 1,) + tuple(state.uVel.shape[1:]),
                    dtype=state.uVel.dtype)
    u = state.uVel.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="kernel W"):
        calc_gw.calc_gw(cfg, grid, u, state.vVel, state.wVel, k, k)
    for name in ("nonHydrostatic", "no_slip_sides=F", "select3dCoriScheme"):
        with pytest.raises(NotImplementedError, match=name):
            adjoint.check_adjoint_supported(cfg)
        cfg = dataclasses.replace(
            cfg, **{"nonHydrostatic": dict(nonHydrostatic=False),
                    "no_slip_sides=F": dict(no_slip_sides=True),
                    "select3dCoriScheme": dict(select3dCoriScheme=0)}[name])
    adjoint.check_adjoint_supported(cfg)


# each sea-ice option check_seaice refuses: (SEAICE_PARM01 settings, or
# parameters set after them, or Config fields; the name it gives)
SEAICE_REFUSALS = [
    ({"SEAICE_deltaTevp": 60.0}, "useEVP"),
    ({"SEAICEuseFREEDRIFT": True}, "useFreeDrift"),
    ({"SEAICEuseDYNAMICS": False}, "useDYNAMICS=F"),
    ({"p.SItrNumInUse": 1}, "SItrNumInUse>0"),
    ({"SEAICEadvScheme": 7}, "SEAICEadvScheme=(7, 7, 7)"),
    ({"SEAICEadvScheme": 2}, "SEAICEadvScheme=(2, 2, 2)"),
    ({"SEAICEadvScheme": 3}, "SEAICEadvScheme=(3, 3, 3)"),
    ({"SEAICEadvScheme": 4}, "SEAICEadvScheme=(4, 4, 4)"),
    ({"SEAICEadvSchSnow": 30}, "SEAICEadvScheme=(77, 77, 30)"),
    ({"useHB87stressCoupling": True}, "useHB87stressCoupling"),
    ({"SEAICEuseStrImpCpl": True}, "useStrImpCpl"),
    ({"LSR_mixIniGuess": 1}, "LSR_mixIniGuess"),
    ({"SEAICE_clipVelocities": True}, "clipVelocities"),
    ({"SEAICE_no_slip": True}, "SEAICE_no_slip"),
    ({"SEAICEetaZmethod": 0}, "etaZmethod=0"),
    ({"p.tensilFac": 0.05}, "tensilFac"),
    ({"p.basalDragK2": 8.0}, "basalDragK2"),
    ({"SEAICEheatConsFix": True}, "SEAICEheatConsFix"),
    ({"p.growMeltByConv": True}, "growMeltByConv"),
    ({"p.useMaykutSatVapPoly": True}, "useMaykutSatVapPoly"),
    ({"p.postSolvTempIter": 0}, "postSolvTempIter!=2"),
    ({"SEAICE_saltFrac": 0.3}, "SEAICE_saltFrac"),
    ({"p.snowThick": 0.0}, "SEAICE_snowThick<=0"),
    ({"SEAICE_multDim": 17}, "SEAICE_multDim>16"),
    ({"cfg.usingPCoords": True}, "p-coordinates"),
    ({"cfg.usingSphericalPolarGrid": True},
     "non-Cartesian grid or cubed sphere"),
    ({"cfg.sNx": 5}, "tiles that do not cover the grid"),
]


@pytest.mark.parametrize("settings,name", SEAICE_REFUSALS,
                         ids=[n for _, n in SEAICE_REFUSALS])
def test_check_seaice_refuses(settings, name):
    import types

    from mitgcm_tpu_torch.model import seaice as seaice_mod

    cfg = synthetic.ice_gyre_config(nx=16, ny=16, nr=2, depth=300.0)
    seaice_mod.check_seaice(cfg, types.SimpleNamespace(p=cfg.seaice))
    nml = {k: v for k, v in settings.items() if "." not in k}
    p = seaice_mod.params_from_namelists(
        cfg, {**synthetic.ICE_GYRE_SEAICE, **nml})
    for key, value in settings.items():
        if key.startswith("p."):
            setattr(p, key[2:], value)
        elif key.startswith("cfg."):
            setattr(cfg, key[4:], value)
    with pytest.raises(NotImplementedError, match=name.replace(
            "(", r"\(").replace(")", r"\)")):
        seaice_mod.check_seaice(cfg, types.SimpleNamespace(p=p))


def test_check_supported_needs_the_seaice_object():
    """useSEAICE without a SeaIce object is refused, and so is a SeaIce
    object without useSEAICE; useEXF stays refused."""
    cfg = synthetic.ice_gyre_config(nx=8, ny=8, nr=2, depth=300.0)
    grid, _, _, _, kpp, ice = synthetic.ice_gyre_setup(
        cfg, dtype=torch.float64, device="cpu")
    check_supported(cfg, kpp=kpp, seaice=ice)
    with pytest.raises(NotImplementedError,
                       match="useSEAICE without a SeaIce object"):
        check_supported(cfg, kpp=kpp)
    cfg.useEXF = True
    with pytest.raises(NotImplementedError, match="packages"):
        check_supported(cfg, kpp=kpp, seaice=ice)
    cfg.useEXF, cfg.useSEAICE = False, False
    with pytest.raises(NotImplementedError,
                       match="a SeaIce object without useSEAICE"):
        check_supported(cfg, kpp=kpp, seaice=ice)
