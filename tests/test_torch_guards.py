"""PyTorch port: guards. The port imports neither jax nor the JAX package
(mitgcm_tpu), its entry points put their tensors on the card unless asked
for the CPU, it has no CPU fallback for its GPU run, refuses configurations
and KPP and GGL90 options off its ported paths (GGL90 with more levels
than kernel G9 takes on the card among them, Langmuir under flux-form
momentum, and pickups that would drop IDEMIX's energy or the SOM moments),
its kernel wrappers refuse to differentiate what their kernels treat as
constants (and V, T, R, K, G9, M, O, P, H-IDEMIX, H-SOM, W and the sea
ice's H-seaice kernels, which have no backward kernels yet, anything: the
sea ice's wrappers and the dispatchers of their twins alike), its adjoint
refuses the vi-gyre, KPP, GGL90, every advection scheme but 2, the
non-hydrostatic path and the sea ice, and the non-hydrostatic path runs
under flux-form momentum only, without the NH options it does not port,
and writes no pickups (JAX's format drops phi_nh and the w-tendency
history); the sea ice runs with a SeaIce object only, check_seaice refuses
by name each sea-ice option it does not carry and lets through the
dynamics it does (LSR, the EVP variants, free drift, none, the clip), and
a step without dynamics matches the JAX package's; GM-Redi runs with a
GMParams only, check_gmredi refuses by name what it does not port (ldd97
in the bolus form, an unknown taper, variable K, p-coordinates), calc_rhs
with a GM tensor and GM's wrappers refuse gradients, and the adjoint
refuses useGMRedi."""

import dataclasses
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.ad import adjoint
from mitgcm_tpu_torch.core.grid import Grid, build_grid
from mitgcm_tpu_torch.model import gad, mom_fluxform, mom_vecinv
from mitgcm_tpu_torch.model import ggl90 as ggl90_mod
from mitgcm_tpu_torch.model import gmredi as gmredi_mod
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
cfg = synthetic.evp_ice_gyre_config(nx=8, ny=8, nr=4, depth=300.0)
g, s, f, op, kpp, ice = synthetic.ice_gyre_setup(cfg, dtype=torch.float64,
                                                 device="cpu")
exp = Experiment(cfg, g, s, f, op, kpp=kpp, seaice=ice)
rec, = exp.run(n_steps=1, collect_monitor=False)
assert rec["lsr_iters"] == [] and float(exp.state.siSigma.abs().max()) > 0.0
with tempfile.TemporaryDirectory() as tmp:
    write_pickup(exp, tmp, 1)
    read_pickup(exp, tmp, 1)
cfg = synthetic.ice_gyre_config(nx=8, ny=8, nr=4, depth=300.0)
cfg.seaice.useFreeDrift = True
g, s, f, op, kpp, ice = synthetic.ice_gyre_setup(cfg, dtype=torch.float64,
                                                 device="cpu")
exp = Experiment(cfg, g, s, f, op, kpp=kpp, seaice=ice)
rec, = exp.run(n_steps=1, collect_monitor=False)
assert float(exp.state.uIce.abs().max()) > 0.0
for config in (synthetic.gm_gyre_config, synthetic.gm_bolus_gyre_config):
    cfg = config(nx=8, ny=8, nr=4, depth=300.0)
    exp = Experiment(cfg, *synthetic.gm_gyre_setup(cfg, dtype=torch.float64,
                                                   device="cpu"))
    rec, = exp.run(n_steps=1, collect_monitor=False)
    assert bool(torch.isfinite(exp.state.theta).all())
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
                                   "ice_gyre_setup", "gm_gyre_setup"])
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
        "gm_gyre_setup": lambda: synthetic.gm_gyre_setup(
            synthetic.gm_bolus_gyre_config(nx=8, ny=8, nr=2))[0].rA,
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
# adaptive EVP with few subcycles (the evp-ice-gyre's dynamics)
AEVP = {"SEAICEaEVPcoeff": 0.5, "SEAICEnEVPstarSteps": 10}
SEAICE_REFUSALS = [
    ({"useHB87stressCoupling": True}, "useHB87stressCoupling without EVP"),
    ({**AEVP, "useHB87stressCoupling": True, "SEAICEuseFREEDRIFT": True},
     "useHB87stressCoupling without EVP"),
    ({**AEVP, "useHB87stressCoupling": True, "SEAICEuseDYNAMICS": False},
     "useHB87stressCoupling without EVP"),
    ({**AEVP, "SEAICEetaZmethod": 0}, "etaZmethod=0"),
    ({**AEVP, "SEAICEnEVPstarSteps": 0}, "SEAICEnEVPstarSteps<1"),
    ({"p.SItrNumInUse": 1}, "SItrNumInUse>0"),
    ({"SEAICEadvScheme": 7}, "SEAICEadvScheme=(7, 7, 7)"),
    ({"SEAICEadvScheme": 2}, "SEAICEadvScheme=(2, 2, 2)"),
    ({"SEAICEadvScheme": 3}, "SEAICEadvScheme=(3, 3, 3)"),
    ({"SEAICEadvScheme": 4}, "SEAICEadvScheme=(4, 4, 4)"),
    ({"SEAICEadvSchSnow": 30}, "SEAICEadvScheme=(77, 77, 30)"),
    ({"SEAICEuseStrImpCpl": True}, "useStrImpCpl"),
    ({"LSR_mixIniGuess": 1}, "LSR_mixIniGuess"),
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


SEAICE_REFUSAL_IDS = ["HB87-LSR", "HB87-freedrift", "HB87-no-dynamics",
                      "EVP-etaZmethod=0", "EVP-no-subcycle"] + [
    n for _, n in SEAICE_REFUSALS[5:]]


@pytest.mark.parametrize("settings,name", SEAICE_REFUSALS,
                         ids=SEAICE_REFUSAL_IDS)
def test_check_seaice_refuses(settings, name):
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


# the sea-ice dynamics check_seaice lets through:
# (SEAICE_PARM01 settings on top of the ice-gyre's)
SEAICE_ACCEPTS = {
    "aEVP": AEVP,
    "revised-EVP": {"SEAICE_evpAlpha": 500.0, "SEAICEnEVPstarSteps": 10},
    "classic-EVP": {"SEAICEuseEVPrev": False, "SEAICEuseEVPstar": False,
                    "SEAICE_deltaTevp": 60.0},
    "EVP*": {"SEAICEuseEVPrev": False, "SEAICE_deltaTevp": 60.0},
    "HB87-aEVP": {**AEVP, "useHB87stressCoupling": True},
    "freedrift": {"SEAICEuseFREEDRIFT": True},
    "no-dynamics": {"SEAICEuseDYNAMICS": False},
    "clip-LSR": {"SEAICE_clipVelocities": True},
    "clip-aEVP": {**AEVP, "SEAICE_clipVelocities": True},
}


@pytest.mark.parametrize("name", list(SEAICE_ACCEPTS))
def test_check_seaice_accepts(name):
    """EVP (adaptive, revised, classic, EVP*), HB87 coupling with EVP, free
    drift, no dynamics and the velocity clip run on the port: check_seaice
    passes them, and SeaIce starts the EVP stresses when EVP runs."""
    from mitgcm_tpu_torch.model import seaice as seaice_mod

    cfg = synthetic.ice_gyre_config(nx=8, ny=8, nr=2, depth=300.0)
    p = seaice_mod.params_from_namelists(
        cfg, {**synthetic.ICE_GYRE_SEAICE, **SEAICE_ACCEPTS[name]})
    cfg.seaice = p
    grid = synthetic.gyre_grid(cfg, dtype=torch.float64, device="cpu")
    si = seaice_mod.SeaIce(cfg, grid, p)
    evp = "EVP" in name
    assert p.useEVP == evp
    assert si.init_state().sigma.shape[0] == (3 if evp else 0)


def _seaice_grad_calls():
    """A call of each sea-ice kernel wrapper (model/seaice_kernels.py) and
    of each dispatcher that runs a twin (model/seaice.py), on CPU inputs of
    which one requires grad."""
    from mitgcm_tpu_torch.model import seaice as seaice_mod
    from mitgcm_tpu_torch.model import seaice_kernels as sk

    cfg = synthetic.ice_gyre_config(nx=8, ny=8, nr=2, depth=300.0)
    cfg.seaice = seaice_mod.params_from_namelists(
        cfg, {**synthetic.ICE_GYRE_SEAICE, **AEVP})
    grid = synthetic.gyre_grid(cfg, dtype=torch.float64, device="cpu")
    si = seaice_mod.SeaIce(cfg, grid, cfg.seaice)
    z = torch.zeros_like(grid.rA)
    x = z.clone().requires_grad_(True)
    ice = si.init_state()._replace(uIce=x)
    c = {k: z for k in ("AU", "BU", "CU", "AV", "BV", "CV", "uRt1", "uRt2",
                        "vRt1", "vRt2", "rhsU", "rhsV", "dwatn")}
    ctrl = torch.zeros(6, dtype=torch.int32)
    wf = torch.zeros(4, dtype=z.dtype)
    setup = si.evp_setup(ice, z, z)
    forc = types.SimpleNamespace(**{k: z for k in (
        "atemp", "aqh", "precip", "swdown", "lwdown", "runoff", "wspeed",
        "evap", "Qnet", "Qsw", "EmPmR", "saltFlux")})
    f3 = torch.stack([z, z, z])
    prep = [x] + [z] * 14
    fixed = {k: z for k in ("uNm1", "vNm1", "uVel0", "vVel0", "forcex0",
                            "forcey0", "massC", "massU", "massV")}
    return {
        "lsr_prep": lambda: si.lsr_prep(*prep),
        "lsr_sweep": lambda: si.lsr_sweep(True, 0, c, x, z, ctrl, wf, None),
        "lsr_check": lambda: si.lsr_check(x, z, z, z, ctrl, wf, None),
        "advdiff": lambda: si.advdiff(ice),
        "thermo": lambda: si.thermo(ice._replace(uIce=z, HEFF=x), forc, z,
                                    z),
        "evp": lambda: si.evp(ice, *[z] * 8),
        "freedrift": lambda: si.freedrift(ice._replace(HEFF=x), z, z, z, z),
        "sk.lsr_visc": lambda: sk.lsr_visc(si, x, z, z, z),
        "sk.lsr_coeffs": lambda: sk.lsr_coeffs(si, *[x] + [z] * 15),
        "sk.lsr_sweep": lambda: sk.lsr_sweep(si, True, 0, c, x, z, ctrl, wf,
                                             z),
        "sk.lsr_check": lambda: sk.lsr_check(si, x, z, z, z, ctrl, wf, None),
        "sk.advect_x": lambda: sk.advect_x(si, ice, f3, f3),
        "sk.advect_y": lambda: sk.advect_y(si, ice, f3, f3, f3),
        "sk.thermo": lambda: sk.thermo(si, ice._replace(HEFF=x), forc, z, z),
        "sk.evp_loop": lambda: sk.evp_loop(si, x, z, z, z, z, z, fixed,
                                           setup, 2),
        "sk.evp_loop(sigma12)": lambda: sk.evp_loop(si, z, z, z, z, x, z,
                                                    fixed, setup, 2),
        "sk.evp_loop(uNm1)": lambda: sk.evp_loop(
            si, z, z, z, z, z, z, {**fixed, "uNm1": x}, setup, 2),
        "sk.freedrift": lambda: sk.freedrift(si, x, z, z, z, z),
    }


SEAICE_GRAD_CALLS = ("lsr_prep", "lsr_sweep", "lsr_check", "advdiff",
                     "thermo", "evp", "freedrift",
                     "sk.lsr_visc", "sk.lsr_coeffs", "sk.lsr_sweep",
                     "sk.lsr_check", "sk.advect_x", "sk.advect_y",
                     "sk.thermo", "sk.evp_loop", "sk.evp_loop(sigma12)",
                     "sk.evp_loop(uNm1)", "sk.freedrift")


@pytest.mark.parametrize("call", SEAICE_GRAD_CALLS)
def test_seaice_kernels_refuse_grad(call):
    """The sea ice's kernels (LSR, advection, growth, EVP, free drift) have
    no backward kernel: each wrapper, and each dispatcher that would run a
    twin, refuses an input that requires grad on every device, before it
    looks at the device (here the CPU)."""
    with pytest.raises(ValueError, match="kernel H-seaice"):
        _seaice_grad_calls()[call]()


def test_adjoint_refuses_gmredi():
    for config in (synthetic.gm_gyre_config, synthetic.gm_bolus_gyre_config):
        cfg = config(nx=8, ny=8, nr=2, depth=300.0)
        with pytest.raises(NotImplementedError, match="useGMRedi"):
            adjoint.check_adjoint_supported(cfg)


def _gm_case(**gm):
    cfg = synthetic.gm_gyre_config(nx=8, ny=8, nr=4, depth=300.0)
    cfg.gmredi = dataclasses.replace(cfg.gmredi, **gm)
    grid = synthetic.gyre_setup(cfg, dtype=torch.float64, device="cpu")[0]
    rho = (1027.0 + 0.01 * torch.arange(grid.maskC.numel(),
                                        dtype=torch.float64)
           .reshape(grid.maskC.shape) % 1.0) * grid.maskC
    sigmaR = -1e-3 * grid.maskC
    return cfg, grid, rho, sigmaR


@pytest.mark.parametrize("field", ["tracer", "uTrans", "Kwx", "Kux"])
def test_calc_rhs_refuses_grad_with_gm(field):
    """Kernel C' has no GM branch: calc_rhs with a GM-Redi tensor refuses
    any input that requires grad (a GM component as a constant), on every
    device; and GM's wrappers refuse inputs that require grad."""
    cfg, grid, rho, sigmaR = _gm_case()
    gm = gmredi_mod.gm_tensor(cfg, grid, cfg.gmredi, rho, sigmaR)
    u = rho.clone()
    flow = gad.calc_adv_flow(grid, 0.0 * u, 0.0 * u, 0.0 * u)
    kappaR = 1e-4 * torch.ones_like(u)
    if field == "tracer":
        u.requires_grad_(True)
    elif field == "uTrans":
        flow = flow._replace(uTrans=flow.uTrans.clone().requires_grad_(True))
    else:
        gm = gm._replace(**{field: getattr(gm, field).clone()
                            .requires_grad_(True)})
    with pytest.raises(ValueError, match="require grad"):
        gad.calc_rhs(cfg, grid, flow, u, kappaR, cfg.diffKhT, gm=gm)
    gad.calc_rhs(cfg, grid, gad.calc_adv_flow(grid, 0.0 * rho, 0.0 * rho,
                                              0.0 * rho),
                 rho, kappaR, cfg.diffKhT,
                 gm=gm._replace(**{f: t.detach() for f, t in
                                   gm._asdict().items() if t is not None}))
    with pytest.raises(ValueError, match="gm_tensor"):
        gmredi_mod.gm_tensor(cfg, grid, cfg.gmredi,
                             rho.clone().requires_grad_(True), sigmaR)
    with pytest.raises(ValueError, match="gm_psi_b"):
        gmredi_mod.gm_psi_b(cfg, grid, cfg.gmredi, rho,
                            sigmaR.clone().requires_grad_(True))


@pytest.mark.parametrize("gm,extra,name", [
    (dict(taper_scheme="ldd97", advForm=True), {},
     "GM_taper_scheme='ldd97' with GM_AdvForm"),
    (dict(taper_scheme="fm07"), {}, "GM_taper_scheme='fm07'"),
    ({}, {"GM_Visbeck_alpha": 0.015}, "GM_Visbeck_alpha"),
    ({}, {"usingPCoords": True}, "p-coordinates")],
    ids=["ldd97-bolus", "unknown-taper", "visbeck", "p-coords"])
def test_check_gmredi_refuses(gm, extra, name):
    """check_supported lets useGMRedi through with the ported settings and
    refuses, by name, the taper that the bolus form's _slope_psi rejects,
    an unknown taper, variable K and p-coordinates."""
    cfg = synthetic.gm_gyre_config(nx=8, ny=8, nr=2, depth=300.0)
    kpp = synthetic.kpp_gyre_setup(cfg, dtype=torch.float64, device="cpu")[4]
    check_supported(cfg, kpp)
    cfg.gmredi = dataclasses.replace(cfg.gmredi, **gm)
    if "usingPCoords" in extra:
        cfg.usingPCoords = True
    else:
        cfg.extra.update(extra)
    with pytest.raises(NotImplementedError, match=name):
        check_supported(cfg, kpp)
    cfg.usingPCoords = False
    cfg.gmredi = None
    with pytest.raises(NotImplementedError, match="GMParams"):
        check_supported(cfg, kpp)


@pytest.mark.parametrize("taper", ["", "clipping", "orig", "gkw91", "linear",
                                   "dm95", "ldd97", "ac02"])
def test_check_gmredi_accepts(taper):
    """Every taper in the skew-flux form, every one but ldd97 in the bolus
    form, with and without GM_NON_UNITY_DIAGONAL."""
    cfg = synthetic.gm_gyre_config(nx=8, ny=8, nr=2, depth=300.0)
    kpp = synthetic.kpp_gyre_setup(cfg, dtype=torch.float64, device="cpu")[4]
    for adv in (False, True):
        for nu in (False, True):
            cfg.gmredi = dataclasses.replace(cfg.gmredi, taper_scheme=taper,
                                             advForm=adv, nonUnityDiagonal=nu)
            if adv and taper == "ldd97":
                continue
            check_supported(cfg, kpp)


def test_adjoint_refuses_seaice():
    for config in (synthetic.ice_gyre_config, synthetic.evp_ice_gyre_config):
        cfg = config(nx=8, ny=8, nr=2, depth=300.0)
        with pytest.raises(NotImplementedError, match="useSEAICE"):
            adjoint.check_adjoint_supported(cfg)


def _ice_step_against_jax(settings, wind=1.0, after=None):
    """One forward_step of the 16x16x12 ice-gyre with these sea-ice
    settings (then the parameters of `after` set on both packages'), the
    wind scaled by `wind` and a drifting initial ice, against the JAX
    package's step run op by op: every ice field, uVel and theta to 12
    digits. Returns the initial and the new state."""
    import jax

    from mitgcm_tpu_torch.model.seaice import params_from_namelists
    from mitgcm_tpu_torch.model.step import forward_step
    from mitgcm_tpu_torch.utils.compare import digits
    from test_torch_evp_gyre import jax_objects

    cfg = synthetic.ice_gyre_config(nx=16, ny=16, nr=12, depth=300.0)
    cfg.seaice = params_from_namelists(cfg, settings)
    after = after or {}
    for k, v in after.items():
        setattr(cfg.seaice, k, v)
    objs = synthetic.ice_gyre_setup(cfg, dtype=torch.float64, device="cpu")
    grid, state, forcing, op, kpp, si = objs
    state.uIce = 0.1 * si.seaiceMaskU
    state.vIce = -0.05 * si.seaiceMaskV
    forcing.fu, forcing.fv = forcing.fu * wind, forcing.fv * wind
    jx = jax_objects(cfg, objs, settings)
    for k, v in after.items():
        setattr(jx.seaice.p, k, v)
    new, _ = forward_step(cfg, grid, op, state, forcing, 0, kpp=kpp,
                          seaice=si)
    with jax.disable_jit():
        jx.run(n_steps=1, collect_monitor=False)
    want = jx.state
    for name in ("uIce", "vIce", "siAREA", "siHEFF", "siHSNOW", "uVel",
                 "theta"):
        d = digits(getattr(new, name)[..., 2:-2, 2:-2].numpy(),
                   np.asarray(getattr(want, name))[..., 2:-2, 2:-2])
        assert d >= 12, (name, d)
    return state, new


def test_no_dynamics_step_against_jax():
    """forward_step with SEAICEuseDYNAMICS = F (the ice drag from the
    standing ice velocity, no solver) against the JAX package's step, op by
    op: one step of the 16x16x12 ice-gyre with a drifting initial ice, every
    ice field and the ocean's surface stress to 12 digits."""
    state, new = _ice_step_against_jax(
        {**synthetic.ICE_GYRE_SEAICE, "SEAICEuseDYNAMICS": False})
    assert torch.equal(new.uIce, state.uIce)


def test_free_drift_evp_clip_step_against_jax():
    """Free drift set on EVP parameters (params_from_namelists clears
    useEVP under free drift, so it is set afterwards) with
    SEAICE_clipVelocities: the free-drift velocity is capped at 0.40 m/s
    after the ocean stress, as the JAX package caps it whenever EVP is set
    (its seaice.py:2063), under a tenfold wind where the cap binds; one
    step against JAX, op by op, 12 digits."""
    _, new = _ice_step_against_jax(
        {**synthetic.ICE_GYRE_SEAICE, **AEVP,
         "SEAICE_clipVelocities": True}, wind=10.0,
        after={"useFreeDrift": True})
    assert float(new.uIce.abs().max()) == 0.40
