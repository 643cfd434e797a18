"""PyTorch port: guards. The port never imports jax, has no CPU fallback
for its GPU run, refuses configurations off its ported main path, and its
kernel wrappers refuse to differentiate what their kernels treat as
constants."""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest
import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.model import gad, mom_fluxform
from mitgcm_tpu_torch.model.step import check_supported
from mitgcm_tpu_torch.solver import cg2d
from mitgcm_tpu_torch.utils import synthetic

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ONE_STEP = """
import sys
import torch
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.model.step import forward_step
from mitgcm_tpu_torch.utils import synthetic
cfg = synthetic.gyre_config(nx=12, ny=10, nr=3)
grid, state, forcing, op = synthetic.gyre_setup(cfg, dtype=torch.float64)
state, diag = forward_step(cfg, grid, op, state, forcing, 0)
assert diag.cg2d_iters > 0 and bool(torch.isfinite(state.uVel).all())
assert "jax" not in sys.modules, "the port imported jax"
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
grid, state, forcing, op = synthetic.gyre_setup(cfg, dtype=torch.float64)
control = adjoint.Control(cfg, grid)
cost = adjoint.cost_boxmean_tracer(cfg, grid, box=(2, 6, 2, 6))
J = adjoint.make_objective(cfg, grid, op, forcing, state, control, cost, 5)
r, = grdchk.grdchk(J, control.zero(), [(0, 5, 5)])
assert r["adj_grad"] != 0.0 and abs(r["rel_err"]) < 1e-5, r
assert "jax" not in sys.modules, "the port's adjoint imported jax"
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
    grid = synthetic.gyre_setup(cfg, dtype=torch.float64)[0]
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
    grid = synthetic.gyre_setup(cfg, dtype=torch.float64)[0]
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


@pytest.mark.parametrize("flag,value", [
    ("useAB3", True), ("vectorInvariantMomentum", True),
    ("nonlinFreeSurf", 4), ("implicitDiffusion", True), ("useKPP", True),
    ("eosType", "JMD95Z"), ("viscA4", 1.0e9), ("tempAdvScheme", 33),
    ("usingSphericalPolarGrid", True)])
def test_check_supported_raises(flag, value):
    cfg = synthetic.gyre_config(nx=8, ny=8, nr=2)
    check_supported(cfg)
    setattr(cfg, flag, value)
    with pytest.raises(NotImplementedError):
        check_supported(cfg)


def test_no_silent_fallback():
    cfg = synthetic.gyre_config(nx=8, ny=8, nr=2)
    _, _, _, op = synthetic.gyre_setup(cfg, dtype=torch.float64)
    b = torch.zeros_like(op.aW)
    with pytest.raises(ValueError):
        cg2d.cg2d(cfg, op, b, b, impl="cuda")
    with pytest.raises(ValueError):   # what a kernel would be handed
        kernels.check_tensors(torch.float64, b=b)
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError):
            kernels.nvcc_path()
