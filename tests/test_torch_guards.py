"""PyTorch port: guards. The port never imports jax, has no CPU fallback
for its GPU run, and refuses configurations off its ported main path."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from mitgcm_tpu_torch import kernels
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
