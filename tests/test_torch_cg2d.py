"""PyTorch port: the cg2d solve (plain twin of kernel A) against the JAX
package, with the min-residual selection on and off, at the iteration cap,
with a zero right-hand side and in float32; and kernel A's wrapper with its
launch mocked.

Both packages iterate the same PCG in the same element-wise order; only the
order of the global dot-product sums differs (XLA's reduction against the
port's fixed block order, which the CUDA kernel shares). The solve
amplifies that last-bit difference, so the bar is 10 digits for x and the
first residual. The last residual sits at the 1e-7 convergence floor of
the normalised system, where it is a difference of nearly equal sums: it is
held to 9 digits.

In float32 the same last-bit difference starts at 1e-7 and the 89
iterations amplify it about a thousandfold: x is held to 3.5 digits
(measured 4.21), the first residual, a single sum, to 6.5 (measured 7.08),
and the last residual, which both packages drive below the target residual
where float32 keeps no digit of it (measured 1.26), only to that target.
The iterations are equal.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.ops.stencil import interior_mask
from mitgcm_tpu.solver import cg2d as jcg
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.solver import cg2d as tcg
from mitgcm_tpu_torch.solver.cg2d import CG2DOperator
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior

torch.set_num_threads(1)

# (the min-residual selection, cg2dMaxIters, the right-hand side's scale,
# float32); the first two keep their earlier ids
CASES = [
    pytest.param((1, None, 1.0, False), id="1"),
    pytest.param((0, None, 1.0, False), id="0"),
    pytest.param((1, 5, 1.0, False), id="cap5-minres1"),
    pytest.param((0, 5, 1.0, False), id="cap5-minres0"),
    pytest.param((1, None, 0.0, False), id="zero-rhs"),
    pytest.param((1, None, 1.0, True), id="float32"),
]


@pytest.mark.parametrize("case", CASES)
def test_cg2d_solve(case):
    use_min_res, max_iters, scale, f32 = case
    cfg = jsyn.gyre_config(nx=32, ny=32, nr=4)
    cfg.cg2dUseMinResSol = use_min_res
    if max_iters is not None:
        cfg.cg2dMaxIters = max_iters
    jdt, tdt = ((jnp.float32, torch.float32) if f32
                else (jnp.float64, torch.float64))
    grid, _, _, op = jsyn.gyre_setup(cfg, dtype=jdt)
    rng = np.random.default_rng(7)
    shape = grid.rA.shape
    mask = np.asarray(grid.maskInC, np.float64) * np.asarray(
        interior_mask(shape, cfg.oly, cfg.olx, jnp.float64))
    # a zero right-hand side from a zero first guess: rhsMax = 0, no
    # iteration
    b = rng.standard_normal(shape) * mask * scale
    x0 = 0.1 * rng.standard_normal(shape) * mask * scale

    want = jcg.cg2d(cfg, grid, op, jnp.asarray(b, jdt), jnp.asarray(x0, jdt))
    top = convert.from_arrays(CG2DOperator, convert.arrays_of(op),
                              device="cpu")
    got = tcg.cg2d(cfg, top, torch.from_numpy(b).to(tdt),
                   torch.from_numpy(x0).to(tdt))

    assert got.x.dtype == tdt
    assert got.n_iters == int(want.n_iters)
    if scale == 0.0:
        assert got.n_iters == 0
        assert not torch.any(got.x)
    elif max_iters is not None:
        assert got.n_iters == max_iters
    else:
        assert got.n_iters > 10
    ol = cfg.olx
    x_digits, first_digits = (3.5, 6.5) if f32 else (10, 10)
    assert digits(interior(got.x, ol),
                  interior(np.asarray(want.x), ol)) >= x_digits
    assert digits(float(got.first_residual),
                  float(want.first_residual)) >= first_digits
    if f32:
        target = cfg.cg2dTargetResidual
        assert float(got.last_residual) <= target
        assert float(want.last_residual) <= target
    else:
        assert digits(float(got.last_residual),
                      float(want.last_residual)) >= 9
    assert got.host_syncs == got.n_iters + 2


def test_cg2d_kernel_wrapper(monkeypatch):
    """Kernel A's path of the solve on CPU tensors, with the launch mocked:
    one cg2d_solve launch a solve, forward and in CG2DSolve.backward (its
    adjoint solve, counted under "adjoint"), with as many arguments as its
    C signature names, one host read, and the per-iteration entry points
    gone."""
    cfg = tsyn.gyre_config(nx=40, ny=24, nr=4)
    _, _, _, op = tsyn.gyre_setup(cfg, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(3)
    b = torch.from_numpy(rng.standard_normal(tuple(op.aW.shape)))
    b.requires_grad_(True)
    x0 = torch.zeros_like(b)

    calls = []

    def launch(kernel, dtype, *args):
        calls.append((kernel, len(args), tuple(kernels._labels)))

    tiles = []
    library = types.SimpleNamespace(
        mitgcm_cg2d_num_partials=lambda ny, nx: tiles.append((ny, nx))
        or -(-nx // 32) * -(-ny // 8))
    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(kernels, "use_kernel",
                        lambda t, impl: impl != "plain")
    monkeypatch.setattr(kernels, "check_tensors", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "library", lambda: library)
    reads = []
    monkeypatch.setattr(tcg, "_iterations",
                        lambda ctrl: reads.append(ctrl) or 0)

    res = tcg.cg2d(cfg, op, b, x0)
    res.x.sum().backward()

    solves = [c for c in calls if c[0] == "cg2d_solve"]
    assert [labels for _, _, labels in solves] == [(), ("adjoint",)]
    # the stream is the C entry point's last argument, added by launch
    assert all(n == len(kernels.SIGNATURES["cg2d_solve"]) - 1
               for _, n, _ in solves)
    assert tiles == [(cfg.ny, cfg.nx)] * 2
    assert res.host_syncs == 1 and len(reads) == 2
    assert b.grad is not None and b.grad.shape == b.shape
    gone = {"cg2d_stencil_dot", "cg2d_s_update", "cg2d_xr_update"}
    assert not gone & set(kernels.SIGNATURES)
