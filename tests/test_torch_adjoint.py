"""PyTorch port: the adjoint of the gyre (reverse-mode autograd through the
checkpointed stepping loop) against the JAX package, in float64 on the CPU.

The twin of tests/test_adjoint.py (grdchk on the 16x16x4 gyre, 6 steps,
chunked), then the cost and the whole gradient field against JAX's
adjoint_gradient on the same control, a step cost over a step count that
the JAX package pads to whole chunks, checkpointing against none, and a
gradcheck of the plain path. Both packages get the same control, made with
numpy and carried across by utils/convert.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.ad import adjoint as jadj
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.ad import adjoint as tadj
from mitgcm_tpu_torch.ad import grdchk
from mitgcm_tpu_torch.core.state import State
from mitgcm_tpu_torch.model.step import forward_step
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior

torch.set_num_threads(1)

SIZE = dict(nx=16, ny=16, nr=4)
BOX, K_RANGE = (8, 12, 8, 12), (0, 2)


class Port:
    """The port's 16x16x4 gyre with the box cost of tests/test_adjoint.py."""

    def __init__(self, n_steps):
        self.cfg = tsyn.gyre_config(**SIZE, n_steps=n_steps)
        self.grid, self.state, self.forcing, self.op = tsyn.gyre_setup(
            self.cfg, dtype=torch.float64, device="cpu")
        self.control = tadj.Control(self.cfg, self.grid, field="theta")
        self.cost = tadj.cost_boxmean_tracer(self.cfg, self.grid, "theta",
                                             box=BOX, k_range=K_RANGE)

    def objective(self, n_steps, **kw):
        return tadj.make_objective(self.cfg, self.grid, self.op, self.forcing,
                                   self.state, self.control, self.cost,
                                   n_steps, **kw)


@pytest.fixture(scope="module")
def port():
    return Port(6)


@pytest.fixture(scope="module")
def control_xx(port):
    """A seeded control perturbation (K) on the wet points."""
    rng = np.random.default_rng(5)
    return 0.1 * rng.standard_normal(tuple(port.grid.maskC.shape))


def test_grdchk_agreement(port):
    cfg = port.cfg
    positions = [(1, cfg.oly + 9, cfg.olx + 9), (0, cfg.oly + 10, cfg.olx + 8),
                 (2, cfg.oly + 6, cfg.olx + 11)]
    res = grdchk.grdchk(port.objective(6), port.control.zero(), positions,
                        eps=1.0e-4)
    assert [r["pos"] for r in res] == positions
    for r in res:
        assert set(r) == {"pos", "fc_ref", "fc_plus", "fc_minus", "fd_grad",
                          "adj_grad", "rel_err"}
        assert r["adj_grad"] != 0.0, r
        assert abs(r["rel_err"]) < 1.0e-5, r


def test_gradient_nonlocal(port):
    """Sensitivity propagates upstream of the cost box."""
    _, grad = tadj.adjoint_gradient(port.objective(6), port.control.zero())
    assert int((interior(grad, port.cfg.olx) != 0).sum()) > 100


def _jax_objective(n_steps, step_cost=False):
    cfg = jsyn.gyre_config(**SIZE, n_steps=n_steps)
    grid, state, forcing, op = jsyn.gyre_setup(cfg, dtype=jnp.float64)
    control = jadj.Control(cfg, grid, field="theta")
    cost = jadj.cost_boxmean_tracer(cfg, grid, "theta", box=BOX,
                                    k_range=K_RANGE)
    if not step_cost:
        return jadj.make_objective(cfg, grid, op, forcing, state, control,
                                   cost, n_steps)

    def J(xx):
        s = control.apply(state, xx)
        return jadj.run_steps(cfg, grid, op, s, forcing, n_steps,
                              step_cost=lambda st, it: cost(st))[1]
    return J


def _assert_matches_jax(fc, grad, want_fc, want_grad):
    assert digits(float(fc), float(want_fc)) >= 10
    assert digits(convert.to_numpy(grad), np.asarray(want_grad)) >= 10


def test_gradient_vs_jax(port, control_xx):
    """Cost and gradient field of the 6-step objective (two checkpointed
    chunks of 3 steps) against JAX's adjoint_gradient."""
    want = jadj.adjoint_gradient(_jax_objective(6), jnp.asarray(control_xx))
    got = tadj.adjoint_gradient(port.objective(6),
                                convert.to_tensor(control_xx, device="cpu"))
    _assert_matches_jax(*got, *want)


def test_step_cost_vs_jax(control_xx):
    """A cost summed over 5 steps: the JAX package pads its scan to 2 chunks
    of 3 with a no-op step, the port runs exactly 5 steps."""
    p = Port(5)

    def J(xx):
        s = p.control.apply(p.state, xx)
        return tadj.run_steps(p.cfg, p.grid, p.op, s, p.forcing, 5,
                              step_cost=lambda st, it: p.cost(st))[1]
    want = jadj.adjoint_gradient(_jax_objective(5, step_cost=True),
                                 jnp.asarray(control_xx))
    _assert_matches_jax(*tadj.adjoint_gradient(
        J, convert.to_tensor(control_xx, device="cpu")), *want)


@pytest.mark.parametrize("chunks", [None, 2])
def test_checkpointing_is_exact(port, control_xx, chunks):
    """9 steps in checkpointed chunks (3 of 3, or 5 + 4) against the plain
    loop with every intermediate kept: bit-equal cost and gradient."""
    def plain(xx):
        s = port.control.apply(port.state, xx)
        for it in range(9):
            s = forward_step(port.cfg, port.grid, port.op, s, port.forcing,
                             port.cfg.nIter0 + it)[0]
        return port.cost(s)
    xx = convert.to_tensor(control_xx, device="cpu")
    fc, grad = tadj.adjoint_gradient(
        port.objective(9, checkpoint_chunks=chunks), xx)
    want_fc, want_grad = tadj.adjoint_gradient(plain, xx)
    assert torch.equal(fc, want_fc)
    assert torch.equal(grad, want_grad)


def test_control_pack_roundtrip(port, control_xx):
    """Control.pack orders the wet points as the JAX package does."""
    jcfg = jsyn.gyre_config(**SIZE)
    jgrid = jsyn.gyre_setup(jcfg, dtype=jnp.float64)[0]
    want = np.asarray(jadj.Control(jcfg, jgrid).pack(jnp.asarray(control_xx)))
    vec = port.control.pack(convert.to_tensor(control_xx, device="cpu"))
    assert np.array_equal(convert.to_numpy(vec), want)
    back = port.control.unpack(vec)
    assert torch.equal(back, convert.to_tensor(control_xx, device="cpu") * (
        port.grid.maskC > 0))


def test_gradcheck_plain_path():
    """torch.autograd.gradcheck (fast mode) of 2 steps of an 8x8x2 gyre
    through every differentiable input of the step: the theta control and
    nonzero initial u and v, so the quadratic advection terms, the fills,
    the in-place writes of the step and the cg2d backward are all on the
    path. The objective is scaled to O(1) so that the finite differences
    are not swamped by rounding."""
    cfg = tsyn.gyre_config(nx=8, ny=8, nr=2)
    grid, state0, forcing, op = tsyn.gyre_setup(cfg, dtype=torch.float64,
                                                device="cpu")
    rng = np.random.default_rng(3)
    shape = tuple(grid.maskC.shape)
    u0 = torch.from_numpy(0.05 * rng.standard_normal(shape)) * grid.maskW
    v0 = torch.from_numpy(0.05 * rng.standard_normal(shape)) * grid.maskS
    cost = tadj.cost_boxmean_tracer(cfg, grid, "theta", box=(2, 6, 2, 6),
                                    k_range=(0, 2))

    def J(xx, u, v):
        s = State(**{**state0.__dict__, "uVel": u, "vVel": v})
        s = tadj.run_steps(cfg, grid, op, tadj.Control(cfg, grid).apply(
            s, xx), forcing, 2)
        return (cost(s) / 1e12 + torch.sum(s.uVel * grid.maskW) * 10.0
                + torch.sum(s.etaN))

    inputs = (torch.zeros(shape, dtype=torch.float64), u0, v0)
    assert torch.autograd.gradcheck(
        J, tuple(t.clone().requires_grad_(True) for t in inputs),
        eps=1e-6, atol=1e-6, rtol=1e-5, fast_mode=True)
