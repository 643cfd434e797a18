"""PyTorch port: the cg3d solve of the non-hydrostatic pressure (plain twin
of kernel H-cg3d, solver/cg3d.py) against the JAX package, in float64 on
the CPU, on the walled 16x16x12 grid with a bank and partial bottom cells
of tests/test_torch_grid.py (dry columns, dry cells under the bank and the
partial cells, so dry pivots in the preconditioner).

build_cg3d's seven arrays and its norm agree to 13 digits or more. A solve
from a seeded right-hand side and warm start takes the same number of
iterations in both packages, below the cap and at a small cg3dMaxIters;
its first residual agrees to 12 digits and x to 10: both packages iterate
the same PCG in the same element-wise order, but sum the dot products in
different orders (XLA's reduction against the port's column sums and fixed
block tree, which kernel H-cg3d shares), and the solve amplifies that.
CG3DSolve's backward (a second solve, JAX's custom VJP) agrees with
jax.vjp of JAX's cg3d to 10 digits. JAX runs jitted (its while_loop is
compiled either way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.ops.stencil import interior_mask
from mitgcm_tpu.solver import cg3d as jcg3
from mitgcm_tpu_torch.solver import cg3d as tcg3
from mitgcm_tpu_torch.utils.compare import digits, interior
from mitgcm_tpu_torch.utils.convert import arrays_of
from test_torch_config import jax_config
from test_torch_grid import nh_walled_config, nh_walled_grid

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def walled():
    cfg = nh_walled_config()
    jgrid, tgrid = nh_walled_grid(cfg)
    return cfg, jgrid, tgrid


def _ops(cfg, jgrid, tgrid):
    return (jcg3.build_cg3d(jax_config(cfg), jgrid),
            tcg3.build_cg3d(cfg, tgrid))


def test_build_cg3d(walled):
    cfg, jgrid, tgrid = walled
    jop, top = _ops(cfg, jgrid, tgrid)
    ref = arrays_of(jop)
    for f in dataclasses.fields(top):
        d = digits(getattr(top, f.name).numpy(), ref[f.name])
        assert d >= 13, f"op3.{f.name}: {d:.2f} digits"
    dry = top.aC.numpy() == 0.0
    assert dry.any() and (~dry).any()
    assert np.array_equal(top.zMC.numpy()[dry], np.ones(dry.sum()))


def _rhs(tgrid, cfg, seed):
    """A seeded right-hand side and warm start on the wet interior."""
    rng = np.random.default_rng(seed)
    shape = tuple(tgrid.hFacC.shape)
    mask = tgrid.maskC.numpy() * np.asarray(
        interior_mask(shape[1:], cfg.oly, cfg.olx, jnp.float64))[None]
    b = rng.standard_normal(shape) * mask
    x0 = 0.1 * rng.standard_normal(shape) * mask
    return b, x0


@pytest.mark.parametrize("max_iters", [200, 7], ids=["converged", "capped"])
def test_cg3d_solve(walled, max_iters):
    cfg, jgrid, tgrid = walled
    cfg = dataclasses.replace(cfg, cg3dMaxIters=max_iters)
    jcfg = jax_config(cfg)
    jop, top = _ops(cfg, jgrid, tgrid)
    b, x0 = _rhs(tgrid, cfg, 21)
    want = jcg3.cg3d(jcfg, jgrid, jop, jnp.asarray(b), jnp.asarray(x0))
    got = tcg3.cg3d(cfg, tgrid, top, torch.from_numpy(b),
                    torch.from_numpy(x0))
    assert got.n_iters == int(want.n_iters)
    if max_iters == 7:
        assert got.n_iters == 7
    else:
        assert 10 < got.n_iters < max_iters
        assert float(got.last_residual) < cfg.cg3dTargetResidual
    ol = cfg.olx
    assert digits(interior(got.x, ol), interior(np.asarray(want.x), ol)) >= 10
    assert digits(float(got.first_residual),
                  float(want.first_residual)) >= 12
    assert got.host_syncs == got.n_iters + 1


def test_cg3d_vjp(walled):
    cfg, jgrid, tgrid = walled
    jcfg = jax_config(cfg)
    jop, top = _ops(cfg, jgrid, tgrid)
    b, x0 = _rhs(tgrid, cfg, 22)
    ct = np.random.default_rng(23).standard_normal(b.shape)
    _, vjp = jax.vjp(lambda bb: jcg3.cg3d(jcfg, jgrid, jop, bb,
                                          jnp.asarray(x0)).x, jnp.asarray(b))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    bt = torch.from_numpy(b).requires_grad_(True)
    x = tcg3.cg3d(cfg, tgrid, top, bt, torch.from_numpy(x0)).x
    (got,) = torch.autograd.grad(x, bt, torch.from_numpy(ct))
    assert np.abs(want).max() > 0.0
    assert digits(got.numpy(), want) >= 10
