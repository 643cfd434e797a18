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

The iteration's two twins (s_stencil_dot, then xr_precond with P's column
solve fused into the update) give x bit for bit and the iteration counts
of the three-twin iteration that they replaced (precond_dot,
s_stencil_dot, xr_update, written out below), on the 64x64x12 box with
walls, a bank and partial cells and on the periodic one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.ops.stencil import interior_mask
from mitgcm_tpu.solver import cg3d as jcg3
from mitgcm_tpu_torch.core.grid import build_grid
from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo
from mitgcm_tpu_torch.ops.stencil import interior_mask as tinterior_mask
from mitgcm_tpu_torch.solver import cg3d as tcg3
from mitgcm_tpu_torch.solver.cg2d import _grid_sum, _set_interior
from mitgcm_tpu_torch.utils.compare import digits, interior
from mitgcm_tpu_torch.utils.convert import arrays_of
from test_torch_config import jax_config
from mitgcm_tpu_torch.utils import synthetic as tsyn
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
        if f.name == "imask3":
            # the port's solve mask (no JAX field): the interior x maskC
            inner = np.zeros(top.imask3.shape)
            inner[:, cfg.oly:-cfg.oly, cfg.olx:-cfg.olx] = 1.0
            assert np.array_equal(top.imask3.numpy(),
                                  inner * tgrid.maskC.numpy())
            continue
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


def _box64(walled):
    """The 64x64x12 box on the CPU in float64: with walls, a bank and a row
    of partial bottom cells (chip_smoke.py's NhCase below full size), or
    periodic and flat."""
    n, nr = 64, 12
    if not walled:
        cfg = tsyn.nh_convection_config(nx=n, ny=n, nr=nr)
        return cfg, build_grid(cfg, dtype=torch.float64, device="cpu")
    cfg = tsyn.nh_convection_config(nx=n, ny=n, nr=nr, hFacMin=0.2)
    depth, dz = sum(cfg.delR), cfg.delR[-1]
    bathy = np.full((n, n), -depth)
    bathy[3 * n // 16:7 * n // 16, 10 * n // 16:14 * n // 16] = (
        -0.5 * depth - 0.5 * dz)
    bathy[9 * n // 16, 6 * n // 16:12 * n // 16] = -depth + 0.4 * dz
    bathy[0, :] = bathy[-1, :] = bathy[:, 0] = bathy[:, -1] = 0.0
    return cfg, build_grid(cfg, bathy=bathy, dtype=torch.float64,
                           device="cpu")


def _three_twin_solve(cfg, grid, op, b, x0):
    """The plain path's PCG loop as three twins an iteration (P's solve
    with dot(q, r); s' and A s' with dot(s', qA); the x and r updates with
    dot(r, r)), in the operations of the solver before P was fused into
    the update: (x, iterations, first and last squared residual)."""
    oly, olx, maskC = cfg.oly, cfg.olx, grid.maskC
    imask = tinterior_mask(b.shape, oly, olx, b.dtype, b.device) * maskC
    col = tcg3._col_sum

    def precond_dot(r, q):
        qf, qkm1 = [], torch.zeros_like(r[0])
        for k in range(r.shape[0]):
            qkm1 = op.zMC[k] * (r[k] - op.zML[k] * qkm1)
            qf.append(qkm1)
        qb, qkp1 = [None] * len(qf), torch.zeros_like(r[0])
        for k in reversed(range(len(qf))):
            qkp1 = qf[k] - op.zMU[k] * qkp1
            qb[k] = qkp1
        qb = torch.stack(qb)
        _set_interior(q, qb, oly, olx)
        return _grid_sum(col(qb, r, maskC, reversed(range(len(qb)))), oly,
                         olx)

    def s_stencil_dot(q, s_in, s_out, qa, beta):
        s = (q + beta * s_in) * imask
        _set_interior(s_out, s, oly, olx)
        a = tcg3.apply_A(op, cyclic_fill_halo(s, oly, olx,
                                              impl="plain")) * imask
        _set_interior(qa, a, oly, olx)
        return _grid_sum(col(s, a, maskC, range(s.shape[0])), oly, olx)

    def xr_update(x, r, s, q, alpha):
        _set_interior(x, (x + alpha * s) * imask, oly, olx)
        rn = (r - alpha * q) * imask
        _set_interior(r, rn, oly, olx)
        return _grid_sum(col(rn, rn, maskC, range(rn.shape[0])), oly, olx)

    b = b * op.cg3dNorm * imask
    rhsMax = torch.max(torch.abs(b))
    rhsNorm = torch.where(rhsMax != 0.0, 1.0 / rhsMax, torch.ones_like(rhsMax))
    b, x0 = b * rhsNorm, x0 * rhsNorm
    one = torch.ones((), dtype=b.dtype)
    x, r = x0 * imask, b.clone()
    s = [torch.zeros_like(b), torch.zeros_like(b)]
    q, qa = torch.zeros_like(b), torch.zeros_like(b)
    s_stencil_dot(x, s[0], s[1], qa, one / one)
    err0 = err = xr_update(x, r, s[0], qa, one / one)
    eta_nm1, cur, it = one, 0, 0
    while err.item() >= op.tolerance_sq.item() and it < cfg.cg3dMaxIters:
        eta_n = precond_dot(r, q)
        sq = s_stencil_dot(q, s[cur], s[1 - cur], qa, eta_n / eta_nm1)
        err = xr_update(x, r, s[1 - cur], qa, eta_n / sq)
        eta_nm1, cur, it = eta_n, 1 - cur, it + 1
    return cyclic_fill_halo(x / rhsNorm, oly, olx), it, err0, err


@pytest.mark.parametrize("walled", [True, False], ids=["walled", "periodic"])
def test_cg3d_two_twins_match_three(walled):
    cfg, grid = _box64(walled)
    # a cap the seeded solves stay under (437 and 210 iterations)
    cfg = dataclasses.replace(cfg, cg3dMaxIters=500)
    op = tcg3.build_cg3d(cfg, grid)
    b, x0 = _rhs(grid, cfg, 31 + walled)
    b, x0 = torch.from_numpy(b), torch.from_numpy(x0)
    want_x, want_it, want_err0, want_err = _three_twin_solve(cfg, grid, op,
                                                             b, x0)
    got = tcg3.cg3d(cfg, grid, op, b, x0)
    assert 10 < got.n_iters < cfg.cg3dMaxIters
    assert got.n_iters == want_it
    assert torch.equal(got.x, want_x)
    assert torch.equal(got.first_residual, torch.sqrt(want_err0))
    assert torch.equal(got.last_residual, torch.sqrt(want_err))
