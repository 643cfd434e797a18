"""PyTorch port: the backward passes of the modules that hold a kernel,
against jax.vjp of the JAX package's functions, in float64 on the CPU.

On the CPU the port's wrappers run their plain twins, so these are the
plain VJPs (autograd through the twins) that the backward kernels B' and
C' are held against on the card. Cotangents are seeded on interior output
cells only: kernels B and C write constant zeros on halo cells, the twins
write garbage there, so a halo cotangent would reach the inputs through the
twin alone. The input cotangents are compared on every cell, halos
included: the forward pass reads inputs one cell outside the interior.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import gad as jgad
from mitgcm_tpu.model import mom_fluxform as jmom
from mitgcm_tpu.ops import stencil as jst
from mitgcm_tpu.ops.stencil import interior_mask
from mitgcm_tpu.solver import cg2d as jcg
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import gad as tgad
from mitgcm_tpu_torch.model import mom_fluxform as tmom
from mitgcm_tpu_torch.ops import stencil as tst
from mitgcm_tpu_torch.solver import cg2d as tcg
from mitgcm_tpu_torch.solver.cg2d import CG2DOperator
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils.compare import digits

torch.set_num_threads(1)

NX, NY, NR = 16, 16, 4


@pytest.fixture(scope="module")
def setup():
    cfg = jsyn.gyre_config(nx=NX, ny=NY, nr=NR)
    jgrid = jsyn.gyre_setup(cfg, dtype=jnp.float64)[0]
    tgrid = convert.from_arrays(Grid, convert.arrays_of(jgrid), device="cpu")
    return cfg, jgrid, tgrid


def _interior_noise(rng, shape, ol):
    a = rng.standard_normal(shape)
    a[..., :ol, :] = a[..., -ol:, :] = 0.0
    a[..., :, :ol] = a[..., :, -ol:] = 0.0
    return a


def _torch_vjp(fn, inputs, cotangents):
    ins = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    out = fn(*ins)
    out = out if isinstance(out, (tuple, list)) else (out,)
    return torch.autograd.grad(out, ins,
                               [torch.from_numpy(c) for c in cotangents])


@pytest.mark.parametrize("shape,oly,olx", [((2, 12, 14), 2, 2),
                                           ((11, 7), 4, 1)])
def test_fill_backward(shape, oly, olx):
    """The fill's fixed-order fold is the transpose of its gather, also
    when a halo is wider than the interior."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal(shape)
    g = rng.standard_normal(np.asarray(tst.cyclic_fill_halo(
        torch.from_numpy(a), oly, olx)).shape)
    _, vjp = jax.vjp(lambda x: jst.cyclic_fill_halo(x, oly, olx),
                     jnp.asarray(a))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got, = _torch_vjp(lambda x: tst.cyclic_fill_halo(x, oly, olx), [a], [g])
    assert digits(got.numpy(), want) >= 15


def test_cg2d_vjp():
    """CG2DSolve's backward (a second solve from a zero first guess)
    against jax.vjp of the JAX package's custom VJP; x0 gets a zero
    gradient and, as in JAX, x_bar's halo cells are dropped."""
    cfg = jsyn.gyre_config(nx=16, ny=16, nr=4)
    grid, _, _, op = jsyn.gyre_setup(cfg, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    shape = grid.rA.shape
    mask = np.asarray(grid.maskInC) * np.asarray(
        interior_mask(shape, cfg.oly, cfg.olx, jnp.float64))
    b = rng.standard_normal(shape) * mask
    x0 = 0.1 * rng.standard_normal(shape) * mask
    x_bar = rng.standard_normal(shape)

    _, vjp = jax.vjp(lambda b_, x0_: jcg.cg2d(cfg, grid, op, b_, x0_).x,
                     jnp.asarray(b), jnp.asarray(x0))
    want_b, want_x0 = map(np.asarray, vjp(jnp.asarray(x_bar)))
    top = convert.from_arrays(CG2DOperator, convert.arrays_of(op),
                              device="cpu")
    got_b, got_x0 = _torch_vjp(lambda b_, x0_: tcg.cg2d(cfg, top, b_, x0_).x,
                               [b, x0], [x_bar])
    assert digits(got_b.numpy(), want_b) >= 10
    assert not np.any(want_x0) and not torch.any(got_x0)


def _mom_fields(grid, seed, kappa_scale):
    """The inputs of tests/test_torch_mom.py."""
    rng = np.random.default_rng(seed)
    shape = grid.hFacC.shape
    u = 0.1 * rng.standard_normal(shape) * np.asarray(grid.maskW)
    v = 0.1 * rng.standard_normal(shape) * np.asarray(grid.maskS)
    w = 1e-4 * rng.standard_normal(shape) * np.asarray(grid.maskC)
    kshape = (shape[0] + 1,) + shape[1:]
    kU = kappa_scale * np.abs(rng.standard_normal(kshape))
    kV = kappa_scale * np.abs(rng.standard_normal(kshape))
    return (u, v, w), (kU, kV), rng


@pytest.mark.parametrize("seed,kappa_scale", [(0, 0.0), (1, 1e-3)])
def test_mom_fluxform_vjp(setup, seed, kappa_scale):
    cfg, jgrid, tgrid = setup
    uvw, (kU, kV), rng = _mom_fields(jgrid, seed, kappa_scale)
    bars = [_interior_noise(rng, uvw[0].shape, cfg.olx) for _ in range(4)]

    def jfn(u, v, w):
        return tuple(jmom.mom_fluxform(cfg, jgrid, u, v, w, jnp.asarray(kU),
                                       jnp.asarray(kV)))
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, uvw))
    want = vjp(tuple(map(jnp.asarray, bars)))
    got = _torch_vjp(lambda u, v, w: tuple(tmom.mom_fluxform(
        cfg, tgrid, u, v, w, torch.from_numpy(kU), torch.from_numpy(kV))),
        uvw, bars)
    plain = tmom.mom_fluxform_vjp_plain(
        cfg, tgrid, *map(torch.from_numpy, uvw), torch.from_numpy(kU),
        torch.from_numpy(kV), [torch.from_numpy(b) for b in bars])
    for name, g, p, w in zip("uvw", got, plain, want):
        assert torch.equal(g, p), name
        d = digits(g.numpy(), np.asarray(w))
        assert d >= 12, f"{name}_bar: {d:.2f} digits"


@pytest.mark.parametrize("seed,diffKh", [(0, 1.0e3), (1, 0.0)])
def test_calc_rhs_vjp(setup, seed, diffKh):
    """Through calc_adv_flow, so that the JAX function's rTransKp path and
    the port's (rebuilt from rTrans) are both differentiated."""
    cfg, jgrid, tgrid = setup
    rng = np.random.default_rng(seed)
    shape = jgrid.hFacC.shape
    u = 0.1 * rng.standard_normal(shape) * np.asarray(jgrid.maskW)
    v = 0.1 * rng.standard_normal(shape) * np.asarray(jgrid.maskS)
    w = 1e-4 * rng.standard_normal(shape) * np.asarray(jgrid.maskC)
    t = (15.0 + rng.standard_normal(shape)) * np.asarray(jgrid.maskC)
    kappaR = 1e-4 * np.abs(rng.standard_normal(shape))
    bar = _interior_noise(rng, shape, cfg.olx)

    def jfn(u_, v_, w_, t_):
        flow = jgad.calc_adv_flow(cfg, jgrid, u_, v_, w_)
        return jgad.calc_rhs(cfg, jgrid, flow, u_, v_, w_, t_, 2, 2, diffKh,
                             0.0, jnp.asarray(kappaR), cfg.deltaT, False)
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (u, v, w, t)))
    want = vjp(jnp.asarray(bar))

    def tfn(u_, v_, w_, t_):
        flow = tgad.calc_adv_flow(tgrid, u_, v_, w_)
        return tgad.calc_rhs(cfg, tgrid, flow, t_, torch.from_numpy(kappaR),
                             diffKh)
    got = _torch_vjp(tfn, (u, v, w, t), [bar])
    for name, g, wnt in zip(("u", "v", "w", "tracer"), got, want):
        d = digits(g.numpy(), np.asarray(wnt))
        assert d >= 12, f"{name}_bar: {d:.2f} digits"

    # the plain VJP in the kernel's variables, carried back to (u, v, w)
    # through calc_adv_flow, is the same gradient
    flow = tgad.calc_adv_flow(tgrid, *map(torch.from_numpy, (u, v, w)))
    t_bar, uT_bar, vT_bar, rT_bar = tgad.calc_rhs_vjp_plain(
        cfg, tgrid, flow, torch.from_numpy(t), torch.from_numpy(kappaR),
        diffKh, torch.from_numpy(bar))
    chained = (uT_bar * flow.xA, vT_bar * flow.yA,
               rT_bar * flow.maskUp * tgrid.rA, t_bar)
    for name, c, g in zip(("u", "v", "w", "tracer"), chained, got):
        d = digits(c.numpy(), g.numpy())
        assert d >= 15, f"{name}_bar: {d:.2f} digits"
