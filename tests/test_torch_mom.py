"""PyTorch port: the flux-form momentum tendency (plain twin of kernel B)
against the JAX package on seeded random velocities and viscosities, 12
digits on the interior of every output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import mom_fluxform as jmom
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import mom_fluxform as tmom
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils.compare import digits, interior

torch.set_num_threads(1)

NX, NY, NR = 16, 16, 4


@pytest.fixture(scope="module")
def setup():
    cfg = jsyn.gyre_config(nx=NX, ny=NY, nr=NR)
    jgrid = jsyn.gyre_setup(cfg, dtype=jnp.float64)[0]
    tgrid = convert.from_arrays(Grid, convert.arrays_of(jgrid))
    return cfg, jgrid, tgrid


def _fields(grid, seed, kappa_scale):
    rng = np.random.default_rng(seed)
    shape = grid.hFacC.shape
    u = 0.1 * rng.standard_normal(shape) * np.asarray(grid.maskW)
    v = 0.1 * rng.standard_normal(shape) * np.asarray(grid.maskS)
    w = 1e-4 * rng.standard_normal(shape) * np.asarray(grid.maskC)
    kshape = (shape[0] + 1,) + shape[1:]
    kU = kappa_scale * np.abs(rng.standard_normal(kshape))
    kV = kappa_scale * np.abs(rng.standard_normal(kshape))
    return u, v, w, kU, kV


# kappa 0 is the gyre's viscAr; a random kappa exercises the vertical
# viscous flux and the bottom drag
@pytest.mark.parametrize("seed,kappa_scale", [(0, 0.0), (1, 1e-3)])
def test_mom_fluxform(setup, seed, kappa_scale):
    cfg, jgrid, tgrid = setup
    arrays = _fields(jgrid, seed, kappa_scale)
    want = jmom.mom_fluxform(cfg, jgrid, *map(jnp.asarray, arrays))
    got = tmom.mom_fluxform(cfg, tgrid, *map(torch.from_numpy, arrays))
    for name in ("gU", "gV", "guDiss", "gvDiss"):
        d = digits(interior(getattr(got, name), cfg.olx),
                   interior(np.asarray(getattr(want, name)), cfg.olx))
        assert d >= 12, f"{name}: {d:.2f} digits"


def test_hfacz_and_ke(setup):
    cfg, jgrid, tgrid = setup
    u, v = _fields(jgrid, 2, 0.0)[:2]
    assert np.array_equal(tmom.calc_hfacz(tgrid).numpy(),
                          np.asarray(jmom.calc_hfacz(jgrid)))
    want = np.asarray(jmom.calc_ke(cfg, jgrid, jnp.asarray(u),
                                   jnp.asarray(v)))
    got = tmom.calc_ke(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    assert digits(interior(got, cfg.olx), interior(want, cfg.olx)) >= 12
