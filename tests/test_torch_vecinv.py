"""PyTorch port: the vector-invariant momentum tendency (plain twin of
kernel V) against the JAX package on seeded random velocities and
viscosities, 12 digits on the interior of every output, over the ported
vorticity and Coriolis schemes, with and without implicit viscosity and
over the bottom-drag options; and its refusals."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import mom_vecinv as jvi
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import mom_vecinv as tvi
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior
from test_torch_config import jax_config

torch.set_num_threads(1)

NX, NY, NR = 12, 10, 3
DIGITS = 12


@pytest.fixture(scope="module")
def grids():
    cfg = tsyn.vi_gyre_config(nx=NX, ny=NY, nr=NR)
    jgrid = jsyn.gyre_setup(jax_config(cfg), dtype=jnp.float64)[0]
    return jgrid, convert.from_arrays(Grid, convert.arrays_of(jgrid),
                                      device="cpu")


def _fields(grid, seed):
    rng = np.random.default_rng(seed)
    shape = grid.hFacC.shape
    u = 0.1 * rng.standard_normal(shape) * np.asarray(grid.maskW)
    v = 0.1 * rng.standard_normal(shape) * np.asarray(grid.maskS)
    w = 1e-4 * rng.standard_normal(shape) * np.asarray(grid.maskC)
    kshape = (shape[0] + 1,) + shape[1:]
    kU = 1e-3 * np.abs(rng.standard_normal(kshape))
    kV = 1e-3 * np.abs(rng.standard_normal(kshape))
    return u, v, w, kU, kV


def _check(cfg, grids, seed):
    jgrid, tgrid = grids
    arrays = _fields(jgrid, seed)
    want = jvi.mom_vecinv(jax_config(cfg), jgrid, *map(jnp.asarray, arrays))
    got = tvi.mom_vecinv(cfg, tgrid, *map(torch.from_numpy, arrays))
    for name in ("gU", "gV", "guDiss", "gvDiss"):
        d = digits(interior(getattr(got, name), cfg.olx),
                   interior(np.asarray(getattr(want, name)), cfg.olx))
        assert d >= DIGITS, f"{name}: {d:.2f} digits"


@pytest.mark.parametrize("vort,cori,implicit", list(itertools.product(
    (0, 1, 2), (0, 1), (False, True))))
def test_mom_vecinv(grids, vort, cori, implicit):
    cfg = tsyn.vi_gyre_config(nx=NX, ny=NY, nr=NR, selectVortScheme=vort,
                              selectCoriScheme=cori,
                              implicitViscosity=implicit)
    _check(cfg, grids, seed=10 * vort + 2 * cori + implicit)


@pytest.mark.parametrize("no_slip_bottom,drag", [(False, 2e-4), (True, 2e-4),
                                                 (False, 0.0)])
def test_mom_vecinv_bottom_drag(grids, no_slip_bottom, drag):
    """selectVortScheme unset (scheme 1), with linear or no bottom drag."""
    cfg = tsyn.vi_gyre_config(nx=NX, ny=NY, nr=NR,
                              no_slip_bottom=no_slip_bottom,
                              bottomDragLinear=drag, implicitViscosity=False)
    assert cfg.selectVortScheme is None
    _check(cfg, grids, seed=99)


def test_relvort_and_hdiv(grids):
    jgrid, tgrid = grids
    cfg = tsyn.vi_gyre_config(nx=NX, ny=NY, nr=NR)
    u, v = _fields(jgrid, 3)[:2]
    for jfn, tfn in ((jvi.calc_relvort3, tvi.calc_relvort3),
                     (jvi.calc_hdiv, tvi.calc_hdiv)):
        want = np.asarray(jfn(jax_config(cfg), jgrid, jnp.asarray(u),
                              jnp.asarray(v)))
        got = tfn(tgrid, torch.from_numpy(u), torch.from_numpy(v))
        assert digits(interior(got, cfg.olx),
                      interior(want, cfg.olx)) >= DIGITS, jfn.__name__


@pytest.mark.parametrize("flag,value", [
    ("viscAhD", 100.0), ("viscAhZ", 100.0), ("viscC2smag", 2.0),
    ("viscA4", 1.0e9), ("selectVortScheme", 3), ("selectCoriScheme", 2),
    ("useAbsVorticity", True), ("upwindVorticity", True),
    ("highOrderVorticity", True), ("useStrainTensionVisc", True),
    ("selectKEscheme", 1), ("selectBotDragQuadr", 0),
    ("useCDscheme", True), ("usingSphericalPolarGrid", True)])
def test_check_branches_vecinv_refuses(flag, value):
    cfg = tsyn.vi_gyre_config(nx=8, ny=8, nr=2)
    tvi.check_branches_vecinv(cfg)
    setattr(cfg, flag, value)
    with pytest.raises(NotImplementedError, match="mom_vecinv"):
        tvi.check_branches_vecinv(cfg)
