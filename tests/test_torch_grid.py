"""PyTorch port: grid, state and the cg2d operator against the JAX package.

The grid geometry is float64 numpy in both packages, so every field must be
bit-equal, on the gyres' walled basins and on the non-hydrostatic tests'
walled grid with a bank and partial bottom cells (nh_walled_grid, which
the other nh tests share); the cg2d operator is built from it by the same
tensor operations in the same order, and must agree to >= 15 digits.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.core import grid as jgrid_mod
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core.grid import build_grid
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from mitgcm_tpu_torch.utils.convert import arrays_of
from test_torch_config import jax_config

torch.set_num_threads(1)


def nh_walled_config(**kw):
    """The nh-convection box at 16x16x12 with partial cells allowed
    (hFacMin 0.2), for the walled grid of nh_walled_grid."""
    return tsyn.nh_convection_config(nx=16, ny=16, nr=12, hFacMin=0.2, **kw)


def nh_walled_bathy(cfg):
    """Walls on the edges, a bank whose top cell is half open, and a row
    of partial bottom cells (0.6 open) on a flat 240 m bottom."""
    n, depth, dz = cfg.nx, sum(cfg.delR), cfg.delR[-1]
    bathy = np.full((cfg.ny, n), -depth)
    bathy[3:7, 10:14] = -150.0                       # a bank
    bathy[9, 6:12] = -depth + 0.4 * dz               # partial cells
    bathy[0, :] = bathy[-1, :] = bathy[:, 0] = bathy[:, -1] = 0.0
    return bathy


def nh_walled_grid(cfg):
    """(JAX grid, port grid) of nh_walled_bathy, float64, on the CPU."""
    bathy = nh_walled_bathy(cfg)
    return (jgrid_mod.build_grid(jax_config(cfg), bathy=bathy,
                                 dtype=jnp.float64),
            build_grid(cfg, bathy=bathy, dtype=torch.float64, device="cpu"))

SIZES = [(16, 16, 4), (24, 12, 3)]


def _setups(nx, ny, nr):
    cfg = jsyn.gyre_config(nx=nx, ny=ny, nr=nr)
    jax_objs = jsyn.gyre_setup(cfg, dtype=jnp.float64)
    tcfg = tsyn.gyre_config(nx=nx, ny=ny, nr=nr)
    return jax_objs, tsyn.gyre_setup(tcfg, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("nx,ny,nr", SIZES)
def test_grid_bit_equal(nx, ny, nr):
    (jgrid, _, _, _), (tgrid, _, _, _) = _setups(nx, ny, nr)
    ref = arrays_of(jgrid)
    for f in dataclasses.fields(tgrid):
        assert getattr(tgrid, f.name).is_contiguous(), f.name
        got = getattr(tgrid, f.name).numpy()
        assert got.dtype == np.float64, f.name
        assert np.array_equal(got, ref[f.name]), f"grid.{f.name} differs"


def test_nh_walled_grid_bit_equal():
    """The regularised columns, their face envelopes and kSurfC where the
    bank and the partial cells make them differ from the raw bathymetry."""
    cfg = nh_walled_config()
    jgrid, tgrid = nh_walled_grid(cfg)
    ref = arrays_of(jgrid)
    for f in dataclasses.fields(tgrid):
        got = getattr(tgrid, f.name).numpy()
        assert np.array_equal(got, ref[f.name]), f"grid.{f.name} differs"
    hfac = tgrid.hFacC.numpy()
    assert ((hfac > 0) & (hfac < 1)).sum() >= 6
    assert (tgrid.kSurfC.numpy() == cfg.nr + 1).any()


@pytest.mark.parametrize("nx,ny,nr", SIZES)
def test_state_and_forcing_bit_equal(nx, ny, nr):
    (_, jstate, jforc, _), (_, tstate, tforc, _) = _setups(nx, ny, nr)
    for jobj, tobj in ((jstate, tstate), (jforc, tforc)):
        ref = arrays_of(jobj)
        for f in dataclasses.fields(tobj):
            got = getattr(tobj, f.name)
            if got is None:     # GGL90TKE off: the JAX state holds zeros
                assert not ref[f.name].any(), f.name
                continue
            assert np.array_equal(got.numpy(), ref[f.name]), f.name


@pytest.mark.parametrize("nx,ny,nr", SIZES)
def test_cg2d_operator(nx, ny, nr):
    (_, _, _, jop), (_, _, _, top) = _setups(nx, ny, nr)
    ref = arrays_of(jop)
    for f in dataclasses.fields(top):
        d = digits(getattr(top, f.name).numpy(), ref[f.name])
        assert d >= 15, f"op.{f.name}: {d:.2f} digits"
