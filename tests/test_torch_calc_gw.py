"""PyTorch port: the vertical-momentum tendency of the non-hydrostatic path
(plain twin of kernel W, model/calc_gw.py) and timestep_wvel against the
JAX package, in float64 on the CPU, on the walled 16x16x12 grid with a bank
and partial bottom cells of tests/test_torch_grid.py, with fPrime = 1e-4
(the 3-D Coriolis term on) and seeded random velocities and viscosities:
13 digits or more on whole padded arrays, halo cells included (both
packages fill their shifts with zeros at the array's edge)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import calc_gw as jgw
from mitgcm_tpu_torch.model import calc_gw as tgw
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config
from test_torch_grid import nh_walled_config, nh_walled_grid

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def walled():
    cfg = nh_walled_config()
    assert cfg.select3dCoriScheme == 1 and cfg.fPrime != 0.0
    return cfg, jax_config(cfg), *nh_walled_grid(cfg)


def _fields(grid, seed):
    """u, v, w on wet points and random interface viscosities, as numpy."""
    rng = np.random.default_rng(seed)
    shape = grid.hFacC.shape
    u = 0.1 * rng.standard_normal(shape) * grid.maskW.numpy()
    v = 0.1 * rng.standard_normal(shape) * grid.maskS.numpy()
    w = 1e-2 * rng.standard_normal(shape) * grid.maskC.numpy()
    kshape = (shape[0] + 1,) + tuple(shape[1:])
    kU = 0.1 * np.abs(rng.standard_normal(kshape))
    kV = 0.1 * np.abs(rng.standard_normal(kshape))
    return u, v, w, kU, kV


@pytest.mark.parametrize("cori3d", [1, 0], ids=["3d-coriolis", "no-3d"])
def test_calc_gw(walled, cori3d):
    cfg, _, jgrid, tgrid = walled
    cfg = dataclasses.replace(cfg, select3dCoriScheme=cori3d)
    jcfg = jax_config(cfg)
    arrays = _fields(tgrid, 11)
    want = jgw.calc_gw(jcfg, jgrid, *map(jnp.asarray, arrays))
    got = tgw.calc_gw(cfg, tgrid, *map(torch.from_numpy, arrays))
    for name, g, w in zip(("gW", "gwDiss"), got, want):
        w = np.asarray(w)
        assert np.abs(w[1:]).max() > 0.0, name
        d = digits(g.numpy(), w)
        assert d >= 13, f"{name}: {d:.2f} digits"


def test_calc_gw_coriolis_term(walled):
    """The 3-D Coriolis term changes gW at k >= 1 only, and by more than
    rounding."""
    cfg, _, _, tgrid = walled
    u, v, w, kU, kV = map(torch.from_numpy, _fields(tgrid, 12))
    with_c = tgw.calc_gw(cfg, tgrid, u, v, w, kU, kV)[0]
    without = tgw.calc_gw(dataclasses.replace(cfg, select3dCoriScheme=0),
                          tgrid, u, v, w, kU, kV)[0]
    diff = (with_c - without).abs()
    assert float(diff[0].max()) == 0.0
    assert float(diff[1:].max()) > 1e-7


def test_timestep_wvel(walled):
    cfg, jcfg, jgrid, tgrid = walled
    rng = np.random.default_rng(13)
    w, gw = (rng.standard_normal(tgrid.hFacC.shape) for _ in range(2))
    want = np.asarray(jgw.timestep_wvel(jcfg, jgrid, jnp.asarray(w),
                                        jnp.asarray(gw)))
    got = tgw.timestep_wvel(cfg, tgrid, torch.from_numpy(w),
                            torch.from_numpy(gw)).numpy()
    assert digits(got, want) >= 13
