"""PyTorch port: the nonlinear equations of state (plain twin of kernel R)
and the AB-3 extrapolation against the JAX package, 13 digits."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import step as jstep
from mitgcm_tpu.ops import eos as jeos
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import step as tstep
from mitgcm_tpu_torch.ops import eos as teos
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config

torch.set_num_threads(1)

DIGITS = 13


@pytest.fixture(scope="module")
def setup():
    cfg = tsyn.vi_gyre_config(nx=12, ny=10, nr=6)
    jgrid = jsyn.gyre_setup(jax_config(cfg), dtype=jnp.float64)[0]
    tgrid = convert.from_arrays(Grid, convert.arrays_of(jgrid), device="cpu")
    rng = np.random.default_rng(7)
    shape = jgrid.hFacC.shape
    theta = 2.0 + 25.0 * rng.random(shape)
    salt = 33.0 + 4.0 * rng.random(shape)
    salt[0, 3, 3] = -0.25          # the s * sqrt(max(s, 0)) guards
    phi = 20.0 * rng.standard_normal(shape)
    return cfg, jgrid, tgrid, theta, salt, phi


@pytest.mark.parametrize("eos,select_p", [
    ("JMD95Z", 0), ("UNESCO", 0), ("UNESCO", 2), ("MDJWF", 0),
    ("MDJWF", 2)])
def test_find_rho(setup, eos, select_p):
    base, jgrid, tgrid, theta, salt, phi = setup
    cfg = dataclasses.replace(base, eosType=eos, selectP_inEOS_Zc=select_p)
    want = np.asarray(jeos.find_rho(jax_config(cfg), jgrid, jnp.asarray(theta),
                                    jnp.asarray(salt),
                                    totPhiHyd=jnp.asarray(phi)))
    got = teos.find_rho(cfg, tgrid, torch.from_numpy(theta),
                        torch.from_numpy(salt),
                        totPhiHyd=torch.from_numpy(phi)).numpy()
    assert digits(got, want) >= DIGITS


@pytest.mark.parametrize("eos", ["POLY3", "TEOS10", "IDEALG"])
def test_find_rho_refuses(setup, eos):
    base, _, tgrid, theta, salt, _ = setup
    cfg = dataclasses.replace(base, eosType=eos)
    with pytest.raises(NotImplementedError):
        teos.find_rho(cfg, tgrid, torch.from_numpy(theta),
                      torch.from_numpy(salt))


def test_find_rho_refuses_grad(setup):
    cfg, _, tgrid, theta, salt, _ = setup
    t = torch.from_numpy(theta).requires_grad_(True)
    with pytest.raises(ValueError, match="kernel R"):
        teos.find_rho(cfg, tgrid, t, torch.from_numpy(salt))


@pytest.mark.parametrize("my_iter", [0, 1, 2, 5])
@pytest.mark.parametrize("pickup", [False, True])
def test_adams_bashforth3(my_iter, pickup):
    """levels 0, 1 and >= 2 from a cold start (nIter0 = 0) and from a
    pickup at nIter0 = 2, where full AB-3 starts at once."""
    cfg = tsyn.vi_gyre_config(nx=8, ny=8, nr=2)
    if pickup:
        cfg.startFromPickup, cfg.nIter0 = True, 2
        my_iter += 2
    rng = np.random.default_rng(my_iter)
    g, g1, g2 = (rng.standard_normal((2, 12, 12)) for _ in range(3))
    want = jstep.adams_bashforth(jax_config(cfg), jnp.asarray(g),
                                 jnp.asarray(g1),
                                 jnp.asarray(g2), my_iter)
    got = tstep.adams_bashforth(cfg, torch.from_numpy(g),
                                torch.from_numpy(g1), torch.from_numpy(g2),
                                my_iter)
    for w, t in zip(want, got):
        assert digits(t.numpy(), np.asarray(w)) >= DIGITS
