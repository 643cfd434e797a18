"""PyTorch port: linear equation of state and the hydrostatic column
integral against the JAX package, 12 digits."""

import jax.numpy as jnp
import numpy as np
import torch

from mitgcm_tpu.model import phihyd as jphi
from mitgcm_tpu.ops import eos as jeos
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import phihyd as tphi
from mitgcm_tpu_torch.ops import eos as teos
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils.compare import digits, interior

torch.set_num_threads(1)


def _setup(seed):
    cfg = jsyn.gyre_config(nx=16, ny=16, nr=6)
    jgrid = jsyn.gyre_setup(cfg, dtype=jnp.float64)[0]
    tgrid = convert.from_arrays(Grid, convert.arrays_of(jgrid), device="cpu")
    rng = np.random.default_rng(seed)
    shape = jgrid.hFacC.shape
    theta = 15.0 + 3.0 * rng.standard_normal(shape)
    salt = 35.0 + rng.standard_normal(shape)
    return cfg, jgrid, tgrid, theta, salt


def test_find_rho():
    cfg, jgrid, tgrid, theta, salt = _setup(0)
    want = np.asarray(jeos.find_rho(cfg, jgrid, jnp.asarray(theta),
                                    jnp.asarray(salt)))
    got = teos.find_rho(cfg, tgrid, torch.from_numpy(theta),
                        torch.from_numpy(salt)).numpy()
    assert digits(got, want) >= 12


def test_calc_phi_hyd():
    cfg, jgrid, tgrid, theta, salt = _setup(1)
    rho = np.asarray(jeos.find_rho(cfg, jgrid, jnp.asarray(theta),
                                   jnp.asarray(salt))) * np.asarray(
                                       jgrid.maskC)
    want = jphi.calc_phi_hyd(cfg, jgrid, jnp.asarray(rho))
    got = tphi.calc_phi_hyd(cfg, tgrid, torch.from_numpy(rho))
    for name, g, w in zip(("phiHydC", "dPhiHydX", "dPhiHydY", "totPhiHyd"),
                          got, want):
        d = digits(interior(g, cfg.olx), interior(np.asarray(w), cfg.olx))
        assert d >= 12, f"{name}: {d:.2f} digits"
