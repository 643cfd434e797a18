"""PyTorch port: the implicit vertical column solve (plain twin of kernel
T) against the JAX package's thermodynamics.impldiff, 12 digits on whole
arrays, at C, W and S points with seeded interface diffusivities and
columns that are partly land."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import thermodynamics as jth
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import thermodynamics as tth
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config

torch.set_num_threads(1)

NX, NY, NR = 12, 10, 5


@pytest.fixture(scope="module")
def setup():
    cfg = tsyn.vi_gyre_config(nx=NX, ny=NY, nr=NR)
    jgrid = jsyn.gyre_setup(jax_config(cfg), dtype=jnp.float64)[0]
    return cfg, jgrid, convert.from_arrays(Grid, convert.arrays_of(jgrid),
                                           device="cpu")


@pytest.mark.parametrize("point,krows", [("C", NR), ("W", NR + 1),
                                         ("S", NR + 1)])
def test_impldiff(setup, point, krows):
    """A tracer's [nr] diffusivity at C points, a velocity's [nr+1]
    viscosity at W and S points; land below level 2 in one column and at
    the surface of another (recip_hFac = 0 there)."""
    cfg, jgrid, tgrid = setup
    rng = np.random.default_rng({"C": 0, "W": 1, "S": 2}[point])
    recip = np.array(getattr(jgrid, f"recip_hFac{point}"))
    recip[2:, 4, 5] = 0.0
    recip[0, 6, 7] = 0.0
    field = rng.standard_normal(recip.shape)
    kappa = 1e-2 * np.abs(rng.standard_normal((krows,) + recip.shape[1:]))
    want = np.asarray(jth.impldiff(jax_config(cfg), jgrid, jnp.asarray(field),
                                   jnp.asarray(kappa), jnp.asarray(recip),
                                   1200.0))
    got = tth.impldiff(cfg, tgrid, torch.from_numpy(field),
                       torch.from_numpy(kappa), torch.from_numpy(recip),
                       1200.0).numpy()
    assert digits(got, want) >= 12
    # the land part of the column keeps its value
    assert np.array_equal(got[3:, 4, 5], field[3:, 4, 5])


def test_impldiff_single_level(setup):
    cfg, _, tgrid = setup
    one = tsyn.vi_gyre_config(nx=NX, ny=NY, nr=1)
    f = torch.ones((1,) + tuple(tgrid.rA.shape), dtype=torch.float64)
    assert tth.impldiff(one, tgrid, f, f, f, 600.0) is f


def test_impldiff_refuses_grad(setup):
    cfg, _, tgrid = setup
    f = tgrid.hFacC.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="kernel T"):
        tth.impldiff(cfg, tgrid, f, tgrid.hFacC, tgrid.recip_hFacC, 600.0)
