"""PyTorch port: the scheme-2 tracer tendency (plain twin of kernel C)
against the JAX package on seeded random flow and tracer, 12 digits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import gad as jgad
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import gad as tgad
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils.compare import digits, interior

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,diffKh", [(0, 1.0e3), (1, 0.0)])
def test_calc_rhs(seed, diffKh):
    cfg = jsyn.gyre_config(nx=16, ny=16, nr=4)
    jgrid = jsyn.gyre_setup(cfg, dtype=jnp.float64)[0]
    tgrid = convert.from_arrays(Grid, convert.arrays_of(jgrid), device="cpu")
    rng = np.random.default_rng(seed)
    shape = jgrid.hFacC.shape
    u = 0.1 * rng.standard_normal(shape) * np.asarray(jgrid.maskW)
    v = 0.1 * rng.standard_normal(shape) * np.asarray(jgrid.maskS)
    w = 1e-4 * rng.standard_normal(shape) * np.asarray(jgrid.maskC)
    t = (15.0 + rng.standard_normal(shape)) * np.asarray(jgrid.maskC)
    kappaR = 1e-4 * np.abs(rng.standard_normal(shape))

    ju, jv, jw = map(jnp.asarray, (u, v, w))
    jflow = jgad.calc_adv_flow(cfg, jgrid, ju, jv, jw)
    want = jgad.calc_rhs(cfg, jgrid, jflow, ju, jv, jw, jnp.asarray(t), 2,
                         2, diffKh, 0.0, jnp.asarray(kappaR), cfg.deltaT,
                         False)
    tflow = tgad.calc_adv_flow(tgrid, *map(torch.from_numpy, (u, v, w)))
    for name in tflow._fields:
        assert np.array_equal(getattr(tflow, name).numpy(),
                              np.asarray(getattr(jflow, name))), name
    got = tgad.calc_rhs(cfg, tgrid, tflow, torch.from_numpy(t),
                        torch.from_numpy(kappaR), diffKh)
    d = digits(interior(got, cfg.olx), interior(np.asarray(want), cfg.olx))
    assert d >= 12, f"gTr: {d:.2f} digits"
