"""PyTorch port: the Shapiro filter (model/shap_filt.py, the plain twins of
kernels SH-uv and SH-ts) against the JAX package's shap_filt.py, in
float64 on the CPU.

The same numpy inputs, made from a seed, go through both on a 12 x 10 x 4
basin with a shelf, a bank and a partial bottom cell, halos of 2 and 3:
the velocity filter in index space (4 passes; 3, whose last pass fills; an
exchange every pass) and in physical space with Shap_uvLength below, at
and above 0, and the tracer filter in index space, in physical space with
and without Shap_TrLength, and with index passes followed by physical ones,
agree on every padded cell to 12 digits or more; so do the namelist
readers' defaults.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.core.grid import build_grid as jbuild_grid
from mitgcm_tpu.model import shap_filt as jshap
from mitgcm_tpu.ops.stencil import cyclic_fill_halo as jfill
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import shap_filt as tshap
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config

torch.set_num_threads(1)

DIGITS = 12.0
UV_CASES = {
    "index": {}, "index, 3 passes": {"nShapUV": 3},
    "index, exchange every pass": {"Shap_alwaysExchUV": True},
    "physical, length < 0": {"nShapUVPhys": 4, "Shap_uvLength": -1.0},
    "physical, length 0": {"nShapUVPhys": 4},
    "physical, length > 0": {"nShapUVPhys": 4, "Shap_uvLength": 3.0e4}}
TS_CASES = {
    "index": {}, "physical": {"nShapTrPhys": 4},
    "physical, length": {"nShapTrPhys": 4, "Shap_TrLength": 3.0e4},
    "mixed": {"nShapTrPhys": 2},
    "mixed, 5 passes": {"nShapT": 5, "nShapS": 5, "nShapTrPhys": 3}}


def setup(ol, **shap):
    """(cfg, JAX grid, port grid): the shap-gyre's configuration on a
    walled 12 x 10 basin with a shelf, a bank and a partial bottom cell,
    halos of `ol`, its ShapParams with `shap` set."""
    cfg = tsyn.shap_gyre_config(nx=12, ny=10, nr=4, olx=ol, oly=ol,
                                shap=shap)
    nx, ny = cfg.nx, cfg.ny
    depth = sum(cfg.delR)
    bathy = np.full((ny, nx), -depth)
    bathy[:, :3] = -0.4 * depth
    bathy[2:4, 6:8] = -0.6 * depth
    bathy[5, 3:6] = -depth + 0.4 * cfg.delR[-1]
    bathy[0, :] = bathy[-1, :] = bathy[:, 0] = bathy[:, -1] = 0.0
    jgrid = jbuild_grid(jax_config(cfg), bathy=bathy, dtype=jnp.float64)
    return cfg, jgrid, convert.from_arrays(Grid, convert.arrays_of(jgrid),
                                           device="cpu")


def jax_params(cfg):
    return jshap.ShapParams(**dataclasses.asdict(cfg.shap))


@pytest.mark.parametrize("ol", (2, 3))
@pytest.mark.parametrize("case", UV_CASES)
def test_apply_uv(case, ol):
    cfg, jgrid, tgrid = setup(ol, **UV_CASES[case])
    rng = np.random.default_rng(5 + ol)
    shape = tuple(tgrid.hFacC.shape)
    u, v = (0.1 * rng.standard_normal(shape) for _ in range(2))

    def fill_uv(a, b):
        return jfill(a, cfg.oly, cfg.olx), jfill(b, cfg.oly, cfg.olx)

    want = jshap.apply_uv(jax_config(cfg), jgrid, jax_params(cfg),
                          jnp.asarray(u), jnp.asarray(v), fill_uv)
    got = tshap.apply_uv(cfg, tgrid, cfg.shap, torch.from_numpy(u),
                         torch.from_numpy(v))
    for name, g, w in zip("uv", got, want):
        assert digits(g.numpy(), np.asarray(w)) >= DIGITS, name
        assert not np.allclose(g.numpy(), {"u": u, "v": v}[name])


@pytest.mark.parametrize("ol", (2, 3))
@pytest.mark.parametrize("case", TS_CASES)
def test_apply_ts(case, ol):
    cfg, jgrid, tgrid = setup(ol, **TS_CASES[case])
    rng = np.random.default_rng(7 + ol)
    shape = tuple(tgrid.hFacC.shape)
    mask = tgrid.maskC.numpy()
    t = (20.0 + rng.standard_normal(shape)) * mask
    s = (35.0 + 0.1 * rng.standard_normal(shape)) * mask
    t, s = (np.array(jfill(jnp.asarray(a), ol, ol)) for a in (t, s))

    def fill(a):
        return jfill(a, cfg.oly, cfg.olx)

    want = jshap.apply_ts(jax_config(cfg), jgrid, jax_params(cfg),
                          jnp.asarray(t), jnp.asarray(s), fill)
    got = tshap.apply_ts(cfg, tgrid, cfg.shap, torch.from_numpy(t),
                         torch.from_numpy(s))
    for name, g, w in zip(("theta", "salt"), got, want):
        assert digits(g.numpy(), np.asarray(w)) >= DIGITS, name
    assert not np.allclose(got[0].numpy(), t)


@pytest.mark.parametrize("group", [
    {}, {"nShapT": 2, "nShapUV": 4, "Shap_funct": 20},
    {"nShapT": 3, "nShapS": 1, "Shap_Trtau": 600.0, "shap_filt_uvStar": 0},
    {"Shap_funct": 4, "Shap_uvtau": 100.0, "nshapuvphys": 2}])
def test_from_namelist(group):
    """The port's SHAP_PARM01 reader and defaults equal JAX's."""
    cfg = tsyn.gyre_config(nx=8, ny=8, nr=2, deltaT=900.0)
    want = dataclasses.asdict(jshap.from_namelist(group, jax_config(cfg)))
    assert dataclasses.asdict(tshap.from_namelist(group, cfg)) == want
    assert convert.shap_params(jshap.from_namelist(group, jax_config(
        cfg))) == tshap.from_namelist(group, cfg)
