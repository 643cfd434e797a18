"""PyTorch port: PP81 and MY82 Richardson-number mixing (model/vertmix.py,
the plain twin of kernel U) against the JAX package's vertmix.py, in
float64 on the CPU.

The same numpy inputs, made from a seed, go through both on an 8 x 8 x 12
basin with a shelf, a bank and a partial bottom cell: velocities whose
shear spans four decades (Richardson numbers on both sides of PP81's
RiLimit and MY82's RiMax, and columns without shear), a stratification
statically unstable at about a fifth of the interfaces, salt, and a
hydrostatic potential for selectP_inEOS_Zc = 2. _ri_number, PP81.calc,
MY82.calc and visc_uv (the step's kappa_uv on MY82's viscAr) agree to 12
digits or more under the LINEAR, JMD95Z
(on the static profile and on totPhiHyd) and MDJWF equations of state;
PP81's RiLimit and MY82's closure constants equal JAX's; the namelist
readers refuse unknown keys and skip the output ones alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.core.grid import build_grid as jbuild_grid
from mitgcm_tpu.model import vertmix as jvm
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import step as tstep
from mitgcm_tpu_torch.model import vertmix as tvm
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config

torch.set_num_threads(1)

SIZE = dict(nx=8, ny=8, nr=12, depth=300.0)
# (eosType, selectP_inEOS_Zc)
EOS_CASES = (("LINEAR", 0), ("JMD95Z", 0), ("JMD95Z", 2), ("MDJWF", 2))


def grids(cfg):
    """Both packages' grids of an 8 x 8 basin with a 120 m shelf along the
    west, a 200 m bank and a partial bottom cell in one row."""
    nx, ny = cfg.nx, cfg.ny
    bathy = np.full((ny, nx), -sum(cfg.delR))
    bathy[:, :3] = -120.0
    bathy[2:4, 5:7] = -200.0
    bathy[5, 3:6] = -sum(cfg.delR) + 0.4 * cfg.delR[-1]
    bathy[0, :] = bathy[-1, :] = bathy[:, 0] = bathy[:, -1] = 0.0
    jgrid = jbuild_grid(jax_config(cfg), bathy=bathy, dtype=jnp.float64)
    return jgrid, convert.from_arrays(Grid, convert.arrays_of(jgrid),
                                      device="cpu")


def fields(cfg, tgrid, seed):
    """Seeded (u, v, theta, salt, totPhiHyd) on tgrid."""
    rng = np.random.default_rng(seed)
    shape = tuple(tgrid.hFacC.shape)
    amp = 10.0 ** rng.uniform(-4.0, 0.0, shape)
    u = 0.1 * amp * rng.standard_normal(shape)
    v = 0.1 * amp * rng.standard_normal(shape)
    u[:, :, 4] = u[:1, :, 4]               # no shear in one column
    v[:, :, 4] = v[:1, :, 4]
    u *= tgrid.maskW.numpy()
    v *= tgrid.maskS.numpy()
    t_ref = np.asarray(cfg.tRef)[:, None, None]
    theta = t_ref + 0.3 * rng.standard_normal(shape)
    unstable = rng.random(shape) < 0.2
    theta[1:][unstable[1:]] = theta[:-1][unstable[1:]] - 0.5
    salt = 34.8 + 0.2 * rng.standard_normal(shape)
    phi = 0.05 * rng.standard_normal(shape)
    return u, v, theta, salt, phi


@pytest.fixture(scope="module", params=EOS_CASES,
                ids=[f"{k}-{p}" for k, p in EOS_CASES])
def case(request):
    kind, select_p = request.param
    cfg = tsyn.pp81_gyre_config(**SIZE, eosType=kind,
                                selectP_inEOS_Zc=select_p)
    jgrid, tgrid = grids(cfg)
    arrays = fields(cfg, tgrid, 25 + EOS_CASES.index(request.param))
    return cfg, jgrid, tgrid, arrays


def test_ri_number(case):
    cfg, jgrid, tgrid, arrays = case
    want = jvm._ri_number(jax_config(cfg), jgrid, *map(jnp.asarray, arrays))
    got = tvm.ri_number(cfg, tgrid, *map(torch.from_numpy, arrays))
    for name, g, w in zip(("buoyFreq", "vertShear"), got, want):
        d = digits(g.numpy(), np.asarray(w))
        assert d >= 12, (name, d)
    # both signs of the buoyancy frequency and shearless interfaces
    buoy, shear = (t.numpy()[1:] for t in got)
    assert (buoy > 0).any() and (buoy < 0).any() and (shear == 0).any()


@pytest.mark.parametrize("scheme", ("PP81", "MY82"))
def test_calc(case, scheme):
    cfg, jgrid, tgrid, arrays = case
    jobj = getattr(jvm, scheme)(jax_config(cfg), jgrid, {})
    tobj = getattr(tvm, scheme)(cfg, tgrid, {})
    want = jobj.calc(*map(jnp.asarray, arrays))
    got = tobj.calc(*map(torch.from_numpy, arrays))
    for name, g, w in zip(("viscAr", "diffKr"), got, want):
        d = digits(g.numpy(), np.asarray(w))
        assert d >= 12, (scheme, name, d)
    # the inputs reach the closures' clips: the cap or PP81's low-Ri
    # branch, and the background floor
    visc = got[0].numpy()[tgrid.maskC.numpy() > 0]
    assert (visc == cfg.viscAr).any() and (visc > 10 * cfg.viscAr).any()


def test_visc_uv(case):
    """The step's blend of MY82's viscAr into KappaRU/RV (step.kappa_uv's
    twin, the code on the path) against JAX's visc_uv on the background
    viscosity, which the step starts from."""
    cfg, jgrid, tgrid, arrays = case
    tobj = tvm.MY82(cfg, tgrid, {})
    viscAr = tobj.calc(*map(torch.from_numpy, arrays))[0]
    kappa = jnp.full(tuple(viscAr.shape), cfg.viscAr, dtype=jnp.float64)
    want = jvm.visc_uv(jax_config(cfg), jgrid, jnp.asarray(viscAr.numpy()),
                       kappa, kappa)
    got = tstep.kappa_uv(cfg, tgrid, vmix_fields={"viscAr": viscAr},
                         impl="plain")
    nr = cfg.nr
    for g, w in zip(got, want):
        assert digits(g[:nr].numpy(), np.asarray(w)) >= 12
        assert (g[nr] == cfg.viscAr).all()
    # the blend lifts some interfaces above the background
    assert (got[0][:nr] > cfg.viscAr).any()


def test_parameters_match():
    """PP81's RiLimit (derived, and given), MY82's alphas and betas, and
    the namelist keys: unknown ones raise, the output ones are skipped."""
    cfg = tsyn.pp81_gyre_config(**SIZE)
    jgrid, tgrid = grids(cfg)
    jcfg = jax_config(cfg)
    for group in ({}, {"PPnRi": 3, "ppnu0": 5e-3, "PPwriteState": True},
                  {"RiLimit": 0.1}):
        assert (tvm.PP81(cfg, tgrid, group).p
                == jvm.PP81(jcfg, jgrid, group).p)
    for group in ({}, {"RiMax": 0.2, "MYwriteState": True}):
        assert (tvm.MY82(cfg, tgrid, group).p
                == jvm.MY82(jcfg, jgrid, group).p)
    for cls in (tvm.PP81, tvm.MY82):
        with pytest.raises(KeyError, match="unknown parameter"):
            cls(cfg, tgrid, {"nonsense": 1})


def test_pp81_integer_power():
    """PPnRi 3: the power multiplied out as JAX's integer_pow does."""
    cfg = tsyn.pp81_gyre_config(**SIZE, eosType="JMD95Z")
    jgrid, tgrid = grids(cfg)
    arrays = fields(cfg, tgrid, 31)
    group = {"PPnRi": 3}
    want = jvm.PP81(jax_config(cfg), jgrid, group).calc(
        *map(jnp.asarray, arrays))
    got = tvm.PP81(cfg, tgrid, group).calc(*map(torch.from_numpy, arrays))
    for g, w in zip(got, want):
        assert digits(g.numpy(), np.asarray(w)) >= 12
