"""PyTorch port: the CD scheme (model/cd_code.py, the plain twin of kernel
CD, and the CD variants of the momentum twins and of kernel G's twin)
against the JAX package's cd_code.py and momentum code, in float64 on the
CPU.

The same numpy inputs, made from a seed, go through both on a 10 x 12 x 4
basin with a shelf, a bank and a partial bottom cell, under the cd-gyre's
and the cd-vi-gyre's configurations (AB-2 and AB-3, rCD of tauCD = 321428
s): the twin's predictors u* = u + deltaTMom (gU_ab + guCor) maskW (and
v*) and its new D-grid velocities agree with JAX's cd_scheme and the step's
use of it on every padded cell to 12 digits or more, on iteration 0 (the
forward D-grid step) and a later one; so do the flux-form and
vector-invariant tendencies without their 2-D and planetary Coriolis
terms, and G's twin with gU_ab and gV_ab in the predictors' places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.core.grid import build_grid as jbuild_grid
from mitgcm_tpu.model import cd_code as jcd
from mitgcm_tpu.model import mom_fluxform as jmom
from mitgcm_tpu.model import mom_vecinv as jvi
from mitgcm_tpu.model import step as jstep
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import cd_code as tcd
from mitgcm_tpu_torch.model import mom_fluxform as tmom
from mitgcm_tpu_torch.model import mom_vecinv as tvi
from mitgcm_tpu_torch.model import step as tstep
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config

torch.set_num_threads(1)

SIZE = dict(nx=12, ny=10, nr=4)
DIGITS = 12.0
CONFIGS = ("cd_gyre_config", "cd_vi_gyre_config")


def grids(cfg):
    """Both packages' grids of a walled basin with a shelf along the west,
    a bank and a partial bottom cell in one row."""
    nx, ny = cfg.nx, cfg.ny
    bathy = np.full((ny, nx), -sum(cfg.delR))
    bathy[:, :3] = -0.4 * sum(cfg.delR)
    bathy[2:4, 6:8] = -0.6 * sum(cfg.delR)
    bathy[5, 3:6] = -sum(cfg.delR) + 0.4 * cfg.delR[-1]
    bathy[0, :] = bathy[-1, :] = bathy[:, 0] = bathy[:, -1] = 0.0
    jgrid = jbuild_grid(jax_config(cfg), bathy=bathy, dtype=jnp.float64)
    return jgrid, convert.from_arrays(Grid, convert.arrays_of(jgrid),
                                      device="cpu")


def cd_inputs(tgrid, seed):
    """Seeded numpy inputs of the CD step: (gU_ab, gV_ab, u, v, uNM1, vNM1,
    uVelD, vVelD, etaN, etaNm1)."""
    rng = np.random.default_rng(seed)
    s3 = tuple(tgrid.hFacC.shape)
    mW, mS = tgrid.maskW.numpy(), tgrid.maskS.numpy()
    g = [1e-5 * rng.standard_normal(s3) * m for m in (mW, mS)]
    vel = [0.1 * rng.standard_normal(s3) * m for m in (mW, mS, mW, mS)]
    dgrid = [0.1 * rng.standard_normal(s3) * m for m in (mS, mW)]
    eta = [0.2 * rng.standard_normal(s3[1:]) for _ in range(2)]
    return g + vel + dgrid + eta


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("it", (0, 7))
def test_cd_scheme(config, it):
    cfg = getattr(tsyn, config)(**SIZE)
    jgrid, tgrid = grids(cfg)
    ins = cd_inputs(tgrid, 11 + it)
    gU, gV, u, v, uNM1, vNM1, uVelD, vVelD, eta, etaNm1 = map(jnp.asarray,
                                                              ins)
    jcfg = jax_config(cfg)
    zero = jnp.zeros_like(u)
    guCor, gvCor, new = jcd.cd_scheme(
        jcfg, jgrid, jcd.CDState(uVelD, vVelD, uNM1, vNM1, etaNm1), eta,
        zero, zero, gU, gV, u, v, it)
    want = (u + cfg.deltaTMom * (gU + guCor) * jgrid.maskW,
            v + cfg.deltaTMom * (gV + gvCor) * jgrid.maskS,
            new.uVelD, new.vVelD)
    t = [torch.from_numpy(a) for a in ins]
    got = tcd.cd_scheme(cfg, tgrid, it, t[0], t[1], t[2], t[3], t[8],
                        tcd.CDState(t[6], t[7], t[4], t[5], t[9]))
    for name, g, w in zip(("uStar", "vStar", "uVelD", "vVelD"), got, want):
        assert digits(g.numpy(), np.asarray(w)) >= DIGITS, name
    # the D-grid step moves the pair: the relaxation keeps rCD of it
    assert not np.allclose(got[2].numpy(), ins[6])
    assert 0.99 < tcd.cd_params(cfg, it)[2] < 1.0


def test_cd_params_first_step():
    """Iteration 0 steps the D grid forward (ab15 1, ab05 0); later ones
    with epsAB_CD (abEps by default)."""
    cfg = tsyn.cd_gyre_config(**SIZE)
    assert tcd.cd_params(cfg, 0)[:2] == (1.0, 0.0)
    eps = cfg.abEps
    assert tcd.cd_params(cfg, 3)[:2] == (1.5 + eps, -0.5 - eps)
    assert tcd.cd_params(tsyn.gyre_config(**SIZE, useCDscheme=True), 1)[2] \
        == 0.0


def momentum_inputs(tgrid, seed):
    rng = np.random.default_rng(seed)
    s3 = tuple(tgrid.hFacC.shape)
    k3 = (s3[0] + 1,) + s3[1:]
    return (0.1 * rng.standard_normal(s3) * tgrid.maskW.numpy(),
            0.1 * rng.standard_normal(s3) * tgrid.maskS.numpy(),
            1e-3 * rng.standard_normal(s3) * tgrid.maskC.numpy(),
            1e-3 * np.abs(rng.standard_normal(k3)),
            1e-3 * np.abs(rng.standard_normal(k3)))


@pytest.mark.parametrize("config", CONFIGS)
def test_momentum_without_coriolis(config):
    """B's and V's twins under useCDscheme: JAX's mom_fluxform drops the
    2-D Coriolis term (keeping the 3-D one, select3dCoriScheme 1 here) and
    mom_vecinv the planetary term."""
    extra = {} if "vi" in config else dict(select3dCoriScheme=1,
                                           fPrime=1e-4)
    cfg = getattr(tsyn, config)(**SIZE, **extra)
    jgrid, tgrid = grids(cfg)
    arrays = momentum_inputs(tgrid, 21)
    jfn, tfn = ((jvi.mom_vecinv, tvi._mom_vecinv_plain) if "vi" in config
                else (jmom.mom_fluxform, tmom._mom_fluxform_plain))
    want = jfn(jax_config(cfg), jgrid, *map(jnp.asarray, arrays))
    got = tfn(cfg, tgrid, *map(torch.from_numpy, arrays))
    ol = cfg.olx
    for name, g, w in zip(tmom.MomTend._fields, got, want):
        a = np.asarray(g)[..., ol:-ol, ol:-ol]
        b = np.asarray(w)[..., ol:-ol, ol:-ol]
        assert digits(a, b) >= DIGITS, name
    # the Coriolis term is gone: the same tendencies without useCDscheme
    # differ
    cfg.useCDscheme = False
    assert not torch.equal(tfn(cfg, tgrid, *map(torch.from_numpy,
                                                 arrays)).gU, got.gU)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("it", (0, 1, 2))
def test_mom_ab_step_cd(config, it):
    """G's twin under useCDscheme: the raw tendencies and gU_ab, gV_ab (JAX's
    adams_bashforth of the summed tendency) in the predictors' places."""
    cfg = getattr(tsyn, config)(**SIZE)
    _, tgrid = grids(cfg)
    rng = np.random.default_rng(31 + it)
    s3 = tuple(tgrid.hFacC.shape)
    t = [rng.standard_normal(s3) * 1e-5 for _ in range(10)]
    ext = [rng.standard_normal(s3[1:]) * 1e-5 for _ in range(2)]
    u = rng.standard_normal(s3) * 0.1
    jcfg = jax_config(cfg)
    want = []
    for gT, dphi, diss, e, nm1, nm2 in ((t[0], t[1], t[2], ext[0], t[3],
                                         t[4]),
                                        (t[5], t[6], t[7], ext[1], t[8],
                                         t[9])):
        g = jnp.asarray(gT) - dphi + diss
        g = g.at[0].add(e)
        want += [g, jstep.adams_bashforth(jcfg, g, jnp.asarray(nm1),
                                          jnp.asarray(nm2), it)[0]]
    T = [torch.from_numpy(a) for a in t]
    E = [torch.from_numpy(a) for a in ext]
    U = torch.from_numpy(u)
    got = tstep._mom_ab_step_plain(cfg, tgrid, it, T[0], T[1], T[2], E[0],
                                   T[3], T[4], U, T[5], T[6], T[7], E[1],
                                   T[8], T[9], U)
    for k, (g, w) in enumerate(zip(got, want)):
        assert digits(g.numpy(), np.asarray(w)) >= DIGITS, k
