"""PyTorch port: GGL90 TKE mixing (model/ggl90.py, the plain twins of kernel
G9) against the JAX package's GGL90.calc, solve_tridiagonal and
thermodynamics.calc_sigmaR, in float64 on the CPU.

The same numpy inputs, made from a seed, go through both on a grid with a
shelf, a bank and a partial bottom cell (so the number of wet levels, and with it
the bottom row of the Dirichlet fold, differs between columns): random
velocities with columns of zero vertical shear, a random TKE, a sigmaR
that is statically unstable at about a fifth of the interfaces, and a
random surface stress. tke', viscArU, viscArV and diffKr agree to 12 digits
or more over mxlMaxFlag 0-3 and both branches of calcMeanVertShear and
GGL90_dirichlet, and the Prandtl number's branch (Ri >= 0.2) is the same in
every cell. The Thomas solve agrees bit for bit (with JAX evaluated op by
op) on a system with a zero pivot, and calc_sigmaR to 12 digits.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.core.grid import build_grid as jbuild_grid
from mitgcm_tpu.model import ggl90 as jg9
from mitgcm_tpu.model import thermodynamics as jth
from mitgcm_tpu.ops import eos as jeos
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import ggl90 as tg9
from mitgcm_tpu_torch.model import thermodynamics as tth
from mitgcm_tpu_torch.ops import eos as teos
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config

torch.set_num_threads(1)

SIZE = dict(nx=16, ny=16, nr=12, depth=300.0)
OUTPUTS = ("tke", "viscArU", "viscArV", "diffKr")


def _grids(cfg):
    """Both packages' grids of the ggl90-gyre's basin with a 120 m shelf
    along the west, a 200 m bank and a partial bottom cell in one row."""
    nx, ny = cfg.nx, cfg.ny
    bathy = np.full((ny, nx), -sum(cfg.delR))
    bathy[:, :5] = -120.0
    bathy[3:7, 10:14] = -200.0
    bathy[9, 6:12] = -sum(cfg.delR) + 0.4 * cfg.delR[-1]
    bathy[0, :] = bathy[-1, :] = bathy[:, 0] = bathy[:, -1] = 0.0
    jgrid = jbuild_grid(jax_config(cfg), bathy=bathy, dtype=jnp.float64)
    return jgrid, convert.from_arrays(Grid, convert.arrays_of(jgrid),
                                      device="cpu")


@pytest.fixture(scope="module")
def case():
    cfg = tsyn.ggl90_gyre_config(**SIZE)
    jgrid, tgrid = _grids(cfg)
    rng = np.random.default_rng(90)
    shape = tgrid.hFacC.shape
    u = 0.1 * rng.standard_normal(shape)
    v = 0.1 * rng.standard_normal(shape)
    for a in (u, v):                       # no vertical shear in column 7
        a[:, :, 7:9] = a[:1, :, 7:9]
    u *= tgrid.maskW.numpy()
    v *= tgrid.maskS.numpy()
    m = tgrid.maskC.numpy()
    tke = np.abs(3e-4 * rng.standard_normal(shape))
    sigmaR = -1e-4 * (1.0 + 0.5 * rng.standard_normal(shape))
    sigmaR[rng.random(shape) < 0.2] *= -0.3     # statically unstable
    # quiet and strongly stratified in the north: the TKE stays at its floor
    tke[:, 12:] = 1e-11
    sigmaR[:, 12:] = -1e-2
    u[:, 12:] *= 1e-3
    v[:, 12:] *= 1e-3
    tke *= m
    sigmaR[0] = 0.0
    sigmaR *= m
    sfU = 1e-4 * rng.standard_normal(shape[1:])
    sfV = 1e-4 * rng.standard_normal(shape[1:])
    return cfg, jgrid, tgrid, (u, v, tke, sigmaR, sfU, sfV)


class _WhereSpy:
    """jax.numpy with `where` recorded: the Prandtl switch of GGL90.calc is
    the one call on whole 3-D fields whose third argument is 1.0
    (ggl90.py:431; the Thomas solve's guards work on 2-D levels)."""

    def __init__(self):
        self.conditions = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def where(self, cond, x, y):
        if isinstance(y, float) and y == 1.0 and np.ndim(cond) == 3:
            self.conditions.append(np.asarray(cond))
        return jnp.where(cond, x, y)


@pytest.mark.parametrize("flag,mean_shear,dirichlet", list(itertools.product(
    range(4), (False, True), (True, False))))
def test_ggl90_calc(case, monkeypatch, flag, mean_shear, dirichlet):
    cfg, jgrid, tgrid, arrays = case
    group = {"mxlMaxFlag": flag, "calcMeanVertShear": mean_shear,
             "GGL90_dirichlet": dirichlet}
    spy = _WhereSpy()
    monkeypatch.setattr(jg9, "jnp", spy)
    jobj = jg9.GGL90(jax_config(cfg), jgrid, group)
    want = jobj.calc(*map(jnp.asarray, arrays))[:4]
    monkeypatch.undo()
    tobj = tg9.GGL90(cfg, tgrid, group)
    got = tobj.calc(*map(torch.from_numpy, arrays))
    for name, g, w in zip(OUTPUTS, got, want):
        d = digits(g.numpy(), np.asarray(w))
        assert d >= 12, (name, d)
    col = tg9._ggl90_col_plain(tobj, *map(torch.from_numpy, arrays))
    branch = col["prandtl"].numpy()
    branch[0] = False                  # Pr(1) = 1 in both (ggl90.py:433)
    jbranch, = spy.conditions
    jbranch = jbranch.copy()
    jbranch[0] = False
    assert np.array_equal(branch, jbranch)
    assert 0 < branch.sum() < branch.size
    # the inputs reach both regimes: TKE above the floor and clipped to it
    tke = got[0].numpy()[1:][tgrid.maskC.numpy()[1:] > 0]
    assert (tke > 1e-6).any() and (tke == tobj.p["GGL90TKEmin"]).any()


def test_klowC_differs_between_columns(case):
    """The shelf and the bank give the bottom fold several rows."""
    tgrid = case[2]
    klow = tg9.GGL90(case[0], tgrid).klowC.numpy()
    assert len(set(klow[tgrid.maskC.numpy()[0] > 0].tolist())) >= 3


def test_solve_tridiagonal_zero_pivot():
    """The Thomas solve bit for bit against JAX's evaluated op by op, with
    a zero pivot giving its row a reciprocal of 0. (XLA's compiled scan
    rounds its sweep otherwise, by an ulp; the port follows the op-by-op
    order, which is the reference's.)"""
    rng = np.random.default_rng(3)
    shape = (6, 4, 5)
    a = rng.standard_normal(shape)
    b = 4.0 + rng.standard_normal(shape)
    c = rng.standard_normal(shape)
    y = rng.standard_normal(shape)
    a[0] = 0.0
    c[-1] = 0.0
    b[2, 1, 1] = 0.0
    a[2, 1, 1] = 0.0                 # den = b - a cp = 0: a zero pivot
    with jax.disable_jit():
        want = np.asarray(jg9.solve_tridiagonal(*map(jnp.asarray,
                                                     (a, b, c, y))))
    got = tg9.solve_tridiagonal(*map(torch.from_numpy, (a, b, c, y)))
    assert np.array_equal(got.numpy(), want)
    assert np.isfinite(want).all()


@pytest.mark.parametrize("eos", ["JMD95Z", "LINEAR", "MDJWF"])
def test_calc_sigmaR(case, eos):
    cfg = tsyn.ggl90_gyre_config(**SIZE, eosType=eos)
    jgrid, tgrid = case[1], case[2]
    rng = np.random.default_rng(11)
    shape = tgrid.hFacC.shape
    m = tgrid.maskC.numpy()
    theta = (np.asarray(cfg.tRef)[:, None, None]
             + 0.5 * rng.standard_normal(shape)) * m
    salt = (np.asarray(cfg.sRef)[:, None, None]
            + 0.05 * rng.standard_normal(shape)) * m
    phi = 2.0 * rng.standard_normal(shape)
    jcfg = jax_config(cfg)
    jt, js, jp = map(jnp.asarray, (theta, salt, phi))
    jrho = jeos.find_rho(jcfg, jgrid, jt, js, totPhiHyd=jp) * jgrid.maskC
    want = np.asarray(jth.calc_sigmaR(jcfg, jgrid, jrho, jt, js,
                                      totPhiHyd=jp))
    tt, ts, tp = map(torch.from_numpy, (theta, salt, phi))
    trho = teos.find_rho(cfg, tgrid, tt, ts, totPhiHyd=tp) * tgrid.maskC
    got = tth.calc_sigmaR(cfg, tgrid, trho, tt, ts, totPhiHyd=tp).numpy()
    assert digits(got, want) >= 12
    assert (want[1:][m[1:] > 0] > 0).any()   # unstable interfaces occur
