"""PyTorch port: GM-Redi's plain twins (model/gmredi.py, and kernel C's GM
branch in model/gad.py:calc_rhs) against the JAX package's functions on
the same seeded inputs, in float64 on every padded cell of a 16x12x8 grid
with walls and stretched levels.

The inputs span every branch of the tapers: stable and unstable
stratification, zero and tiny vertical gradients (the big-slope and
small-number guards), slopes on both sides of GM_maxSlope and of Scrit, and
a few huge horizontal gradients that reach the slope cutoffs. The bars:
13 digits where only + - * / and sqrt enter, 12 where tanh or sin does
(dm95, ldd97: PyTorch's CPU tanh and sin round otherwise than XLA's).
Measured: 16 (equal) but for calc_tensor with the clipping (15.38) and
linear (15.45) tapers, whose sqrt rounds otherwise, dm95 (13.62), ldd97
(14.07), and calc_psi_b with dm95 (14.46).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import gad as jgad
from mitgcm_tpu.model import gmredi as jgm
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import gad as tgad
from mitgcm_tpu_torch.model import gmredi as tgm
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config

torch.set_num_threads(1)

TAPERS = ("", "clipping", "gkw91", "linear", "dm95", "ldd97", "ac02")
PSI_TAPERS = ("", "clipping", "gkw91", "linear", "dm95", "ac02")
# tanh or sin in the taper: PyTorch's CPU libm against XLA's
TRANSCENDENTAL = ("dm95", "ldd97")


def _bar(taper):
    return 12.0 if taper in TRANSCENDENTAL else 13.0


@functools.lru_cache(maxsize=1)
def _grids():
    """JAX's and the port's grid of a small kpp-gyre (walls, 8 levels
    stretched over 300 m)."""
    jcfg = jax_config(tsyn.kpp_gyre_config(nx=16, ny=12, nr=8, depth=300.0))
    jgrid = jsyn.gyre_setup(jcfg, dtype=jnp.float64)[0]
    return jgrid, convert.from_arrays(Grid, convert.arrays_of(jgrid),
                                      device="cpu")


class Case:
    """The grids of _grids, the configuration with the GM-Redi settings
    `gm`, and seeded density gradients."""

    def __init__(self, seed=0, **gm):
        cfg = tsyn.kpp_gyre_config(nx=16, ny=12, nr=8, depth=300.0)
        cfg.useGMRedi = True
        cfg.gmredi = tgm.GMParams(**{"background_K": 1000.0,
                                     "Kmin_horiz": 100.0, **gm})
        self.cfg = cfg
        self.jcfg = jax_config(cfg)
        self.jgrid, self.grid = _grids()
        rng = np.random.default_rng(seed)
        g = self.jgrid
        shape = g.hFacC.shape
        mW, mS, mC = (np.asarray(m) for m in (g.maskW, g.maskS, g.maskC))
        sx = 1e-7 * rng.standard_normal(shape) * mW
        sy = 1e-7 * rng.standard_normal(shape) * mS
        # |sigmaR| log-uniform over 1e-8..1e-3, a tenth unstable, some 0
        # and some below small_number; a few huge horizontal gradients
        mag = 10.0 ** rng.uniform(-8.0, -3.0, shape)
        sign = np.where(rng.random(shape) < 0.1, 1.0, -1.0)
        sr = sign * mag
        sr[rng.random(shape) < 0.05] = 0.0
        sr[rng.random(shape) < 0.03] = -3e-21
        sx[rng.random(shape) < 0.01] = 1e5
        sy[rng.random(shape) < 0.01] = -1e5
        sr[0] = 0.0
        self.sigma = (sx, sy, sr * mC)
        self.rho = (1027.0 + rng.standard_normal(shape)) * mC

    def port(self, *arrays):
        return [torch.from_numpy(np.array(a)) for a in arrays]

    def jax(self, *arrays):
        return [jnp.asarray(a) for a in arrays]


def _check(got, want, bar, label):
    for name, g, w in zip(("0", "1", "2", "3", "4", "5", "6"), got, want):
        if w is None:
            assert g is None, (label, name)
            continue
        d = digits(np.asarray(g), np.asarray(w))
        assert d >= bar, f"{label}[{name}]: {d:.2f} digits < {bar}"


@pytest.mark.parametrize("adv_form", [False, True])
@pytest.mark.parametrize("non_unity", [True, False])
@pytest.mark.parametrize("taper", TAPERS)
def test_calc_tensor(taper, non_unity, adv_form):
    c = Case(taper_scheme=taper, nonUnityDiagonal=non_unity,
             advForm=adv_form, isopycK=500.0 if adv_form else -999.0)
    want = jgm.calc_tensor(c.jcfg, c.jgrid, c.jcfg.gmredi, *c.jax(*c.sigma))
    got = tgm.calc_tensor(c.cfg, c.grid, c.cfg.gmredi, *c.port(*c.sigma))
    assert type(got).__name__ == "GMTensor"
    assert got._fields == want._fields
    if not non_unity:
        assert got.Kux.dim() == 0 and float(got.Kux) == float(want.Kux)
    assert (got.Kuz is not None) == (adv_form and non_unity)
    _check(got, want, _bar(taper), f"calc_tensor {taper!r}")


@pytest.mark.parametrize("taper", PSI_TAPERS)
def test_calc_psi_b(taper):
    c = Case(seed=1, taper_scheme=taper, advForm=True)
    want = jgm.calc_psi_b(c.jcfg, c.jgrid, c.jcfg.gmredi, *c.jax(*c.sigma))
    got = tgm.calc_psi_b(c.cfg, c.grid, c.cfg.gmredi, *c.port(*c.sigma))
    _check(got, want, _bar(taper), f"calc_psi_b {taper!r}")
    # the psi taper's cutoff is float64's, 1e24, in float32 too
    assert tgm.psi_cutoff(c.cfg.gmredi) == 1e24


def test_wrappers_on_the_cpu_run_the_twins():
    """gm_tensor and gm_psi_b on CPU tensors: sigmaX and sigmaY from the
    density as JAX's step computes them, then the twins."""
    c = Case(seed=2, taper_scheme="gkw91", advForm=True)
    g = c.jgrid
    jrho, jsr = c.jax(c.rho, c.sigma[2])
    jsx = g.maskW * g.recip_dxC * (jrho - jnp.roll(jrho, 1, axis=-1)
                                   .at[..., 0].set(0.0))
    jsy = g.maskS * g.recip_dyC * (jrho - jnp.roll(jrho, 1, axis=-2)
                                   .at[..., 0, :].set(0.0))
    rho, sr = c.port(c.rho, c.sigma[2])
    n0 = tgm.plain_calls
    got = tgm.gm_tensor(c.cfg, c.grid, c.cfg.gmredi, rho, sr)
    want = jgm.calc_tensor(c.jcfg, g, c.jcfg.gmredi, jsx, jsy, jsr)
    _check(got, want, 16.0, "gm_tensor")
    got = tgm.gm_psi_b(c.cfg, c.grid, c.cfg.gmredi, rho, sr)
    want = jgm.calc_psi_b(c.jcfg, g, c.jcfg.gmredi, jsx, jsy, jsr)
    _check(got, want, 16.0, "gm_psi_b")
    assert tgm.plain_calls == n0 + 2


def _flow_and_tracer(c, seed):
    rng = np.random.default_rng(seed)
    g = c.jgrid
    shape = g.hFacC.shape
    u = 0.1 * rng.standard_normal(shape) * np.asarray(g.maskW)
    v = 0.1 * rng.standard_normal(shape) * np.asarray(g.maskS)
    w = 1e-4 * rng.standard_normal(shape) * np.asarray(g.maskC)
    t = (15.0 + rng.standard_normal(shape)) * np.asarray(g.maskC)
    return u, v, w, t, rng


def test_residual_flow():
    c = Case(seed=3, taper_scheme="dm95", advForm=True)
    u, v, w, _, _ = _flow_and_tracer(c, 3)
    jpsi = jgm.calc_psi_b(c.jcfg, c.jgrid, c.jcfg.gmredi, *c.jax(*c.sigma))
    psi = c.port(*jpsi)
    want = jgm.residual_flow(c.jcfg, c.jgrid, *jpsi, *c.jax(u, v, w))
    got = tgm.gm_residual_flow(c.cfg, c.grid, *psi, *c.port(u, v, w))
    _check(got, want, 16.0, "residual_flow")


@pytest.mark.parametrize("non_unity,extra", [(True, False), (True, True),
                                             (False, False)])
def test_xy_and_r_flux(non_unity, extra):
    c = Case(seed=4, taper_scheme="gkw91", nonUnityDiagonal=non_unity,
             advForm=extra)
    _, _, _, t, _ = _flow_and_tracer(c, 4)
    jten = jgm.calc_tensor(c.jcfg, c.jgrid, c.jcfg.gmredi, *c.jax(*c.sigma))
    ten = tgm.calc_tensor(c.cfg, c.grid, c.cfg.gmredi, *c.port(*c.sigma))
    assert (ten.Kuz is not None) == extra
    jxA = c.jgrid.dyG * c.jgrid.drF[:, None, None] * c.jgrid.hFacW
    jyA = c.jgrid.dxG * c.jgrid.drF[:, None, None] * c.jgrid.hFacS
    xA, yA = c.port(jxA, jyA)
    (jt,), (tt,) = c.jax(t), c.port(t)
    want = jgm.xy_flux(c.jcfg, c.jgrid, jten, jxA, jyA, jt)
    got = tgm.xy_flux(c.cfg, c.grid, ten, xA, yA, tt)
    _check(got, want, 13.0, "xy_flux")
    mC = c.jgrid.maskC
    jup = mC * jnp.concatenate([jnp.zeros_like(mC[:1]), mC[:-1]])
    want = jgm.r_flux(c.jcfg, c.jgrid, jten, jup, jt)
    got = tgm.r_flux(c.cfg, c.grid, ten, *c.port(jup), tt)
    _check([got], [want], 13.0, "r_flux")


@pytest.mark.parametrize("with_df", [False, True])
@pytest.mark.parametrize("calc_advection,implicit", [(True, True),
                                                     (True, False),
                                                     (False, True)])
@pytest.mark.parametrize("non_unity,extra", [(True, False), (True, True),
                                             (False, False)])
def test_calc_rhs_with_gm(non_unity, extra, calc_advection, implicit,
                          with_df):
    """calc_rhs's GM branch (the twin of kernel C's) against JAX's calc_rhs
    with its gm_tensor, scheme 2 and without advection (the
    multi-dimensional schemes' tracers), with and without KPP's df."""
    c = Case(seed=5, taper_scheme="gkw91", nonUnityDiagonal=non_unity,
             advForm=extra)
    u, v, w, t, rng = _flow_and_tracer(c, 5)
    shape = t.shape
    kappaR = 1e-4 * np.abs(rng.standard_normal(shape))
    df = 1e-3 * rng.standard_normal(shape) * np.asarray(c.jgrid.maskC)
    cfg, jcfg = c.cfg, c.jcfg
    jten = jgm.calc_tensor(jcfg, c.jgrid, jcfg.gmredi, *c.jax(*c.sigma))
    ten = tgm.calc_tensor(cfg, c.grid, cfg.gmredi, *c.port(*c.sigma))
    ju, jv, jw = c.jax(u, v, w)
    jflow = jgad.calc_adv_flow(jcfg, c.jgrid, ju, jv, jw)
    want = jgad.calc_rhs(jcfg, c.jgrid, jflow, ju, jv, jw, jnp.asarray(t),
                         2, 2, cfg.diffKhT, 0.0, jnp.asarray(kappaR),
                         cfg.deltaT, implicit,
                         calc_advection=calc_advection, gm_tensor=jten,
                         kpp_df=jnp.asarray(df) if with_df else None)
    flow = tgad.calc_adv_flow(c.grid, *c.port(u, v, w))
    n0 = tgm.plain_calls
    got = tgad.calc_rhs(cfg, c.grid, flow, *c.port(t, kappaR), cfg.diffKhT,
                        implicit_diffusion=implicit,
                        df=torch.from_numpy(df) if with_df else None,
                        calc_advection=calc_advection, gm=ten)
    assert tgm.plain_calls == n0 + 1
    # kernel C writes zero halo cells; both agree on the interior
    ol = cfg.olx
    _check([got[..., ol:-ol, ol:-ol]], [np.asarray(want)[..., ol:-ol, ol:-ol]],
           13.0, "calc_rhs with GM")
