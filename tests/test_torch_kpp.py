"""PyTorch port: KPP (model/kpp.py, the plain twins of kernel K) against the
JAX package's KPP.calc, in float64 on the CPU.

The same numpy inputs, made from a seed, go through both, with the JAX
KPP run eagerly: a stratified column set with a convective north and a
stable south, random shear and a random totPhiHyd. Every output agrees to
12 digits or more (measured 16), over the option sets (the default, no
KPP_GHAT, no smoothing, LimitHblStable off from a data.kpp namelist) on
JMD95Z and over the LINEAR and MDJWF equations of state; the boundary-
layer index kbl of each package's BLDEPTH is identical in every column.
Also: d(rho)/d(theta) and d(rho)/d(salt) to 13 digits, the wm/ws tables
bit for bit, kernel C's twin with the nonlocal flux df against JAX's
calc_rhs(kpp_df=...) to 12 digits, and the glue visc_uv and ghat_flux.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import gad as jgad
from mitgcm_tpu.model import kpp as jkpp
from mitgcm_tpu.ops import eos as jeos
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core import nml
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import gad as tgad
from mitgcm_tpu_torch.model import kpp as tkpp
from mitgcm_tpu_torch.ops import eos as teos
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config

torch.set_num_threads(1)

SIZE = dict(nx=16, ny=16, nr=12, depth=300.0)
OUTPUTS = ("viscAz", "diffKzT", "diffKzS", "ghat", "hbl", "frac")
UNLIMITED = nml.parse_namelist(
    " &KPP_PARM01\n LimitHblStable=.FALSE.,\n &\n")["KPP_PARM01"]


def _grids(cfg):
    jgrid = jsyn.gyre_setup(jax_config(cfg), dtype=jnp.float64)[0]
    return jgrid, convert.from_arrays(Grid, convert.arrays_of(jgrid),
                                      device="cpu")


@pytest.fixture(scope="module")
def inputs():
    """KPP.calc's arguments as numpy arrays: the kpp-gyre's profiles with
    noise, a wind stress, and a heat flux that cools the north and heats
    the south."""
    cfg = tsyn.kpp_gyre_config(**SIZE)
    jgrid, _ = _grids(cfg)
    rng = np.random.default_rng(2024)
    shape = jgrid.hFacC.shape
    m = np.asarray(jgrid.maskC)
    tref = np.asarray(cfg.tRef)[:, None, None]
    sref = np.asarray(cfg.sRef)[:, None, None]
    u = 0.1 * rng.standard_normal(shape) * np.asarray(jgrid.maskW)
    v = 0.1 * rng.standard_normal(shape) * np.asarray(jgrid.maskS)
    theta = (tref + 0.3 * rng.standard_normal(shape)) * m
    salt = (sref + 0.02 * rng.standard_normal(shape)) * m
    phi = 2.0 * rng.standard_normal(shape)
    s2 = shape[1:]
    y = np.linspace(0.0, np.pi, s2[0])[:, None] * np.ones(s2)
    sfU = 1e-4 * (1.0 + rng.random(s2))
    sfV = 2e-5 * rng.standard_normal(s2)
    sfT = 5e-5 * np.cos(y) * m[0]           # heating south, cooling north
    sfS = 1e-7 * rng.standard_normal(s2) * m[0]
    Qsw = -100.0 * m[0]
    difT = np.full(shape, cfg.diffKrT)
    difS = np.full(shape, cfg.diffKrS)
    return (u, v, theta, salt, phi, sfU, sfV, sfT, sfS, Qsw, difT, difS)


def _calc_both(cfg, arrays, group, options):
    jcfg = jax_config(cfg)
    jgrid, tgrid = _grids(cfg)
    jk = jkpp.KPP(jcfg, jgrid, group, options=options)
    tk = tkpp.KPP(cfg, tgrid, group, options=options)
    kbl = []
    bldepth = jk.bldepth

    def spy(*args):
        out = bldepth(*args)
        kbl.append(np.asarray(out[-1]))
        return out
    jk.bldepth = spy
    want = jk.calc(*map(jnp.asarray, arrays))
    got = tk.calc(*map(torch.from_numpy, arrays))
    return want, got, kbl[0], tk


@pytest.mark.parametrize("eos,group,options", [
    ("JMD95Z", {}, tkpp.DEFAULT_OPTIONS),
    ("JMD95Z", {}, {"KPP_SMOOTH_SHSQ", "KPP_SMOOTH_DBLOC"}),
    ("JMD95Z", {}, {"KPP_GHAT"}),
    ("JMD95Z", UNLIMITED, tkpp.DEFAULT_OPTIONS),
    ("LINEAR", {}, tkpp.DEFAULT_OPTIONS),
    ("MDJWF", {}, tkpp.DEFAULT_OPTIONS),
], ids=["default", "no-ghat", "no-smoothing", "unlimited-hbl", "linear",
        "mdjwf"])
def test_kpp_calc(inputs, eos, group, options):
    cfg = tsyn.kpp_gyre_config(**SIZE, eosType=eos)
    want, got, want_kbl, tk = _calc_both(cfg, inputs, group, options)
    for name in OUTPUTS:
        d = digits(got[name].numpy(), np.asarray(want[name]))
        assert d >= 12, (name, d)
    assert np.array_equal(got["kbl"].numpy(), want_kbl)
    # both regimes are exercised: a convective boundary layer with a
    # nonlocal flux and a shallow stable one
    hbl = got["hbl"].numpy()[np.asarray(tk.grid.maskC[0]) > 0]
    assert hbl.min() < 10.0 < 25.0 < hbl.max()
    assert np.count_nonzero(got["ghat"].numpy()) > 0


def test_kpp_tables_bit_equal():
    cfg = tsyn.kpp_gyre_config(**SIZE)
    jgrid, tgrid = _grids(cfg)
    jk = jkpp.KPP(jax_config(cfg), jgrid, {})
    tk = tkpp.KPP(cfg, tgrid, {})
    for name in ("wmt", "wst"):
        assert np.array_equal(getattr(tk, name).numpy(),
                              np.asarray(getattr(jk, name))), name
    assert np.array_equal(tk.zgrid_f, jk.zgrid_f)
    assert np.array_equal(tk.hwide_f, jk.hwide_f)
    assert np.array_equal(tk.kmtj.numpy(), np.asarray(jk.kmtj))


@pytest.mark.parametrize("eos,select_p", [
    ("LINEAR", 0), ("JMD95Z", 0), ("UNESCO", 2), ("MDJWF", 0), ("MDJWF", 2)])
@pytest.mark.parametrize("which", ["alpha", "beta"])
def test_find_alpha_beta(inputs, eos, select_p, which):
    cfg = dataclasses.replace(tsyn.kpp_gyre_config(**SIZE), eosType=eos,
                              selectP_inEOS_Zc=select_p)
    jgrid, tgrid = _grids(cfg)
    theta, salt, phi = inputs[2], inputs[3].copy(), inputs[4]
    salt[0, 3, 3] = -0.25          # the max(s, 0) guards
    jfn = getattr(jeos, f"find_{which}")
    tfn = getattr(teos, f"find_{which}")
    want = np.asarray(jfn(jax_config(cfg), jgrid, jnp.asarray(theta),
                          jnp.asarray(salt), totPhiHyd=jnp.asarray(phi)))
    got = tfn(cfg, tgrid, torch.from_numpy(theta), torch.from_numpy(salt),
              totPhiHyd=torch.from_numpy(phi)).numpy()
    assert digits(got, want) >= 13


@pytest.mark.parametrize("implicit", [False, True])
def test_calc_rhs_with_df(inputs, implicit):
    """Kernel C's twin with the nonlocal flux df added to fVer."""
    cfg = tsyn.kpp_gyre_config(**SIZE)
    jgrid, tgrid = _grids(cfg)
    u, v, theta = inputs[0], inputs[1], inputs[2]
    rng = np.random.default_rng(5)
    w = 1e-4 * rng.standard_normal(theta.shape) * np.asarray(jgrid.maskC)
    kappa = 1e-3 * np.abs(rng.standard_normal(theta.shape))
    df = 1e-2 * rng.standard_normal(theta.shape)
    df[0] = 0.0
    jcfg = jax_config(cfg)
    ju, jv, jw = map(jnp.asarray, (u, v, w))
    jflow = jgad.calc_adv_flow(jcfg, jgrid, ju, jv, jw)
    want = jgad.calc_rhs(jcfg, jgrid, jflow, ju, jv, jw, jnp.asarray(theta),
                         2, 2, cfg.diffKhT, 0.0, jnp.asarray(kappa),
                         cfg.deltaTTracer, implicit,
                         kpp_df=jnp.asarray(df))
    tflow = tgad.calc_adv_flow(tgrid, *map(torch.from_numpy, (u, v, w)))
    got = tgad.calc_rhs(cfg, tgrid, tflow, torch.from_numpy(theta),
                        torch.from_numpy(kappa), cfg.diffKhT,
                        implicit_diffusion=implicit,
                        df=torch.from_numpy(df))
    ol = cfg.olx
    assert digits(got.numpy()[:, ol:-ol, ol:-ol],
                  np.asarray(want)[:, ol:-ol, ol:-ol]) >= 12


def test_kpp_glue(inputs):
    """visc_uv (KPP's viscosity blended into kappaRU/RV) and ghat_flux
    against the JAX package's."""
    cfg = tsyn.kpp_gyre_config(**SIZE)
    jgrid, tgrid = _grids(cfg)
    jcfg = jax_config(cfg)
    rng = np.random.default_rng(9)
    shape = jgrid.hFacC.shape
    az, kz, ghat = (np.abs(rng.standard_normal(shape)) * 1e-2
                    for _ in range(3))
    kU, kV = (np.full(shape, cfg.viscAr) for _ in range(2))
    sfc, qsw = (rng.standard_normal(shape[1:]) for _ in range(2))
    maskUp = np.asarray(tgad.calc_adv_flow(tgrid, *[
        torch.zeros(shape, dtype=torch.float64)] * 3).maskUp)
    want = jkpp.visc_uv(jcfg, jgrid, {"viscAz": jnp.asarray(az)},
                        jnp.asarray(kU), jnp.asarray(kV))
    got = tkpp.visc_uv(cfg, tgrid, {"viscAz": torch.from_numpy(az)},
                       torch.from_numpy(kU), torch.from_numpy(kV))
    for w, g in zip(want, got):
        assert digits(g.numpy(), np.asarray(w)) >= 15
    want = jkpp.ghat_flux(jcfg, jgrid, *map(jnp.asarray, (
        kz, ghat, sfc, qsw, maskUp)))
    got = tkpp.ghat_flux(cfg, tgrid, *map(torch.from_numpy, (
        kz, ghat, sfc, qsw, maskUp)))
    assert digits(got.numpy(), np.asarray(want)) >= 15
