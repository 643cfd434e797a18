"""PyTorch port: IDEMIX and the Langmuir parameterization in GGL90
(model/ggl90.py, the plain twins of kernels H-IDEMIX and G9) against the
JAX package's GGL90.idemix, GGL90.calc, GGL90.mixinglength, stokes_drift
and init_idemix_forc, in float64 on the CPU.

The same numpy inputs, made from a seed, go through both on the grid of
tests/test_torch_ggl90.py (a shelf, a bank and a partial bottom cell, so
klowC and hFacI take several values): a random internal-wave energy, a
buoyancy frequency with strongly, moderately and weakly stratified columns
and unstable cells, and the energy-flux maps of synthetic.idemix_maps
stretched past the [0, 1] W/m2 clip. IDEMIX's step agrees to 12 digits or
more, and GGL90.calc to 12 digits or more with IDEMIX alone, Langmuir alone
and both, over mxlMaxFlag 1-3 (0 with IDEMIX alone: Langmuir refuses it,
as JAX does) and both calcMeanVertShear settings. XLA and PyTorch evaluate
asin, pow, exp and log differently on the CPU, so the bar is digits, not
bits. Branch tests show that these inputs reach each discrete choice both
ways: N < |f| (hofx1 < 0), v0's CFL cap, the floors of cstar and tau_d,
Langmuir's ML == its limit, IDEMIX's Prandtl number clipped at 1 and at 10,
and a zero pivot of IDEMIX's vertical solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import ggl90 as jg9
from mitgcm_tpu_torch.model import ggl90 as tg9
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config
from test_torch_ggl90 import SIZE, _grids

torch.set_num_threads(1)

IDEMIX = {"useIDEMIX": True, "IDEMIX_tidal_file": "idemix_tidal",
          "IDEMIX_wind_file": "idemix_wind"}
LANGMUIR = {"useLANGMUIR": True}
OUTPUTS = ("tke", "viscArU", "viscArV", "diffKr", "IDEMIX_E")


def _maps(cfg, tgrid):
    """The idemix-gyre's flux maps, scaled so that the clip to [0, 1] W/m2
    bites in places (numpy, by file name)."""
    ol = cfg.olx
    wet = tgrid.maskC[0, ol:-ol, ol:-ol].numpy()
    maps = tsyn.idemix_maps(cfg, wet, torch.float64, "cpu")
    return {"idemix_tidal": maps["idemix_tidal"].numpy() * 250.0 - 0.2,
            "idemix_wind": maps["idemix_wind"].numpy() * 400.0}


@pytest.fixture(scope="module")
def case():
    cfg = tsyn.ggl90_gyre_config(**SIZE)
    jgrid, tgrid = _grids(cfg)
    rng = np.random.default_rng(17)
    shape = tgrid.hFacC.shape
    m = tgrid.maskC.numpy()
    ny, nx = shape[1:]
    # per column: strong (N2 1e-3, v0 above its CFL cap), moderate and
    # weak (cstar at its floor) stratification, with unstable cells
    regime = rng.choice([1e-3, 1e-5, 1e-9], size=(ny, nx))
    nsq = regime * (1.0 + 0.5 * rng.standard_normal(shape))
    nsq[rng.random(shape) < 0.1] *= -0.5
    nsq[0] = 0.0
    nsq *= m
    E = np.abs(1e-4 * rng.standard_normal(shape)) * m
    u = 0.1 * rng.standard_normal(shape) * tgrid.maskW.numpy()
    v = 0.1 * rng.standard_normal(shape) * tgrid.maskS.numpy()
    tke = np.abs(3e-4 * rng.standard_normal(shape)) * m
    tke[:, :, :3] = 1e-11 * m[:, :, :3]        # quiet columns: TKE at floor
    # sigmaR for calc: Nsq = -(g / rhoConst) sigmaR in z-coordinates
    sigmaR = -nsq * cfg.rhoConst / cfg.gravity
    sfU = 1e-4 * rng.standard_normal(shape[1:])
    sfV = 1e-4 * rng.standard_normal(shape[1:])
    return cfg, jgrid, tgrid, dict(nsq=nsq, E=E, u=u, v=v, tke=tke,
                                   sigmaR=sigmaR, sfU=sfU, sfV=sfV)


def _objects(case, group):
    """Both packages' GGL90 for `group`, with the flux maps loaded when
    useIDEMIX."""
    cfg, jgrid, tgrid, _ = case
    jobj = jg9.GGL90(jax_config(cfg), jgrid, group)
    tobj = tg9.GGL90(cfg, tgrid, group)
    if group.get("useIDEMIX"):
        maps = _maps(cfg, tgrid)
        jobj.init_idemix_forc(lambda f: jnp.asarray(maps[f]))
        tobj.init_idemix_forc(lambda f: torch.from_numpy(maps[f]))
    return jobj, tobj


def _hfac_I(hFacC):
    """JAX's hFacI and recip_hFacI (ggl90.py:375-379), in numpy."""
    km1 = np.concatenate([hFacC[:1], hFacC[:-1]])
    hI = np.minimum(0.5, km1) + np.minimum(0.5, hFacC)
    return hI, np.where(hI != 0.0, 1.0 / np.where(hI == 0.0, 1.0, hI), 0.0)


def test_init_idemix_forc_matches(case):
    jobj, tobj = _objects(case, IDEMIX)
    for name in ("idemix_F_b", "idemix_F_s"):
        got = getattr(tobj, name).numpy()
        want = np.asarray(getattr(jobj, name))
        assert np.array_equal(got, want), name
    # the clip to [0, 1] W/m2 is reached at both ends
    raw = _maps(case[0], case[2])["idemix_tidal"]
    assert (raw < 0.0).any() and (raw > 1.0).any()


def test_idemix_step_matches(case):
    jobj, tobj = _objects(case, IDEMIX)
    a = case[3]
    hI, rhI = _hfac_I(case[2].hFacC.numpy())
    want = jobj.idemix(jnp.asarray(a["E"]), jnp.asarray(a["nsq"]),
                       jnp.asarray(hI), jnp.asarray(rhI))
    got = tobj.idemix(torch.from_numpy(a["E"]), torch.from_numpy(a["nsq"]))
    for name, g, w in zip(("E", "gTKE"), got, want):
        d = digits(g.numpy(), np.asarray(w))
        assert d >= 12, (name, d)
    E = got[0].numpy()[1:][case[2].maskC.numpy()[1:] > 0]
    assert (E > 0.0).all()


CALC_CASES = ([("idemix", flag, mean) for flag in range(4)
               for mean in (False, True)]
              + [(which, flag, mean) for which in ("langmuir", "both")
                 for flag in (1, 2, 3) for mean in (False, True)])


@pytest.mark.parametrize("which,flag,mean_shear", CALC_CASES)
def test_ggl90_calc_matches(case, which, flag, mean_shear):
    group = {"mxlMaxFlag": flag, "calcMeanVertShear": mean_shear}
    if which != "langmuir":
        group.update(IDEMIX)
    if which != "idemix":
        group.update(LANGMUIR)
    jobj, tobj = _objects(case, group)
    a = case[3]
    names = ("u", "v", "tke", "sigmaR", "sfU", "sfV")
    want = jobj.calc(*[jnp.asarray(a[n]) for n in names],
                     idemix_E=jnp.asarray(a["E"]))
    got = tobj.calc(*[torch.from_numpy(a[n]) for n in names],
                    idemix_E=torch.from_numpy(a["E"]))
    for name, g, w in zip(OUTPUTS, got, want):
        d = digits(g.numpy(), np.asarray(w))
        assert d >= 12, (name, d)


def test_stokes_drift_matches(case):
    cfg, _, _, a = case
    jobj, tobj = _objects(case, LANGMUIR | {"mxlMaxFlag": 2})
    want = jobj.stokes_drift(jnp.asarray(a["sfU"]), jnp.asarray(a["sfV"]))
    got = tobj.stokes_drift(torch.from_numpy(a["sfU"]),
                            torch.from_numpy(a["sfV"]))
    for g, w in zip(got, want):
        assert digits(g.numpy(), np.asarray(w)) >= 13


def _both_ways(mask, name):
    mask = np.asarray(mask)
    assert mask.any() and not mask.all(), name


def test_idemix_branches(case):
    """The inputs reach both sides of IDEMIX's discrete choices."""
    _, tobj = _objects(case, IDEMIX)
    wet = case[2].maskC.numpy()
    out = tg9._idemix_prep_plain(tobj, torch.from_numpy(case[3]["nsq"]),
                                 branches=True)
    for name in ("hofx1_neg", "cfl_cap", "tau_floor"):
        _both_ways(out[name].numpy()[wet[1:] > 0], name)
    _both_ways(out["cstar_floor"].numpy()[wet[0] > 0], "cstar_floor")


def test_langmuir_length_both_ways(case):
    """Langmuir's length is LC_Gamma ML where the limiter set ML (an exact
    equality) and ML elsewhere, for each limiter it runs with."""
    a = case[3]
    for flag in (1, 2, 3):
        _, tobj = _objects(case, LANGMUIR | {"mxlMaxFlag": flag})
        tke, nsq = torch.from_numpy(a["tke"]), torch.from_numpy(a["nsq"])
        mskLoc = tobj.grid.maskC * torch.cat([tobj.grid.maskC[:1],
                                              tobj.grid.maskC[:-1]])
        ML = tg9.SQRTTWO * torch.sqrt(tke) / torch.sqrt(
            torch.clamp(nsq, min=tg9.GGL90EPS))
        ML = torch.cat([torch.full_like(ML[:1], 1e-8), ML[1:] * mskLoc[1:]])
        jML, jLC, _ = jg9.GGL90(jax_config(tobj.cfg), case[1], {
            "mxlMaxFlag": flag, **LANGMUIR}).mixinglength(jnp.asarray(ML))
        ML_t, LCML, _ = tobj.mixinglength(ML.clone())
        assert digits(LCML.numpy(), np.asarray(jLC)) >= 15
        wet = mskLoc[1:].numpy() > 0
        raised = (LCML[1:] != ML_t[1:]).numpy()[wet]
        _both_ways(raised, f"mxlMaxFlag={flag}")


def test_idemix_prandtl_clipped_both_ways(case):
    _, tobj = _objects(case, IDEMIX | {"mxlMaxFlag": 2})
    a = case[3]
    E, gTKE = tobj.idemix(torch.from_numpy(a["E"]),
                          torch.from_numpy(a["nsq"]))
    col = tg9._ggl90_col_plain(tobj, *[torch.from_numpy(a[n]) for n in (
        "u", "v", "tke", "sigmaR", "sfU", "sfV")], gTKE)
    pr = col["prandtl"].numpy()[1:][case[2].maskC.numpy()[1:] > 0]
    assert (pr < 1.0).any() and (pr > 10.0).any()
    assert ((pr > 1.0) & (pr < 10.0)).any()


def test_idemix_zero_pivot(case):
    """A column without vertical propagation (c0 = 0) whose dissipation
    cancels the diagonal exactly at one level: the Thomas solve's zero
    pivot gives that level a reciprocal of 0 (the rule of the shared
    solve_tridiagonal, held against JAX's in tests/test_torch_ggl90.py),
    and every other level its diagonal solution y / b."""
    _, tobj = _objects(case, IDEMIX)
    cfg, tgrid = case[0], case[2]
    k, j, i = cfg.nr // 2, 8, 8
    assert tgrid.maskC[k - 1:k + 1, j, i].min() > 0
    shape = tgrid.hFacC.shape
    E = np.abs(1e-4 * np.random.default_rng(5).standard_normal(shape))
    tau = np.full(shape, 1.0 / 1024.0)
    dt = cfg.deltaTTracer
    e = -1024.0 / dt
    while 1.0 + dt * (1.0 / 1024.0) * e != 0.0:     # exact cancellation
        e = np.nextafter(e, 0.0)
    E[k, j, i] = e
    got, _ = tg9._idemix_col_plain(tobj, *map(torch.from_numpy, (
        E, np.zeros(shape), tau)))
    m = tgrid.maskC.numpy()
    mkm1 = np.concatenate([m[:1], m[:-1]])
    b = 1.0 + dt * tau * E * m * mkm1
    b[0] = 1.0
    y = E.copy()
    y[1] += (dt * tobj.idemix_F_s.numpy() * tgrid.recip_drC[1].item()
             * tg9.hfac_I(tgrid)[1][1].numpy() * m[1])
    kB0 = np.maximum(tobj.klowC.numpy() - 1, 0)
    rhI = tg9.hfac_I(tgrid)[1].numpy()
    jj, ii = np.indices(kB0.shape)
    y[kB0, jj, ii] += (-dt * tobj.idemix_F_b.numpy()
                       * tgrid.recip_drC.numpy()[kB0] * rhI[kB0, jj, ii]
                       * m[kB0, jj, ii])
    want = np.where(b != 0.0, y * (1.0 / np.where(b != 0.0, b, 1.0)), 0.0)
    assert b[k, j, i] == 0.0 and got[k, j, i] == 0.0
    assert digits(got.numpy(), want) >= 15
