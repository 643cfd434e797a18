"""PyTorch port: each function of the sea-ice step (model/seaice.py, the
twins of kernels seaice_lsr_prep, seaice_lsr_tridiag, seaice_advect and
seaice_thermo) against the JAX package's SeaIce methods on the same seeded
inputs, float64 on the CPU, on the 16x16 ice-gyre grid with its 2 x 2
tiles, on whole padded arrays:
  - one Picard pass's assembly (strainrates, viscosities, oceandrag, the
    FORCEX/Y terms, _lsr_rhs_u/_v, _lsr_coeffs and the land closure,
    seaice.py:912-972), with and without a water turning angle and the
    scaled surface stress: 13 digits;
  - one _lsr_iterate with the 2 x 2 tiles (JAX op by op: its compiled
    scan rounds an ulp away), equal ICOUNT1/ICOUNT2: 12 digits;
  - advdiff with each ice advection scheme the port carries, and with
    harmonic diffusion: 13 digits;
  - reg_ridge, solve4temp and growth with 7 categories, over cells that
    freeze, melt, sublimate, flood and clip: 12 digits.
The twins replay JAX's operation order, so most fields agree bit for bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import seaice as jseaice
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.model import seaice as tseaice
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config

torch.set_num_threads(1)

PREP_OUT = ("AU", "BU", "CU", "AV", "BV", "CV", "uRt1", "uRt2", "vRt1",
            "vRt2", "rhsU", "rhsV", "dwatn")


def make(**nml):
    """(port SeaIce, JAX SeaIce, seeded field factory) on the 16x16x12
    ice-gyre grid, with the ice-gyre's settings and `nml` on top."""
    cfg = tsyn.ice_gyre_config(nx=16, ny=16, nr=12, depth=300.0)
    settings = {**tsyn.ICE_GYRE_SEAICE, **nml}
    cfg.seaice = tseaice.params_from_namelists(cfg, settings)
    grid = tsyn.gyre_grid(cfg, dtype=torch.float64, device="cpu")
    jcfg = jax_config(cfg)
    jcfg.seaice = jseaice.params_from_namelists(jcfg, settings, {})
    jgrid = jsyn.gyre_setup(jcfg, dtype=jnp.float64)[0]
    ts = tseaice.SeaIce(cfg, grid, cfg.seaice)
    js = jseaice.SeaIce(jcfg, jgrid, jcfg.seaice)
    rng = np.random.default_rng(7)
    shape = tuple(grid.rA.shape)

    def field(lo, hi, mask=None):
        a = rng.uniform(lo, hi, shape)
        if mask is not None:
            a = a * mask.numpy()
        return a

    return ts, js, field


def both(a):
    """The same numpy field as a port tensor and a JAX array."""
    return torch.as_tensor(a), jnp.asarray(a)


def check(got, want, bar, name=""):
    d = digits(got.numpy(), np.asarray(want))
    assert d >= bar, (name, d)


@pytest.mark.parametrize("nml", [{}, {"SEAICE_waterTurnAngle": 25.0,
                                      "SEAICEscaleSurfStress": False}])
def test_lsr_prep(nml):
    ts, js, field = make(**nml)
    mU, mV = ts.seaiceMaskU, ts.seaiceMaskV
    ins = {"uIce": field(-0.2, 0.2, mU), "vIce": field(-0.2, 0.2, mV),
           "uVel0": field(-0.3, 0.3), "vVel0": field(-0.3, 0.3),
           "press0": field(0.0, 4e4, ts.HEFFM), "fxTmp": field(-1, 1),
           "fyTmp": field(-1, 1), "areaW": field(0, 1), "areaS": field(0, 1),
           "massC": field(0, 3e3), "massU": field(0, 3e3),
           "massV": field(0, 3e3)}
    ins["uIceC"] = 0.5 * (ins["uIce"] + field(-0.2, 0.2, mU))
    ins["vIceC"] = 0.5 * (ins["vIce"] + field(-0.2, 0.2, mV))
    ins["zMax"] = ts.p.zetaMaxFac * ins["press0"]
    t = {k: both(v)[0] for k, v in ins.items()}
    j = {k: both(v)[1] for k, v in ins.items()}
    got = ts.lsr_prep(**t)
    # the JAX package's pass (seaice.py:912-972), step by step
    p, g = js.p, js.grid
    import math
    sinwat = math.sin(math.radians(p.waterTurnAngle))
    coswat = math.cos(math.radians(p.waterTurnAngle))
    sh = jseaice.sh
    with jax.disable_jit():
        e11, e22, e12 = js.strainrates(j["uIceC"], j["vIceC"])
        eta, etaZ, zeta, zetaZ, press, _ = js.viscosities(
            e11, e22, e12, j["press0"], j["zMax"],
            jnp.full_like(j["press0"], p.zetaMin))
        dwatn = js.oceandrag(j["uIceC"], j["vIceC"], j["uVel0"], j["vVel0"])
        epz, zme = eta + zeta, zeta - eta
        sgn = jnp.sign(g.fCori)
        sgn = jnp.where(sgn == 0.0, 1.0, sgn)
        uC, vC, u0, v0 = j["uIceC"], j["vIceC"], j["uVel0"], j["vVel0"]
        dvC = v0 - vC
        frcU = (j["fxTmp"] + (0.5 * (dwatn + sh(dwatn, di=-1)) * coswat * u0
                - sgn * sinwat * 0.5 * (dwatn * 0.5 * (dvC + sh(dvC, dj=1))
                + sh(dwatn, di=-1) * 0.5 * (sh(dvC, di=-1)
                + sh(sh(dvC, dj=1), di=-1)))) * j["areaW"])
        duC = u0 - uC
        frcV = (j["fyTmp"] + (0.5 * (dwatn + sh(dwatn, dj=-1)) * coswat * v0
                + sgn * sinwat * 0.5 * (dwatn * 0.5 * (duC + sh(duC, di=1))
                + sh(dwatn, dj=-1) * 0.5 * (sh(duC, dj=-1)
                + sh(sh(duC, di=1), dj=-1)))) * j["areaS"])
        vCc = 0.5 * (vC + sh(vC, dj=1))
        frcU = frcU + 0.5 * (j["massC"] * g.fCori * vCc
                             + sh(j["massC"] * g.fCori * vCc, di=-1))
        uCc = 0.5 * (uC + sh(uC, di=1))
        frcV = frcV - 0.5 * (j["massC"] * g.fCori * uCc
                             + sh(j["massC"] * g.fCori * uCc, dj=-1))
        rhsU = frcU * js.seaiceMaskU + js._lsr_rhs_u(
            zme, epz, etaZ, zetaZ, press, uC, vC)
        rhsV = frcV * js.seaiceMaskV + js._lsr_rhs_v(
            zme, epz, etaZ, zetaZ, press, uC, vC)
        co = dict(zip(PREP_OUT[:10], js._lsr_coeffs(
            epz, zme, etaZ, zetaZ, dwatn * coswat, j["massU"], j["massV"],
            j["areaW"], j["areaS"])))
        mIn = g.maskInC
        badU = mIn * sh(mIn, di=-1) == 0.0
        badV = mIn * sh(mIn, dj=-1) == 0.0
        for k in ("AU", "CU", "uRt1", "uRt2"):
            co[k] = jnp.where(badU, 0.0, co[k])
        for k in ("AV", "CV", "vRt1", "vRt2"):
            co[k] = jnp.where(badV, 0.0, co[k])
        co["BU"] = jnp.where(badU, 1.0, co["BU"])
        co["BV"] = jnp.where(badV, 1.0, co["BV"])
        co["rhsU"] = jnp.where(badU, j["uIce"], rhsU)
        co["rhsV"] = jnp.where(badV, j["vIce"], rhsV)
        if p.scaleSurfStress:
            co["BU"] = jnp.where(co["BU"] == 0.0, 1.0, co["BU"])
            co["BV"] = jnp.where(co["BV"] == 0.0, 1.0, co["BV"])
        co["dwatn"] = dwatn
    for k in PREP_OUT:
        check(got[k], co[k], 13, k)
    assert float(np.abs(np.asarray(co["rhsU"])).max()) > 0.0


def test_lsr_iterate():
    """One linear loop on a pass's coefficients: the zebra half-sweeps per
    tile, the relaxation freeze and the stops, equal ICOUNT1/ICOUNT2."""
    ts, js, field = make()
    mU, mV = ts.seaiceMaskU, ts.seaiceMaskV
    ins = {"uIce": field(-0.2, 0.2, mU), "vIce": field(-0.2, 0.2, mV),
           "uVel0": field(-0.3, 0.3), "vVel0": field(-0.3, 0.3),
           "press0": field(0.0, 4e4, ts.HEFFM), "fxTmp": field(-1, 1),
           "fyTmp": field(-1, 1), "areaW": field(0.5, 1),
           "areaS": field(0.5, 1), "massC": field(1e3, 3e3),
           "massU": field(1e3, 3e3), "massV": field(1e3, 3e3)}
    ins["uIceC"], ins["vIceC"] = ins["uIce"], ins["vIce"]
    ins["zMax"] = ts.p.zetaMaxFac * ins["press0"]
    t = {k: torch.as_tensor(v) for k, v in ins.items()}
    c = ts.lsr_prep(**t)
    u0 = ts.fill(t["uIce"])
    v0 = ts.fill(t["vIce"])
    u, v, icount, syncs = ts.lsr_iterate(c, u0, v0)
    jc = [jnp.asarray(c[k].numpy()) for k in PREP_OUT[:12]]
    with jax.disable_jit():
        ju, jv = js._lsr_iterate(*jc, jnp.asarray(u0.numpy()),
                                 jnp.asarray(v0.numpy()))
    assert icount == (int(js._lsr_diag[0]), int(js._lsr_diag[1]))
    assert syncs == max(icount)
    assert max(icount) > 2
    check(u, ju, 12, "u")
    check(v, jv, 12, "v")


@pytest.mark.parametrize("nml", [
    {"SEAICEadvScheme": s} for s in tseaice.ADV_SCHEMES] + [
    {"SEAICEdiffKhHeff": 300.0, "SEAICEdiffKhArea": 200.0,
     "SEAICEdiffKhSnow": 100.0}])
def test_advdiff(nml):
    ts, js, field = make(**nml)
    hm = ts.HEFFM
    ins = {"uIce": ts.fill(torch.as_tensor(field(-0.3, 0.3, ts.seaiceMaskU))),
           "vIce": ts.fill(torch.as_tensor(field(-0.3, 0.3, ts.seaiceMaskV))),
           "AREA": torch.as_tensor(field(0.0, 1.0, hm)),
           "HEFF": torch.as_tensor(field(0.0, 3.0, hm)),
           "HSNOW": torch.as_tensor(field(0.0, 0.5, hm))}
    tice = ts.init_state(torch.float64)._replace(**ins)
    got = ts.advdiff(tice)
    jice = jseaice.IceState(**{k: jnp.asarray(np.asarray(v)) for k, v in
                               tice._asdict().items()})
    with jax.disable_jit():
        want = js.advdiff(jice)
    for k in ("HEFF", "AREA", "HSNOW"):
        check(getattr(got, k), getattr(want, k), 13, k)


def thermo_inputs(ts, field):
    """Seeded ice, ocean and atmosphere over the wet cells: thick, thin,
    negative and absent ice and snow; water above and below freezing."""
    hm = ts.HEFFM.numpy()
    heff = field(-0.2, 3.0, ts.HEFFM)
    heff[::3, ::2] = 0.0
    heff[1::4, ::3] = 5e-6
    hsnow = field(-0.05, 0.4, ts.HEFFM)
    hsnow[::2, 1::3] = 0.0
    ice = {"HEFF": heff, "HSNOW": hsnow, "AREA": field(-0.1, 1.1, ts.HEFFM),
           "TICES": np.stack([field(240.0, 274.0)
                              for _ in range(ts.p.multDim)])}
    forc = {"atemp": field(240.0, 275.0), "aqh": field(1e-4, 3e-3),
            "precip": field(0.0, 1e-7), "swdown": field(0.0, 300.0),
            "lwdown": field(150.0, 320.0), "runoff": field(0.0, 1e-8),
            "wspeed": field(0.0, 12.0), "evap": field(-1e-8, 1e-8),
            "Qnet": field(-200.0, 300.0) * hm,
            "Qsw": field(-200.0, 0.0) * hm, "EmPmR": field(-1e-5, 1e-5),
            "saltFlux": field(-1e-3, 1e-3)}
    ocean = {"theta0": field(-2.2, 1.0), "salt0": field(30.0, 35.0)}
    return ice, forc, ocean


def jax_ice(ts, ice):
    z = np.zeros_like(ice["HEFF"])
    full = {"uIce": z, "vIce": z, "HSALT": z,
            "SItracer": np.zeros((0,) + z.shape),
            "sigma": np.zeros((0,) + z.shape), **ice}
    return (tseaice.IceState(**{k: torch.as_tensor(v)
                                for k, v in full.items()}),
            jseaice.IceState(**{k: jnp.asarray(v) for k, v in full.items()}))


def test_reg_ridge():
    ts, js, field = make()
    ice, _, _ = thermo_inputs(ts, field)
    tice, jice = jax_ice(ts, ice)
    got = ts.reg_ridge(tice)
    with jax.disable_jit():
        want = js.reg_ridge(jice)
    for k in ("HEFF", "HSNOW", "AREA", "TICES"):
        check(getattr(got[0], k), getattr(want[0], k), 16, k)
    check(got[1], want[1], 16, "dHn")
    check(got[2], want[2], 16, "dSn")


def test_solve4temp():
    ts, js, field = make()
    ice, forc, ocean = thermo_inputs(ts, field)
    tf = types.SimpleNamespace(**{k: torch.as_tensor(v)
                                  for k, v in forc.items()})
    jf = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in forc.items()})
    UG = np.maximum(ts.p.EPS, forc["wspeed"])
    hice = np.maximum(ice["HEFF"], 0.0)
    hsnow = np.maximum(ice["HSNOW"], 0.0)
    got = ts.solve4temp(torch.as_tensor(UG), torch.as_tensor(hice),
                        torch.as_tensor(hsnow),
                        torch.as_tensor(ice["TICES"][0]), tf,
                        torch.as_tensor(ocean["salt0"]))
    with jax.disable_jit():
        want = js.solve4temp(jnp.asarray(UG), jnp.asarray(hice),
                             jnp.asarray(hsnow),
                             jnp.asarray(ice["TICES"][0]), jf,
                             jnp.asarray(ocean["salt0"]))
    for name, a, b in zip(("tsurf", "F_ia", "IcePenetSW", "FWsublim"), got,
                          want):
        check(a, b, 13, name)


def test_growth():
    """reg_ridge then growth with 7 categories: the ice, TICES and the
    ocean's Qnet, Qsw, EmPmR and saltFlux."""
    ts, js, field = make()
    assert ts.p.multDim == 7
    ice, forc, ocean = thermo_inputs(ts, field)
    tice, jice = jax_ice(ts, ice)
    tf = types.SimpleNamespace(**{k: torch.as_tensor(v)
                                  for k, v in forc.items()})
    jf = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in forc.items()})
    tocean = {k: torch.as_tensor(v) for k, v in ocean.items()}
    got_ice, got_f = ts.thermo(tice, tf, **tocean)
    with jax.disable_jit():
        jr, dHn, dSn = js.reg_ridge(jice)
        want_ice, want_f, _, _ = js.growth(
            jr, jf, jnp.asarray(ocean["theta0"]), jnp.asarray(ocean["salt0"]),
            dHn, dSn)
    for k in ("HEFF", "HSNOW", "AREA", "TICES"):
        check(getattr(got_ice, k), getattr(want_ice, k), 12, k)
    for k in ("Qnet", "Qsw", "EmPmR", "saltFlux"):
        check(got_f[k], want_f[k], 12, k)
    heff = got_ice.HEFF.numpy()
    assert (heff > np.maximum(ice["HEFF"], 0.0)).any()
    assert (heff < np.maximum(ice["HEFF"], 0.0) - 1e-3).any()
