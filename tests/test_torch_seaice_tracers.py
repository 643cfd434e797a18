"""PyTorch port: the sea-ice twins of this slice against the JAX package's
SeaIce methods on the same seeded inputs, float64 on the CPU, on the 16x16
ice-gyre grid with its 2 x 2 tiles, on whole padded arrays, 12 digits or
more (tests/test_torch_seaice.py's helpers):
  - advdiff's tracer branch (the twin of seaice_advect's tracer variant)
    with an 'age' on HEFF and a 'one' on AREA, under each multi-dimensional
    scheme the port carries and with harmonic diffusion, over cells where
    the mates fall below siEps and area_floor and where ADVCAP clips;
  - tracer_phys after reg_ridge and growth (the twin of seaice_thermo's
    tracer variant), with growth's stages, over cells that grow, melt,
    flood and expand, with sources of 0, of 1 ('one') and others;
  - the legacy advection (_advect_legacy, the twin of kernel LA) with and
    without DIFF1, with and without diffKh, and diffus.F's _diffus.
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
from test_torch_config import jax_config
from test_torch_seaice import check, thermo_inputs

torch.set_num_threads(1)

TRACERS = {"sitrnuminuse": 3, "sitrname(1)": "age", "sitrmate(1)": "HEFF",
           "sitrname(2)": "one", "sitrmate(2)": "AREA",
           "sitrname(3)": "salinity", "sitrmate(3)": "HEFF",
           "sitrfromocean0(3)": 4.0, "sitrfromflood0(3)": 30.0,
           "sitrexpand0(3)": 2.0}


def make(nml01, nml03):
    cfg = tsyn.ice_gyre_config(nx=16, ny=16, nr=12, depth=300.0)
    settings = {**tsyn.ICE_GYRE_SEAICE, **nml01}
    cfg.seaice = tseaice.params_from_namelists(cfg, settings, nml03)
    grid = tsyn.gyre_grid(cfg, dtype=torch.float64, device="cpu")
    jcfg = jax_config(cfg)
    jcfg.seaice = jseaice.params_from_namelists(jcfg, settings, nml03)
    jgrid = jsyn.gyre_setup(jcfg, dtype=jnp.float64)[0]
    ts = tseaice.SeaIce(cfg, grid, cfg.seaice)
    js = jseaice.SeaIce(jcfg, jgrid, jcfg.seaice)
    rng = np.random.default_rng(17)
    shape = tuple(grid.rA.shape)

    def field(lo, hi, mask=None):
        a = rng.uniform(lo, hi, shape)
        return a * mask.numpy() if mask is not None else a

    return ts, js, field


def moving_ice(ts, field, ntr):
    """Seeded moving ice whose HEFF and AREA fall below siEps and
    area_floor on some cells, and tracers of a wide spread (so that ADVCAP
    clips and the negativity fix acts)."""
    hm = ts.HEFFM
    heff = field(0.0, 3.0, hm)
    heff[::3, ::4] = 3e-6
    area = field(0.0, 1.0, hm)
    area[1::4, ::3] = 2e-6
    tr = np.stack([field(-1.0, 5.0) for _ in range(ntr)]
                  or [field(0.0, 0.0)])[:ntr]
    return {"uIce": ts.fill(torch.as_tensor(field(-0.3, 0.3,
                                                  ts.seaiceMaskU))),
            "vIce": ts.fill(torch.as_tensor(field(-0.3, 0.3,
                                                  ts.seaiceMaskV))),
            "AREA": torch.as_tensor(area), "HEFF": torch.as_tensor(heff),
            "HSNOW": torch.as_tensor(field(0.0, 0.5, hm)),
            "SItracer": torch.as_tensor(tr)}


def to_jax(tice):
    return jseaice.IceState(**{k: jnp.asarray(np.asarray(v))
                               for k, v in tice._asdict().items()})


@pytest.mark.parametrize("nml", [
    {"SEAICEadvScheme": s} for s in tseaice.ADV_SCHEMES] + [
    {"SEAICEdiffKhHeff": 300.0, "SEAICEdiffKhArea": 200.0,
     "SEAICEdiffKhSnow": 100.0}])
def test_advdiff_tracers(nml):
    ts, js, field = make(nml, TRACERS)
    tice = ts.init_state(torch.float64)._replace(
        **moving_ice(ts, field, 3))
    got = ts.advdiff(tice)
    with jax.disable_jit():
        want = js.advdiff(to_jax(tice))
    for k in ("HEFF", "AREA", "HSNOW", "SItracer"):
        check(getattr(got, k), getattr(want, k), 13, k)
    # the cap and the fix acted, and low mates gave 0
    prev, tr = tice.SItracer.numpy(), got.SItracer.numpy()
    assert (tr[:, 2:-2, 2:-2] < prev[:, 2:-2, 2:-2]).any()
    low = got.HEFF.numpy()[2:-2, 2:-2] < tseaice.SI_EPS
    assert (tr[0][2:-2, 2:-2][low] == 0.0).any()


def test_tracer_phys():
    """reg_ridge, growth and tracer_phys (SeaIce.thermo's twin) against
    JAX's reg_ridge, growth and tracer_phys with its stages."""
    ts, js, field = make({}, TRACERS)
    ice, forc, ocean = thermo_inputs(ts, field)
    ice["SItracer"] = np.stack([field(0.0, 1e5), field(0.5, 1.5),
                                field(0.0, 40.0)])
    z = np.zeros_like(ice["HEFF"])
    full = {"uIce": z, "vIce": z, "HSALT": z,
            "sigma": np.zeros((0,) + z.shape), **ice}
    tice = tseaice.IceState(**{k: torch.as_tensor(v)
                               for k, v in full.items()})
    jice = jseaice.IceState(**{k: jnp.asarray(v) for k, v in full.items()})
    tf = types.SimpleNamespace(**{k: torch.as_tensor(v)
                                  for k, v in forc.items()})
    jf = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in forc.items()})
    got, got_f = ts.thermo(tice, tf, **{k: torch.as_tensor(v)
                                        for k, v in ocean.items()})
    with jax.disable_jit():
        jr, dHn, dSn = js.reg_ridge(jice)
        want, want_f, sh_, sa_ = js.growth(
            jr, jf, jnp.asarray(ocean["theta0"]),
            jnp.asarray(ocean["salt0"]), dHn, dSn)
        want = js.tracer_phys(want, sh_, sa_)
    for k in ("HEFF", "HSNOW", "AREA", "TICES", "SItracer"):
        check(getattr(got, k), getattr(want, k), 12, k)
    for k in ("Qnet", "Qsw", "EmPmR", "saltFlux"):
        check(got_f[k], want_f[k], 12, k)
    # every stage moved some tracer, and the age was reset under no ice
    moved = got.SItracer.numpy() != ice["SItracer"]
    assert moved[0].any() and moved[1].any() and moved[2].any()
    assert (got.SItracer.numpy()[0][2:-2, 2:-2][
        got.HEFF.numpy()[2:-2, 2:-2] <= 0.0] == 0.0).all()


@pytest.mark.parametrize("nml", [
    {"SEAICEadvScheme": 2, "DIFF1": 4.0e-3},
    {"SEAICEadvScheme": 3},
    {"SEAICEadvScheme": 4, "DIFF1": 2.0e-3, "SEAICEdiffKhHeff": 300.0,
     "SEAICEdiffKhArea": 200.0},
    {"SEAICEadvScheme": 2, "DIFF1": 4.0e-3, "SEAICEdiffKhSnow": 50.0}],
    ids=["DIFF1", "scheme3-no-DIFF1", "scheme4-DIFF1-diffKh",
         "DIFF1-diffKhSnow"])
def test_advdiff_legacy(nml):
    ts, js, field = make(nml, {})
    ins = moving_ice(ts, field, 0)
    ins.pop("SItracer")
    tice = ts.init_state(torch.float64)._replace(**ins)
    got = ts.advdiff(tice)
    with jax.disable_jit():
        want = js.advdiff(to_jax(tice))
    for k in ("HEFF", "AREA", "HSNOW"):
        check(getattr(got, k), getattr(want, k), 12, k)
        assert not torch.equal(getattr(got, k), getattr(tice, k))


def test_diffus():
    ts, js, field = make({"SEAICEadvScheme": 2, "DIFF1": 4.0e-3}, {})
    fld = field(-1.0, 1.0)
    for coef in (ts.DIFFA, -ts.DIFFA * ts.DIFFA):
        got = ts._diffus(torch.as_tensor(fld), coef, ts.HEFFM)
        with jax.disable_jit():
            want = js._diffus(jnp.asarray(fld), jnp.asarray(coef.numpy()),
                              jnp.asarray(ts.HEFFM.numpy()))
        check(got, want, 12, "diffus")
