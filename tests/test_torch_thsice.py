"""PyTorch port: Winton's thermodynamic sea ice (model/thsice.py, kernel
TH's twin) against the JAX package's mitgcm_tpu/model/thsice.py, function
by function, in float64 on the CPU, JAX evaluated op by op
(jax.disable_jit).

The inputs are utils/synthetic.py:thsice_inputs's seeded fields on the
64x64 thsice-gyre grid (numpy.random.default_rng(0)), under
thsice_readparms.F's defaults and the two settings of THSICE_VARIANTS
(a daily step, two surface iterations), which together take every branch
of solve4temp, calc_thickn and extend: the test asserts that each was
taken. Tolerance: 12 matching digits (max|a-b| / max|b| over the padded
array) on every output of albedo, get_exf, solve4temp, calc_thickn,
extend, step, init_state and monitor. Measured: solve4temp 14.25 digits
or more, the whole step 15.03, albedo 15.88, get_exf 15.41, calc_thickn
15.78, monitor 15.33; extend and init_state equal.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import thsice as jthsice
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.model import thsice
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config

torch.set_num_threads(1)

N = 64
DIGITS = 12.0
VARIANTS = list(tsyn.THSICE_VARIANTS)


@pytest.fixture(scope="module")
def case():
    # half the basin south of y = 0, so that the monitor's two latitude
    # bands both hold ice
    cfg = tsyn.thsice_gyre_config(nx=N, ny=N, nr=4, depth=300.0,
                                  ygOrigin=-0.5 * N * 20.0e3)
    grid = tsyn.gyre_grid(cfg, dtype=torch.float64, device="cpu")
    jcfg = jax_config(cfg)
    jgrid = jsyn.gyre_setup(jcfg, dtype=jnp.float64)[0]
    return cfg, grid, jcfg, jgrid, tsyn.thsice_inputs(cfg, grid, seed=0)


def pair(case, variant=""):
    """The port's ThSIce and the JAX package's of the same parameters."""
    cfg, grid, jcfg, jgrid, _ = case
    p = dataclasses.replace(thsice.params_from_namelists(cfg, {}, {}),
                            **tsyn.THSICE_VARIANTS[variant])
    return (thsice.ThSIce(cfg, grid, p),
            jthsice.ThSIce(jcfg, jgrid,
                           jthsice.ThsiceParams(**dataclasses.asdict(p))))


def J(t):
    return jnp.asarray(t.numpy())


def jforc(forc):
    return types.SimpleNamespace(**{k: J(getattr(forc, k))
                                    for k in thsice.TH_FORCING})


def hold(got, want, what):
    """Every output to DIGITS; returns the fewest digits."""
    worst = 16.0
    for k, (g, w) in enumerate(zip(got, want)):
        d = digits(g.numpy(), np.asarray(w))
        assert d >= DIGITS, (what, k, d)
        worst = min(worst, d)
    return worst


def stage_inputs(case, ts):
    """The inputs of solve4temp, calc_thickn and extend as the step forms
    them, from the port's twin (tensors): a dict by stage."""
    _, _, _, _, args = case
    th, forc, theta, salt = args[:4]
    p = ts.p
    on = th["thIceMask"] > 0.0
    alb = ts.albedo(th["thIceMask"], th["thIceH"], th["thSnowH"],
                    th["thTsrf"], th["thSnowAge"])
    flxSW = torch.where(on, forc.swdown * (1.0 - alb), forc.swdown)
    tFrzOce = torch.where(on, -p.mu_Tf * salt, torch.zeros_like(salt))
    s4t = (th["thIceMask"], th["thIceH"], th["thSnowH"], tFrzOce, flxSW,
           th["thTsrf"], th["thQice1"], th["thQice2"])
    (sw, tSrf, q1, q2, tIc1, tIc2, sHeat, flxCnB, _flxAtm,
     evpAtm) = ts.solve4temp(forc, *s4t)
    tFrz = -p.mu_Tf * salt
    hOce = ts.grid.drF[0] * args[6]
    fz = (tFrz - theta) * (p.cpWater * p.rhosw * hOce) / p.ocean_deltaT
    v2 = 0.5 * (args[4] ** 2 + args[5] ** 2)
    snowP = torch.where(on & (forc.atemp <= ts.cfg.celsius2K),
                        forc.precip * 1000.0, torch.zeros_like(salt))
    ct = (th["thIceMask"], tFrz, theta, v2, snowP,
          (forc.precip + forc.runoff) * 1000.0, sHeat, flxCnB,
          th["thIceMask"], th["thIceH"], th["thSnowH"], tSrf, q1, q2,
          evpAtm, fz, sw)
    out = ts.calc_thickn(*ct)
    ex = (out[7], tFrz, theta, out[0], out[1], out[2], out[3], tIc1, tIc2,
          out[4], out[5])
    return {"solve4temp": s4t, "calc_thickn": ct, "extend": ex}


def test_params_match_and_refusals(case):
    cfg, _, jcfg, _, _ = case
    const = {"RHOS": 300.0, "hiMax": 8.0, "nitMaxTsf": 10,
             "fracEnFreez": 0.2}
    parm01 = {"thSIce_deltaT": 600.0, "stressReduction": 0.5}
    p = thsice.params_from_namelists(cfg, const, parm01)
    jp = jthsice.params_from_namelists(jcfg, const, parm01)
    assert p == convert.thsice_params(jp)
    assert p.hNewIceMax == 8.0 and p.thSIce_dtTemp == 600.0
    with pytest.raises(NotImplementedError, match="data.ice key"):
        thsice.params_from_namelists(cfg, {"bogus": 1.0}, {})
    for key, value in (("thSIceAdvScheme", 77), ("thSIce_calc_albNIR", True),
                       ("thSIce_skipThermo", True),
                       ("thSIceBalanceAtmFW", 1)):
        bad = dataclasses.replace(p, **{key: value})
        with pytest.raises(NotImplementedError):
            thsice.ThSIce(cfg, case[1], bad)


def test_init_state(case):
    """init_state from arrays against JAX's from files of the same
    arrays, the enthalpies of new ice at -1.70 degC."""
    ts, jts = pair(case)
    th = case[4][0]
    got = ts.init_state(iceMask=th["thIceMask"], iceH=th["thIceH"],
                        snowH=th["thSnowH"], snowA=th["thSnowAge"],
                        tsrf=th["thTsrf"])
    files = {"m": th["thIceMask"], "h": th["thIceH"], "s": th["thSnowH"],
             "a": th["thSnowAge"], "t": th["thTsrf"]}
    jts.p = dataclasses.replace(jts.p, fract_file="m", thick_file="h",
                                snowh_file="s", snowa_file="a",
                                tsurf_file="t")
    want = jts.init_state(lambda f: J(files[f]), dtype=jnp.float64)
    hold([got[k] for k in thsice.TH_FIELDS],
         [want[k] for k in thsice.TH_FIELDS], "init_state")


def test_albedo_and_get_exf(case):
    ts, jts = pair(case)
    th, forc = case[4][:2]
    a = (th["thIceMask"], th["thIceH"], th["thSnowH"], th["thTsrf"],
         th["thSnowAge"])
    with jax.disable_jit():
        want = jts.albedo(*[J(t) for t in a])
        icFlag = torch.where(th["thIceMask"] > 0.0, 1.0, 0.0).double()
        jw = jts.get_exf(jforc(forc), J(icFlag), J(th["thSnowH"]),
                         J(th["thTsrf"]))
    hold([ts.albedo(*a)], [want], "albedo")
    hold(ts.get_exf(forc, icFlag, th["thSnowH"], th["thTsrf"]), jw,
         "get_exf")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("stage", ["solve4temp", "calc_thickn", "extend"])
def test_stage(case, variant, stage):
    """solve4temp, calc_thickn and extend on the inputs the step gives
    them."""
    ts, jts = pair(case, variant)
    ins = stage_inputs(case, ts)[stage]
    forc = case[4][1]
    fn, jfn = getattr(ts, stage), getattr(jts, stage)
    lead, jlead = ((forc,), (jforc(forc),)) if stage == "solve4temp" \
        else ((), ())
    with jax.disable_jit():
        want = jfn(*jlead, *[J(t) for t in ins])
    hold(fn(*lead, *ins), want, (stage, variant))


@pytest.mark.parametrize("variant", VARIANTS)
def test_step(case, variant):
    """The whole step: the nine th* fields and the four ocean fluxes on
    every padded cell."""
    ts, jts = pair(case, variant)
    args = case[4]
    th, forc = args[:2]
    with jax.disable_jit():
        jth, jupd = jts.step({k: J(v) for k, v in th.items()}, jforc(forc),
                             *[J(t) for t in args[2:]])
    got_th, got_upd = ts.step(*args)
    hold([got_th[k] for k in thsice.TH_FIELDS] +
         [got_upd[k] for k in thsice.TH_FLUXES],
         [jth[k] for k in thsice.TH_FIELDS] +
         [jupd[k] for k in thsice.TH_FLUXES], ("step", variant))


def test_every_branch_taken(case):
    """Each branch of thsice.BRANCHES is taken by some interior cell under
    some variant; under the defaults every ice cell leaves the Terrmax
    loop before its last iteration, some after one iteration and some
    after more, and with nitMaxTsf = 2 some run both iterations."""
    ol = case[0].olx
    taken = dict.fromkeys(thsice.BRANCHES, 0)
    iterations = {}
    for variant in VARIANTS:
        ts, _ = pair(case, variant)
        br = {}
        ts.step(*case[4], branches=br)
        for name in thsice.BRANCHES:
            taken[name] += int(br[name][ol:-ol, ol:-ol].sum())
        iterations[variant] = br["iterations"][ol:-ol, ol:-ol]
    assert all(n > 0 for n in taken.values()), taken
    on = case[4][0]["thIceMask"][ol:-ol, ol:-ol] > 0.0
    it = iterations[""][on]
    assert int(it.min()) == 1 and 1 < int(it.max()) < 20
    assert int(iterations["nitMaxTsf=2"][on].max()) == 2


def test_monitor(case):
    """The thSI_* statistics of a stepped state, with ice in both latitude
    bands."""
    ts, jts = pair(case)
    th, _ = ts.step(*case[4])
    got = ts.monitor(th)
    with jax.disable_jit():
        want = jts.monitor({k: J(v) for k, v in th.items()})
    assert set(got) == set(want)
    assert float(got["thSI_Ice_Area_S"]) > 0.0
    assert float(got["thSI_Ice_Area_N"]) > 0.0
    hold([got[k] for k in want], [want[k] for k in want], "monitor")


def test_advance_runs_the_twin_on_the_cpu(case):
    """advance takes the twin for CPU tensors (counting the call) and with
    impl="plain", refuses another impl and an input that requires grad."""
    ts, _ = pair(case)
    args = case[4]
    n0 = thsice.plain_calls
    th, upd = ts.advance(*args)
    th2, upd2 = ts.advance(*args, impl="plain")
    want_th, want_upd = ts.step(*args)
    assert thsice.plain_calls == n0 + 2
    for k in thsice.TH_FIELDS:
        assert torch.equal(th[k], want_th[k]) and torch.equal(th2[k],
                                                              want_th[k])
    for k in thsice.TH_FLUXES:
        assert torch.equal(upd[k], want_upd[k])
    with pytest.raises(ValueError, match="impl"):
        ts.advance(*args, impl="fast")
    grad = dict(args[0], thIceH=args[0]["thIceH"].clone().requires_grad_())
    with pytest.raises(ValueError, match="require grad"):
        ts.advance(grad, *args[1:])
