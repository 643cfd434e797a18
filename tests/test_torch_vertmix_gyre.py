"""PyTorch port: the pp81-, my82- and opps-gyre (the kpp-gyre with PP81's
or MY82's Richardson-number mixing or OPPS plume convection in place of
KPP) against the JAX package, 10 steps at 16x16x12 (depth 300 m) in
float64 on the CPU.

The JAX runs are jitted, as the flux-form gyre with KPP of
tests/test_torch_kpp_gyre.py is: op by op (jax.disable_jit), JAX's OPPS
alone, its loops over launches, levels and sub-steps unrolled into single
operations, takes minutes for 10 steps. Every monitor statistic agrees to
10 digits on every step and the cg2d iteration counts are equal;
cg2d_init_res to 9 digits and cg2d_last_res to 12 against the solve's
first residual. PP81 and MY82 mix well above the background in the
cooled north after 10 steps. OPPS launches plumes in the cooled north and
none in the heated south from the second step on; a 2+2 restart through
the pickups is bit-equal to 4 straight steps on each path; and the
pairings that the port refuses are refused by name.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import opps as jopps
from mitgcm_tpu.model import vertmix as jvm
from mitgcm_tpu.model.experiment import Experiment as JaxExperiment
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.model import step as tstep
from mitgcm_tpu_torch.model.experiment import (Experiment, read_pickup,
                                               write_pickup)
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits
from test_torch_config import jax_config

torch.set_num_threads(1)

N_STEPS = 10
SIZE = dict(nx=16, ny=16, nr=12, depth=300.0)
PATHS = ("pp81", "my82", "opps")
FIELDS = ("uVel", "vVel", "wVel", "theta", "salt", "etaN", "guNm1", "gvNm1",
          "gtNm1", "gsNm1", "guNm2", "gvNm2", "gtNm2", "gsNm2", "PmEpR")


def port_experiment(kind):
    cfg = getattr(tsyn, f"{kind}_gyre_config")(**SIZE)
    if kind == "opps":
        grid, state, forcing, op, obj = tsyn.opps_gyre_setup(
            cfg, dtype=torch.float64, device="cpu")
        return Experiment(cfg, grid, state, forcing, op, opps=obj)
    grid, state, forcing, op, obj = tsyn.vertmix_gyre_setup(
        cfg, dtype=torch.float64, device="cpu")
    return Experiment(cfg, grid, state, forcing, op, vmix=obj)


def jax_experiment(exp):
    """The JAX package's experiment of the port's: the same configuration,
    heat fluxes and package parameters."""
    jcfg = jax_config(exp.cfg)
    grid, state, forcing, op = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    forcing = dataclasses.replace(
        forcing, Qnet=jnp.asarray(exp.forcing.Qnet.numpy()),
        Qsw=jnp.asarray(exp.forcing.Qsw.numpy()))
    kw = {}
    if exp.opps is not None:
        kw["opps"] = jopps.OPPS(jcfg, grid, {})
    else:
        kw["vmix"] = getattr(jvm, exp.vmix.scheme)(jcfg, grid, {})
    return JaxExperiment(cfg=jcfg, grid=grid, state=state, forcing=forcing,
                         op=op, **kw)


@pytest.fixture(scope="module", params=PATHS)
def run(request):
    exp = port_experiment(request.param)
    jexp = jax_experiment(exp)
    want = jexp.run(n_steps=N_STEPS)
    return request.param, exp, exp.run(n_steps=N_STEPS), jexp, want


def test_ten_steps(run):
    kind, exp, got, jexp, want = run
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for rec, ref in zip(got, want):
        assert rec.get("cg2d_iters") == ref.get("cg2d_iters"), rec["iter"]
        dig = record_digits(rec, ref)
        missing = {k for k in ref if k.startswith("dynstat_")} - set(dig)
        assert not missing, missing
        for key, d in dig.items():
            if key == "cg2d_init_res":
                assert d >= 9, (kind, rec["iter"], key, d)
            elif key == "cg2d_last_res":
                err = abs(rec[key] - ref[key]) / ref["cg2d_init_res"]
                d = 16.0 if err == 0.0 else -math.log10(err)
                assert d >= 12, (kind, rec["iter"], key, d)
            else:
                assert d >= 10, (kind, rec["iter"], key, d)
    ol = exp.cfg.olx
    for name in ("theta", "salt", "uVel", "vVel", "etaN"):
        d = digits(interior(getattr(exp.state, name), ol),
                   interior(np.asarray(getattr(jexp.state, name)), ol))
        assert d >= 8.5, (kind, name, d)
    if kind == "opps":
        return
    st = exp.state
    visc, diff = exp.vmix.calc(st.uVel, st.vVel, st.theta, st.salt,
                               st.totPhiHyd)
    wet = exp.grid.maskC > 0
    assert float(visc[wet].max()) > 100 * exp.cfg.viscAr
    assert float(diff[wet].max()) > 100 * exp.cfg.diffKrS
    assert float(visc[wet].min()) == exp.cfg.viscAr


def test_opps_fires():
    """OPPS launches plumes in the cooled north and none in the heated
    south on the step that follows the first: the count of OPPS.apply on
    the state and w at the start of step 2."""
    exp = port_experiment("opps")
    exp.run(n_steps=1, collect_monitor=False)
    st = exp.state
    _, _, cnt = exp.opps.apply(st.theta, st.salt, st.wVel, st.totPhiHyd)
    ol, ny = exp.cfg.oly, exp.cfg.ny
    north = float(cnt[:, ol + ny // 2:ol + ny].sum())
    south = float(cnt[:, ol:ol + ny // 2].sum())
    assert north > 0 and south == 0, (north, south)


@pytest.mark.parametrize("kind", PATHS)
def test_2plus2(kind, tmp_path):
    e4 = port_experiment(kind)
    e4.run(n_steps=4, collect_monitor=False)
    e2 = port_experiment(kind)
    e2.run(n_steps=2, collect_monitor=False)
    write_pickup(e2, str(tmp_path), myIter=2)
    e22 = port_experiment(kind)
    read_pickup(e22, str(tmp_path), myIter=2)
    e22.run(n_steps=2, collect_monitor=False)
    ol = e4.cfg.olx
    differ = [n for n in FIELDS
              if not torch.equal(getattr(e4.state, n)[..., ol:-ol, ol:-ol],
                                 getattr(e22.state, n)[..., ol:-ol, ol:-ol])]
    assert not differ, differ


REFUSALS = {
    "usePP81 with useMY82": dict(useMY82=True),
    "usePP81 or useMY82 with useKPP": dict(useKPP=True),
    "usePP81 or useMY82 with useGGL90": dict(useGGL90=True),
    "a PP81 or MY82 object of another scheme": dict(usePP81=False,
                                                    useMY82=True),
}


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals(name):
    exp = port_experiment("pp81")
    cfg = dataclasses.replace(exp.cfg, **REFUSALS[name])
    with pytest.raises(NotImplementedError, match=name):
        tstep.check_supported(cfg, vmix=exp.vmix)


def test_refusals_without_objects():
    pp81, opps = port_experiment("pp81"), port_experiment("opps")
    with pytest.raises(NotImplementedError,
                       match="usePP81 or useMY82 without a PP81 or MY82"):
        tstep.check_supported(pp81.cfg)
    with pytest.raises(NotImplementedError,
                       match="useOPPS without an OPPS object"):
        tstep.check_supported(opps.cfg)
    with pytest.raises(NotImplementedError,
                       match="an OPPS object without useOPPS"):
        tstep.check_supported(pp81.cfg, vmix=pp81.vmix, opps=opps.opps)
    cfg = dataclasses.replace(opps.cfg, cAdjFreq=600.0)
    with pytest.raises(NotImplementedError, match="cAdjFreq"):
        tstep.check_supported(cfg, opps=opps.opps)
    tstep.check_supported(pp81.cfg, vmix=pp81.vmix)
    tstep.check_supported(opps.cfg, opps=opps.opps)
