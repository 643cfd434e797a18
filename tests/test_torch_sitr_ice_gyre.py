"""PyTorch port: the sitr-ice-gyre (the ice-gyre of
tests/test_torch_ice_gyre.py carrying two ice tracers, an 'age' with HEFF
and a 'one' with AREA: advdiff's tracer branch and tracer_phys) against the
JAX package, 10 steps at 16x16x12 (depth 300 m) in float64 on the CPU,
with the JAX side evaluated op by op (jax.disable_jit) as the ice-gyre's.

Tolerances are the ice-gyre's: equal cg2d and LSR iteration counts; every
monitor statistic, the seaice_* ones and the seaice_sitracer01/02 rows
included, to 10 digits; cg2d_init_res 9 digits, cg2d_last_res 12 digits
against the solve's first residual; the ice fields, the two tracers and the
ocean's theta, salt, uVel and etaN after 10 steps to 10 digits. A pickup
round trip (5 + 5 steps through pickup and pickup_seaice, with the
siTrac01/02 records) is bit-exact against the 10 straight steps, and
utils/convert.py carries the tracers across.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import kpp as jkpp
from mitgcm_tpu.model import seaice as jseaice
from mitgcm_tpu.model.experiment import Experiment as JaxExperiment
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.model.experiment import (Experiment, read_pickup,
                                               write_pickup)
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits
from test_torch_config import jax_config

torch.set_num_threads(1)

N_STEPS = 10
SIZE = dict(nx=16, ny=16, nr=12, depth=300.0)
ICE_FIELDS = ("uIce", "vIce", "siAREA", "siHEFF", "siHSNOW", "siTICES",
              "SItracer")
FORCING = ("Qnet", "Qsw", "atemp", "aqh", "precip", "swdown", "lwdown",
           "runoff", "wspeed", "evap")


def jax_objects(cfg, objs, nml01, nml03):
    """The JAX package's Experiment for the port's objects: the same grid,
    forcing and initial ice (the tracers too), KPP and a SeaIce of the same
    parameters."""
    jcfg = jax_config(cfg)
    jcfg.seaice = jseaice.params_from_namelists(jcfg, nml01, nml03)
    grid, state, forcing, op = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    _, pstate, pforcing, _, pkpp, _ = objs
    forcing = dataclasses.replace(forcing, **{
        k: jnp.asarray(getattr(pforcing, k).numpy()) for k in FORCING})
    z0 = jnp.zeros((0,) + tuple(state.etaN.shape))
    state = dataclasses.replace(state, **{
        k: jnp.asarray(getattr(pstate, k).numpy())
        for k in ICE_FIELDS + ("siHSALT",)}, siSigma=z0)
    kpp = jkpp.KPP(jcfg, grid, {}, options=set(pkpp.options))
    seaice = jseaice.SeaIce(jcfg, grid, jcfg.seaice)
    seaice.debug = True
    return JaxExperiment(cfg=jcfg, grid=grid, state=state, forcing=forcing,
                         op=op, kpp=kpp, seaice=seaice)


def run_both(cfg, nml01, nml03):
    """(port Experiment, its records, JAX Experiment, its records, the
    JAX LSR counts a step) after N_STEPS steps of each."""
    objs = tsyn.ice_gyre_setup(cfg, dtype=torch.float64, device="cpu")
    jexp = jax_objects(cfg, objs, nml01, nml03)
    want, counts = [], []
    with jax.disable_jit():
        for _ in range(N_STEPS):
            jexp.seaice.last_lsr = []
            want += jexp.run(n_steps=1)[len(want) > 0:]
            counts.append([(int(d[0]), int(d[1]))
                           for d in jexp.seaice.last_lsr])
    grid, state, forcing, op, kpp, seaice = objs
    exp = Experiment(cfg, grid, state, forcing, op, kpp=kpp, seaice=seaice)
    return exp, exp.run(n_steps=N_STEPS), jexp, want, counts


def check_records(got, want, counts, extra=()):
    """The ice-gyre's bars on every record, and every statistic of JAX's
    (the rows named in `extra` among them) in the port's records."""
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for rec, ref in zip(got, want):
        assert rec.get("cg2d_iters") == ref.get("cg2d_iters"), rec["iter"]
        dig = record_digits(rec, ref)
        missing = {k for k in ref if k.startswith(("dynstat_", "seaice_"))
                   } - set(dig)
        assert not missing, missing
        assert all(any(k.startswith(e) for k in dig) for e in extra)
        for key, d in dig.items():
            if key == "cg2d_init_res":
                assert d >= 9, (rec["iter"], key, d)
            elif key == "cg2d_last_res":
                err = abs(rec[key] - ref[key]) / ref["cg2d_init_res"]
                d = 16.0 if err == 0.0 else -math.log10(err)
                assert d >= 12, (rec["iter"], key, d)
            else:
                assert d >= 10, (rec["iter"], key, d)
    assert [[tuple(c) for c in r["lsr_iters"]] for r in got[1:]] == counts


def check_fields(exp, jexp, names):
    ol = exp.cfg.olx
    for name in names + ("theta", "salt", "uVel", "etaN"):
        d = digits(interior(getattr(exp.state, name), ol),
                   interior(np.asarray(getattr(jexp.state, name)), ol))
        assert d >= 10, (name, d)


@pytest.fixture(scope="module")
def sitr_gyre():
    cfg = tsyn.sitr_ice_gyre_config(**SIZE)
    return run_both(cfg, tsyn.ICE_GYRE_SEAICE, tsyn.SITR_ICE_GYRE_SEAICE03)


def test_sitr_ice_gyre_ten_steps(sitr_gyre):
    exp, got, _, want, counts = sitr_gyre
    check_records(got, want, counts, extra=("seaice_sitracer01_",
                                            "seaice_sitracer02_"))


def test_sitr_ice_gyre_fields(sitr_gyre):
    exp, _, jexp, _, _ = sitr_gyre
    check_fields(exp, jexp, ICE_FIELDS)


def test_sitr_tracers_age_and_spread(sitr_gyre):
    """After 10 steps the age under the northern ice is close to 10
    deltaTtherm (a little less: growth mixes in new ice of age 0), 0 where
    no ice is and never more than the run's length; 'one' stays 1 where
    AREA is."""
    exp, _, _, _, _ = sitr_gyre
    st, ol, ny = exp.state, exp.cfg.olx, exp.cfg.ny
    age, one = (interior(st.SItracer[i], ol) for i in range(2))
    heff, area = interior(st.siHEFF, ol), interior(st.siAREA, ol)
    dt = exp.seaice.p.deltaTtherm
    north = age[ny // 3 + 2:-2, 2:-2]
    assert (north > 0.99 * N_STEPS * dt).all()
    assert (north < N_STEPS * dt).all()
    assert (age[heff <= 0.0] == 0.0).all() and (age[heff > 0.0] > 0.0).all()
    assert age.max() <= N_STEPS * dt
    assert np.allclose(one[area > 0.0], 1.0)


def test_sitr_pickup_round_trip(tmp_path):
    """5 + 5 steps through pickup and pickup_seaice (siTrac01, siTrac02
    written after siHSNOW, as the JAX package writes them) bit-exact
    against 10 straight steps."""
    cfg = tsyn.sitr_ice_gyre_config(**SIZE)

    def experiment():
        objs = tsyn.ice_gyre_setup(cfg, dtype=torch.float64, device="cpu")
        grid, state, forcing, op, kpp, seaice = objs
        return Experiment(cfg, grid, state, forcing, op, kpp=kpp,
                          seaice=seaice)

    straight = experiment()
    straight.run(n_steps=10, collect_monitor=False)
    first = experiment()
    first.run(n_steps=5, collect_monitor=False)
    write_pickup(first, str(tmp_path), 5)
    meta = (tmp_path / "pickup_seaice.0000000005.meta").read_text()
    assert meta.index("'siHSNOW") < meta.index("'siTrac01") \
        < meta.index("'siTrac02") < meta.index("'siUICE")
    again = experiment()
    read_pickup(again, str(tmp_path), 5)
    assert torch.equal(again.state.SItracer, first.state.SItracer)
    again.run(n_steps=5, collect_monitor=False)
    for name in ICE_FIELDS + ("theta", "salt", "uVel", "etaN"):
        assert torch.equal(getattr(again.state, name),
                           getattr(straight.state, name)), name


def test_sitr_state_crosses(sitr_gyre):
    """utils/convert.py carries the two ice tracers from the JAX package's
    state to the port's and back."""
    from mitgcm_tpu_torch.core.state import State
    from mitgcm_tpu_torch.utils import convert

    exp, _, jexp, _, _ = sitr_gyre
    state = convert.from_arrays(State, convert.arrays_of(jexp.state),
                                device="cpu")
    assert state.SItracer.shape[0] == 2
    assert np.array_equal(state.SItracer.numpy(),
                          np.asarray(jexp.state.SItracer))
    back = convert.arrays_of(exp.state)
    assert np.array_equal(back["SItracer"], exp.state.SItracer.numpy())
