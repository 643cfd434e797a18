"""PyTorch port: the ice-gyre (the kpp-gyre made polar under a cold
atmosphere, with a dynamic-thermodynamic sea-ice cover: LSR dynamics on
2 x 2 tiles, scheme-77 ice advection, 7-category growth) against the JAX
package, 10 steps at 16x16x12 (depth 300 m) in float64 on the CPU. The JAX
side is the JAX package's SeaIce built from the same parameters and handed
to its Experiment; it is evaluated op by op (jax.disable_jit), as the
kpp-gyre of tests/test_torch_kpp_gyre.py is, for the reason given there.

Tolerances: the LSR iteration counts (ICOUNT1, ICOUNT2 of each Picard pass)
and the cg2d iteration counts are equal on every step; every monitor
statistic, the seaice_* ones included, agrees to 10 digits (downstream of
the cg2d and LSR solves), the cg2d residuals keep the kpp-gyre's bars
(cg2d_init_res 9 digits, cg2d_last_res 12 digits against the solve's first
residual, ROADMAP Queue 3), and the ice fields and the ocean's theta,
salt, uVel and etaN after 10 steps agree to 10 digits (measured: the
statistics 12.35 digits or more, the seaice_* ones 13.30, cg2d_init_res
11.14, the fields 11.43 or more, etaN the lowest).
tests/test_torch_seaice.py holds each function of the step to 12 digits or
more.
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
from mitgcm_tpu_torch.model.experiment import Experiment
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits
from test_torch_config import jax_config

torch.set_num_threads(1)

N_STEPS = 10
SIZE = dict(nx=16, ny=16, nr=12, depth=300.0)
ICE_FIELDS = ("uIce", "vIce", "siAREA", "siHEFF", "siHSNOW", "siTICES")
FORCING = ("Qnet", "Qsw", "atemp", "aqh", "precip", "swdown", "lwdown",
           "runoff", "wspeed", "evap")


def jax_objects(cfg, objs):
    """The JAX package's Experiment for the port's ice-gyre objects: the
    same grid, forcing and initial ice, KPP and a SeaIce of the same
    parameters."""
    jcfg = jax_config(cfg)
    jcfg.seaice = jseaice.params_from_namelists(jcfg, tsyn.ICE_GYRE_SEAICE,
                                                {})
    grid, state, forcing, op = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    _, pstate, pforcing, _, pkpp, _ = objs
    forcing = dataclasses.replace(forcing, **{
        k: jnp.asarray(getattr(pforcing, k).numpy()) for k in FORCING})
    z0 = jnp.zeros((0,) + tuple(state.etaN.shape))
    state = dataclasses.replace(state, **{
        k: jnp.asarray(getattr(pstate, k).numpy())
        for k in ICE_FIELDS + ("siHSALT",)}, SItracer=z0, siSigma=z0)
    kpp = jkpp.KPP(jcfg, grid, {}, options=set(pkpp.options))
    seaice = jseaice.SeaIce(jcfg, grid, jcfg.seaice)
    seaice.debug = True
    return JaxExperiment(cfg=jcfg, grid=grid, state=state, forcing=forcing,
                         op=op, kpp=kpp, seaice=seaice)


@pytest.fixture(scope="module")
def ice_gyre():
    cfg = tsyn.ice_gyre_config(**SIZE)
    objs = tsyn.ice_gyre_setup(cfg, dtype=torch.float64, device="cpu")
    jexp = jax_objects(cfg, objs)
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


def test_ice_gyre_ten_steps(ice_gyre):
    exp, got, jexp, want, counts = ice_gyre
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for rec, ref in zip(got, want):
        assert rec.get("cg2d_iters") == ref.get("cg2d_iters"), rec["iter"]
        dig = record_digits(rec, ref)
        missing = {k for k in ref if k.startswith(("dynstat_", "seaice_"))
                   } - set(dig)
        assert not missing, missing
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


def test_ice_gyre_fields(ice_gyre):
    exp, _, jexp, _, _ = ice_gyre
    ol = exp.cfg.olx
    for name in ICE_FIELDS + ("theta", "salt", "uVel", "etaN"):
        d = digits(interior(getattr(exp.state, name), ol),
                   interior(np.asarray(getattr(jexp.state, name)), ol))
        assert d >= 10, (name, d)


def test_ice_gyre_freezes_and_drifts(ice_gyre):
    """After 10 steps the ice has grown in the open south (frazil and
    open-water growth), still covers the north and drifts, and the LSR
    iterated beyond its first check."""
    exp, got, _, _, _ = ice_gyre
    st, ol, ny = exp.state, exp.cfg.olx, exp.cfg.ny
    area = interior(st.siAREA, ol)
    assert area[1:ny // 3 - 1, 1:-1].min() > 0.0
    assert area[ny // 3:-1, 1:-1].min() > 0.9
    assert float(st.uIce.abs().max()) > 1e-4
    assert max(max(c) for r in got[1:] for c in r["lsr_iters"]) > 2


def test_ice_state_and_atmosphere_cross(ice_gyre):
    """utils/convert.py carries the ice state and the atmospheric forcing
    from the JAX package's arrays to the port's tensors and back."""
    from mitgcm_tpu_torch.core.state import Forcing, State
    from mitgcm_tpu_torch.utils import convert

    exp, _, jexp, _, _ = ice_gyre
    state = convert.from_arrays(State, convert.arrays_of(jexp.state),
                                device="cpu")
    forcing = convert.from_arrays(Forcing, convert.arrays_of(jexp.forcing),
                                  device="cpu")
    for name in ICE_FIELDS + ("siHSALT",):
        assert np.array_equal(getattr(state, name).numpy(),
                              np.asarray(getattr(jexp.state, name))), name
    assert state.SItracer.shape[0] == 0 and state.siSigma.shape[0] == 0
    for name in FORCING:
        assert np.array_equal(getattr(forcing, name).numpy(),
                              np.asarray(getattr(jexp.forcing, name))), name
    back = convert.arrays_of(exp.state)
    assert all(np.array_equal(back[n], getattr(exp.state, n).numpy())
               for n in ICE_FIELDS)
