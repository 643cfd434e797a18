"""PyTorch port: the thsice-gyre (the ice-gyre's polar kpp-gyre and cold
atmosphere under Winton's thermodynamic sea ice, pkg/thsice, in place of
pkg/seaice) against the JAX package, 10 steps at 16x16x12 (depth 300 m) in
float64 on the CPU. The JAX side is the JAX package's ThSIce built from
the same parameters (utils/convert.py:thsice_params carries them across)
and set on its Experiment as the JAX runner sets it; its state starts from
the port's through utils/convert.py; it is evaluated op by op
(jax.disable_jit), as the ice-gyre of tests/test_torch_ice_gyre.py is.

Tolerances: the cg2d iteration counts are equal on every step; every
monitor statistic, the thSI_* ones included, agrees to 10 digits
(downstream of the cg2d solve), cg2d_init_res to 9 digits and
cg2d_last_res to 12 digits against the solve's first residual (the
kpp-gyre's bars, ROADMAP Queue 3); theta, salt, uVel, etaN and the nine
th* fields after 10 steps to 10 digits. Measured: every statistic 12.83
digits or more (the thSI_* ones 14.57), cg2d_init_res 10.83,
cg2d_last_res 15.24 against the first residual, the fields 11.65 or more
(etaN the lowest; the th* fields 14.46). tests/test_torch_thsice.py holds
each function of the step to 12 digits or more.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import kpp as jkpp
from mitgcm_tpu.model import thsice as jthsice
from mitgcm_tpu.model.experiment import Experiment as JaxExperiment
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core.state import State
from mitgcm_tpu_torch.model import step as tstep
from mitgcm_tpu_torch.model.experiment import Experiment, write_pickup
from mitgcm_tpu_torch.model.thsice import TH_FIELDS
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits
from test_torch_config import jax_config

torch.set_num_threads(1)

N_STEPS = 10
SIZE = dict(nx=16, ny=16, nr=12, depth=300.0)
FORCING = ("Qnet", "Qsw", "atemp", "aqh", "precip", "swdown", "lwdown",
           "runoff", "wspeed", "evap")


def jax_objects(cfg, objs):
    """The JAX package's Experiment for the port's thsice-gyre objects: the
    same grid, forcing and initial ice (through utils/convert.py), KPP and
    a ThSIce of the same parameters."""
    jcfg = jax_config(cfg)
    grid, state, forcing, op = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    _, pstate, pforcing, _, pkpp, pth = objs
    forcing = dataclasses.replace(forcing, **{
        k: jnp.asarray(getattr(pforcing, k).numpy()) for k in FORCING})
    arrays = convert.arrays_of(pstate)
    state = dataclasses.replace(state, **{
        k: jnp.asarray(arrays[k]) for k in TH_FIELDS})
    kpp = jkpp.KPP(jcfg, grid, {}, options=set(pkpp.options))
    jp = jthsice.ThsiceParams(**dataclasses.asdict(pth.p))
    jexp = JaxExperiment(cfg=jcfg, grid=grid, state=state, forcing=forcing,
                         op=op, kpp=kpp)
    jexp.thsice = jthsice.ThSIce(jcfg, grid, jp)
    return jexp


@pytest.fixture(scope="module")
def thsice_gyre():
    cfg = tsyn.thsice_gyre_config(**SIZE)
    objs = tsyn.thsice_gyre_setup(cfg, dtype=torch.float64, device="cpu")
    jexp = jax_objects(cfg, objs)
    with jax.disable_jit():
        want = jexp.run(n_steps=N_STEPS)
    grid, state, forcing, op, kpp, th = objs
    exp = Experiment(cfg, grid, state, forcing, op, kpp=kpp, thsice=th)
    return exp, exp.run(n_steps=N_STEPS), jexp, want


def test_thsice_gyre_ten_steps(thsice_gyre):
    exp, got, jexp, want = thsice_gyre
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for rec, ref in zip(got, want):
        assert rec.get("cg2d_iters") == ref.get("cg2d_iters"), rec["iter"]
        dig = record_digits(rec, ref)
        missing = {k for k in ref if k.startswith(("dynstat_", "thSI_"))
                   } - set(dig)
        assert not missing, missing
        assert any(k.startswith("thSI_") for k in dig)
        for key, d in dig.items():
            if key == "cg2d_init_res":
                assert d >= 9, (rec["iter"], key, d)
            elif key == "cg2d_last_res":
                err = abs(rec[key] - ref[key]) / ref["cg2d_init_res"]
                d = 16.0 if err == 0.0 else -math.log10(err)
                assert d >= 12, (rec["iter"], key, d)
            else:
                assert d >= 10, (rec["iter"], key, d)


def test_thsice_gyre_fields(thsice_gyre):
    exp, _, jexp, _ = thsice_gyre
    ol = exp.cfg.olx
    for name in TH_FIELDS + ("theta", "salt", "uVel", "etaN"):
        d = digits(interior(getattr(exp.state, name), ol),
                   interior(np.asarray(getattr(jexp.state, name)), ol))
        assert d >= 10, (name, d)


def test_thsice_gyre_freezes_in_the_south(thsice_gyre):
    """After 10 steps new ice covers the open south (its water starts
    below the freezing point) and the north keeps its ice."""
    exp, got, _, _ = thsice_gyre
    st, ol, ny = exp.state, exp.cfg.olx, exp.cfg.ny
    mask = interior(st.thIceMask, ol)
    assert mask[1:ny // 3 - 1, 1:-1].min() > 0.0
    assert mask[ny // 3:-1, 1:-1].min() > 0.9
    assert got[-1]["thSI_Ice_Area_G"] > got[0]["thSI_Ice_Area_G"]


def test_thsice_state_and_params_cross(thsice_gyre):
    """utils/convert.py carries the nine th* fields from the JAX package's
    arrays to the port's tensors and back, and ThsiceParams across."""
    exp, _, jexp, _ = thsice_gyre
    state = convert.from_arrays(State, convert.arrays_of(jexp.state),
                                device="cpu")
    for name in TH_FIELDS:
        assert np.array_equal(getattr(state, name).numpy(),
                              np.asarray(getattr(jexp.state, name))), name
    assert convert.thsice_params(jexp.thsice.p) == exp.thsice.p


def test_thsice_refusals(thsice_gyre, tmp_path):
    """useThSIce without a ThSIce object, a ThSIce object without
    useThSIce and useThSIce with useSEAICE are refused by name, and so is a
    pickup of a thsice run (the JAX package's pickup has no thsice
    record)."""
    exp = thsice_gyre[0]
    cfg, th = exp.cfg, exp.thsice
    tstep.check_supported(cfg, kpp=exp.kpp, thsice=th)
    with pytest.raises(NotImplementedError,
                       match="useThSIce without a ThSIce object"):
        tstep.check_supported(cfg, kpp=exp.kpp)
    with pytest.raises(NotImplementedError,
                       match="useThSIce with useSEAICE"):
        tstep.check_supported(dataclasses.replace(cfg, useSEAICE=True),
                              kpp=exp.kpp, thsice=th)
    with pytest.raises(NotImplementedError,
                       match="a ThSIce object without useThSIce"):
        tstep.check_supported(dataclasses.replace(cfg, useThSIce=False),
                              kpp=exp.kpp, thsice=th)
    with pytest.raises(NotImplementedError, match="useThSIce"):
        write_pickup(exp, str(tmp_path), 10)
