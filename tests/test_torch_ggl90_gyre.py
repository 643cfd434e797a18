"""PyTorch port: the ggl90-gyre (the kpp-gyre's levels, profiles and heat
fluxes with GGL90 TKE mixing in place of KPP and DST-3 flux-limited
tracers under the multi-dimensional advection) against the JAX package, 10
steps at 16x16x12 (depth 300 m) in float64 on the CPU.

The JAX run is evaluated op by op (jax.disable_jit), as the vi-gyre of
tests/test_torch_vi_gyre.py is, for the reason given there. Every monitor
statistic agrees to 10 digits on every step and the cg2d iteration counts
are equal; the cg2d residuals keep the bars of ROADMAP Queue 3
(cg2d_init_res 9 digits, cg2d_last_res 12 digits against the solve's first
residual); GGL90TKE agrees to 10 digits. A coverage check keeps both
regimes of GGL90 under test: turbulent interfaces above 1e-6 m2/s2 beside
ones at the floor, columns whose diffusivity exceeds 1e-3 m2/s, and
statically unstable interfaces in the cooled north.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.core.state import State as JaxState
from mitgcm_tpu.model import ggl90 as jg9
from mitgcm_tpu.model.experiment import Experiment as JaxExperiment
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.model import thermodynamics as tth
from mitgcm_tpu_torch.model.experiment import Experiment
from mitgcm_tpu_torch.model.step import load_fields
from mitgcm_tpu_torch.ops.eos import find_rho
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior
from test_torch_config import jax_config
from test_torch_kpp_gyre import _check_records

torch.set_num_threads(1)

N_STEPS = 10
SIZE = dict(nx=16, ny=16, nr=12, depth=300.0)


def jax_experiment(cfg, port_objs):
    """The JAX package's ggl90-gyre for cfg: its gyre with the port's heat
    fluxes, GGL90 with the port's settings and the TKE at its floor."""
    jcfg = jax_config(cfg)
    grid, state, forcing, op = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    pf = port_objs[2]
    forcing = dataclasses.replace(forcing, Qnet=jnp.asarray(pf.Qnet.numpy()),
                                  Qsw=jnp.asarray(pf.Qsw.numpy()))
    ggl90 = jg9.GGL90(jcfg, grid, dict(port_objs[4].p))
    state = JaxState(**{**state.__dict__,
                        "GGL90TKE": ggl90.init_tke(jnp.float64)})
    return JaxExperiment(cfg=jcfg, grid=grid, state=state, forcing=forcing,
                         op=op, ggl90=ggl90)


def port_experiment(cfg, dtype=torch.float64):
    grid, state, forcing, op, ggl90 = tsyn.ggl90_gyre_setup(
        cfg, dtype=dtype, device="cpu")
    return Experiment(cfg, grid, state, forcing, op, ggl90=ggl90)


@pytest.fixture(scope="module")
def ggl90_gyre():
    cfg = tsyn.ggl90_gyre_config(**SIZE)
    exp = port_experiment(cfg)
    jexp = jax_experiment(cfg, (exp.grid, exp.state, exp.forcing, exp.op,
                                exp.ggl90))
    with jax.disable_jit():
        want = jexp.run(n_steps=N_STEPS)
    return exp, exp.run(n_steps=N_STEPS), jexp, want


def test_ggl90_gyre_ten_steps(ggl90_gyre):
    exp, got, jexp, want = ggl90_gyre
    _check_records(got, want)
    ol = exp.cfg.olx
    for name in ("theta", "salt", "uVel", "vVel", "etaN", "GGL90TKE"):
        d = digits(interior(getattr(exp.state, name), ol),
                   interior(np.asarray(getattr(jexp.state, name)), ol))
        assert d >= 10, (name, d)


def test_ggl90_gyre_covers_both_regimes(ggl90_gyre):
    """After 10 steps the TKE is turbulent in many interfaces and at its
    floor in others, GGL90's diffusivity is large in some columns, and the
    cooled north is statically unstable in places."""
    exp = ggl90_gyre[0]
    cfg, grid, st = exp.cfg, exp.grid, exp.state
    wet = grid.maskC[1:] * grid.maskC[:-1] > 0
    tke = st.GGL90TKE[1:][wet]
    assert int((tke > 1e-6).sum()) > 100
    assert int((tke == exp.ggl90.p["GGL90TKEmin"]).sum()) > 100
    forc = load_fields(exp.forcing)
    rho = find_rho(cfg, grid, st.theta, st.salt) * grid.maskC
    sigmaR = tth.calc_sigmaR(cfg, grid, rho, st.theta, st.salt)
    assert int((sigmaR[1:][wet] > 0).sum()) > 10      # unstable interfaces
    diffKr = exp.ggl90.calc(st.uVel, st.vVel, st.GGL90TKE, sigmaR,
                            forc.fu * cfg.mass2rUnit,
                            forc.fv * cfg.mass2rUnit)[3]
    assert int((diffKr.amax(dim=0) > 1e-3).sum()) > 10
