"""PyTorch port: the nh-convection box (the non-hydrostatic path: calc_gw
and the AB step of w, the cg2d and cg3d solves, the phi_nh gradient in the
correction) against the JAX package, 10 steps at 16x16x12 in float64 on
the CPU, from the port's seeded initial state and cooling disc.

JAX steps through model/step.py:forward_step with op3, evaluated as
compiled (jitted); its monitor statistics come from its Experiment. The
cg2d and cg3d iteration counts are equal on every step (cg3d's from JAX's
StepDiag). Measured on this configuration: the monitor statistics agree
to 12.32 digits or more (ke_max, with its w^2 term, to 13.44),
cg2d_init_res to 12.16 and cg3d_init_res to 12.08, phi_nh to 12.13, wVel
to 13.23, uVel to 13.40 and theta to 15.45; the last residuals sit at the
solves' floors and agree to 18 digits against the solve's first residual
(cg3d_last_res to 7.95 as a value). The bars are 10 digits, the last
residuals judged against the first. Coverage: phi_nh, gW and gwDiss are
not zero, and every cg3d solve stops below its cap of 100 iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.core import grid as jgrid_mod
from mitgcm_tpu.core import state as jstate_mod
from mitgcm_tpu.model import step as jstep
from mitgcm_tpu.model.experiment import Experiment as JaxExperiment
from mitgcm_tpu.solver import cg2d as jcg2
from mitgcm_tpu.solver import cg3d as jcg3
from mitgcm_tpu_torch.model import calc_gw as tgw
from mitgcm_tpu_torch.model.experiment import Experiment
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits
from mitgcm_tpu_torch.utils.convert import arrays_of
from test_torch_config import jax_config

torch.set_num_threads(1)

N_STEPS = 10
SIZE = dict(nx=16, ny=16, nr=12)
BAR = 10.0


def jax_experiment(cfg, exp):
    """The JAX package's box: its grid, state and operators built from the
    same configuration, with the port's initial fields and forcing."""
    jcfg = jax_config(cfg)
    grid = jgrid_mod.build_grid(jcfg, dtype=jnp.float64)
    init = arrays_of(exp.state)
    state = jstate_mod.init_state(jcfg, grid)
    state = jstate_mod.State(**{**state.__dict__, **{
        k: jnp.asarray(init[k]) for k in ("uVel", "vVel", "wVel", "theta")}})
    forcing = dataclasses.replace(jstate_mod.zero_forcing(jcfg),
                                  Qnet=jnp.asarray(exp.forcing.Qnet.numpy()))
    return JaxExperiment(cfg=jcfg, grid=grid, state=state, forcing=forcing,
                         op=jcg2.build_cg2d(jcfg, grid),
                         op3=jcg3.build_cg3d(jcfg, grid))


def jax_run(jexp, n_steps):
    """Records of n_steps of JAX's forward_step, with the cg3d diagnostics
    of its StepDiag."""
    cfg = jexp.cfg
    step = jax.jit(lambda s, it: jstep.forward_step(
        cfg, jexp.grid, jexp.op, s, jexp.forcing, it, op3=jexp.op3))
    recs = [{"iter": 0, **jexp.monitor_stats()}]
    for it in range(n_steps):
        jexp.state, diag = step(jexp.state, it)
        recs.append({"iter": it + 1,
                     **{k: float(getattr(diag, k)) for k in (
                         "cg2d_init_res", "cg2d_last_res", "cg3d_init_res",
                         "cg3d_last_res")},
                     "cg2d_iters": int(diag.cg2d_iters),
                     "cg3d_iters": int(diag.cg3d_iters),
                     **jexp.monitor_stats()})
    return recs


@pytest.fixture(scope="module")
def nh_box():
    cfg = tsyn.nh_convection_config(**SIZE)
    grid, state, forcing, op, op3 = tsyn.nh_convection_setup(
        cfg, dtype=torch.float64, device="cpu", seed=5)
    exp = Experiment(cfg, grid, state, forcing, op, op3=op3)
    jexp = jax_experiment(cfg, exp)
    return exp, exp.run(n_steps=N_STEPS), jexp, jax_run(jexp, N_STEPS)


def test_nh_convection_ten_steps(nh_box):
    exp, got, jexp, want = nh_box
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for rec, ref in zip(got, want):
        for key in ("cg2d_iters", "cg3d_iters"):
            assert rec.get(key) == ref.get(key), (rec["iter"], key)
        dig = record_digits(rec, ref)
        missing = {k for k in ref if k.startswith(("dynstat_", "ke_"))} \
            - set(dig)
        assert not missing, missing
        for key, d in dig.items():
            if key == "cg2d_last_res" or key == "cg3d_last_res":
                continue      # at the solves' floors: judged below
            assert d >= BAR, (rec["iter"], key, d)
        for key in ("cg2d", "cg3d"):
            if f"{key}_last_res" in ref:
                err = abs(rec[f"{key}_last_res"] - ref[f"{key}_last_res"])
                assert err <= 10.0 ** -BAR * ref[f"{key}_init_res"], \
                    (rec["iter"], key)
    ol = exp.cfg.olx
    for name in ("phi_nh", "wVel", "uVel", "theta"):
        d = digits(interior(getattr(exp.state, name), ol),
                   interior(np.asarray(getattr(jexp.state, name)), ol))
        assert d >= BAR, (name, d)


def test_nh_convection_covers_the_path(nh_box):
    """phi_nh, gW and gwDiss are not zero, the 3-D Coriolis term is on,
    and every cg3d solve stops below its cap."""
    exp, got = nh_box[:2]
    cfg, st = exp.cfg, exp.state
    assert cfg.select3dCoriScheme == 1 and not cfg.no_slip_sides
    assert float(st.phi_nh.abs().max()) > 0.0
    kappa = torch.full((cfg.nr + 1,) + tuple(st.uVel.shape[1:]), cfg.viscAr,
                       dtype=st.uVel.dtype)
    gW, gwDiss = tgw.calc_gw(cfg, exp.grid, st.uVel, st.vVel, st.wVel,
                             kappa, kappa)
    assert float(gW[1:].abs().max()) > 0.0
    assert float(gwDiss[1:].abs().max()) > 0.0
    iters = [r["cg3d_iters"] for r in got[1:]]
    assert all(0 < n < cfg.cg3dMaxIters for n in iters), iters
