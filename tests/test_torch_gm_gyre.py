"""PyTorch port: the gm-gyre (the kpp-gyre with GM-Redi in its skew-flux
form, the gkw91 taper and GM_NON_UNITY_DIAGONAL) and the gm-bolus-gyre
(the advective form with the dm95 taper and GM_ExtraDiag), both started
with a temperature front, against the JAX package: 10 steps at 16x16x12
(depth 300 m) in float64 on the CPU; the ggl90-gyre (GGL90, DST-3
flux-limited tracers under the multi-dimensional advection) with the
gm-bolus-gyre's GM-Redi and front, 3 steps, so that Kwz joins the
profile diffusivities and the residual flow advects through kernel M's
twin; a 2+2 restart of the gm-gyre; and the front's effect at step 0.

The JAX gyres are evaluated op by op (jax.disable_jit), as the kpp-gyre of
tests/test_torch_kpp_gyre.py is, for the vi-gyre's reason (ROADMAP Queue
3). Every monitor statistic agrees to 10 digits on every step and the
cg2d iteration counts are equal; the cg2d residuals keep the bars of
ROADMAP Queue 3 (cg2d_init_res 9 digits, cg2d_last_res 12 against the
solve's first residual).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import kpp as jkpp
from mitgcm_tpu.model.experiment import Experiment as JaxExperiment
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.model import gad, gmredi
from mitgcm_tpu_torch.model import thermodynamics as tth
from mitgcm_tpu_torch.model.experiment import (Experiment, read_pickup,
                                               write_pickup)
from mitgcm_tpu_torch.ops import eos
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits
from test_torch_config import jax_config
from test_torch_ggl90_gyre import jax_experiment as jax_ggl90_experiment

torch.set_num_threads(1)

N_STEPS = 10
SIZE = dict(nx=16, ny=16, nr=12, depth=300.0)
CONFIGS = {"gm-gyre": tsyn.gm_gyre_config,
           "gm-bolus-gyre": tsyn.gm_bolus_gyre_config}


def port_experiment(kind):
    cfg = CONFIGS[kind](**SIZE)
    return Experiment(cfg, *tsyn.gm_gyre_setup(cfg, dtype=torch.float64,
                                               device="cpu"))


def jax_experiment(exp):
    """The JAX package's experiment on the port's configuration, forcing,
    front and KPP settings."""
    jcfg = jax_config(exp.cfg)
    grid, state, forcing, op = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    pf = exp.forcing
    forcing = dataclasses.replace(forcing, Qnet=jnp.asarray(pf.Qnet.numpy()),
                                  Qsw=jnp.asarray(pf.Qsw.numpy()))
    state = dataclasses.replace(state,
                                theta=jnp.asarray(exp.state.theta.numpy()))
    kpp = jkpp.KPP(jcfg, grid, {}, options=set(exp.kpp.options))
    return JaxExperiment(cfg=jcfg, grid=grid, state=state, forcing=forcing,
                         op=op, kpp=kpp)


@pytest.fixture(scope="module", params=list(CONFIGS))
def gm_run(request):
    exp = port_experiment(request.param)
    jexp = jax_experiment(exp)
    with jax.disable_jit():
        want = jexp.run(n_steps=N_STEPS)
    return request.param, exp, exp.run(n_steps=N_STEPS), jexp, want


def _check_records(kind, got, want):
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


def test_gm_gyres_ten_steps(gm_run):
    kind, exp, got, jexp, want = gm_run
    _check_records(kind, got, want)
    ol = exp.cfg.olx
    for name in ("theta", "salt", "uVel", "vVel", "etaN"):
        d = digits(interior(getattr(exp.state, name), ol),
                   interior(np.asarray(getattr(jexp.state, name)), ol))
        assert d >= 10, (kind, name, d)


def test_gm_bolus_with_ggl90_and_multidim():
    cfg = tsyn.ggl90_gyre_config(
        **SIZE, useGMRedi=True,
        gmredi=tsyn.gm_bolus_gyre_config(**SIZE).gmredi)
    objs = list(tsyn.ggl90_gyre_setup(cfg, dtype=torch.float64,
                                      device="cpu"))
    grid, state = objs[0], objs[1]
    state.theta = (state.theta + tsyn.front_theta(cfg, torch.float64, "cpu")
                   ) * grid.maskC
    jexp = jax_ggl90_experiment(cfg, objs)
    jexp.state = dataclasses.replace(jexp.state,
                                     theta=jnp.asarray(state.theta.numpy()))
    with jax.disable_jit():
        want = jexp.run(n_steps=3)
    exp = Experiment(cfg, *objs[:4], ggl90=objs[4])
    _check_records("ggl90-gm-bolus", exp.run(n_steps=3), want)


def test_gm_gyre_restart(tmp_path):
    """tools/do_tst_2+2: 4 steps == 2 + pickup + 2 bit for bit; GM-Redi
    keeps no state from step to step, so the pickup is the kpp-gyre's."""
    e4 = port_experiment("gm-gyre")
    e4.run(n_steps=4, collect_monitor=False)
    e2 = port_experiment("gm-gyre")
    e2.run(n_steps=2, collect_monitor=False)
    write_pickup(e2, str(tmp_path), 2)
    e22 = port_experiment("gm-gyre")
    read_pickup(e22, str(tmp_path), 2)
    e22.run(n_steps=2, collect_monitor=False)
    ol = e4.cfg.olx
    for name in ("uVel", "vVel", "wVel", "theta", "salt", "etaN", "guNm1",
                 "guNm2", "gtNm1", "gtNm2", "gsNm1", "gsNm2"):
        a = getattr(e4.state, name)[..., ol:-ol, ol:-ol]
        b = getattr(e22.state, name)[..., ol:-ol, ol:-ol]
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_front_makes_gm_bite_at_step_zero(kind):
    """The front slopes the isopycnals at step 0: over the wet interfaces
    the W-point taper is below 1 on at least 1 % and 1 on at least 1 %
    (dm95's: below 0.5 and above 0.99), Kwx and Kwy are not 0, and GM's
    part of theta's tendency is not 0 (in the bolus form, psi is not 0
    either)."""
    exp = port_experiment(kind)
    cfg, grid, st = exp.cfg, exp.grid, exp.state
    gm = cfg.gmredi
    rho = eos.find_rho(cfg, grid, st.theta, st.salt,
                       totPhiHyd=st.totPhiHyd) * grid.maskC
    sigmaR = tth.calc_sigmaR(cfg, grid, rho, st.theta, st.salt,
                             totPhiHyd=st.totPhiHyd)
    sigmaX, sigmaY = gmredi.sigma_xy(grid, rho)
    _, _, _, taper, maskFk = gmredi.w_slopes(cfg, grid, gm, sigmaX, sigmaY,
                                             sigmaR)
    ol = cfg.olx
    wet = interior(maskFk, ol)[1:] > 0
    tap = interior(taper, ol)[1:][wet]
    if gm.taper_scheme == "dm95":
        # tanh's taper is 1 only where its argument is clipped: count the
        # flat and the steep ends of its range instead
        flat, bites = (tap > 0.99).mean(), (tap < 0.5).mean()
    else:
        flat, bites = (tap == 1.0).mean(), (tap < 1.0).mean()
    assert bites >= 0.01 and flat >= 0.01, (bites, flat)
    ten = gmredi.gm_tensor(cfg, grid, gm, rho, sigmaR)
    assert float(ten.Kwx.abs().max()) > 0.0
    assert float(ten.Kwy.abs().max()) > 0.0
    flow = gad.calc_adv_flow(grid, st.uVel, st.vVel, st.wVel)
    kappa = tth.tracer_kappa(cfg, grid, cfg.diffKrT)
    args = (cfg, grid, flow, st.theta, kappa, cfg.diffKhT)
    g_gm = gad.calc_rhs(*args, implicit_diffusion=True, gm=ten)
    g_off = gad.calc_rhs(*args, implicit_diffusion=True)
    assert float((g_gm - g_off).abs().max()) > 0.0
    if gm.advForm:
        psiX, psiY = gmredi.gm_psi_b(cfg, grid, gm, rho, sigmaR)
        assert float(psiX.abs().max()) > 0.0
        assert float(psiY.abs().max()) > 0.0
