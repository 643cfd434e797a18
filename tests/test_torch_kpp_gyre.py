"""PyTorch port: the kpp-gyre (the vi-gyre with KPP boundary-layer mixing,
stretched levels, a surface mixed layer and a heat flux that heats the
south and cools the north) against the JAX package, 10 steps at 16x16x12
(depth 300 m) in float64 on the CPU; and the flux-form gyre with KPP on the
same levels, profiles and forcing (LINEAR EOS, explicit vertical mixing).

The JAX kpp-gyre is evaluated op by op (jax.disable_jit), as the vi-gyre of
tests/test_torch_vi_gyre.py is, for the reason given there; the flux-form
run is held against the jitted JAX step. Every monitor statistic agrees to
10 digits on every step and the cg2d iteration counts are equal; the cg2d
residuals keep the bars of ROADMAP Queue 3 (cg2d_init_res 9 digits,
cg2d_last_res 12 digits against the solve's first residual).
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
from mitgcm_tpu_torch.model import thermodynamics as tth
from mitgcm_tpu_torch.model.experiment import Experiment
from mitgcm_tpu_torch.model.step import load_fields
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits
from test_torch_config import jax_config

torch.set_num_threads(1)

N_STEPS = 10
SIZE = dict(nx=16, ny=16, nr=12)


def kpp_config():
    return tsyn.kpp_gyre_config(**SIZE, depth=300.0)


def fluxform_config():
    """The gyre (flux-form momentum, LINEAR EOS, explicit vertical
    diffusion, AB-2) on the kpp-gyre's levels and profiles, with KPP."""
    k = kpp_config()
    return tsyn.gyre_config(**SIZE, useKPP=True, delR=k.delR, tRef=k.tRef,
                            sRef=k.sRef)


def _jax_experiment(cfg, port_objs):
    """The JAX package's objects for cfg, with the port's heat fluxes and
    the same KPP settings."""
    jcfg = jax_config(cfg)
    grid, state, forcing, op = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    pf = port_objs[2]
    forcing = dataclasses.replace(forcing, Qnet=jnp.asarray(pf.Qnet.numpy()),
                                  Qsw=jnp.asarray(pf.Qsw.numpy()))
    kpp = jkpp.KPP(jcfg, grid, {}, options=set(port_objs[4].options))
    return JaxExperiment(cfg=jcfg, grid=grid, state=state, forcing=forcing,
                         op=op, kpp=kpp)


def _run_both(cfg, eager):
    objs = tsyn.kpp_gyre_setup(cfg, dtype=torch.float64, device="cpu")
    jexp = _jax_experiment(cfg, objs)
    if eager:
        with jax.disable_jit():
            want = jexp.run(n_steps=N_STEPS)
    else:
        want = jexp.run(n_steps=N_STEPS)
    exp = Experiment(cfg, *objs)
    return exp, exp.run(n_steps=N_STEPS), jexp, want


def _check_records(got, want):
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for rec, ref in zip(got, want):
        assert rec.get("cg2d_iters") == ref.get("cg2d_iters"), rec["iter"]
        dig = record_digits(rec, ref)
        missing = {k for k in ref if k.startswith("dynstat_")} - set(dig)
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


@pytest.fixture(scope="module")
def kpp_gyre():
    return _run_both(kpp_config(), eager=True)


def test_kpp_gyre_ten_steps(kpp_gyre):
    exp, got, jexp, want = kpp_gyre
    _check_records(got, want)
    ol = exp.cfg.olx
    for name in ("theta", "salt", "uVel", "vVel", "etaN"):
        d = digits(interior(getattr(exp.state, name), ol),
                   interior(np.asarray(getattr(jexp.state, name)), ol))
        assert d >= 8.5, (name, d)


def test_kpp_gyre_covers_both_regimes(kpp_gyre):
    """After 10 steps the boundary layer is shallow and stable in the
    heated south and deep and convective, with a nonlocal flux, in the
    cooled north, so both branches of BLDEPTH and BLMIX stay tested."""
    exp = kpp_gyre[0]
    cfg, grid, st = exp.cfg, exp.grid, exp.state
    forc = load_fields(exp.forcing)
    sf = tth.surface_forcing(cfg, grid, st, forc)
    kappa = tth.tracer_kappa(cfg, grid, cfg.diffKrT)
    f = exp.kpp.calc(st.uVel, st.vVel, st.theta, st.salt, st.totPhiHyd,
                     sf.tauU, sf.tauV, sf.sfT, sf.sfS, forc.Qsw, kappa, kappa)
    wet = grid.maskC[0] > 0
    hbl = f["hbl"][wet]
    assert float(hbl.min()) < 10.0 and float(hbl.max()) > 40.0
    assert int((f["ghat"].abs().sum(dim=0) > 0).sum()) > 0
    assert float(f["diffKzT"].max()) > 1e-2


def test_fluxform_gyre_with_kpp():
    exp, got, jexp, want = _run_both(fluxform_config(), eager=False)
    _check_records(got, want)
