"""PyTorch port: the evp-ice-gyre (the ice-gyre with lab_sea/input.hb87's
dynamics: adaptive EVP with 500 subcycles, EVP* and revised EVP, and
Hibler-Bryan stress coupling; utils/synthetic.py:evp_ice_gyre_config)
against the JAX package at 16x16x12 (depth 300 m) in float64 on the CPU.

500 unconverged aEVP subcycles amplify roundoff by about 1e12 a step: in
the port alone, a relative change of 1e-15 in HEFF moves uIce in its fourth
digit after one step (1e-12 after 100 subcycles). JAX's jitted step and
JAX op by op disagree with each other in that way, and the port, whose
EVP twins replay JAX's operation order (15 digits and more over 30
subcycles in tests/test_torch_evp.py), differs from either by the ulps of
the step's other parts (exp, the ocean's solve). So:
  - the evp-ice-gyre with its subcycles cut to 20 (EVP_SHORT), where the
    amplification stays below 1e3, is held against JAX op by op
    (jax.disable_jit) for 3 steps with the bars of the ice-gyre
    (tests/test_torch_ice_gyre.py): equal cg2d iterations, every monitor
    statistic 10 digits, cg2d_init_res 9 and cg2d_last_res 12 against the
    first residual, the ice (sigma included, on the whole padded array) and
    the ocean's fields 10 digits (measured: statistics 12.48 or more, the
    seaice_* ones 11.74, cg2d_init_res 12.01, fields 11.44, sigma 13.16);
    and so is a variant with SEAICE_clipVelocities under a tenfold wind,
    where the clip binds (unclipped, |uIce| reaches 0.494 m/s);
  - the evp-ice-gyre itself, 500 subcycles, is held against JAX's jitted
    step for 2 steps at the digits it reaches (ROADMAP Queue 3, documented
    bars): every statistic 3 digits (measured 3.18, seaice_uice_min; the
    ocean's 4.70), the ice thickness, concentration and snow 6.5 (measured
    7.00), theta and salt 7 (7.58, 8.93);
  - a pickup_seaice that the JAX package writes, EVP stresses included, is
    read by the port with every field equal.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import experiment as jexp
from mitgcm_tpu.model import kpp as jkpp
from mitgcm_tpu.model import seaice as jseaice
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.model.experiment import Experiment, read_pickup
from mitgcm_tpu_torch.model.seaice import params_from_namelists
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits
from test_torch_config import jax_config
from test_torch_ice_gyre import FORCING, ICE_FIELDS

torch.set_num_threads(1)

SIZE = dict(nx=16, ny=16, nr=12, depth=300.0)
EVP_SHORT = {**tsyn.EVP_ICE_GYRE_SEAICE, "SEAICEnEVPstarSteps": 20}
OCEAN = ("theta", "salt", "uVel", "etaN")


def jax_objects(cfg, objs, settings):
    """The JAX package's Experiment for the port's evp-ice-gyre objects:
    the same grid, forcing (the wind too) and initial ice, KPP and a SeaIce
    of the same settings."""
    jcfg = jax_config(cfg)
    jcfg.seaice = jseaice.params_from_namelists(jcfg, settings, {})
    grid, state, forcing, op = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    _, pstate, pforcing, _, pkpp, _ = objs
    forcing = dataclasses.replace(forcing, **{
        k: jnp.asarray(getattr(pforcing, k).numpy())
        for k in FORCING + ("fu", "fv")})
    state = dataclasses.replace(state, **{
        k: jnp.asarray(getattr(pstate, k).numpy())
        for k in ICE_FIELDS + ("siHSALT", "SItracer", "siSigma")})
    kpp = jkpp.KPP(jcfg, grid, {}, options=set(pkpp.options))
    seaice = jseaice.SeaIce(jcfg, grid, jcfg.seaice)
    return jexp.Experiment(cfg=jcfg, grid=grid, state=state,
                           forcing=forcing, op=op, kpp=kpp, seaice=seaice)


def pair(settings, wind=1.0):
    """The port's and the JAX package's Experiment of the evp-ice-gyre with
    these sea-ice settings (and the wind scaled by `wind`)."""
    cfg = tsyn.evp_ice_gyre_config(**SIZE)
    cfg.seaice = params_from_namelists(cfg, settings)
    objs = tsyn.ice_gyre_setup(cfg, dtype=torch.float64, device="cpu")
    grid, state, forcing, op, kpp, seaice = objs
    forcing.fu, forcing.fv = forcing.fu * wind, forcing.fv * wind
    jx = jax_objects(cfg, objs, settings)
    return Experiment(cfg, grid, state, forcing, op, kpp=kpp,
                      seaice=seaice), jx


def hold(got, want, bar, init_res_bar, last_res_bar):
    """Every record's statistics to `bar` digits, cg2d_init_res to
    init_res_bar and cg2d_last_res to last_res_bar against the solve's first
    residual; equal cg2d iterations."""
    for rec, ref in zip(got, want):
        assert rec.get("cg2d_iters") == ref.get("cg2d_iters"), rec["iter"]
        dig = record_digits(rec, ref)
        missing = {k for k in ref if k.startswith(("dynstat_", "seaice_"))
                   } - set(dig)
        assert not missing, missing
        for key, d in dig.items():
            if key == "cg2d_init_res":
                assert d >= init_res_bar, (rec["iter"], key, d)
            elif key == "cg2d_last_res":
                err = abs(rec[key] - ref[key]) / ref["cg2d_init_res"]
                d = 16.0 if err == 0.0 else -math.log10(err)
                assert d >= last_res_bar, (rec["iter"], key, d)
            else:
                assert d >= bar, (rec["iter"], key, d)


def fields_digits(exp, jx):
    ol = exp.cfg.olx
    out = {name: digits(interior(getattr(exp.state, name), ol),
                        interior(np.asarray(getattr(jx.state, name)), ol))
           for name in ICE_FIELDS + OCEAN}
    out["siSigma"] = digits(exp.state.siSigma.numpy(),
                            np.asarray(jx.state.siSigma))
    return out


@pytest.mark.parametrize("clip", [False, True], ids=["hb87", "hb87-clip"])
def test_evp_gyre_short_against_jax(clip):
    settings = {**EVP_SHORT, "SEAICE_clipVelocities": clip}
    exp, jx = pair(settings, wind=10.0 if clip else 1.0)
    assert exp.seaice.p.useHB87stressCoupling and exp.seaice.p.useEVP
    with jax.disable_jit():
        want = jx.run(n_steps=3)
    got = exp.run(n_steps=3)
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    hold(got, want, 10, 9, 12)
    for name, d in fields_digits(exp, jx).items():
        assert d >= 10, (name, d)
    u = exp.state.uIce
    assert float(u.abs().max()) > 1e-3
    if clip:   # the clip bound: some ice drifts at the cap
        assert float(u.abs().max()) == pytest.approx(0.40, abs=0.0)


def test_evp_gyre_against_jax_jitted():
    exp, jx = pair(tsyn.EVP_ICE_GYRE_SEAICE)
    assert exp.seaice.p.nEVPstarSteps == 500
    want = jx.run(n_steps=2)
    got = exp.run(n_steps=2)
    hold(got, want, 3, 3, 3)
    dig = fields_digits(exp, jx)
    for name in ("siAREA", "siHEFF", "siHSNOW"):
        assert dig[name] >= 6.5, (name, dig[name])
    for name in ("theta", "salt"):
        assert dig[name] >= 7, (name, dig[name])
    assert bool(torch.isfinite(exp.state.siSigma).all())


def test_jax_evp_pickup_read_by_port(tmp_path):
    _, jx = pair(EVP_SHORT)
    jx.run(n_steps=1, collect_monitor=False)
    jexp.write_pickup(jx, str(tmp_path), 1)
    exp, _ = pair(EVP_SHORT)
    read_pickup(exp, str(tmp_path), 1)
    ol = exp.cfg.olx
    sig = np.asarray(jx.state.siSigma)
    assert np.abs(sig).max() > 0.0
    for name in ICE_FIELDS + ("siSigma",):
        want = np.asarray(getattr(jx.state, name))[..., ol:-ol, ol:-ol]
        assert np.array_equal(getattr(exp.state, name).numpy()[
            ..., ol:-ol, ol:-ol], want), name
