"""PyTorch port: the idemix-gyre (the ggl90-gyre with GGL90's IDEMIX
internal-wave energy, forced by the tidal and wind flux maps of
synthetic.idemix_maps, and the Langmuir parameterization) against the JAX
package, 10 steps at 16x16x12 (depth 300 m) in float64 on the CPU, JAX
evaluated op by op (jax.disable_jit) as in tests/test_torch_ggl90_gyre.py.

The cg2d iteration counts are equal on every step. The two packages sum
the cg2d dot products in different orders, which moves the residuals in
their last digits from the first step on, and the gyre carries those
differences: GGL90.calc itself matches JAX to 14.5 digits or more on one
step (tests/test_torch_idemix.py), but with Langmuir's mixing length (ten
times the limited one in most interfaces) the state is more sensitive than
the ggl90-gyre's. Measured on this configuration: the monitor statistics
agree to 11.50 digits or more, cg2d_init_res to 10.68, cg2d_last_res to
15.5 against the solve's first residual, the state fields to 11.16,
GGL90TKE to 10.54 and IDEMIX_E to 11.04 (with IDEMIX alone: 11.4 or
more on all of them). The bars keep a margin under those: 11.4, 10.5,
12, 11, 10.4 and 10.9. Coverage: after 10 steps IDEMIX_E is positive in
over 1000 cells, and Langmuir's length differs from the mixing length
somewhere.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu_torch.model import ggl90 as tg9
from mitgcm_tpu_torch.model import thermodynamics as tth
from mitgcm_tpu_torch.ops.eos import find_rho
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits
from test_torch_ggl90_gyre import jax_experiment, port_experiment

torch.set_num_threads(1)

N_STEPS = 10
SIZE = dict(nx=16, ny=16, nr=12, depth=300.0)
FIELDS = ("theta", "salt", "uVel", "vVel", "etaN")


def run_both(cfg):
    """The port's and JAX's runs of a ggl90-gyre variant, JAX with the
    port's IDEMIX flux maps when useIDEMIX: (exp, records, jexp, records)."""
    exp = port_experiment(cfg)
    jexp = jax_experiment(cfg, (exp.grid, exp.state, exp.forcing, exp.op,
                                exp.ggl90))
    if exp.ggl90.p["useIDEMIX"]:
        ol = cfg.olx
        wet = exp.grid.maskC[0, ol:-ol, ol:-ol].numpy()
        maps = tsyn.idemix_maps(cfg, wet, torch.float64, "cpu")
        jexp.ggl90.init_idemix_forc(lambda f: jnp.asarray(maps[f].numpy()))
    got = exp.run(n_steps=N_STEPS)
    with jax.disable_jit():
        want = jexp.run(n_steps=N_STEPS)
    return exp, got, jexp, want


def check_gyre(exp, got, jexp, want, bars):
    """Hold the port's run to JAX's: equal cg2d iterations, and the digits
    of `bars` for the monitor statistics ("stats"), cg2d_init_res
    ("init_res"), cg2d_last_res against the solve's first residual
    ("last_res"), the state fields ("fields") and each further state field
    bars names."""
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for rec, ref in zip(got, want):
        assert rec.get("cg2d_iters") == ref.get("cg2d_iters"), rec["iter"]
        dig = record_digits(rec, ref)
        missing = {k for k in ref if k.startswith("dynstat_")} - set(dig)
        assert not missing, missing
        for key, d in dig.items():
            if key == "cg2d_init_res":
                assert d >= bars["init_res"], (rec["iter"], key, d)
            elif key == "cg2d_last_res":
                err = abs(rec[key] - ref[key]) / ref["cg2d_init_res"]
                d = 16.0 if err == 0.0 else -math.log10(err)
                assert d >= bars["last_res"], (rec["iter"], key, d)
            else:
                assert d >= bars["stats"], (rec["iter"], key, d)
    ol = exp.cfg.olx
    extra = [k for k in bars if k not in ("stats", "init_res", "last_res",
                                          "fields")]
    for name in FIELDS + tuple(extra):
        d = digits(interior(getattr(exp.state, name), ol),
                   interior(np.asarray(getattr(jexp.state, name)), ol))
        assert d >= bars.get(name, bars["fields"]), (name, d)


@pytest.fixture(scope="module")
def idemix_gyre():
    cfg = tsyn.idemix_gyre_config(**SIZE)
    return run_both(cfg)


def test_idemix_gyre_ten_steps(idemix_gyre):
    check_gyre(*idemix_gyre, bars=dict(stats=11.4, init_res=10.5,
                                       last_res=12, fields=11.0,
                                       GGL90TKE=10.4, IDEMIX_E=10.9))


def test_idemix_gyre_covers_idemix_and_langmuir(idemix_gyre):
    """IDEMIX's energy has spread over the wet interfaces, and the Langmuir
    length is LC_Gamma times the mixing length in places."""
    exp = idemix_gyre[0]
    cfg, grid, st, g9 = exp.cfg, exp.grid, exp.state, exp.ggl90
    assert g9.p["useIDEMIX"] and g9.p["useLANGMUIR"]
    E = interior(st.IDEMIX_E, cfg.olx)
    assert int((E > 0.0).sum()) > 1000
    rho = find_rho(cfg, grid, st.theta, st.salt) * grid.maskC
    sigmaR = tth.calc_sigmaR(cfg, grid, rho, st.theta, st.salt)
    Nsq = tg9.nsq(cfg, sigmaR)
    mskLoc = grid.maskC * torch.cat([grid.maskC[:1], grid.maskC[:-1]])
    ML = tg9.SQRTTWO * torch.sqrt(st.GGL90TKE) / torch.sqrt(
        torch.clamp(Nsq, min=tg9.GGL90EPS))
    ML = torch.cat([torch.full_like(ML[:1], 1e-8), ML[1:] * mskLoc[1:]])
    ML, LCML, _ = g9.mixinglength(ML)
    assert bool((LCML[1:] != ML[1:])[mskLoc[1:] > 0].any())
