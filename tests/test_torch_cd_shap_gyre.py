"""PyTorch port: the cd-gyre, the cd-vi-gyre (the gyre and the vi-gyre
under the CD scheme's Coriolis, tauCD = 321428 s) and the shap-gyre (the
gyre with the Shapiro filter, 4 index-space passes on the velocities and
on each tracer) against the JAX package, 10 steps at 16x16x4 in float64
on the CPU.

The cd-gyre and the shap-gyre run against JAX's jitted step; the
cd-vi-gyre against JAX op by op (jax.disable_jit), as
tests/test_torch_vi_gyre.py runs the vi-gyre: JAX's jitted vi-gyre step
disagrees with its own op-by-op evaluation at about 9 digits (ROADMAP
Queue 3). Every monitor statistic agrees to 10 digits on every step and the
cg2d iteration counts are equal (cg2d_init_res to 10 digits,
cg2d_last_res to 12 against the solve's first residual). A 2+2 restart
through the pickups (pickup_cd on the CD paths) is bit-equal to 4 straight
steps, JAX's reader takes the port's pickup_cd, and every refusal of the
slice is raised by name.
"""

import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model.experiment import Experiment as JaxExperiment
from mitgcm_tpu.model.experiment import read_pickup as jread_pickup
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.ad import adjoint as tadjoint
from mitgcm_tpu_torch.model import step as tstep
from mitgcm_tpu_torch.model.experiment import (Experiment, read_pickup,
                                               write_pickup)
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits
from test_torch_config import jax_config

torch.set_num_threads(1)

N_STEPS = 10
SIZE = dict(nx=16, ny=16, nr=4)
PATHS = ("cd_gyre", "cd_vi_gyre", "shap_gyre")
FIELDS = ("uVel", "vVel", "wVel", "theta", "salt", "etaN", "guNm1", "gvNm1",
          "gtNm1", "gsNm1", "guNm2", "gvNm2", "gtNm2", "gsNm2", "PmEpR")
CD_FIELDS = ("uVelD", "vVelD", "uNM1", "vNM1", "etaNm1")


def port_experiment(kind, **kw):
    cfg = getattr(tsyn, f"{kind}_config")(**SIZE, **kw)
    return Experiment(cfg, *tsyn.gyre_setup(cfg, dtype=torch.float64,
                                            device="cpu"))


def jax_experiment(exp):
    jcfg = jax_config(exp.cfg)
    grid, state, forcing, op = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    return JaxExperiment(cfg=jcfg, grid=grid, state=state, forcing=forcing,
                         op=op)


@pytest.fixture(scope="module", params=PATHS)
def run(request):
    kind = request.param
    exp = port_experiment(kind)
    jexp = jax_experiment(exp)
    if kind == "cd_vi_gyre":
        with jax.disable_jit():
            want = jexp.run(n_steps=N_STEPS)
    else:
        want = jexp.run(n_steps=N_STEPS)
    return kind, exp, exp.run(n_steps=N_STEPS), jexp, want


def test_ten_steps(run):
    kind, exp, got, jexp, want = run
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for rec, ref in zip(got, want):
        assert rec.get("cg2d_iters") == ref.get("cg2d_iters"), rec["iter"]
        dig = record_digits(rec, ref)
        missing = {k for k in ref if k.startswith("dynstat_")} - set(dig)
        assert not missing, missing
        for key, d in dig.items():
            if key == "cg2d_last_res":
                err = abs(rec[key] - ref[key]) / ref["cg2d_init_res"]
                d = 16.0 if err == 0.0 else -math.log10(err)
                assert d >= 12, (kind, rec["iter"], key, d)
            else:
                assert d >= 10, (kind, rec["iter"], key, d)
    ol = exp.cfg.olx
    names = ("theta", "uVel", "vVel", "etaN") + (
        CD_FIELDS if exp.cfg.useCDscheme else ())
    for name in names:
        d = digits(interior(getattr(exp.state, name), ol),
                   interior(np.asarray(getattr(jexp.state, name)), ol))
        assert d >= 10, (kind, name, d)


def test_cd_moves_the_flow():
    """The CD scheme changes the flow: after 3 steps the cd-gyre's eta and
    u differ from the gyre's, and the D-grid velocities are nonzero."""
    cd, gyre = port_experiment("cd_gyre"), port_experiment("cd_gyre")
    gyre.cfg.useCDscheme = False
    for e in (cd, gyre):
        e.run(n_steps=3, collect_monitor=False)
    assert not torch.allclose(cd.state.uVel, gyre.state.uVel)
    assert float(cd.state.uVelD.abs().max()) > 0.0
    assert gyre.state.uVelD is None


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
    names = FIELDS + (CD_FIELDS if e4.cfg.useCDscheme else ())
    differ = [n for n in names
              if not torch.equal(getattr(e4.state, n)[..., ol:-ol, ol:-ol],
                                 getattr(e22.state, n)[..., ol:-ol, ol:-ol])]
    assert not differ, differ


def test_jax_reads_pickup_cd(tmp_path):
    """JAX's reader takes the port's pickup and pickup_cd: its state holds
    the port's D-grid velocities, uNM1, vNM1 and etaNm1."""
    exp = port_experiment("cd_vi_gyre")
    exp.run(n_steps=3, collect_monitor=False)
    write_pickup(exp, str(tmp_path), myIter=3)
    jexp = jax_experiment(port_experiment("cd_vi_gyre"))
    jread_pickup(jexp, str(tmp_path), myIter=3)
    ol = exp.cfg.olx
    for name in CD_FIELDS:
        want = interior(getattr(exp.state, name), ol)
        got = interior(np.asarray(getattr(jexp.state, name)), ol)
        assert np.array_equal(got, want), name
        assert np.abs(want).max() > 0.0, name


def test_pickup_cd_needed(tmp_path):
    """A CD run refuses to restart without pickup_cd."""
    exp = port_experiment("cd_gyre")
    exp.run(n_steps=1, collect_monitor=False)
    write_pickup(exp, str(tmp_path), myIter=1)
    (tmp_path / "pickup_cd.0000000001.data").unlink()
    with pytest.raises(FileNotFoundError, match="pickup_cd"):
        read_pickup(port_experiment("cd_gyre"), str(tmp_path), myIter=1)


# the Shapiro settings the port refuses, by name (model/shap_filt.py:
# refusals): the JAX step ignores shap_filt_uvStar=T and nShapS; JAX raises
# on the other two
SHAP_REFUSALS = {
    "shap_filt_uvStar=T with nShapUV>0": {"shap_filt_uvStar": True},
    "nShapS=2 != nShapT=4": {"nShapS": 2},
    "Shap_funct=4": {"Shap_funct": 4},
    "nShapUVPhys=2 with nShapUV=4": {"nShapUVPhys": 2},
}


@pytest.mark.parametrize("name", SHAP_REFUSALS)
def test_shap_refusals(name):
    cfg = tsyn.shap_gyre_config(**SIZE, shap=SHAP_REFUSALS[name])
    with pytest.raises(NotImplementedError, match=re.escape(name)):
        tstep.check_supported(cfg)
    cfg.shap = None
    with pytest.raises(NotImplementedError,
                       match=r"useSHAP_FILT without ShapParams"):
        tstep.check_supported(cfg)


def test_paths_accepted_and_adjoint_refuses():
    """check_supported takes the three paths (and uvStar=T when only the
    tracers are filtered); the adjoint refuses useCDscheme and
    useSHAP_FILT by name."""
    for kind in PATHS:
        cfg = getattr(tsyn, f"{kind}_config")(**SIZE)
        tstep.check_supported(cfg)
        flag = "useCDscheme" if cfg.useCDscheme else "useSHAP_FILT"
        with pytest.raises(NotImplementedError, match=flag):
            tadjoint.check_adjoint_supported(cfg)
    cfg = tsyn.shap_gyre_config(**SIZE, shap={"shap_filt_uvStar": True,
                                               "nShapUV": 0})
    tstep.check_supported(cfg)
    cfg = dataclasses.replace(tsyn.cd_gyre_config(**SIZE),
                              staggerTimeStep=True)
    with pytest.raises(NotImplementedError, match="staggerTimeStep"):
        tstep.check_supported(cfg)
