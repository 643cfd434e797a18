"""PyTorch port: 10 steps of the 64x64x4 wind-driven gyre (entry()'s size)
against the JAX package, in float64 on the CPU.

Every monitor statistic and the first cg2d residual must match to 10
digits on every step, the cg2d iteration counts must be equal, and the
final u, v, theta and etaN interiors must match to 10 digits. Statistics
are judged against their field's amplitude (see utils/compare.py). The
last cg2d residual is held to 9 digits: it is the norm of a residual at
the 1e-7 convergence floor, and the two packages sum their dot products in
different orders (measured: 9.5 digits at worst, on step 7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model.experiment import Experiment as JaxExperiment
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.core.state import Forcing, State
from mitgcm_tpu_torch.model.experiment import Experiment
from mitgcm_tpu_torch.solver.cg2d import CG2DOperator
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits

torch.set_num_threads(1)

N_STEPS = 10
SIZE = dict(nx=64, ny=64, nr=4)


@pytest.fixture(scope="module")
def reference():
    cfg = jsyn.gyre_config(**SIZE)
    setup = jsyn.gyre_setup(cfg, dtype=jnp.float64)
    exp = JaxExperiment(cfg=cfg, grid=setup[0], state=setup[1],
                        forcing=setup[2], op=setup[3])
    return setup, exp.run(n_steps=N_STEPS), exp.state


def _port_experiment(source, jax_setup):
    cfg = tsyn.gyre_config(**SIZE)
    if source == "port setup":
        objs = tsyn.gyre_setup(cfg, dtype=torch.float64, device="cpu")
    else:   # the JAX package's own objects, carried across
        objs = [convert.from_arrays(cls, convert.arrays_of(obj), device="cpu")
                for cls, obj in zip((Grid, State, Forcing, CG2DOperator),
                                    jax_setup)]
    return Experiment(cfg, *objs)


@pytest.mark.parametrize("source", ["port setup", "converted"])
def test_gyre_ten_steps(reference, source):
    jax_setup, want, want_state = reference
    exp = _port_experiment(source, jax_setup)
    got = exp.run(n_steps=N_STEPS)
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for rec, ref in zip(got, want):
        assert rec.get("cg2d_iters") == ref.get("cg2d_iters"), rec["iter"]
        dig = record_digits(rec, ref)
        missing = {k for k in ref if k.startswith("dynstat_")} - set(dig)
        assert not missing, missing
        for key, d in dig.items():
            if key.startswith(("dynstat_", "cg2d_init_res")):
                assert d >= 10, (rec["iter"], key, d)
            elif key == "cg2d_last_res":
                assert d >= 9, (rec["iter"], key, d)
    ol = exp.cfg.olx
    for name in ("uVel", "vVel", "theta", "etaN"):
        d = digits(interior(getattr(exp.state, name), ol),
                   interior(np.asarray(getattr(want_state, name)), ol))
        assert d >= 10, (name, d)
