"""PyTorch port: cg2dExactSums' ordered dot (solver/cg2d.py:_dot_seq, the
twin of kernel A-exact's sums) and the exact-gyre against the JAX package,
on the CPU, in float64 unless named.

  - `_dot_seq` is bit-equal to the JAX package's `_dot_seq_fortran` on
    seeded products in float64 and float32, with tiles that divide the
    interior and with the one-tile fallback in either direction;
  - one 16x16 solve under the flag, on 8 x 8 and on 4 x 4 tiles, is
    bit-equal to JAX's `_cg2d_raw` evaluated op by op (jax.disable_jit),
    iterations and residuals included;
  - 2 steps of a 16x16x4 exact-gyre on 4 x 4 tiles are bit-equal to JAX's
    step op by op: u, v, w, theta, etaN and the cg2d residuals;
  - the exact-gyre (the gyre with cg2dExactSums on 16 x 16 tiles) over 10
    steps at 32x32x4 against JAX's jitted step: equal iterations, every
    statistic, cg2d_init_res and the fields to 11 digits, cg2d_last_res to
    12 digits against the solve's first residual. JAX's compiled step
    rounds some of the step's products otherwise than its op-by-op
    evaluation, whatever the dot's order (measured: the statistics and
    cg2d_init_res 11.28 digits at worst, the fields 11.16, vVel the
    lowest), so the 12 digits asked of the statistics and fields hold only
    op by op, where the fields are equal (ROADMAP Queue 3).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model.experiment import Experiment as JaxExperiment
from mitgcm_tpu.solver import cg2d as jcg
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.model.experiment import Experiment
from mitgcm_tpu_torch.solver import cg2d as tcg
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits
from test_torch_config import jax_config

torch.set_num_threads(1)

N_STEPS = 10
SIZE = dict(nx=32, ny=32, nr=4)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("tiles", [(8, 16), (16, 16), (5, 16), (8, 7),
                                   (0, 0)],
                         ids=["8x16", "16x16", "fallback-y", "fallback-x",
                              "unset"])
def test_dot_seq_bit_equal(dtype, tiles):
    cfg = tsyn.gyre_config(nx=32, ny=24, nr=2, sNy=tiles[0], sNx=tiles[1])
    rng = np.random.default_rng(11)
    shape = (cfg.ny + 2 * cfg.oly, cfg.nx + 2 * cfg.olx)
    a = rng.standard_normal(shape).astype(dtype)
    c = (rng.standard_normal(shape) * 1e3).astype(dtype)
    imask = np.zeros(shape, dtype)
    imask[cfg.oly:-cfg.oly, cfg.olx:-cfg.olx] = 1.0
    v = a * c * imask
    want = np.asarray(jcg._dot_seq_fortran(jax_config(cfg), jnp.asarray(v)))
    got = tcg._dot_seq(torch.from_numpy(v), cfg)
    assert got.dtype == getattr(torch, dtype)
    assert got.numpy().tobytes() == want.tobytes()
    # the tree order of kernel A differs in its last bits
    assert tcg.exact_tiles(cfg) == (
        tiles[0] if tiles[0] and cfg.ny % tiles[0] == 0 else cfg.ny,
        tiles[1] if tiles[1] and cfg.nx % tiles[1] == 0 else cfg.nx)


@pytest.mark.parametrize("use_min,tile", [(0, 8), (1, 4)])
def test_exact_solve_matches_jax(use_min, tile):
    """Against JAX's _cg2d_raw op by op (jax.disable_jit): the same sums in
    the same order give the same bits, iterations and residuals included.
    JAX's compiled loop rounds some products otherwise (11.3 digits of x
    measured), whatever the dot's order."""
    cfg = tsyn.exact_gyre_config(nx=16, ny=16, nr=4, tile=tile)
    cfg.cg2dUseMinResSol = use_min
    jcfg = jax_config(cfg)
    jgrid, _, _, jop = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    _, _, _, op = tsyn.gyre_setup(cfg, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    shape = tuple(op.aC.shape)
    b = rng.standard_normal(shape) * 1e-3
    x0 = rng.standard_normal(shape) * 1e-1
    with jax.disable_jit():
        want = jcg._cg2d_raw(jcfg, jgrid, jop, jnp.asarray(b),
                             jnp.asarray(x0))
    got = tcg.cg2d(cfg, op, torch.from_numpy(b), torch.from_numpy(x0))
    assert got.n_iters == int(want.n_iters)
    for g, w in ((got.x, want.x), (got.first_residual, want.first_residual),
                 (got.last_residual, want.last_residual)):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_exact_gyre_bit_equal_op_by_op():
    cfg = tsyn.exact_gyre_config(nx=16, ny=16, nr=4, tile=4)
    jcfg = jax_config(cfg)
    jsetup = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    jexp = JaxExperiment(cfg=jcfg, grid=jsetup[0], state=jsetup[1],
                         forcing=jsetup[2], op=jsetup[3])
    with jax.disable_jit():
        want = jexp.run(n_steps=2)
    exp = Experiment(cfg, *tsyn.gyre_setup(cfg, dtype=torch.float64,
                                           device="cpu"))
    got = exp.run(n_steps=2)
    for rec, ref in zip(got[1:], want[1:]):
        for key in ("cg2d_iters", "cg2d_init_res", "cg2d_last_res"):
            assert rec[key] == ref[key], (rec["iter"], key)
    for name in ("uVel", "vVel", "wVel", "theta", "etaN"):
        assert np.array_equal(getattr(exp.state, name).numpy(),
                              np.asarray(getattr(jexp.state, name))), name


@pytest.fixture(scope="module")
def exact_gyre():
    cfg = tsyn.exact_gyre_config(**SIZE)
    grid, state, forcing, op = tsyn.gyre_setup(cfg, dtype=torch.float64,
                                               device="cpu")
    jcfg = jax_config(cfg)
    jsetup = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    jexp = JaxExperiment(cfg=jcfg, grid=jsetup[0], state=jsetup[1],
                         forcing=jsetup[2], op=jsetup[3])
    want = jexp.run(n_steps=N_STEPS)
    exp = Experiment(cfg, grid, state, forcing, op)
    return exp, exp.run(n_steps=N_STEPS), jexp, want


def test_exact_gyre_ten_steps(exact_gyre):
    exp, got, jexp, want = exact_gyre
    assert exp.cfg.cg2dExactSums and (exp.cfg.sNx, exp.cfg.sNy) == (16, 16)
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for rec, ref in zip(got, want):
        assert rec.get("cg2d_iters") == ref.get("cg2d_iters"), rec["iter"]
        dig = record_digits(rec, ref)
        missing = {k for k in ref if k.startswith("dynstat_")} - set(dig)
        assert not missing, missing
        for key, d in dig.items():
            if key == "cg2d_last_res":
                e = abs(rec[key] - ref[key]) / ref["cg2d_init_res"]
                d = 16.0 if e == 0.0 else -math.log10(e)
                assert d >= 12, (rec["iter"], key, d)
            else:
                assert d >= 11, (rec["iter"], key, d)


def test_exact_gyre_fields(exact_gyre):
    exp, _, jexp, _ = exact_gyre
    ol = exp.cfg.olx
    for name in ("uVel", "vVel", "theta", "etaN"):
        d = digits(interior(getattr(exp.state, name), ol),
                   interior(np.asarray(getattr(jexp.state, name)), ol))
        assert d >= 11, (name, d)


def test_exact_sums_move_the_answer(exact_gyre):
    """The ordered dot is not the tree sum: the same gyre without the flag
    steps to other bits (so the path under test is the exact one)."""
    exp, _, _, _ = exact_gyre
    cfg = tsyn.gyre_config(**SIZE)
    objs = tsyn.gyre_setup(cfg, dtype=torch.float64, device="cpu")
    plain = Experiment(cfg, *objs)
    plain.run(n_steps=N_STEPS, collect_monitor=False)
    assert not torch.equal(plain.state.etaN, exp.state.etaN)
