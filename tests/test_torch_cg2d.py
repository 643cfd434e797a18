"""PyTorch port: the cg2d solve (plain twin of kernel A) against the JAX
package, with the min-residual selection on and off.

Both packages iterate the same PCG in the same element-wise order; only the
order of the global dot-product sums differs (XLA's reduction against the
port's fixed block order, which the CUDA kernels share). The solve
amplifies that last-bit difference, so the bar is 10 digits for x and the
first residual. The last residual sits at the 1e-7 convergence floor of
the normalised system, where it is a difference of nearly equal sums: it is
held to 9 digits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.ops.stencil import interior_mask
from mitgcm_tpu.solver import cg2d as jcg
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.solver import cg2d as tcg
from mitgcm_tpu_torch.solver.cg2d import CG2DOperator
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils.compare import digits, interior

torch.set_num_threads(1)


@pytest.mark.parametrize("use_min_res", [1, 0])
def test_cg2d_solve(use_min_res):
    cfg = jsyn.gyre_config(nx=32, ny=32, nr=4)
    cfg.cg2dUseMinResSol = use_min_res
    grid, _, _, op = jsyn.gyre_setup(cfg, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    shape = grid.rA.shape
    mask = np.asarray(grid.maskInC) * np.asarray(
        interior_mask(shape, cfg.oly, cfg.olx, jnp.float64))
    b = rng.standard_normal(shape) * mask
    x0 = 0.1 * rng.standard_normal(shape) * mask

    want = jcg.cg2d(cfg, grid, op, jnp.asarray(b), jnp.asarray(x0))
    top = convert.from_arrays(CG2DOperator, convert.arrays_of(op),
                              device="cpu")
    got = tcg.cg2d(cfg, top, torch.from_numpy(b), torch.from_numpy(x0))

    assert got.n_iters == int(want.n_iters)
    assert got.n_iters > 10
    ol = cfg.olx
    assert digits(interior(got.x, ol), interior(np.asarray(want.x), ol)) >= 10
    assert digits(float(got.first_residual),
                  float(want.first_residual)) >= 10
    assert digits(float(got.last_residual), float(want.last_residual)) >= 9
    assert got.host_syncs == got.n_iters + 2
