"""PyTorch port: the som-gyre (the ggl90-gyre with theta advected by
Prather's limited second-order moments, scheme 81, and salt by the
unlimited scheme 80) against the JAX package, 10 steps at 16x16x12 (depth
300 m) in float64 on the CPU, JAX evaluated op by op (jax.disable_jit) as
in tests/test_torch_ggl90_gyre.py.

The cg2d iteration counts are equal on every step. Measured on this
configuration: the monitor statistics agree to 12.72 digits or more,
cg2d_init_res to 11.14, cg2d_last_res to 16.0 against the solve's first
residual, the state fields to 11.65, GGL90TKE to 11.50 and the moments to
11.83; the bars: 11.5, 11, 12, 11.5, 11 and 11. Coverage: the moments
develop in every slot and are finite after the end-of-step fill (which
overwrites SOM's non-finite first padded row and column). Prather's
limiter clips nothing on this warm, smooth theta (10-24 degC: no slope
reaches 1.5 times a cell's content in 10 steps, measured), so its branches
are held in tests/test_torch_som.py.
"""

import pytest
import torch

from mitgcm_tpu_torch.model import som as tsom
from mitgcm_tpu_torch.utils import synthetic as tsyn
from test_torch_idemix_gyre import SIZE, check_gyre, run_both

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def som_gyre():
    cfg = tsyn.som_gyre_config(**SIZE)
    assert (cfg.tempAdvScheme, cfg.saltAdvScheme) == (81, 80)
    assert cfg.tempVertAdvScheme is None and cfg.saltVertAdvScheme is None
    return run_both(cfg)


def test_som_gyre_ten_steps(som_gyre):
    check_gyre(*som_gyre, bars=dict(stats=11.5, init_res=11, last_res=12,
                                    fields=11.5, GGL90TKE=11, somT=11,
                                    somS=11))


def test_som_gyre_moments_develop(som_gyre):
    """After 10 steps both tracers' moments are finite everywhere and
    nonzero in every slot of the interior."""
    exp = som_gyre[0]
    ol = exp.cfg.olx
    for name in ("somT", "somS"):
        sm = getattr(exp.state, name)
        assert sm.shape[0] == tsom.NSOM
        assert bool(torch.isfinite(sm).all()), name
        inner = sm[:, :, ol:-ol, ol:-ol].abs().amax(dim=(1, 2, 3))
        assert bool((inner > 0).all()), (name, inner)
