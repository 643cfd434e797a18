"""PyTorch port: the legacy-ice-gyre (the ice-gyre of
tests/test_torch_ice_gyre.py under SEAICEadvScheme 2, the legacy two-pass
centred advection, with DIFF1 = 4e-3 harmonic and biharmonic diffusion, as
lab_sea's input.hb87 sets them) against the JAX package, 10 steps at
16x16x12 (depth 300 m) in float64 on the CPU, with the JAX side evaluated
op by op (jax.disable_jit) as the ice-gyre's; the ice-gyre's bars
(tests/test_torch_sitr_ice_gyre.py:check_records)."""

import pytest
import torch

from mitgcm_tpu_torch.utils import synthetic as tsyn
from test_torch_sitr_ice_gyre import (SIZE, check_fields, check_records,
                                      run_both)

torch.set_num_threads(1)

ICE_FIELDS = ("uIce", "vIce", "siAREA", "siHEFF", "siHSNOW", "siTICES")


@pytest.fixture(scope="module")
def legacy_gyre():
    cfg = tsyn.legacy_ice_gyre_config(**SIZE)
    assert (cfg.seaice.advScheme, cfg.seaice.DIFF1) == (2, 4.0e-3)
    return run_both(cfg, tsyn.LEGACY_ICE_GYRE_SEAICE, {})


def test_legacy_ice_gyre_ten_steps(legacy_gyre):
    exp, got, _, want, counts = legacy_gyre
    check_records(got, want, counts)


def test_legacy_ice_gyre_fields(legacy_gyre):
    exp, _, jexp, _, _ = legacy_gyre
    check_fields(exp, jexp, ICE_FIELDS)


def test_legacy_ice_gyre_moves_the_ice(legacy_gyre):
    """The legacy advection and DIFF1 moved the ice: the state differs from
    the ice-gyre's scheme-77 run of the same steps."""
    exp, _, _, _, _ = legacy_gyre
    cfg = tsyn.ice_gyre_config(**SIZE)
    from mitgcm_tpu_torch.model.experiment import Experiment
    grid, state, forcing, op, kpp, seaice = tsyn.ice_gyre_setup(
        cfg, dtype=torch.float64, device="cpu")
    ref = Experiment(cfg, grid, state, forcing, op, kpp=kpp, seaice=seaice)
    ref.run(n_steps=10, collect_monitor=False)
    assert not torch.equal(ref.state.siHEFF, exp.state.siHEFF)
