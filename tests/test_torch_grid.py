"""PyTorch port: grid, state and the cg2d operator against the JAX package.

The grid geometry is float64 numpy in both packages, so every field must be
bit-equal; the cg2d operator is built from it by the same tensor operations
in the same order, and must agree to >= 15 digits.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from mitgcm_tpu_torch.utils.convert import arrays_of

torch.set_num_threads(1)

SIZES = [(16, 16, 4), (24, 12, 3)]


def _setups(nx, ny, nr):
    cfg = jsyn.gyre_config(nx=nx, ny=ny, nr=nr)
    jax_objs = jsyn.gyre_setup(cfg, dtype=jnp.float64)
    tcfg = tsyn.gyre_config(nx=nx, ny=ny, nr=nr)
    return jax_objs, tsyn.gyre_setup(tcfg, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("nx,ny,nr", SIZES)
def test_grid_bit_equal(nx, ny, nr):
    (jgrid, _, _, _), (tgrid, _, _, _) = _setups(nx, ny, nr)
    ref = arrays_of(jgrid)
    for f in dataclasses.fields(tgrid):
        assert getattr(tgrid, f.name).is_contiguous(), f.name
        got = getattr(tgrid, f.name).numpy()
        assert got.dtype == np.float64, f.name
        assert np.array_equal(got, ref[f.name]), f"grid.{f.name} differs"


@pytest.mark.parametrize("nx,ny,nr", SIZES)
def test_state_and_forcing_bit_equal(nx, ny, nr):
    (_, jstate, jforc, _), (_, tstate, tforc, _) = _setups(nx, ny, nr)
    for jobj, tobj in ((jstate, tstate), (jforc, tforc)):
        ref = arrays_of(jobj)
        for f in dataclasses.fields(tobj):
            got = getattr(tobj, f.name)
            if got is None:     # GGL90TKE off: the JAX state holds zeros
                assert not ref[f.name].any(), f.name
                continue
            assert np.array_equal(got.numpy(), ref[f.name]), f.name


@pytest.mark.parametrize("nx,ny,nr", SIZES)
def test_cg2d_operator(nx, ny, nr):
    (_, _, _, jop), (_, _, _, top) = _setups(nx, ny, nr)
    ref = arrays_of(jop)
    for f in dataclasses.fields(top):
        d = digits(getattr(top, f.name).numpy(), ref[f.name])
        assert d >= 15, f"op.{f.name}: {d:.2f} digits"
