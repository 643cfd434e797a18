"""PyTorch port: stencil primitives against the JAX package, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.ops import stencil as jst
from mitgcm_tpu_torch.ops import stencil as tst

torch.set_num_threads(1)


def _field(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("dj,di", [(0, 0), (0, 1), (0, -1), (1, 0),
                                   (-1, 0), (1, -1), (-2, 2), (3, -3)])
def test_shift(dj, di):
    a = _field((3, 9, 11))
    want = np.asarray(jst.shift(jnp.asarray(a), dj=dj, di=di))
    got = tst.shift(torch.from_numpy(a), dj=dj, di=di).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dk", [-2, -1, 0, 1, 2])
def test_shift_k(dk):
    a = _field((4, 6, 7), seed=1)
    want = np.asarray(jst.shift_k(jnp.asarray(a), dk))
    got = tst.shift_k(torch.from_numpy(a), dk).numpy()
    assert np.array_equal(got, want)


# (ny, nx, oly, olx): the last two halos are wider than the interior
@pytest.mark.parametrize("ny,nx,oly,olx", [(8, 10, 2, 2), (5, 7, 1, 3),
                                           (2, 6, 3, 2), (1, 1, 2, 2)])
def test_cyclic_fill_halo(ny, nx, oly, olx):
    a = _field((2, ny + 2 * oly, nx + 2 * olx), seed=2)
    want = np.asarray(jst.cyclic_fill_halo(jnp.asarray(a), oly, olx))
    got = tst.cyclic_fill_halo(torch.from_numpy(a), oly, olx).numpy()
    assert np.array_equal(got, want)


def test_interior_and_mask():
    a = _field((9, 12), seed=3)
    want = np.asarray(jst.interior_mask(a.shape, 2, 3, jnp.float64))
    got = tst.interior_mask(a.shape, 2, 3, torch.float64, "cpu").numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tst.interior(torch.from_numpy(a), 2, 3).numpy(),
                          np.asarray(jst.interior(jnp.asarray(a), 2, 3)))
