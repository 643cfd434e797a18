"""PyTorch port: OPPS plume convection (model/opps.py, the plain twin of
kernel Z) against the JAX package's OPPS.apply, in float64 on the CPU.

The same numpy inputs, made from a seed, go through both on an 8 x 8 x 12
basin with a shelf, a bank and a partial bottom cell: a stably stratified
column everywhere (no plume launches), then the vermix test's
cold-over-warm profile (2 to 12 degC from the top down, every level
launching) over the north half of the basin with a mildly unstable
perturbation in the south, and the same with useGCMwVel (the launch
speed from w, of both signs) and with two adjustment iterations. theta',
salt' agree to 12 digits or more and the convect counts are equal; each
column's heat (theta drF summed) and salt are conserved to 1e-9 relative
under every equation of state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import opps as jopps
from mitgcm_tpu_torch.model import opps as topps
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config
from test_torch_vertmix import grids

torch.set_num_threads(1)

SIZE = dict(nx=8, ny=8, nr=12, depth=300.0)
EOS_CASES = (("JMD95Z", 0), ("JMD95Z", 2), ("MDJWF", 2), ("LINEAR", 0))
VARIANTS = {"defaults": {}, "useGCMwVel": {"useGCMwVel": True},
            "two adjustments": {"MAX_ABE_ITERATIONS": 2}}


def profiles(cfg, tgrid, seed, unstable):
    """Seeded (theta, salt, w, totPhiHyd): tRef warmed towards the top,
    with noise (stable), or with unstable, the cold-over-warm profile in
    the north half and every other interface mildly unstable in the
    south."""
    rng = np.random.default_rng(seed)
    shape = tuple(tgrid.hFacC.shape)
    mask = tgrid.maskC.numpy()
    nr = shape[0]
    # tRef warmed by up to 0.2 degC towards the top: stable everywhere
    t_ref = (np.asarray(cfg.tRef) + 0.2 * (1.0 - np.arange(nr) / nr))
    theta = t_ref[:, None, None] + 1e-4 * rng.standard_normal(shape)
    if unstable:
        theta[:, 6:] = np.linspace(2.0, 12.0, nr)[:, None, None]
        theta[1::2, :6] = theta[:-1:2, :6] + 0.05
    salt = 34.8 + 1e-4 * rng.standard_normal(shape)
    w = 1e-2 * rng.standard_normal(shape) * mask
    phi = 0.05 * rng.standard_normal(shape)
    return theta * mask, salt * mask, w, phi


def run_both(kind, select_p, group, unstable, seed=40):
    cfg = tsyn.opps_gyre_config(**SIZE, eosType=kind,
                                selectP_inEOS_Zc=select_p)
    jgrid, tgrid = grids(cfg)
    arrays = profiles(cfg, tgrid, seed, unstable)
    want = jopps.OPPS(jax_config(cfg), jgrid, group).apply(
        *map(jnp.asarray, arrays))
    got = topps.OPPS(cfg, tgrid, group).apply(*map(torch.from_numpy,
                                                   arrays))
    return tgrid, arrays, [g.numpy() for g in got], \
        [np.asarray(w) for w in want]


@pytest.mark.parametrize("kind,select_p", EOS_CASES)
def test_opps_stable(kind, select_p):
    _, arrays, got, want = run_both(kind, select_p, {}, unstable=False)
    for name, g, w in zip(("theta", "salt"), got, want):
        assert np.array_equal(g, w) and np.array_equal(g, arrays[
            ("theta", "salt").index(name)]), name
    assert not got[2].any() and not want[2].any()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind,select_p", EOS_CASES)
def test_opps_unstable(kind, select_p, variant):
    tgrid, arrays, got, want = run_both(kind, select_p, VARIANTS[variant],
                                        unstable=True)
    for name, g, w in zip(("theta", "salt"), got, want):
        d = digits(g, w)
        assert d >= 12, (name, d)
    assert np.array_equal(got[2], want[2])
    count = got[2]
    # plumes in the cold-over-warm north at every level of a full column
    # (with useGCMwVel only where w launches them downwards), and launches
    # in the mildly unstable rest
    launched = count[:, 8, 5].sum()
    if VARIANTS[variant].get("useGCMwVel"):
        assert 0 < launched < SIZE["nr"] - 1
    else:
        assert launched == SIZE["nr"] - 1
    assert count[:, 2:6].sum() > 0
    drF = tgrid.drF.numpy()[:, None, None]
    for before, after in zip(arrays[:2], got[:2]):
        h0 = (before * drF).sum(axis=0)
        h1 = (after * drF).sum(axis=0)
        assert np.abs(h1 - h0).max() <= 1e-9 * np.abs(h0).max()
    # the cold top warmed and the warm bottom cooled
    assert got[0][0, 8, 5] > 2.0 and got[0][-1, 8, 5] < 12.0


def test_opps_parameters_match():
    cfg = tsyn.opps_gyre_config(**SIZE)
    jgrid, tgrid = grids(cfg)
    for group in ({}, {"PlumeRadius": 50.0, "oppsWriteState": True}):
        assert (topps.OPPS(cfg, tgrid, group).p
                == jopps.OPPS(jax_config(cfg), jgrid, group).p)
    assert np.array_equal(topps.OPPS(cfg, tgrid).kLowC.numpy(),
                          np.asarray(jopps.OPPS(jax_config(cfg),
                                                jgrid).kLowC))
    with pytest.raises(KeyError, match="unknown parameter"):
        topps.OPPS(cfg, tgrid, {"nonsense": 1})
