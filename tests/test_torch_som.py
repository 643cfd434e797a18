"""PyTorch port: second-order-moment advection, schemes 80 and 81
(model/som.py, the plain twins of kernel H-SOM) against the JAX package's
som_advect, in float64 on the CPU.

The same numpy inputs, made from a seed, go through both on the grid of
tests/test_torch_ggl90.py (a shelf, a bank and a partial cell): velocities
of both signs with Courant numbers up to about 0.5 and zero on dry faces
and on a block of wet faces, a tracer with fronts in x, y and r, and
moments of up to about twice the cell's content, so that Prather's limiter
clips each moment it limits from above and from below in every pass.
Whole padded arrays are compared, halos included: gTracer and the nine
moments agree to 12 digits or more, and the non-finite cells (the first
padded column and row, where both packages divide by the zero volume of
the zero-filled upwind cell) are the same cells in both. The AB rule: the
tendency of a SOM tracer is not extrapolated, as in JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import som as jsom
from mitgcm_tpu_torch.model import gad as tgad
from mitgcm_tpu_torch.model import som as tsom
from mitgcm_tpu_torch.model import thermodynamics as tth
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config
from test_torch_ggl90 import SIZE, _grids

torch.set_num_threads(1)

DT = 600.0


@pytest.fixture(scope="module")
def case():
    cfg = tsyn.som_gyre_config(**SIZE)
    jgrid, tgrid = _grids(cfg)
    rng = np.random.default_rng(80)
    shape = tgrid.hFacC.shape
    m = tgrid.maskC.numpy()
    u = 0.5 * rng.standard_normal(shape) * tgrid.maskW.numpy()
    v = 0.5 * rng.standard_normal(shape) * tgrid.maskS.numpy()
    w = 5e-3 * rng.standard_normal(shape) * m
    for a in (u, v, w):                        # still water in one block
        a[:, 10:13, 10:13] = 0.0
    tr = (np.asarray(cfg.tRef)[:, None, None]
          + 0.2 * rng.standard_normal(shape))
    tr[:, :, 11:] += 3.0           # fronts in x, y and r
    tr[:, 13:, :] -= 2.0
    tr[5:] -= 1.5
    tr *= m
    vol = (tgrid.rA * tgrid.drF[:, None, None] * tgrid.hFacC).numpy()
    sm = 2.0 * rng.standard_normal((9,) + shape) * (tr * vol)[None]
    return cfg, jgrid, tgrid, (u, v, w, tr, sm)


def _check_whole(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    bad_g, bad_w = ~np.isfinite(got), ~np.isfinite(want)
    assert np.array_equal(bad_g, bad_w), name
    d = digits(got[~bad_g], want[~bad_w])
    assert d >= 12, (name, d)
    return bad_g


@pytest.mark.parametrize("scheme", [80, 81])
def test_som_advect_matches(case, scheme):
    cfg, jgrid, tgrid, arrays = case
    want = jsom.som_advect(jax_config(cfg), jgrid,
                           *map(jnp.asarray, arrays), scheme, DT)
    got = tsom.som_advect(cfg, tgrid, *map(torch.from_numpy, arrays),
                          scheme, DT)
    bad = _check_whole("gTr", got[0].numpy(), want[0])
    _check_whole("sm", got[1].numpy(), want[1])
    # the non-finite cells are the first padded column and row of every
    # level, in gTr and in each moment
    nr, nyp, nxp = bad.shape
    assert bad[:, 0, :].all() and bad[:, :, 0].all()
    assert int(bad.sum()) == nr * (nyp + nxp - 1)
    assert int((~np.isfinite(got[1].numpy())).sum()) == 9 * int(bad.sum())


def _pass_inputs(case, scheme):
    """The state each pass of the twin starts from: (direction, o, the
    moments it limits)."""
    cfg, _, tgrid, arrays = case
    u, v, w, tr, sm = map(torch.from_numpy, arrays)
    vol0 = tgrid.rA * tgrid.drF[:, None, None] * tgrid.hFacC
    volx, ox, smx = tsom._som_x_plain(cfg, tgrid, u, tr, sm, scheme, DT)
    _, oy, smy = tsom._som_y_plain(cfg, tgrid, v, volx, ox, smx, scheme, DT)
    return (("x", tr * vol0, sm), ("y", ox, smx), ("r", oy, smy))


def test_som_limiter_clips_both_ways(case):
    """With scheme 81 each pass's limiter clips the slope, the curvature
    and both cross moments from above and from below somewhere in the
    interior."""
    ol = case[0].olx
    for direction, o, sm in _pass_inputs(case, 81):
        A, AA, semis, _ = tsom._ROLES[direction]
        slots = (A, AA, semis[0][1], semis[1][1])
        new = tsom._limit_1d(o, *(sm[s] for s in slots))
        for s, n in zip(slots, new):
            old = sm[s][:, ol:-ol, ol:-ol]
            n = n[:, ol:-ol, ol:-ol]
            assert (n < old).any() and (n > old).any(), (direction, s)


def test_som_transports_cover_both_signs_and_zero(case):
    cfg, _, tgrid, (u, v, w, _, _) = case
    ol = cfg.olx
    for vel in (u, v, w):
        inner = vel[1:, ol:-ol, ol:-ol]
        assert (inner > 0).any() and (inner < 0).any() and (inner == 0).any()


def test_som_tendency_is_not_extrapolated(case):
    """JAX extrapolates the tendency (AB) of schemes 2, 3 and 4 only
    (thermodynamics.py:340-342): a SOM tracer's history passes through
    tracer_integrate untouched, and its moments come back updated."""
    cfg, _, tgrid, arrays = case
    u, v, w, tr, sm = map(torch.from_numpy, arrays)
    flow = tgad.calc_adv_flow(tgrid, u, v, w)
    gNm1 = torch.full_like(tr, 1e-3)
    gNm2 = torch.full_like(tr, 2e-3)
    for scheme in (80, 81):
        _, g1, g2, sm_new = tth.tracer_integrate(
            cfg, tgrid, flow, tr, gNm1, gNm2, torch.zeros_like(tr),
            torch.zeros_like(tr[0]), 0.0, 3, schemes=(scheme, scheme),
            uvw=(u, v, w), som_state=sm)
        assert g1 is gNm1 and g2 is gNm2, scheme
        assert sm_new.shape == sm.shape and not torch.equal(sm_new, sm)
