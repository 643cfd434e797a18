"""PyTorch port: the high-order schemes of the multi-dimensional advection
(model/gad_ho.py and model/gad.py, the plain twins of kernels M, O and P)
against the JAX package, in float64 on the CPU, on halos of 4: upwind (1),
DST-2 (20), OS7MP (7) and PPM/PQM with the null, monotone and WENO
limiters (40-42, 50-52), the vertical schemes 3 and 4, and
multidim_advection with mixed horizontal and vertical schemes.

The same numpy inputs, made from a seed, go through both on the grid of
tests/test_torch_ggl90.py (a shelf, a bank and a partial cell) at olx = oly
= 4: velocities of both signs with Courant numbers up to about 0.5, zero on
dry faces, and a tracer with fronts in x, y and r and a flat patch.
Whole padded arrays are compared, halos included, since both packages
compute them with the same zero-filled shifts; every flux and tendency
agrees to 12 digits or more (bit for bit on this CPU). Branch tests show
that these inputs reach each discrete choice of the limiters both ways.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import gad as jgad
from mitgcm_tpu_torch.model import gad as tgad
from mitgcm_tpu_torch.model import gad_ho
from mitgcm_tpu_torch.model import thermodynamics as tth
from mitgcm_tpu_torch.ops.stencil import shift as sh
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config
from test_torch_ggl90 import SIZE, _grids

torch.set_num_threads(1)

DT = 600.0
HIGH_ORDER = (1, 20, 7, 40, 41, 42, 50, 51, 52)
PAIRS = [(7, 7), (40, 40), (41, 41), (42, 42), (50, 50), (51, 51), (52, 52),
         (1, 1), (20, 20), (7, 33), (33, 2), (30, 4), (41, 3)]


@pytest.fixture(scope="module")
def case():
    cfg = tsyn.pqm_gyre_config(**SIZE)
    assert cfg.olx == cfg.oly == 4
    jgrid, tgrid = _grids(cfg)
    rng = np.random.default_rng(7)
    shape = tgrid.hFacC.shape
    m = tgrid.maskC.numpy()
    u = 0.5 * rng.standard_normal(shape) * tgrid.maskW.numpy()
    v = 0.5 * rng.standard_normal(shape) * tgrid.maskS.numpy()
    w = 5e-3 * rng.standard_normal(shape) * m
    tr = (np.asarray(cfg.tRef)[:, None, None]
          + 0.2 * rng.standard_normal(shape))
    tr[:, :, 11:] += 3.0           # fronts in x, y and r
    tr[:, 13:, :] -= 2.0
    tr[5:] -= 1.5
    tr[:, 6:9, 5:8] = 10.0         # a flat patch: zero slopes
    tr *= m
    jcfg = jax_config(cfg)
    jflow = jgad.calc_adv_flow(jcfg, jgrid, *map(jnp.asarray, (u, v, w)))
    tflow = tgad.calc_adv_flow(tgrid, *map(torch.from_numpy, (u, v, w)))
    return cfg, jgrid, tgrid, jflow, tflow, (u, v, w, tr)


def _flux(case, scheme, direction):
    """(JAX's, the port's) flux of the scheme in the direction."""
    cfg, jgrid, tgrid, jflow, tflow, arrays = case
    jcfg = jax_config(cfg)
    ja = list(map(jnp.asarray, arrays))
    ta = list(map(torch.from_numpy, arrays))
    if direction == "x":
        want = jgad.adv_flux_x(jcfg, jgrid, scheme, jflow.uTrans, ja[0], ja[3],
                               DT, jgrid.maskW * jgrid.maskInW,
                               wetW=jgrid.maskW)
        got = tgad.adv_flux_x(tgrid, scheme, tflow.uTrans, ta[0], ta[3], DT,
                              tgrid.maskW * tgrid.maskInW)
    elif direction == "y":
        want = jgad.adv_flux_y(jcfg, jgrid, scheme, jflow.vTrans, ja[1], ja[3],
                               DT, jgrid.maskS * jgrid.maskInS,
                               wetS=jgrid.maskS)
        got = tgad.adv_flux_y(tgrid, scheme, tflow.vTrans, ta[1], ta[3], DT,
                              tgrid.maskS * tgrid.maskInS)
    else:
        want = jgad.adv_flux_r(jcfg, jgrid, scheme, jflow.rTrans, ja[2], ja[3],
                               DT)
        got = tgad.adv_flux_r(tgrid, scheme, tflow.rTrans, ta[2], ta[3], DT)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("scheme,direction", [
    (s, d) for s in HIGH_ORDER for d in "xyr"] + [(3, "r"), (4, "r")])
def test_adv_flux(case, scheme, direction):
    want, got = _flux(case, scheme, direction)
    assert np.count_nonzero(want) > want.size // 3
    assert digits(got, want) >= 12


@pytest.mark.parametrize("scheme,vert_scheme", PAIRS)
def test_multidim_advection(case, scheme, vert_scheme):
    cfg, jgrid, tgrid, jflow, tflow, arrays = case
    want = np.asarray(jgad.multidim_advection(
        jax_config(cfg), jgrid, jflow, *map(jnp.asarray, arrays), scheme,
        vert_scheme, DT))
    got = tgad.multidim_advection(cfg, tgrid, tflow,
                                  *map(torch.from_numpy, arrays), scheme,
                                  vert_scheme, DT).numpy()
    assert digits(got, want) >= 12


def _both_ways(flags, *names):
    for name in names:
        f = flags[name]
        assert bool(f.any()) and not bool(f.all()), name


def test_transports_of_both_signs_and_zero(case):
    """The inputs carry transports of both signs and zero on every axis,
    and a zero transport gives a zero flux."""
    _, _, _, _, tflow, _ = case
    for trans, d in ((tflow.uTrans, "x"), (tflow.vTrans, "y"),
                     (tflow.rTrans, "r")):
        assert bool((trans > 0).any() and (trans < 0).any()
                    and (trans == 0).any()), d
    for scheme in (7, 41, 51):
        for d, trans in (("x", tflow.uTrans), ("y", tflow.vTrans)):
            got = _flux(case, scheme, d)[1]
            assert not np.any(got[(trans == 0).numpy()]), (scheme, d)


@pytest.mark.parametrize("axis", ["x", "y"])
def test_os7mp_branches(case, axis):
    """OS7MP clips Phi at PhiMin and at PhiMax, and meets DelIp == 0."""
    _, _, tgrid, _, tflow, arrays = case
    u, v, _, tr = map(torch.from_numpy, arrays)
    flags = {}
    if axis == "x":
        gad_ho._os7mp_flux_h(tflow.uTrans, u, tgrid.maskW * tgrid.maskInW, tr,
                             DT, tgrid.recip_dxC, lambda a, d: sh(a, di=d),
                             1.0, flags)
    else:
        gad_ho._os7mp_flux_h(tflow.vTrans, v, tgrid.maskS * tgrid.maskInS, tr,
                             DT, tgrid.recip_dyC, lambda a, d: sh(a, dj=d),
                             1.0, flags)
    _both_ways(flags, "PhiMin", "PhiMax", "DelIp0")


@pytest.mark.parametrize("scheme", [41, 42, 51, 52])
def test_ppm_pqm_branches(case, scheme):
    """Monotone PPM takes condA and condB; monotone PQM binds the
    inflexion on both edges (bindm, bindp) and pops them (c1, c2); WENO
    blends in some cells and not in others."""
    _, _, tgrid, _, tflow, arrays = case
    u, _, _, tr = map(torch.from_numpy, arrays)
    flags = {}
    gad_ho._ppm_pqm_flux_h(tgrid, scheme, "x", tflow.uTrans, u, tr, DT, flags)
    if scheme in gad_ho.PPM_SCHEMES:
        _both_ways(flags, "condA", "condB")
    else:
        _both_ways(flags, "bindm", "bindp", "c1", "c2")
    if scheme in (42, 52):
        _both_ways(flags, "blend", "ok")


def test_no_multidim_scheme_is_extrapolated(case):
    """JAX extrapolates the tendency (AB) of schemes 2, 3 and 4 only
    (thermodynamics.py:340-342), none of which runs under the
    multi-dimensional advection; the port's tracer_integrate passes the
    history of a multidim scheme through untouched."""
    assert not {2, 3, 4} & set(tgad.MULTIDIM_SCHEMES)
    assert set(tgad.MULTIDIM_SCHEMES) == set(jgad.MULTIDIM_SCHEMES)
    cfg, _, tgrid, _, tflow, arrays = case
    u, v, w, tr = map(torch.from_numpy, arrays)
    gNm1 = torch.full_like(tr, 1e-3)
    gNm2 = torch.full_like(tr, 2e-3)
    for scheme in (7, 41, 51, 1, 20):
        _, g1, g2, _ = tth.tracer_integrate(
            cfg, tgrid, tflow, tr, gNm1, gNm2, torch.zeros_like(tr),
            torch.zeros_like(tr[0]), 0.0, 3, schemes=(scheme, scheme),
            uvw=(u, v, w))
        assert g1 is gNm1 and g2 is gNm2, scheme
