"""PyTorch port: the flux-limited advection schemes 30 (DST-3), 33 (DST-3
flux-limited) and 77 (Superbee) and the multi-dimensional advection
(model/gad.py, the plain twins of kernel M) against the JAX package's
adv_flux_x / adv_flux_y / adv_flux_r and multidim_advection, in float64
on the CPU; kernel C's twin without its advective part against JAX's
calc_rhs(calc_advection=False); and check_supported's refusals of the
schemes that are not ported.

The same numpy inputs, made from a seed, go through both on the grid of
tests/test_torch_ggl90.py (a shelf, a bank and a partial cell): velocities
of both signs with Courant numbers up to about 0.5, and a tracer with
fronts in x, y and r, so that the limiters clip (psi at 0 and 1, the
Superbee branches, the overflow guard of a zero slope). Whole padded
arrays are compared, halos included, since both packages compute them
with the same zero-filled shifts; every flux and tendency agrees to 12
digits or more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import gad as jgad
from mitgcm_tpu_torch.model import gad as tgad
from mitgcm_tpu_torch.model.step import check_supported
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config
from test_torch_ggl90 import SIZE, _grids

torch.set_num_threads(1)

SCHEMES = (30, 33, 77)
DT = 600.0


@pytest.fixture(scope="module")
def case():
    cfg = tsyn.ggl90_gyre_config(**SIZE)
    jgrid, tgrid = _grids(cfg)
    rng = np.random.default_rng(33)
    shape = tgrid.hFacC.shape
    m = tgrid.maskC.numpy()
    u = 0.5 * rng.standard_normal(shape) * tgrid.maskW.numpy()
    v = 0.5 * rng.standard_normal(shape) * tgrid.maskS.numpy()
    w = 5e-3 * rng.standard_normal(shape) * m
    tr = (np.asarray(cfg.tRef)[:, None, None]
          + 0.2 * rng.standard_normal(shape))
    tr[:, :, 9:] += 3.0            # fronts in x, y and r
    tr[:, 11:, :] -= 2.0
    tr[5:] -= 1.5
    tr[:, 4:7, 3:6] = 10.0         # a flat patch: zero slopes
    tr *= m
    return cfg, jgrid, tgrid, (u, v, w, tr)


def _flows(cfg, jgrid, tgrid, arrays):
    u, v, w = arrays[:3]
    jflow = jgad.calc_adv_flow(jax_config(cfg), jgrid,
                               *map(jnp.asarray, (u, v, w)))
    tflow = tgad.calc_adv_flow(tgrid, *map(torch.from_numpy, (u, v, w)))
    return jflow, tflow


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("direction", ["x", "y", "r"])
def test_adv_flux(case, scheme, direction):
    cfg, jgrid, tgrid, arrays = case
    jcfg = jax_config(cfg)
    jflow, tflow = _flows(cfg, jgrid, tgrid, arrays)
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
    want = np.asarray(want)
    assert np.count_nonzero(want) > want.size // 3
    assert digits(got.numpy(), want) >= 12


@pytest.mark.parametrize("scheme,vert_scheme", [(30, 30), (33, 33), (77, 77),
                                                (33, 77)])
def test_multidim_advection(case, scheme, vert_scheme):
    cfg, jgrid, tgrid, arrays = case
    jflow, tflow = _flows(cfg, jgrid, tgrid, arrays)
    want = np.asarray(jgad.multidim_advection(
        jax_config(cfg), jgrid, jflow, *map(jnp.asarray, arrays), scheme,
        vert_scheme, DT))
    got = tgad.multidim_advection(cfg, tgrid, tflow,
                                  *map(torch.from_numpy, arrays), scheme,
                                  vert_scheme, DT).numpy()
    assert digits(got, want) >= 12


def test_limiters_clip(case):
    """The inputs reach the clips: DST3-FL's psi at 0 and at 1 and
    Superbee's limiter at 0 and at 2."""
    cfg, _, tgrid, arrays = case
    t = torch.from_numpy(arrays[3])
    mW = tgrid.maskW * tgrid.maskInW
    Rjp = (tgad.sh(t, di=1) - t) * tgad.sh(mW, di=1)
    Rj = (t - tgad.sh(t, di=-1)) * mW
    cfl = (torch.from_numpy(arrays[0]) * DT * tgrid.recip_dxC).abs()
    d0 = (2.0 - cfl) * (1.0 - cfl) * (1.0 / 6.0)
    d1 = (1.0 - cfl * cfl) * (1.0 / 6.0)
    psi = tgad._dst3fl_psi(Rj, Rjp, cfl, d0, d1)
    lim = tgad._limiter(tgad._flux_limit_cr(Rj, Rjp))
    assert bool((psi == 0.0).any()) and bool((psi == 1.0).any())
    assert bool((lim == 0.0).any()) and bool((lim == 2.0).any())


@pytest.mark.parametrize("implicit", [False, True])
def test_calc_rhs_without_advection(case, implicit):
    cfg, jgrid, tgrid, arrays = case
    jcfg = jax_config(cfg)
    jflow, tflow = _flows(cfg, jgrid, tgrid, arrays)
    kappa = np.abs(1e-3 * np.random.default_rng(4).standard_normal(
        arrays[3].shape))
    want = jgad.calc_rhs(jcfg, jgrid, jflow, *map(jnp.asarray, arrays[:4]),
                         33, 33, cfg.diffKhT, 0.0, jnp.asarray(kappa), DT,
                         implicit, calc_advection=False)
    got = tgad.calc_rhs(cfg, tgrid, tflow, torch.from_numpy(arrays[3]),
                        torch.from_numpy(kappa), cfg.diffKhT,
                        implicit_diffusion=implicit, calc_advection=False)
    ol = cfg.olx
    assert digits(got.numpy()[:, ol:-ol, ol:-ol],
                  np.asarray(want)[:, ol:-ol, ol:-ol]) >= 12


@pytest.mark.parametrize("scheme", [1, 20, 3, 4, 7, 40, 41, 42, 50, 51, 52,
                                    80, 81])
def test_is_multidim_matches(scheme):
    cfg = tsyn.ggl90_gyre_config(nx=8, ny=8, nr=2)
    for flag in (True, False):
        cfg.multiDimAdvection = flag
        for s in (scheme, 2) + SCHEMES:
            assert tgad.is_multidim(cfg, s) == bool(
                jgad.is_multidim(jax_config(cfg), s)), (s, flag)


@pytest.mark.parametrize("settings,name", [
    (dict(tempAdvScheme=3), "tempAdvScheme=3"),
    (dict(saltAdvScheme=4), "saltAdvScheme=4"),
    (dict(saltAdvScheme=80, saltVertAdvScheme=2), "saltAdvScheme=80"),
    (dict(multiDimAdvection=False), "multiDimAdvection=False"),
    (dict(tempAdvScheme=2, tempVertAdvScheme=33), "tempVertAdvScheme=33"),
    (dict(tempAdvScheme=7, multiDimAdvection=False), "tempAdvScheme=7"),
    (dict(saltAdvScheme=41, multiDimAdvection=False), "saltAdvScheme=41"),
    (dict(tempVertAdvScheme=80), "tempVertAdvScheme=80"),
    (dict(saltVertAdvScheme=81), "saltVertAdvScheme=81"),
    (dict(tempAdvScheme=2, tempVertAdvScheme=7), "tempVertAdvScheme=7"),
    (dict(tempAdvScheme=81, tempVertAdvScheme=33), "tempAdvScheme=81"),
], ids=lambda x: x if isinstance(x, str) else None)
def test_check_supported_refuses_schemes(settings, name):
    """Under the multi-dimensional advection every horizontal scheme of
    JAX's MULTIDIM_SCHEMES passes with every vertical scheme that JAX's
    adv_flux_r computes; scheme 2 passes in both directions only, SOM (80,
    81) with its vertical scheme unset or equal. Every other pair is refused
    by name: the multi-dimensional schemes without it, SOM with another
    vertical scheme (JAX ignores the vertical scheme there), a vertical
    scheme adv_flux_r does not know (JAX runs centred 2nd order for it), and
    a non-2 vertical scheme under scheme 2."""
    cfg = tsyn.ggl90_gyre_config(nx=8, ny=8, nr=2, useGGL90=False)
    check_supported(cfg)
    for flag, value in settings.items():
        setattr(cfg, flag, value)
    with pytest.raises(NotImplementedError, match=name):
        check_supported(cfg)


@pytest.mark.parametrize("schemes", [
    (30, 30), (77, 77), (33, 77), (2, 2), (1, 1), (7, 7), (20, 20),
    (41, 41), (52, 52), (33, 2), (7, 33), (30, 4), (41, 3), (50, 1),
    (42, 20)])
def test_check_supported_passes_schemes(schemes):
    cfg = tsyn.ggl90_gyre_config(nx=8, ny=8, nr=2, useGGL90=False,
                                 tempAdvScheme=schemes[0],
                                 tempVertAdvScheme=schemes[1])
    check_supported(cfg)


@pytest.mark.parametrize("multidim", [True, False])
@pytest.mark.parametrize("vertical", ["unset", "equal"])
def test_check_supported_passes_som(multidim, vertical):
    """SOM (theta 81, salt 80) passes with its vertical scheme unset or
    equal, with the multi-dimensional advection on or off: JAX runs SOM
    before it looks at multiDimAdvection (thermodynamics.py:304-311)."""
    vert = {} if vertical == "unset" else dict(tempVertAdvScheme=81,
                                              saltVertAdvScheme=80)
    cfg = tsyn.som_gyre_config(nx=8, ny=8, nr=2, useGGL90=False,
                               multiDimAdvection=multidim, **vert)
    check_supported(cfg)
