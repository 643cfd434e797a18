"""PyTorch port: the twins of the variable and biharmonic viscosity against
the JAX package, in float64 on the CPU.

Kernel X's twin (model/mom_visc.py:_calc_visc_plain: the divergence,
vorticity, tension, strain and KE formed from u and v, then
calc_visc_plain) against JAX's calc_visc fed by its mom_fluxform's front
end, on every padded cell, in each combination of Smagorinsky, Leith, full
Leith, the grid and grid-Reynolds limits, biharmonic output and
useAreaViscLength; kernel Y's twins (mom_fluxform.py:_del2uv with and
without the closed-wall term, mom_vecinv.py:del2uv_plain) against JAX's
_del2uv and del2uv; hdissip_strain_tension_plain against JAX's; and the
momentum tendencies of kernels B's and V's dissipation variants (the
twins with X's and Y's twins inside) against JAX's mom_fluxform and
mom_vecinv on the interior: variable, constant biharmonic, strain-tension,
linear and quadratic bottom drag, free-slip sides. The same numpy inputs,
made from a seed, go through both, on the visc-gyre's basin cut to 12 x 20
x 4 with halos of 4, a shelf, a bank and partial bottom cells, and
velocities whose amplitude varies over four decades so that each limit
picks either side somewhere. Bar: 12 digits (max|a-b| / max|b|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.core.grid import build_grid as jbuild_grid
from mitgcm_tpu.model import mom_fluxform as jff
from mitgcm_tpu.model import mom_vecinv as jvi
from mitgcm_tpu.model import mom_visc as jvisc
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import mom_fluxform as tff
from mitgcm_tpu_torch.model import mom_vecinv as tvi
from mitgcm_tpu_torch.model import mom_visc as tvisc
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior
from test_torch_config import jax_config

torch.set_num_threads(1)

NY, NX, NR, OL = 12, 20, 4, 4
DIGITS = 12.0

# calc_visc's flag combinations: settings over a base without variable
# viscosity (viscAh 400 as the gyres')
OFF = dict(viscC2smag=0.0, viscC2leith=0.0, viscC2leithD=0.0,
           viscC4leith=0.0, viscC4leithD=0.0, viscAhGridMax=1.0e21,
           viscA4GridMax=1.0e21, viscAhReMax=0.0, viscA4ReMax=0.0)
VISC_CASES = {
    "smagorinsky": dict(viscC2smag=2.2),
    "smagorinsky 4": dict(viscC2smag=2.2, viscC4smag=2.0),
    "leith": dict(viscC2leith=1.85, viscC2leithD=1.85, viscC4leith=2.0,
                  viscC4leithD=2.0),
    "full leith": dict(viscC2leith=1.85, viscC2leithD=1.85, viscC4leith=2.0,
                       viscC4leithD=2.0, useFullLeith=True),
    "reynolds": dict(viscC2smag=2.2, viscAhReMax=10.0, viscA4ReMax=10.0,
                     viscA4=1.0e9),
    "reynolds harmonic": dict(viscC2smag=2.2, viscAhReMax=10.0),
    "grid": dict(viscAhGrid=0.02, viscA4Grid=0.005, viscAhGridMin=0.001,
                 viscA4GridMin=0.0005, viscAhGridMax=0.5,
                 viscA4GridMax=0.3, viscAhMax=3.0e3, viscA4Max=5.0e12),
    "visc-gyre": {},
    "visc-gyre, area length": dict(useAreaViscLength=True),
    "visc-gyre, free slip": dict(no_slip_sides=False),
}


def _case(vi=False, **settings):
    """(cfg, JAX grid, port grid, u, v, w, kappaRU, kappaRV) on the
    visc-gyre's (or visc-vi-gyre's) basin with a shelf, a bank and a
    partial bottom cell, hFacMin 0.1."""
    config = tsyn.visc_vi_gyre_config if vi else tsyn.visc_gyre_config
    cfg = config(nx=NX, ny=NY, nr=NR, hFacMin=0.1, **settings)
    depth = sum(cfg.delR)
    bathy = np.full((NY, NX), -depth)
    bathy[:, :3] = -0.4 * depth
    bathy[2:5, NX // 2:NX // 2 + 4] = -0.6 * depth
    bathy[NY // 2, 4:NX - 4] = -depth + 0.4 * cfg.delR[-1]
    bathy[0, :] = bathy[-1, :] = bathy[:, 0] = bathy[:, -1] = 0.0
    jgrid = jbuild_grid(jax_config(cfg), bathy=bathy, dtype=jnp.float64)
    tgrid = convert.from_arrays(Grid, convert.arrays_of(jgrid), device="cpu")
    hfac = tgrid.hFacC.numpy()
    assert ((hfac > 0) & (hfac < 1)).any() and (hfac == 0).any()
    rng = np.random.default_rng(7 + len(settings))
    shape = hfac.shape
    amp = 10.0 ** rng.uniform(-3.0, 1.0, shape)
    u = amp * rng.standard_normal(shape) * np.asarray(jgrid.maskW)
    v = amp * rng.standard_normal(shape) * np.asarray(jgrid.maskS)
    w = 1e-4 * rng.standard_normal(shape) * np.asarray(jgrid.maskC)
    kshape = (shape[0] + 1,) + shape[1:]
    kU = 1e-3 * np.abs(rng.standard_normal(kshape))
    kV = 1e-3 * np.abs(rng.standard_normal(kshape))
    return cfg, jgrid, tgrid, (u, v, w, kU, kV)


def _jax_visc(jcfg, jgrid, u, v):
    """JAX's calc_visc as its mom_fluxform feeds it (mom_fluxform.py:
    237-252)."""
    hFacZ = jff.calc_hfacz(jgrid)
    fac = jcfg.sideDragFactor if jcfg.no_slip_sides else 0.0
    hDiv = jvi.calc_hdiv(jcfg, jgrid, u, v)
    vort3 = jvi.calc_relvort3(jcfg, jgrid, u, v)
    vort3 = jnp.where(hFacZ == 0.0, fac * vort3, vort3)
    tension = jvisc.calc_tension(jcfg, jgrid, u, v)
    strain = jvisc.calc_strain(jcfg, jgrid, u, v)
    strain = jnp.where(hFacZ == 0.0, fac * strain, strain)
    return jvisc.calc_visc(jcfg, jgrid, jvisc.length_scales(jcfg, jgrid),
                           hDiv, vort3, tension, strain,
                           jff.calc_ke(jcfg, jgrid, u, v), hFacZ)


def _same(got, want, label, whole=True):
    got = got.numpy() if whole else interior(got, OL)
    want = np.asarray(want) if whole else interior(np.asarray(want), OL)
    d = digits(got, want)
    assert d >= DIGITS, f"{label}: {d:.2f} digits"


@pytest.mark.parametrize("name", VISC_CASES)
def test_calc_visc(name):
    """Every padded cell of the four viscosities (the biharmonic pair None
    without biharmonic viscosity), and the limits' branches taken."""
    settings = VISC_CASES[name]
    if name != "visc-gyre" and not name.startswith("visc-gyre,"):
        settings = {**OFF, **settings}
    cfg, jgrid, tgrid, (u, v, *_) = _case(**settings)
    want = _jax_visc(jax_config(cfg), jgrid, jnp.asarray(u), jnp.asarray(v))
    got = tvisc.calc_visc(cfg, tgrid, torch.from_numpy(u),
                          torch.from_numpy(v))
    bih = tvisc.use_biharmonic_visc(cfg)
    assert (got[2] is not None) == bih
    for label, g, w in zip(("viscAh_Z", "viscAh_D", "viscA4_Z", "viscA4_D"),
                           got, want):
        if g is not None:
            _same(g, w, f"{name}: {label}")
    AhD = got[1][:, OL:-OL, OL:-OL]
    if name == "visc-gyre":
        # the grid limit binds in some cells and not in others
        cap = 0.25 / cfg.deltaTMom * tvisc.length_scales(cfg, tgrid)["L2_D"]
        assert bool((AhD == cap[OL:-OL, OL:-OL]).any())
        assert bool((AhD < cap[OL:-OL, OL:-OL]).any())


def test_length_scales_built_once():
    """The scales are built once per grid and time step, in the grid's
    dtype, from the float64 metrics (equal to JAX's)."""
    cfg, jgrid, tgrid, _ = _case()
    a = tvisc.length_scales(cfg, tgrid)
    assert tvisc.length_scales(cfg, tgrid) is a
    want = jvisc.length_scales(jax_config(cfg), jgrid)
    for name in ("L2_D", "L3_D", "L4rdt_D", "L2_Z", "L3_Z", "L4rdt_Z"):
        assert np.array_equal(a[name].numpy(), np.asarray(want[name])), name
        assert a[name].dtype == tgrid.rA.dtype
    other = tvisc.length_scales(
        tsyn.visc_gyre_config(nx=NX, ny=NY, nr=NR, deltaT=600.0), tgrid)
    assert other is not a and other["recip_dt"] == 1.0 / 600.0


@pytest.mark.parametrize("form", ["flux, no slip", "flux, free slip",
                                  "vector invariant"])
def test_del2uv(form):
    """Kernel Y's twins on every padded cell."""
    vi = form == "vector invariant"
    cfg, jgrid, tgrid, (u, v, *_) = _case(
        vi=vi, no_slip_sides=form != "flux, free slip")
    jcfg = jax_config(cfg)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    if vi:
        hFacZ = jff.calc_hfacz(jgrid)
        vort3 = jvi.calc_relvort3(jcfg, jgrid, ju, jv)
        vort3 = jnp.where(hFacZ == 0.0, jcfg.sideDragFactor * vort3, vort3)
        want = jvi.del2uv(jcfg, jgrid, jvi.calc_hdiv(jcfg, jgrid, ju, jv),
                          vort3, hFacZ)
    else:
        hFacZ = jff.calc_hfacz(jgrid)
        want = jff._del2uv(jcfg, jgrid, ju, jv, hFacZ, hFacZ)
    got = tvisc.del2uv(cfg, tgrid, torch.from_numpy(u), torch.from_numpy(v))
    for label, g, w in zip(("del2u", "del2v"), got, want):
        _same(g, w, f"{form}: {label}")


@pytest.mark.parametrize("viscosity", ["constant", "fields"])
def test_hdissip_strain_tension(viscosity):
    cfg, jgrid, tgrid, (u, v, *_) = _case(vi=True)
    jcfg = jax_config(cfg)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    tension = jvisc.calc_tension(jcfg, jgrid, ju, jv)
    strain = jvisc.calc_strain(jcfg, jgrid, ju, jv)
    if viscosity == "constant":
        vs, vt = 350.0, 420.0
        tvs, tvt = vs, vt
    else:
        rng = np.random.default_rng(3)
        vs, vt = (jnp.asarray(300.0 + 200.0 * rng.uniform(size=u.shape))
                  for _ in range(2))
        tvs, tvt = (torch.from_numpy(np.asarray(x)) for x in (vs, vt))
    want = jvisc.hdissip_strain_tension(jcfg, jgrid, tension, strain, vs, vt)
    t_tension = tvisc.calc_tension(tgrid, *map(torch.from_numpy, (u, v)))
    t_strain = tvisc.calc_strain(tgrid, *map(torch.from_numpy, (u, v)))
    _same(t_tension, tension, "tension")
    _same(t_strain, strain, "strain")
    got = tvisc.hdissip_strain_tension_plain(tgrid, t_tension, t_strain, tvs,
                                             tvt)
    for label, g, w in zip(("uDiss", "vDiss"), got, want):
        _same(g, w, f"{viscosity}: {label}", whole=False)


# the flux form's dissipation variant: the visc-gyre, its viscosity alone,
# a constant biharmonic viscosity, the drags, free-slip sides
FLUX_CASES = {
    "visc-gyre": {},
    "visc-gyre, free slip": dict(no_slip_sides=False),
    "variable, no biharmonic": dict(viscC4leith=0.0, viscC4leithD=0.0),
    "constant biharmonic": {**OFF, "viscA4": 2.0e9, "viscA4D": 3.0e9},
    "linear and quadratic drag": {**OFF, "bottomDragLinear": 2e-4},
    "linear drag, free-slip bottom": {**OFF, "bottomDragLinear": 2e-4,
                                      "no_slip_bottom": False,
                                      "bottomDragQuadratic": 0.0},
    "no drag": {**OFF, "no_slip_bottom": False, "selectBotDragQuadr": -1},
}
VI_CASES = {
    "visc-vi-gyre": {},
    "leith, quadratic drag": dict(useFullLeith=False,
                                  bottomDragQuadratic=2.5e-3),
    "variable, no biharmonic, explicit": dict(viscC4leith=0.0,
                                              viscC4leithD=0.0,
                                              implicitViscosity=False),
    "constant biharmonic": {**OFF, "viscA4": 2.0e9},
    "strain-tension": {**OFF, "useStrainTensionVisc": True,
                       "viscC2smag": 2.2, "viscAhGridMax": 1.0},
    "strain-tension, constant": {**OFF, "useStrainTensionVisc": True,
                                 "viscAhD": 300.0, "viscAhZ": 500.0},
}


@pytest.mark.parametrize("form,name", [("flux", n) for n in FLUX_CASES]
                         + [("vi", n) for n in VI_CASES])
def test_momentum_dissipation(form, name):
    """guDiss and gvDiss (and gU, gV) of B's and V's dissipation variants'
    twins against JAX's mom_fluxform and mom_vecinv on the interior; the
    vector-invariant quadratic drag, which JAX's mom_vecinv leaves out, is
    held as its difference from JAX's tendency, against the flux form's
    formula."""
    vi = form == "vi"
    cases = VI_CASES if vi else FLUX_CASES
    cfg, jgrid, tgrid, arrays = _case(vi=vi, **cases[name])
    module, jmodule = (tvi.mom_vecinv, jvi.mom_vecinv) if vi else \
        (tff.mom_fluxform, jff.mom_fluxform)
    assert (tvi if vi else tff).uses_visc_variant(cfg)
    jcfg = jax_config(cfg)
    want = jmodule(jcfg, jgrid, *map(jnp.asarray, arrays))
    got = module(cfg, tgrid, *map(torch.from_numpy, arrays))
    want = {n: np.asarray(getattr(want, n)) for n in got._fields}
    if vi and cfg.bottomDragQuadratic != 0.0:
        u, v = arrays[:2]
        ke = jff.calc_ke(jcfg, jgrid, jnp.asarray(u), jnp.asarray(v))
        for name_, vel, di, dj, m, rh in (
                ("guDiss", u, -1, 0, jgrid.maskW, jgrid.recip_hFacW),
                ("gvDiss", v, 0, -1, jgrid.maskS, jgrid.recip_hFacS)):
            from mitgcm_tpu.ops.stencil import shift
            keS = ke + shift(ke, di=di, dj=dj)
            cq = jnp.where(keS > 0.0, cfg.bottomDragQuadratic
                           * jnp.sqrt(jnp.maximum(keS, 0.0)), 0.0)
            below = jnp.concatenate([m[1:], jnp.zeros_like(m[:1])])
            bottom = m * (1.0 - below)
            want[name_] = want[name_] - np.asarray(
                cq * bottom * vel * rh * jgrid.recip_drF[:, None, None] * m)
    for label in got._fields:
        _same(getattr(got, label), want[label], f"{name}: {label}",
              whole=False)


@pytest.mark.parametrize("vi", [False, True])
def test_kernel_twins_take_fields(vi):
    """mom_fluxform_visc and mom_vecinv_visc on the CPU are the twins fed
    the viscosities and the Laplacian given: equal to the whole tendency's
    twin when fed X's and Y's twins."""
    cfg, _, tgrid, arrays = _case(vi=vi)
    ts = [torch.from_numpy(a) for a in arrays]
    visc = tvisc.calc_visc(cfg, tgrid, ts[0], ts[1])
    del2 = tvisc.del2uv(cfg, tgrid, ts[0], ts[1])
    fn = tvi.mom_vecinv_visc if vi else tff.mom_fluxform_visc
    whole = (tvi.mom_vecinv if vi else tff.mom_fluxform)(cfg, tgrid, *ts)
    for a, b in zip(fn(cfg, tgrid, *ts, visc, del2), whole):
        assert torch.equal(a, b)
