"""PyTorch port: the plain twins of the step's glue kernels against the JAX
package, in float64 on the CPU, on seeded 16x16x4 gyre grids with halos
of 2 and 4 (and a halo wider than the interior for F), and the
differentiable wrappers of D, E and G against autograd through their twins.

- F, the halo wrap (ops/stencil.py): the gather against JAX's
  cyclic_fill_halo, bit for bit; its backward (the fold) against
  index_select's autograd backward to 14 digits (the two add the halo
  cotangents in other orders).
- D (model/phihyd.py), E (model/step.py: the cg2d right-hand side and
  continuity's w) and G (model/step.py: the momentum tendency's assembly,
  AB-2/AB-3 and u*, w* on the non-hydrostatic path; the momentum
  correction with and without phi_nh; model/thermodynamics.py: the
  tracer's forcing, AB and step) against the JAX code they replace, on
  whole padded arrays: 12 digits, the ROADMAP bar of pointwise and column
  computations (measured: 16, equal, on every output here).
- kernels.TwinVJP with the twin as its forward: the gradient equals
  autograd through the twin bit for bit.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import calc_gw as jgw
from mitgcm_tpu.model import phihyd as jphi
from mitgcm_tpu.model import step as jstep
from mitgcm_tpu.ops import stencil as jst
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import phihyd as tphi
from mitgcm_tpu_torch.model import step as tstep
from mitgcm_tpu_torch.model import thermodynamics as tth
from mitgcm_tpu_torch.model.mom_fluxform import MomTend
from mitgcm_tpu_torch.ops import stencil as tst
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config
from test_torch_grid import nh_walled_config, nh_walled_grid

torch.set_num_threads(1)

DIGITS = 12.0
HALOS = [2, 4]


def _gyre(ol, **kw):
    """(port cfg, JAX cfg, port grid, JAX grid) of the 16x16x4 gyre."""
    cfg = tsyn.gyre_config(nx=16, ny=16, nr=4, olx=ol, oly=ol, **kw)
    jcfg = jax_config(cfg)
    jgrid = jsyn.gyre_setup(jcfg, dtype=jnp.float64)[0]
    tgrid = convert.from_arrays(Grid, convert.arrays_of(jgrid), device="cpu")
    return cfg, jcfg, tgrid, jgrid


def _rand(rng, shape, scale, mask=None):
    a = scale * rng.standard_normal(shape)
    return a if mask is None else a * np.asarray(mask)


def _check(got, want, bar=DIGITS):
    for g, w in zip(got, want):
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        d = digits(g, np.asarray(w))
        assert d >= bar, f"{d:.2f} digits"


# ---------------------------------------------------------------- F
# (ny, nx, oly, olx): the last two halos are wider than the interior
@pytest.mark.parametrize("ny,nx,oly,olx", [(16, 16, 2, 2), (16, 16, 4, 4),
                                           (3, 5, 4, 4), (2, 6, 3, 2)])
def test_halo_fill_twin_matches_jax(ny, nx, oly, olx):
    """F's twin and the wrapper on CPU tensors against JAX, bit for bit
    (a copy), on a 3-D and a 2-D field."""
    rng = np.random.default_rng(10)
    for shape in ((4, ny + 2 * oly, nx + 2 * olx), (ny + 2 * oly,
                                                    nx + 2 * olx)):
        a = rng.standard_normal(shape)
        want = np.asarray(jst.cyclic_fill_halo(jnp.asarray(a), oly, olx))
        calls = tst.plain_calls
        got = tst.cyclic_fill_halo(torch.from_numpy(a), oly, olx)
        assert tst.plain_calls == calls + 1
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(tst._gather(torch.from_numpy(a), oly,
                                          olx).numpy(), want)


@pytest.mark.parametrize("oly,olx", [(2, 2), (4, 3)])
def test_halo_fill_backward_matches_gather(oly, olx):
    """The fill's backward (the fold) against autograd through the gather:
    14 digits (the sums of the wrapped cotangents run in other orders)."""
    rng = np.random.default_rng(11)
    shape = (3, 3 + 2 * oly, 5 + 2 * olx)
    a = torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)
    bar = torch.from_numpy(rng.standard_normal(shape))
    g1, = torch.autograd.grad(tst.cyclic_fill_halo(a, oly, olx), a, bar)
    g2, = torch.autograd.grad(tst._gather(a, oly, olx), a, bar)
    assert digits(g1.numpy(), g2.numpy()) >= 14.0


# ---------------------------------------------------------------- D
@pytest.mark.parametrize("ol", HALOS)
def test_phihyd_twin_matches_jax(ol):
    cfg, jcfg, tgrid, jgrid = _gyre(ol)
    rng = np.random.default_rng(12)
    rho = _rand(rng, jgrid.hFacC.shape, 0.5, jgrid.maskC)
    want = jphi.calc_phi_hyd(jcfg, jgrid, jnp.asarray(rho))[:3]
    got = tphi._phi_hyd_plain(cfg, tgrid, torch.from_numpy(rho))
    _check(got, want)
    assert all(torch.equal(a, b) for a, b in zip(
        got, tphi.calc_phi_hyd(cfg, tgrid, torch.from_numpy(rho))))


# ---------------------------------------------------------------- E
class _Captured(Exception):
    pass


@pytest.mark.parametrize("ol", HALOS)
def test_cg2d_rhs_twin_matches_jax(ol, monkeypatch):
    """The hydrostatic cg2d right-hand side against the cg2d_b that JAX's
    solve_for_pressure hands its cg2d (caught there)."""
    cfg, jcfg, tgrid, jgrid = _gyre(ol)
    _, jstate, jforc, jop = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    rng = np.random.default_rng(13)
    shape = jgrid.hFacC.shape
    uS = _rand(rng, shape, 0.1, jgrid.maskW)
    vS = _rand(rng, shape, 0.1, jgrid.maskS)
    eta = _rand(rng, shape[1:], 0.1)
    seen = {}

    def capture(cfg_, grid_, op_, b, x, **kw):
        seen["b"] = np.asarray(b)
        raise _Captured

    monkeypatch.setattr(jstep.cg2d_mod, "cg2d", capture)
    with pytest.raises(_Captured):
        jstep.solve_for_pressure(jcfg, jgrid, jop,
                                 dataclasses.replace(
                                     jstate, etaN=jnp.asarray(eta)),
                                 jnp.asarray(uS), jnp.asarray(vS), jforc)
    got = tstep._cg2d_rhs_plain(cfg, tgrid, torch.from_numpy(uS),
                                torch.from_numpy(vS), torch.from_numpy(eta),
                                True)
    _check(got, [seen["b"]])


@pytest.mark.parametrize("ol", HALOS)
def test_continuity_twin_matches_jax(ol):
    cfg, jcfg, tgrid, jgrid = _gyre(ol)
    rng = np.random.default_rng(14)
    shape = jgrid.hFacC.shape
    u = _rand(rng, shape, 0.1, jgrid.maskW)
    v = _rand(rng, shape, 0.1, jgrid.maskS)
    emp = _rand(rng, shape[1:], 1e-6)
    z2 = jnp.zeros(shape[1:])
    w, *_, pmepr = jstep.integr_continuity(jcfg, jgrid, jnp.asarray(u),
                                           jnp.asarray(v), z2, z2, z2,
                                           jnp.asarray(emp), 1)
    got = tstep._continuity_plain(cfg, tgrid, torch.from_numpy(u),
                                  torch.from_numpy(v), torch.from_numpy(emp))
    _check(got, [w, pmepr])


# ---------------------------------------------------------------- G
_MOM = ("gU", "gV", "guDiss", "gvDiss", "dPhiX", "dPhiY", "guExt", "gvExt",
        "guNm1", "gvNm1", "guNm2", "gvNm2", "gW", "gwDiss", "gwNm1", "gwNm2")


def _mom_inputs(grid, seed):
    rng = np.random.default_rng(seed)
    shape = grid.hFacC.shape
    f = {k: _rand(rng, shape, 1e-4) for k in _MOM}
    # apply_forcing.F's wind stress: the surface level alone (the port's
    # mom_ab_step takes that level, kernel Q's)
    f["guExt"][1:] = 0.0
    f["gvExt"][1:] = 0.0
    f["u"] = _rand(rng, shape, 0.1, grid.maskW)
    f["v"] = _rand(rng, shape, 0.1, grid.maskS)
    f["w"] = _rand(rng, shape, 1e-3, grid.maskC)
    return f


def _mom_ab_want(jcfg, jgrid, f, it, nh):
    """The JAX package's assembly, adams_bashforth and predictor
    (step.py:300-357), and with nh the AB of gW and timestep_wvel."""
    J = {k: jnp.asarray(v) for k, v in f.items()}
    out = []
    for c, x, mask in (("u", "u", jgrid.maskW), ("v", "v", jgrid.maskS)):
        g = J[f"g{c.upper()}"] - J[f"dPhi{'X' if c == 'u' else 'Y'}"] \
            + J[f"g{c}Diss"] + J[f"g{c}Ext"]
        g_ab, g1, g2 = jstep.adams_bashforth(jcfg, g, J[f"g{c}Nm1"],
                                             J[f"g{c}Nm2"], it)
        out += [g1, J[x] + jcfg.deltaTMom * g_ab * mask, g2]
    if nh:
        g = J["gW"] + J["gwDiss"]
        g_ab, g1, g2 = jstep.adams_bashforth(jcfg, g, J["gwNm1"],
                                             J["gwNm2"], it)
        out += [g1, jgw.timestep_wvel(jcfg, jgrid, J["w"], g_ab), g2]
    return out


def _mom_ab_got(cfg, grid, f, it, nh, impl=None):
    T = {k: torch.from_numpy(v) for k, v in f.items()}
    state = types.SimpleNamespace()
    for k, name in (("u", "uVel"), ("v", "vVel"), ("w", "wVel")):
        setattr(state, name, T[k])
    for k in ("guNm1", "gvNm1", "guNm2", "gvNm2", "gwNm1", "gwNm2"):
        setattr(state, k, T[k])
    tend = MomTend(T["gU"], T["gV"], T["guDiss"], T["gvDiss"])
    uS, vS, gu1, gv1, gu2, gv2, nhd = tstep.mom_ab_step(
        cfg, grid, state, tend, T["dPhiX"], T["dPhiY"], T["guExt"][0],
        T["gvExt"][0], it, impl=impl,
        gw=(T["gW"], T["gwDiss"]) if nh else None)
    out = [gu1, uS, gu2, gv1, vS, gv2]
    if nh:
        out += [nhd["gwNm1"], nhd["wStar"], nhd["gwNm2"]]
    return out


@pytest.mark.parametrize("ab3", [False, True])
@pytest.mark.parametrize("it", [0, 1, 2])
def test_mom_ab_step_twin_matches_jax(ab3, it):
    """On the cold-start (0), second (1) and a later (2) step, under AB-2
    and AB-3: gNm1', u*, gNm2' of u and v."""
    cfg, jcfg, tgrid, jgrid = _gyre(2, **({"alph_AB": 0.5, "beta_AB":
                                           5.0 / 12.0} if ab3 else {}))
    assert cfg.useAB3 == ab3
    f = _mom_inputs(jgrid, 15 + it)
    _check(_mom_ab_got(cfg, tgrid, f, it, False),
           _mom_ab_want(jcfg, jgrid, f, it, False))


@pytest.mark.parametrize("it", [0, 1, 2])
def test_mom_ab_step_nh_twin_matches_jax(it):
    """The non-hydrostatic flag on the walled box: u, v and w."""
    cfg = nh_walled_config()
    jgrid, tgrid = nh_walled_grid(cfg)
    f = _mom_inputs(jgrid, 18 + it)
    _check(_mom_ab_got(cfg, tgrid, f, it, True),
           _mom_ab_want(jax_config(cfg), jgrid, f, it, True))


@pytest.mark.parametrize("nh", [False, True])
def test_mom_correction_twin_matches_jax(nh):
    if nh:
        cfg = nh_walled_config()
        jcfg = jax_config(cfg)
        jgrid, tgrid = nh_walled_grid(cfg)
    else:
        cfg, jcfg, tgrid, jgrid = _gyre(4)
    rng = np.random.default_rng(21)
    shape = jgrid.hFacC.shape
    uS = _rand(rng, shape, 0.1, jgrid.maskW)
    vS = _rand(rng, shape, 0.1, jgrid.maskS)
    eta = _rand(rng, shape[1:], 0.1)
    phi = _rand(rng, shape, 1.0) if nh else None
    want = jstep.momentum_correction_step(
        jcfg, jgrid, jnp.asarray(eta), jnp.asarray(uS), jnp.asarray(vS),
        None if phi is None else jnp.asarray(phi))
    got = tstep.momentum_correction_step(
        cfg, tgrid, torch.from_numpy(eta), torch.from_numpy(uS),
        torch.from_numpy(vS), None if phi is None else torch.from_numpy(phi))
    _check(got, want)


@pytest.mark.parametrize("ab3", [False, True])
@pytest.mark.parametrize("it,use_ab", [(0, True), (1, True), (2, True),
                                       (1, False)])
def test_tracer_step_twin_matches_jax(ab3, it, use_ab):
    """The surface forcing into ksurf0, the AB (scheme 2) or none, and the
    step (thermodynamics.py:329-358 of the JAX package): tracer', gNm1',
    gNm2'."""
    cfg, jcfg, tgrid, jgrid = _gyre(2, **({"alph_AB": 0.5, "beta_AB":
                                           5.0 / 12.0} if ab3 else {}))
    rng = np.random.default_rng(22 + it)
    shape = jgrid.hFacC.shape
    gTr, g1, g2 = (_rand(rng, shape, 1e-5) for _ in range(3))
    tr = 15.0 + _rand(rng, shape, 2.0)
    sfc = _rand(rng, shape[1:], 1e-3)
    ks = jcfg.ksurf0
    gForc = jnp.zeros(shape).at[ks].add(
        jnp.asarray(sfc) * jgrid.recip_drF[ks] * jgrid.recip_hFacC[ks])
    g = jnp.asarray(gTr) + gForc
    if use_ab:
        g_ab, n1, n2 = jstep.adams_bashforth(jcfg, g, jnp.asarray(g1),
                                             jnp.asarray(g2), it)
    else:
        g_ab, n1, n2 = g, g1, g2
    want = [jnp.asarray(tr) + jcfg.deltaTTracer * g_ab, n1, n2]
    got = tth.tracer_step(cfg, tgrid, *(torch.from_numpy(a) for a in (
        gTr, tr, g1, g2, sfc)), it, use_ab)
    _check(got, want)


# ------------------------------------------------ autograd (TwinVJP)
def _vjp_cases():
    """(name, twin, inputs) of each kernel's wrapper on the gyre."""
    cfg, _, grid, _ = _gyre(2)
    rng = np.random.default_rng(30)
    shape = tuple(grid.hFacC.shape)

    def t(scale, s=shape):
        return torch.from_numpy(_rand(rng, s, scale))

    f = _mom_inputs(grid, 31)
    # the forcing's surface level, as the twin takes it
    mom = [torch.from_numpy(f[k][0] if k.endswith("Ext") else f[k])
           for k in ("gU", "dPhiX", "guDiss", "guExt", "guNm1", "guNm2", "u",
                     "gV", "dPhiY", "gvDiss", "gvExt", "gvNm1", "gvNm2",
                     "v")]
    return {
        "phihyd": (lambda rho: tphi._phi_hyd_plain(cfg, grid, rho),
                   [t(0.5)]),
        "cg2d_rhs": (lambda u, v, e: tstep._cg2d_rhs_plain(cfg, grid, u, v,
                                                           e, True),
                     [t(0.1), t(0.1), t(0.1, shape[1:])]),
        # the non-hydrostatic sum and each level's divergence
        "cg2d_rhs(nh)": (lambda u, v, e, phi: tstep._cg2d_rhs_plain(
            cfg, grid, u, v, e, False, phi),
                         [t(0.1), t(0.1), t(0.1, shape[1:]), t(1.0)]),
        "continuity": (lambda u, v, e: tstep._continuity_plain(cfg, grid, u,
                                                               v, e),
                       [t(0.1), t(0.1), t(1e-6, shape[1:])]),
        "mom_ab_step": (lambda *ts: tstep._mom_ab_step_plain(cfg, grid, 1,
                                                             *ts), mom),
        "mom_correction": (lambda e, u, v: tstep._mom_correction_plain(
            cfg, grid, e, u, v), [t(0.1, shape[1:]), t(0.1), t(0.1)]),
        "tracer_step": (lambda *ts: tth._tracer_step_plain(cfg, grid, 1,
                                                           True, *ts),
                        [t(1e-5), t(2.0), t(1e-5), None,
                         t(1e-3, shape[1:])]),
        # without AB the twin has one output
        "tracer_step(no AB)": (lambda *ts: tth._tracer_step_plain(
            cfg, grid, 1, False, *ts), [t(1e-5), t(2.0), None, None,
                                        t(1e-3, shape[1:])]),
    }


@pytest.mark.parametrize("name", ["phihyd", "cg2d_rhs", "cg2d_rhs(nh)",
                                  "continuity", "mom_ab_step",
                                  "mom_correction", "tracer_step",
                                  "tracer_step(no AB)"])
def test_twin_vjp_gradient_is_the_twins(name):
    """kernels.TwinVJP with the twin in the kernel's place: its outputs and
    its gradient (every differentiable input, seeded cotangents) equal
    autograd through the twin bit for bit."""
    twin, ins = _vjp_cases()[name]
    rng = np.random.default_rng(32)
    grads = []
    for wrapped in (True, False):
        xs = [None if x is None else x.clone().requires_grad_(True)
              for x in ins]
        outs = (kernels.TwinVJP.apply(twin, twin, *xs) if wrapped
                else twin(*xs))
        bars = [torch.from_numpy(rng.standard_normal(tuple(o.shape)))
                for o in outs]
        rng = np.random.default_rng(32)
        live = [x for x in xs if x is not None]
        grads.append((outs, torch.autograd.grad(outs, live, bars,
                                                allow_unused=True)))
    (o1, g1), (o2, g2) = grads
    assert all(torch.equal(a, b) for a, b in zip(o1, o2))
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(g1, g2))
    assert any(a is not None and bool(a.abs().max() > 0) for a in g1)
