"""PyTorch port: the plain VJPs of the step glue's backward kernels F', D',
E', G', L' and R' against jax.vjp of the JAX code their twins replace and
against autograd through the twins, in float64 on the CPU, on seeded
16x16x4 gyre grids with halos of 2 and 4.

- jax.vjp: 12 digits or more (the ROADMAP bar of pointwise and column
  computations). Cotangents are seeded on interior output cells only, as
  tests/test_torch_vjp.py seeds them; the input cotangents are compared on
  every cell.
- autograd through the twin (torch.autograd.grad, the gradient that
  kernels.TwinVJP gave before the backward kernels): cotangents seeded on
  every cell. Bit-equal where the plain VJP adds in autograd's order: F'
  (against the fill's own backward), E', G''s mom_ab_step_adj and
  tracer_step_adj, mom_correction_adj's uStar and vStar cotangents, L',
  R'. Within chip_smoke.py:TOL in float64, 1e-12 relative, where autograd
  adds in an order of its own: D' (its five-term cotangent of phiHydC and
  the running sum's transpose; measured 15.5 digits) and
  mom_correction_adj's etaN cotangent (the level sum and the neighbours'
  terms; 15.6).

AB-2 and AB-3 run on the cold-start (0), second (1) and a later (2) step,
tracer_step with and without AB. The backward kernels are held to these
plain VJPs bit for bit on the host (tests/test_torch_host_kernels.py) and
on the card (chip_smoke.py phase 6).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import gad as jgad
from mitgcm_tpu.model import phihyd as jphi
from mitgcm_tpu.model import step as jstep
from mitgcm_tpu.ops import eos as jeos
from mitgcm_tpu.ops import stencil as jst
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model import gad as tgad
from mitgcm_tpu_torch.model import phihyd as tphi
from mitgcm_tpu_torch.model import step as tstep
from mitgcm_tpu_torch.model import thermodynamics as tth
from mitgcm_tpu_torch.ops import eos as teos
from mitgcm_tpu_torch.ops import stencil as tst
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config

torch.set_num_threads(1)

DIGITS = 12.0
HALOS = [2, 4]
# chip_smoke.py:TOL in float64: the largest relative error of a plain VJP
# against autograd through the twin where their sums run in other orders
TOL = 1e-12
AB3 = {"alph_AB": 0.5, "beta_AB": 5.0 / 12.0}
# (AB-3, step): AB-2 and AB-3 on the cold-start, second and a later step
AB_CASES = [(ab3, it) for ab3 in (False, True) for it in (0, 1, 2)]


def _gyre(ol, **kw):
    """(port cfg, JAX cfg, port grid, JAX grid) of the 16x16x4 gyre."""
    cfg = tsyn.gyre_config(nx=16, ny=16, nr=4, olx=ol, oly=ol, **kw)
    jcfg = jax_config(cfg)
    jgrid = jsyn.gyre_setup(jcfg, dtype=jnp.float64)[0]
    tgrid = convert.from_arrays(Grid, convert.arrays_of(jgrid), device="cpu")
    return cfg, jcfg, tgrid, jgrid


def _interior(rng, shape, ol):
    a = rng.standard_normal(shape)
    a[..., :ol, :] = a[..., -ol:, :] = 0.0
    a[..., :, :ol] = a[..., :, -ol:] = 0.0
    return a


def _jax_vjp(fn, inputs, cotangents):
    out, pull = jax.vjp(fn, *[jnp.asarray(a) for a in inputs])
    return [np.asarray(g) for g in pull(
        type(out)(jnp.asarray(c) for c in cotangents)
        if isinstance(out, (tuple, list)) else jnp.asarray(cotangents[0]))]


def _check_jax(got, want):
    """Every cotangent (None: one JAX gives as zeros) to DIGITS."""
    for k, (g, w) in enumerate(zip(got, want)):
        if g is None:
            assert not np.any(w), f"input {k}: JAX's cotangent is not 0"
            continue
        d = digits(g.numpy(), w)
        assert d >= DIGITS, f"input {k}: {d:.2f} digits"


def _autograd(twin, inputs, bars):
    """torch.autograd.grad of twin(*inputs) with the cotangents bars,
    None for an input that no output reads."""
    xs = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    outs = twin(*xs)
    return torch.autograd.grad(outs, xs, bars, allow_unused=True)


def _check_autograd(got, want, inexact=()):
    """Each cotangent equal to autograd's bit for bit, those of the inputs
    `inexact` within TOL (relative to its largest value)."""
    for k, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            assert w is None or not bool(w.any()), f"input {k}"
            continue
        if k not in inexact or not bool(w.any()):
            assert torch.equal(g, w), f"input {k}: not bit-equal"
        else:
            err = float((g - w).abs().max() / w.abs().max())
            assert err <= TOL, f"input {k}: relative error {err:.3e}"


def _bars(rng, outs):
    return [torch.from_numpy(rng.standard_normal(tuple(o.shape)))
            for o in outs]


# ---------------------------------------------------------------- F'
@pytest.mark.parametrize("ny,nx,oly,olx", [(16, 16, 2, 2), (16, 16, 4, 4),
                                           (3, 5, 4, 4), (2, 6, 3, 2)])
def test_halo_fold_vjp(ny, nx, oly, olx):
    """F''s plain version against jax.vjp of the fill (the whole padded
    cotangent: the fill writes its halo cells) and against the fill's own
    backward on CPU tensors, bit for bit, on a 3-D and a 2-D field, halos
    wider than the interior too."""
    rng = np.random.default_rng(40)
    for shape in ((4, ny + 2 * oly, nx + 2 * olx), (ny + 2 * oly,
                                                    nx + 2 * olx)):
        a = rng.standard_normal(shape)
        bar = rng.standard_normal(shape)
        got = tst.halo_fold_vjp_plain(torch.from_numpy(bar), oly, olx)
        want, = _jax_vjp(lambda x: jst.cyclic_fill_halo(x, oly, olx), [a],
                         [bar])
        _check_jax([got], [want])
        x = torch.from_numpy(a).requires_grad_(True)
        folds = tst.plain_folds
        own, = torch.autograd.grad(tst.cyclic_fill_halo(x, oly, olx), x,
                                   torch.from_numpy(bar))
        assert tst.plain_folds == folds + 1
        assert torch.equal(got, own)


# ---------------------------------------------------------------- D'
@pytest.mark.parametrize("ol", HALOS)
def test_phihyd_vjp(ol):
    cfg, jcfg, tgrid, jgrid = _gyre(ol)
    rng = np.random.default_rng(41)
    shape = jgrid.hFacC.shape
    rho = rng.standard_normal(shape) * np.asarray(jgrid.maskC)
    bars = [_interior(rng, shape, ol) for _ in range(3)]
    got = tphi.phihyd_vjp_plain(cfg, tgrid, *(torch.from_numpy(b)
                                              for b in bars))
    want = _jax_vjp(lambda r: jphi.calc_phi_hyd(jcfg, jgrid, r)[:3], [rho],
                    bars)
    _check_jax([got], want)
    bars = _bars(rng, [got] * 3)
    _check_autograd([tphi.phihyd_vjp_plain(cfg, tgrid, *bars)],
                    _autograd(lambda r: tphi._phi_hyd_plain(cfg, tgrid, r),
                              [rho], bars), inexact=(0,))


# ---------------------------------------------------------------- E'
def _jax_cg2d_b(jcfg, jgrid, monkeypatch):
    """The JAX package's cg2d right-hand side as a function of (uStar,
    vStar, etaN): solve_for_pressure up to the cg2d_b it hands its cg2d
    (caught there)."""
    _, jstate, jforc, jop = jsyn.gyre_setup(jcfg, dtype=jnp.float64)
    seen = {}

    def capture(cfg_, grid_, op_, b, x, **kw):
        seen["b"] = b
        return types.SimpleNamespace(x=x, first_residual=0.0,
                                     last_residual=0.0, n_iters=0)

    monkeypatch.setattr(jstep.cg2d_mod, "cg2d", capture)

    def rhs(uS, vS, eta):
        jstep.solve_for_pressure(jcfg, jgrid, jop, dataclasses.replace(
            jstate, etaN=eta), uS, vS, jforc)
        return seen["b"]
    return rhs


@pytest.mark.parametrize("ol", HALOS)
def test_cg2d_rhs_vjp(ol, monkeypatch):
    cfg, jcfg, tgrid, jgrid = _gyre(ol)
    rng = np.random.default_rng(42)
    shape = jgrid.hFacC.shape
    ins = [rng.standard_normal(shape) * 0.1, rng.standard_normal(shape) * 0.1,
           rng.standard_normal(shape[1:]) * 0.1]
    bar = _interior(rng, shape[1:], ol)
    got = tstep.cg2d_rhs_vjp_plain(cfg, tgrid, torch.from_numpy(bar))
    _check_jax(got, _jax_vjp(_jax_cg2d_b(jcfg, jgrid, monkeypatch), ins,
                             [bar]))
    bars = _bars(rng, [got[2]])
    _check_autograd(tstep.cg2d_rhs_vjp_plain(cfg, tgrid, bars[0]),
                    _autograd(lambda u, v, e: tstep._cg2d_rhs_plain(
                        cfg, tgrid, u, v, e, True), ins, bars))


@pytest.mark.parametrize("ol", HALOS)
def test_continuity_vjp(ol):
    cfg, jcfg, tgrid, jgrid = _gyre(ol)
    rng = np.random.default_rng(43)
    shape = jgrid.hFacC.shape
    ins = [rng.standard_normal(shape) * 0.1, rng.standard_normal(shape) * 0.1,
           rng.standard_normal(shape[1:]) * 1e-6]
    bars = [_interior(rng, shape, ol), _interior(rng, shape[1:], ol)]
    got = tstep.continuity_vjp_plain(cfg, tgrid, *(torch.from_numpy(b)
                                                   for b in bars))
    z2 = jnp.zeros(shape[1:])

    def jfn(u, v, emp):
        out = jstep.integr_continuity(jcfg, jgrid, u, v, z2, z2, z2, emp, 1)
        return out[0], out[-1]
    _check_jax(got, _jax_vjp(jfn, ins, bars))
    bars = _bars(rng, got[:1] + got[2:])
    _check_autograd(tstep.continuity_vjp_plain(cfg, tgrid, *bars),
                    _autograd(lambda u, v, e: tstep._continuity_plain(
                        cfg, tgrid, u, v, e), ins, bars))


# ---------------------------------------------------------------- G'
_MOM_IN = ("gU", "dPhiX", "guDiss", "guExt", "guNm1", "guNm2", "u", "gV",
           "dPhiY", "gvDiss", "gvExt", "gvNm1", "gvNm2", "v")


def _mom_ab_grads(cfg, grid, it, bars):
    """mom_ab_step_vjp_plain's cotangents in the twin's input order."""
    out = tstep.mom_ab_step_vjp_plain(cfg, grid, it, *bars)
    grads = []
    for c in range(2):
        g, dphi, nm1, nm2 = out[4 * c:4 * c + 4]
        grads += [g, dphi, g, g, nm1, nm2, bars[2 * c + 1]]
    return grads


@pytest.mark.parametrize("ab3,it", AB_CASES)
def test_mom_ab_step_vjp(ab3, it):
    """gU, dPhiHydX, guDiss, guExt, guNm1, guNm2 and u's cotangents (and
    v's) from those of gNm1' and u*."""
    cfg, jcfg, tgrid, jgrid = _gyre(2, **(AB3 if ab3 else {}))
    rng = np.random.default_rng(44 + it)
    shape = jgrid.hFacC.shape
    ins = [rng.standard_normal(shape) * (0.1 if n in "uv" else 1e-4)
           for n in _MOM_IN]
    bars = [_interior(rng, shape, 2) for _ in range(4)]
    got = _mom_ab_grads(cfg, tgrid, it, [torch.from_numpy(b) for b in bars])

    def jfn(*J):
        out = []
        for c, mask in ((0, jgrid.maskW), (7, jgrid.maskS)):
            gU, dPhi, diss, ext, nm1, nm2, x = J[c:c + 7]
            g = gU - dPhi + diss + ext
            g_ab = jstep.adams_bashforth(jcfg, g, nm1, nm2, it)[0]
            out += [g, x + jcfg.deltaTMom * g_ab * mask]
        return tuple(out)
    _check_jax(got, _jax_vjp(jfn, ins, bars))
    bars = _bars(rng, [got[0]] * 4)
    # the twin takes the forcing's surface level (kernel Q's), whose
    # cotangent is that level of g's
    grads = _mom_ab_grads(cfg, tgrid, it, bars)
    for k in (3, 10):
        grads[k], ins[k] = grads[k][0], ins[k][0]
    _check_autograd(grads, _autograd(
        lambda *ts: tstep._mom_ab_step_plain(cfg, tgrid, it, *ts), ins,
        bars))


@pytest.mark.parametrize("ol", HALOS)
def test_mom_correction_vjp(ol):
    cfg, jcfg, tgrid, jgrid = _gyre(ol)
    rng = np.random.default_rng(47)
    shape = jgrid.hFacC.shape
    ins = [rng.standard_normal(shape[1:]) * 0.1,
           rng.standard_normal(shape) * 0.1, rng.standard_normal(shape) * 0.1]
    bars = [_interior(rng, shape, ol) for _ in range(2)]
    got = tstep.mom_correction_vjp_plain(cfg, tgrid, *(torch.from_numpy(b)
                                                       for b in bars))
    _check_jax(got, _jax_vjp(lambda e, u, v: jstep.momentum_correction_step(
        jcfg, jgrid, e, u, v, None), ins, bars))
    bars = _bars(rng, got[1:])
    _check_autograd(tstep.mom_correction_vjp_plain(cfg, tgrid, *bars),
                    _autograd(lambda e, u, v: tstep._mom_correction_plain(
                        cfg, tgrid, e, u, v), ins, bars), inexact=(0,))


@pytest.mark.parametrize("ab3,it,use_ab", [(a, i, True) for a, i in AB_CASES]
                         + [(False, 1, False), (True, 1, False)])
def test_tracer_step_vjp(ab3, it, use_ab):
    """gTr, tracer, gNm1, gNm2 and the surface forcing's cotangents from
    those of tracer' and (with AB) the raw tendency."""
    cfg, jcfg, tgrid, jgrid = _gyre(2, **(AB3 if ab3 else {}))
    rng = np.random.default_rng(48 + it)
    shape = jgrid.hFacC.shape
    ins = [rng.standard_normal(shape) * 1e-5,
           15.0 + 2.0 * rng.standard_normal(shape),
           rng.standard_normal(shape) * 1e-5,
           rng.standard_normal(shape) * 1e-5,
           rng.standard_normal(shape[1:]) * 1e-3]
    bars = [_interior(rng, shape, 2) for _ in range(2 if use_ab else 1)]
    got = tth.tracer_step_vjp_plain(cfg, tgrid, it, use_ab,
                                    *(torch.from_numpy(b) for b in bars))
    ks = jcfg.ksurf0

    def jfn(gTr, tr, g1, g2, sfc):
        gForc = jnp.zeros(shape).at[ks].add(
            sfc * jgrid.recip_drF[ks] * jgrid.recip_hFacC[ks])
        g = gTr + gForc
        if not use_ab:
            return (tr + jcfg.deltaTTracer * g,)
        g_ab = jstep.adams_bashforth(jcfg, g, g1, g2, it)[0]
        return tr + jcfg.deltaTTracer * g_ab, g
    _check_jax(got, _jax_vjp(jfn, ins, bars))
    bars = _bars(rng, got[:len(bars)])
    _check_autograd(tth.tracer_step_vjp_plain(cfg, tgrid, it, use_ab, *bars),
                    _autograd(lambda *ts: tth._tracer_step_plain(
                        cfg, tgrid, it, use_ab, *ts), ins, bars))


# ---------------------------------------------------------------- L'
@pytest.mark.parametrize("ol", HALOS)
def test_adv_flow_vjp(ol):
    """u, v and w's cotangents from those of uTrans, vTrans, rTrans and
    rTransKp."""
    cfg, jcfg, tgrid, jgrid = _gyre(ol)
    rng = np.random.default_rng(50)
    shape = jgrid.hFacC.shape
    ins = [rng.standard_normal(shape) for _ in range(3)]
    bars = [_interior(rng, shape, ol) for _ in range(4)]
    got = tgad.adv_flow_vjp_plain(tgrid, *(torch.from_numpy(b)
                                           for b in bars))
    _check_jax(got, _jax_vjp(lambda u, v, w: tuple(jgad.calc_adv_flow(
        jcfg, jgrid, u, v, w))[:4], ins, bars))
    bars = _bars(rng, [got[0]] * 4)
    _check_autograd(tgad.adv_flow_vjp_plain(tgrid, *bars), _autograd(
        lambda u, v, w: tgad._calc_adv_flow_plain(tgrid, u, v, w)[:4], ins,
        bars))


# ---------------------------------------------------------------- R'
@pytest.mark.parametrize("masked", [True, False])
def test_eos_linear_vjp(masked):
    """theta and salt's cotangents of the LINEAR kind, times maskC (the
    step's rhoInSitu) or not."""
    cfg, jcfg, tgrid, jgrid = _gyre(2)
    rng = np.random.default_rng(51)
    shape = jgrid.hFacC.shape
    ins = [15.0 + 2.0 * rng.standard_normal(shape),
           35.0 + 0.5 * rng.standard_normal(shape)]
    bar = _interior(rng, shape, 2)
    mask = tgrid.maskC if masked else None
    got = teos.eos_linear_vjp_plain(cfg, torch.from_numpy(bar), mask)

    def jfn(t, s):
        rho = jeos.find_rho(jcfg, jgrid, t, s)
        return rho * jgrid.maskC if masked else rho
    _check_jax(got, _jax_vjp(jfn, ins, [bar]))
    bars = _bars(rng, [got[0]])
    _check_autograd(teos.eos_linear_vjp_plain(cfg, bars[0], mask), _autograd(
        lambda t, s: teos._find_rho_plain(cfg, tgrid, t, s, None, mask), ins,
        bars))


# --------------------------------------------------- the wrappers' refusals
def _kernel_path(monkeypatch):
    """Every wrapper on its kernel path for CPU tensors, its forward
    kernel replaced by its twin; no backward kernel runs here."""
    from mitgcm_tpu_torch import kernels

    monkeypatch.setattr(kernels, "use_kernel",
                        lambda t, impl=None: impl != "plain")
    monkeypatch.setattr(tphi, "_phi_hyd_kernel", tphi._phi_hyd_plain)
    monkeypatch.setattr(tstep, "_cg2d_rhs_kernel", tstep._cg2d_rhs_plain)
    monkeypatch.setattr(tstep, "_continuity_kernel", tstep._continuity_plain)
    monkeypatch.setattr(tstep, "_mom_ab_step_kernel",
                        tstep._mom_ab_step_plain)
    monkeypatch.setattr(tstep, "_mom_correction_kernel",
                        tstep._mom_correction_plain)
    monkeypatch.setattr(tth, "_tracer_step_kernel", tth._tracer_step_plain)
    monkeypatch.setattr(tgad, "_calc_adv_flow_kernel",
                        tgad._calc_adv_flow_plain)
    monkeypatch.setattr(teos, "_find_rho_kernel",
                        lambda *a: (teos._find_rho_plain(*a),))


def _calls(cfg, grid, rng):
    """{wrapper: (the grid field its backward kernel takes as a constant,
    a call of the wrapper on seeded inputs that require grad)}."""
    shape = tuple(grid.hFacC.shape)

    def t(s=shape):
        return torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)

    state = types.SimpleNamespace(uVel=t(), vVel=t(), guNm1=t(), gvNm1=t(),
                                  guNm2=None, gvNm2=None, gwNm2=None)
    tend = types.SimpleNamespace(gU=t(), gV=t(), guDiss=t(), gvDiss=t())
    return {
        "calc_phi_hyd": ("recip_dxC", lambda g: tphi.calc_phi_hyd(
            cfg, g, t())[:3]),
        "mom_ab_step": ("maskW", lambda g: tstep.mom_ab_step(
            cfg, g, state, tend, t(), t(), t(), t(), 1)[:4]),
        "cg2d_rhs": ("hFacW", lambda g: tstep.cg2d_rhs(
            cfg, g, t(), t(), t(shape[1:]))),
        "momentum_correction_step": ("Bo_surf", lambda g:
                                     tstep.momentum_correction_step(
                                         cfg, g, t(shape[1:]), t(), t())),
        "integr_continuity": ("maskC", lambda g: tstep.integr_continuity(
            cfg, g, t(), t(), t(shape[1:]))),
        "tracer_step": ("recip_hFacC", lambda g: tth.tracer_step(
            cfg, g, t(), t(), t(), None, t(shape[1:]), 1, True)[:2]),
        "calc_adv_flow": ("hFacW", lambda g: tuple(tgad.calc_adv_flow(
            g, t(), t(), t()))[:4]),
        "find_rho": ("mask", lambda g: (teos.find_rho(
            cfg, g, t(), t(), mask=g.maskC),)),
    }


WRAPPERS = ("calc_phi_hyd", "mom_ab_step", "cg2d_rhs",
            "momentum_correction_step", "integr_continuity", "tracer_step",
            "calc_adv_flow", "find_rho")


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_path_saves_nothing_and_refuses_constants(name, monkeypatch):
    """On the kernel path (kernels.KernelVJP) each wrapper's outputs keep
    no saved tensor for their backward, and a grid field that its backward
    kernel reads as a constant, given requires_grad, is refused by name."""
    _kernel_path(monkeypatch)
    cfg, _, tgrid, _ = _gyre(2)
    field, call = _calls(cfg, tgrid, np.random.default_rng(60))[name]
    outs = call(tgrid)
    fn = outs[0].grad_fn
    assert type(fn).__name__ == "KernelVJPBackward"
    assert fn.saved_tensors == ()
    const = "maskC" if field == "mask" else field
    g = dataclasses.replace(tgrid, **{const: getattr(
        tgrid, const).clone().requires_grad_(True)})
    with pytest.raises(ValueError, match=field):
        call(g)


def test_twin_vjp_counts_its_backward_runs():
    """kernels.TwinVJP, kept for the kernels that the adjoint refuses,
    counts each backward run under "twin_vjp" and the twin's name, so that
    a run of the card can show the gyre's gradient ran none."""
    from mitgcm_tpu_torch import kernels

    cfg, _, tgrid, _ = _gyre(2)
    x = torch.from_numpy(np.random.default_rng(61).standard_normal(
        tuple(tgrid.hFacC.shape))).requires_grad_(True)

    def twin(rho):
        return tphi._phi_hyd_plain(cfg, tgrid, rho)

    before = dict(kernels.launches)
    outs = kernels.TwinVJP.apply(twin, twin, x)
    torch.autograd.grad(outs[0].sum(), x)
    assert kernels.launches["twin_vjp"] == before.get("twin_vjp", 0) + 1
    assert kernels.launches["twin_vjp:_phi_hyd_plain"] == before.get(
        "twin_vjp:_phi_hyd_plain", 0) + 1
