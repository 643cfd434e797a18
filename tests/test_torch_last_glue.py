"""The twins of the last plain glue held bit for bit against the code they
replaced (copied here as it stood, `_former_*`), on the CPU: kernel E's
non-hydrostatic cg2d_rhs with pre_cg3d's surface term, N1 (pre_cg3d), N2
(cg3d's set-up and end), Q (the surface forcing, once a step where two
calls were), G's mom_ab_step on the forcing's surface level, S1 (the sea
ice's set-up), S2 (its ocean stress, the no-dynamics drag and EVP's
clip), the `+ gTr` addend of the multi-dimensional and SOM advection and
the constant kappas built once (two configurations on one grid keep
their own values). The kernels themselves are held against these twins on
the host mock (tests/test_torch_host_kernels.py) and on the card
(chip_smoke.py phase 18)."""

import dataclasses
import gc
import math
import weakref

import numpy as np
import pytest
import torch

from mitgcm_tpu_torch.core.grid import build_grid
from mitgcm_tpu_torch.model import gad, seaice, som, step
from mitgcm_tpu_torch.model import thermodynamics as th
from mitgcm_tpu_torch.model.experiment import Experiment
from mitgcm_tpu_torch.model.step import load_fields
from mitgcm_tpu_torch.ops.stencil import interior_mask, shift as sh
from mitgcm_tpu_torch.solver import cg3d
from mitgcm_tpu_torch.utils import synthetic

DTYPES = (torch.float64, torch.float32)


def same(a, b):
    """Equal on every cell, NaN in the same cells, signed zeros alike."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(torch.signbit(a), torch.signbit(b))
            and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def check(got, want, label):
    assert len(got) == len(want), label
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), f"{label} {k}"
        assert g is None or same(g, w), f"{label} {k}"


def rand(rng, shape, scale, dtype):
    return torch.as_tensor(scale * rng.standard_normal(shape), dtype=dtype)


@pytest.fixture(scope="module")
def box():
    """The 16x16x12 nh-convection box's grid with a column whose surface
    is below the top level and a dry one (kSurfC 3 and nr + 1)."""
    cfg = synthetic.nh_convection_config(nx=16, ny=16, nr=12)
    grid = build_grid(cfg, dtype=torch.float64, device="cpu")
    ks = grid.kSurfC.clone()
    ks[5, 6], ks[7, 8] = 3.0, cfg.nr + 1.0
    return cfg, dataclasses.replace(grid, kSurfC=ks)


# ------------------------------------------------------------- E and N1
def _former_nh_rhs(cfg, grid, uStar, vStar, etaN, phi_nh):
    """The former code's non-hydrostatic right-hand sides: E's twin's sum and
    divergence, then solve_for_pressure's surface term."""
    pfx, pfy = step._predicted_transport(cfg, grid, uStar, vStar)
    dbx = sh(pfx, di=1) - pfx
    dby = sh(pfy, dj=1) - pfy
    cg2d_b = torch.zeros_like(etaN)
    for k in range(cfg.nr - 1, -1, -1):
        cg2d_b = cg2d_b + dbx[k]
        cg2d_b = cg2d_b + dby[k]
    div = dbx + dby
    k3 = torch.arange(cfg.nr)[:, None, None]
    selS = (k3 == grid.kSurfC[None] - 1) & (grid.kSurfC[None] <= cfg.nr)
    zero = torch.zeros((), dtype=uStar.dtype)
    surfT = -step._surf_c(cfg, grid) * (etaN + torch.sum(
        torch.where(selS, phi_nh, zero), dim=0) * grid.recip_Bo)
    imask = interior_mask(etaN.shape, cfg.oly, cfg.olx, etaN.dtype, "cpu")
    return (cg2d_b + surfT) * imask, div + torch.where(selS, surfT[None],
                                                        zero)


def _former_pre_cg3d(cfg, grid, cg2dx, etaN, wk, cg3d_b):
    """The former code's pre_cg3d glue, its divisions by Python numbers."""
    drF = grid.drF[:, None, None]
    k3 = torch.arange(cfg.nr)[:, None, None]
    psFac = cfg.implicSurfPress * cfg.implicDiv2Dflow
    uf = -grid.recip_dxC * psFac * (cg2dx - sh(cg2dx, di=-1))
    vf = -grid.recip_dyC * psFac * (cg2dx - sh(cg2dx, dj=-1))
    fx = drF * grid.dyG[None] * grid.hFacW * uf[None]
    fy = drF * grid.dxG[None] * grid.hFacS * vf[None]
    wkp1 = torch.cat([wk[1:], torch.zeros_like(wk[:1])])
    maskC_km1 = torch.cat([torch.ones_like(grid.maskC[:1]),
                           grid.maskC[:-1]])
    wterm = torch.where(
        k3 == 0, cfg.freeSurfFac * etaN[None] / cfg.deltaTFreeSurf - wkp1,
        wk * maskC_km1 - wkp1) * grid.rA[None] / cfg.deltaTMom
    cg3d_b = cg3d_b + (sh(fx, di=1) - fx)
    cg3d_b = cg3d_b + (sh(fy, dj=1) - fy)
    return cg3d_b + wterm


def test_cg2d_rhs_nh_twin_matches_former_code(box):
    """E's non-hydrostatic twin with the surface term folded in: the
    former code's right-hand side and divergence bit for bit, a -0.0 phi_nh at
    a surface level and a dry column included."""
    cfg, grid = box
    rng = np.random.default_rng(1)
    shape = tuple(grid.hFacC.shape)
    u, v = rand(rng, shape, 0.1, torch.float64), rand(rng, shape, 0.1,
                                                      torch.float64)
    phi = rand(rng, shape, 1.0, torch.float64)
    phi[2, 5, 6] = -0.0
    eta = rand(rng, shape[1:], 0.1, torch.float64)
    check(step._cg2d_rhs_plain(cfg, grid, u, v, eta, False, phi),
          _former_nh_rhs(cfg, grid, u, v, eta, phi), "cg2d_rhs(nh)")


def test_pre_cg3d_twin_matches_former_code(box):
    """N1's twin divides as tensors; on the CPU the former code's division by
    a Python number is the same IEEE division."""
    cfg, grid = box
    rng = np.random.default_rng(2)
    shape = tuple(grid.hFacC.shape)
    x2, eta = (rand(rng, shape[1:], s, torch.float64) for s in (10.0, 0.1))
    w, div = (rand(rng, shape, s, torch.float64) for s in (1e-3, 1e-2))
    check([step._pre_cg3d_plain(cfg, grid, x2, eta, w, div)[0]],
          [_former_pre_cg3d(cfg, grid, x2, eta, w, div)], "pre_cg3d")


# ------------------------------------------------------------------- N2
@pytest.mark.parametrize("case", ("normalise", "no normalise", "rhsMax 0"))
def test_cg3d_setup_twin_matches_former_code(box, case):
    """N2's twins: the former code's set-up (r a clone of b) and end."""
    cfg, grid = box
    op = cg3d.build_cg3d(cfg, grid)
    rng = np.random.default_rng(3)
    shape = tuple(grid.hFacC.shape)
    b = rand(rng, shape, 1.0, torch.float64) * (case != "rhsMax 0")
    x0 = rand(rng, shape, 1.0, torch.float64)
    normalise = case != "no normalise"
    imask = interior_mask(shape, cfg.oly, cfg.olx, b.dtype, "cpu") \
        * grid.maskC
    want_b = b * op.cg3dNorm * imask
    want_x0 = x0
    if normalise:
        rhsMax = torch.max(torch.abs(want_b))
        rhsNorm = torch.where(rhsMax != 0.0, 1.0 / rhsMax,
                              torch.ones_like(rhsMax))
        want_b = want_b * rhsNorm
        want_x0 = x0 * rhsNorm
    want = [want_b.clone(), want_x0 * imask] + [torch.zeros_like(b)] * 4
    got = cg3d._setup_plain(op, b, x0, normalise)
    check(list(got[:6]), want, case)
    if normalise:
        assert same(got[6], rhsNorm)
    else:
        assert got[6] is None


# ---------------------------------------------------------------- Q, G
def _former_surface_forcing_ts(cfg, grid, state, forcing):
    sfT = torch.zeros_like(state.etaN)
    sfS = torch.zeros_like(state.etaN)
    ks = cfg.ksurf0
    openFrac = 1.0
    if (cfg.useSEAICE and cfg.seaice is not None
            and not cfg.seaice.restoreUnderIce
            and state.siAREA is not None and state.siAREA.dim() == 2):
        openFrac = 1.0 - state.siAREA
    if cfg.tauThetaClimRelax > 0.0:
        lam = 1.0 / cfg.tauThetaClimRelax
        sfT = sfT - lam * openFrac * (state.theta[ks] - forcing.SST) \
            * grid.drF[ks] * grid.hFacC[ks]
    if cfg.tauSaltClimRelax > 0.0:
        lam = 1.0 / cfg.tauSaltClimRelax
        sfS = sfS - lam * openFrac * (state.salt[ks] - forcing.SSS) \
            * grid.drF[ks] * grid.hFacC[ks]
    recip_Cp = 1.0 / cfg.HeatCapacity_Cp
    sfT = sfT - forcing.Qnet * recip_Cp * cfg.mass2rUnit
    sfS = sfS - forcing.saltFlux * cfg.mass2rUnit
    if cfg.temp_EvPrRn is not None:
        sfT = sfT + forcing.EmPmR * (cfg.tRef[0]
                                     - cfg.temp_EvPrRn) * cfg.mass2rUnit
    if cfg.salt_EvPrRn is not None:
        sfS = sfS + forcing.EmPmR * (cfg.convertFW2Salt
                                     - cfg.salt_EvPrRn) * cfg.mass2rUnit
    return sfT, sfS


def _former_apply_forcing_uv(cfg, grid, forcing):
    sfu = forcing.fu * cfg.mass2rUnit
    sfv = forcing.fv * cfg.mass2rUnit
    shape = (cfg.nr,) + tuple(sfu.shape)
    guExt = torch.zeros(shape, dtype=sfu.dtype)
    gvExt = torch.zeros_like(guExt)
    guExt[0] = sfu * grid.recip_drF[0] * grid.recip_hFacW[0]
    gvExt[0] = sfv * grid.recip_drF[0] * grid.recip_hFacS[0]
    return guExt, gvExt


def _ice_gyre(dtype, **kw):
    cfg = synthetic.ice_gyre_config(nx=16, ny=16, nr=12, depth=300.0)
    cfg = dataclasses.replace(cfg, **kw)
    return cfg, synthetic.ice_gyre_setup(cfg, dtype=dtype, device="cpu")


# configuration changes of the surface forcing's cases on the ice-gyre
# (its sea ice scales the relaxation by 1 - AREA)
FORCING_CASES = {
    "ice-gyre": {},
    "relaxation": dict(tauThetaClimRelax=86400.0 * 30,
                       tauSaltClimRelax=86400.0 * 60),
    "E-P-R": dict(temp_EvPrRn=0.5, salt_EvPrRn=0.0),
    "every term": dict(tauThetaClimRelax=86400.0 * 30,
                       tauSaltClimRelax=86400.0 * 60, temp_EvPrRn=0.5,
                       salt_EvPrRn=0.0)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FORCING_CASES)
def test_surface_forcing_twin_matches_former_code(dtype, case):
    """Q's twin: the former code's surface_forcing_ts and apply_forcing_uv's
    surface level (zeros below it), and the surface stress KPP and GGL90
    read, with a sea-ice AREA."""
    cfg, (grid, state, forcing, *_) = _ice_gyre(dtype, **FORCING_CASES[case])
    rng = np.random.default_rng(4)
    state = dataclasses.replace(state, siAREA=torch.as_tensor(
        rng.uniform(0.0, 1.0, grid.rA.shape), dtype=dtype))
    forc = load_fields(forcing)
    sf = th.surface_forcing(cfg, grid, state, forc)
    check([sf.sfT, sf.sfS], list(_former_surface_forcing_ts(
        cfg, grid, state, forc)), case)
    gu, gv = _former_apply_forcing_uv(cfg, grid, forc)
    check([sf.guExt, sf.gvExt], [gu[0], gv[0]], case)
    assert not bool(gu[1:].any()) and not bool(gv[1:].any())
    check([sf.tauU, sf.tauV], [forc.fu * cfg.mass2rUnit,
                               forc.fv * cfg.mass2rUnit], case)


@pytest.mark.parametrize("config", ("kpp", "ice"))
def test_surface_forcing_once_a_step(monkeypatch, config):
    """The step forms the surface forcing once (the former step formed the
    tracers' twice on the KPP paths, in forward_step and thermodynamics)."""
    calls = []
    twin = th._surface_forcing_plain

    def counted(*args):
        calls.append(1)
        return twin(*args)

    monkeypatch.setattr(th, "_surface_forcing_plain", counted)
    if config == "kpp":
        cfg = synthetic.kpp_gyre_config(nx=16, ny=16, nr=12, depth=300.0)
        grid, state, forcing, op, kpp = synthetic.kpp_gyre_setup(
            cfg, dtype=torch.float64, device="cpu")
        exp = Experiment(cfg, grid, state, forcing, op, kpp=kpp)
    else:
        cfg, (grid, state, forcing, op, kpp, si) = _ice_gyre(torch.float64)
        exp = Experiment(cfg, grid, state, forcing, op, kpp=kpp, seaice=si)
    exp.run(n_steps=2)
    assert len(calls) == 2


def _former_mom_ab_step_plain(cfg, grid, myIter, gU, dPhiX, guDiss, guExt,
                              guNm1, guNm2, u, gV, dPhiY, gvDiss, gvExt,
                              gvNm1, gvNm2, v):
    out = []
    for terms, gNm1, gNm2, x, mask in (
            ((gU, dPhiX, guDiss, guExt), guNm1, guNm2, u, grid.maskW),
            ((gV, dPhiY, gvDiss, gvExt), gvNm1, gvNm2, v, grid.maskS)):
        tend, dPhi, diss, ext = terms
        g = tend - dPhi + diss + ext
        g_ab = step.adams_bashforth(cfg, g, gNm1, gNm2, myIter)[0]
        out += [g, x + cfg.deltaTMom * g_ab * mask]
    return tuple(out)


@pytest.mark.parametrize("ab3,it", [(False, 0), (False, 1), (True, 2)])
def test_mom_ab_step_twin_matches_former_code(ab3, it):
    """G's twin on the forcing's surface level: the former code's, which read
    the 3-D forcing of zeros below the surface, signed zeros included."""
    config = synthetic.vi_gyre_config if ab3 else synthetic.gyre_config
    cfg = config(nx=16, ny=16, nr=4)
    grid = synthetic.gyre_grid(cfg, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5 + it)
    shape = tuple(grid.hFacC.shape)
    ins = [rand(rng, shape, 1e-4, torch.float64) for _ in range(14)]
    ins[0][2, 3, 4], ins[1][2, 3, 4], ins[2][2, 3, 4] = -0.0, 0.0, -0.0
    ext = [rand(rng, shape[1:], 1e-5, torch.float64) for _ in range(2)]
    ext3 = [torch.zeros(shape, dtype=torch.float64) for _ in range(2)]
    for e3, e in zip(ext3, ext):
        e3[0] = e
    got = step._mom_ab_step_plain(cfg, grid, it, *ins[:3], ext[0],
                                  *ins[4:10], ext[1], *ins[11:])
    want = _former_mom_ab_step_plain(cfg, grid, it, *ins[:3], ext3[0],
                                     *ins[4:10], ext3[1], *ins[11:])
    check(list(got), list(want), f"AB-{3 if ab3 else 2} step {it}")


# ---------------------------------------------------------------- S1, S2
def _former_setup(si, ice, forc, etaN):
    """The former code's SeaIce.step set-up and evp_setup."""
    p, g = si.p, si.grid
    press0 = (p.strength * ice.HEFF
              * torch.exp(-p.cStar * (1.0 - ice.AREA))) * si.HEFFM
    zMax = p.zetaMaxFac * press0
    cdair = torch.where(g.yC < 0.0, torch.tensor(p.drag_south / p.OCEAN_drag,
                                                 dtype=g.yC.dtype),
                        torch.tensor(p.drag / p.OCEAN_drag,
                                     dtype=g.yC.dtype))
    taux, tauy = cdair * forc.fu * si.SIMaskU, cdair * forc.fv * si.SIMaskV
    massC = p.rhoIce * ice.HEFF
    massU = p.rhoIce * 0.5 * (ice.HEFF + sh(ice.HEFF, di=-1))
    massV = p.rhoIce * 0.5 * (ice.HEFF + sh(ice.HEFF, dj=-1))
    if p.addSnowMass:
        massC = massC + p.rhoSnow * ice.HSNOW
        massU = massU + p.rhoSnow * 0.5 * (ice.HSNOW
                                           + sh(ice.HSNOW, di=-1))
        massV = massV + p.rhoSnow * 0.5 * (ice.HSNOW
                                           + sh(ice.HSNOW, dj=-1))
    phiSurf = g.Bo_surf * etaN
    if p.scaleSurfStress:
        forcex0 = taux * 0.5 * (ice.AREA + sh(ice.AREA, di=-1))
        forcey0 = tauy * 0.5 * (ice.AREA + sh(ice.AREA, dj=-1))
        areaW = 0.5 * (ice.AREA + sh(ice.AREA, di=-1))
        areaS = 0.5 * (ice.AREA + sh(ice.AREA, dj=-1))
    else:
        forcex0, forcey0 = taux, tauy
        areaW, areaS = torch.ones_like(ice.uIce), torch.ones_like(ice.uIce)
    if p.useTilt:
        forcex0 = forcex0 - massU * g.recip_dxC * (
            phiSurf - sh(phiSurf, di=-1))
        forcey0 = forcey0 - massV * g.recip_dyC * (
            phiSurf - sh(phiSurf, dj=-1))
    one, zero = massU.new_tensor(1.0), massU.new_tensor(0.0)
    return [press0, zMax, taux, tauy, massC, massU, massV, forcex0, forcey0,
            areaW, areaS, torch.where(massU != 0.0, one, zero),
            torch.where(massV != 0.0, one, zero)]


def _former_sum_norm(si):
    hm = si.HEFFM
    s = hm + sh(hm, di=-1) + sh(hm, dj=-1) + sh(sh(hm, di=-1), dj=-1)
    return torch.where(s > 0.0, s.new_tensor(1.0) / torch.where(
        s > 0.0, s, s.new_tensor(1.0)), s.new_tensor(0.0))


def _ice_inputs(dtype, seed, **p):
    cfg, (grid, state, forcing, op, kpp, si) = _ice_gyre(dtype)
    si.p = dataclasses.replace(si.p, **p)
    rng = np.random.default_rng(seed)

    def fld(lo, hi, mask=None):
        a = torch.as_tensor(rng.uniform(lo, hi, grid.rA.shape), dtype=dtype)
        return a if mask is None else a * mask

    hm = si.HEFFM
    ice = si.init_state()._replace(
        AREA=fld(0.0, 1.0, hm), HEFF=fld(0.0, 3.0, hm),
        HSNOW=fld(0.0, 0.4, hm), uIce=fld(-0.6, 0.6, si.seaiceMaskU),
        vIce=fld(-0.6, 0.6, si.seaiceMaskV))
    ice.HEFF[5, ::2] = 0.0
    return si, ice, load_fields(forcing), fld


# S1's flags: (SEAICEaddSnowMass, SEAICEscaleSurfStress, SEAICEuseTilt)
DYNFORCING_CASES = {"snow, scaled, tilt": (True, True, True),
                    "none": (False, False, False),
                    "snow": (True, False, False),
                    "scaled": (False, True, False),
                    "tilt": (False, False, True)}


@pytest.mark.parametrize("case", DYNFORCING_CASES)
def test_dynforcing_twin_matches_former_code(case):
    """S1's twin: the former code's set-up, areas and EVP masks; sumNorm built
    once per SeaIce, the former code's."""
    snow, scale, tilt = DYNFORCING_CASES[case]
    si, ice, forc, fld = _ice_inputs(torch.float64, 6, addSnowMass=snow,
                                     scaleSurfStress=scale, useTilt=tilt)
    etaN = fld(-0.5, 0.5)
    d = si.dynforcing(ice, forc.fu, forc.fv, etaN, True)
    check([d[k] for k in seaice.DYNFORCING_OUT],
          _former_setup(si, ice, forc, etaN), case)
    assert same(si.sumNorm, _former_sum_norm(si))
    assert sorted(si.dynforcing(ice, forc.fu, forc.fv, etaN, False)) == \
        sorted(seaice.DYNFORCING_OUT[:11])


@pytest.mark.parametrize("scale", (True, False))
def test_evp_setup_is_dynforcing(scale):
    """SeaIce.evp's set-up for masses of a caller's own
    (synthetic.evp_setup, the tests' and tools') equals the one the step
    passes, S1's (and sumNorm), on S1's masses."""
    si, ice, forc, fld = _ice_inputs(torch.float64, 7,
                                     scaleSurfStress=scale)
    d = si.dynforcing(ice, forc.fu, forc.fv, fld(-0.5, 0.5), True)
    got = synthetic.evp_setup(si, ice.AREA, d["massU"], d["massV"])
    assert got["sumNorm"] is si.sumNorm
    check([got[k] for k in ("areaW", "areaS", "locMaskU", "locMaskV")],
          [d[k] for k in ("areaW", "areaS", "locMaskU", "locMaskV")],
          f"scale {scale}")
    assert bool((d["locMaskU"] == 0.0).any())


def _former_ocean_stress(si, ice, dwatn, uVel0, vVel0, fu, fv):
    p, g = si.p, si.grid
    sinwat = math.sin(math.radians(p.waterTurnAngle))
    coswat = math.cos(math.radians(p.waterTurnAngle))
    sgn = torch.where(g.fCori < 0.0, -g.fCori.new_tensor(1.0),
                      g.fCori.new_tensor(1.0))
    du = ice.uIce - uVel0
    dv = ice.vIce - vVel0
    fuIce = (0.5 * (dwatn + sh(dwatn, di=-1)) * coswat * du
             - sgn * sinwat * 0.5
             * (dwatn * 0.5 * (dv + sh(dv, dj=1))
                + sh(dwatn, di=-1) * 0.5
                * (sh(dv, di=-1) + sh(sh(dv, dj=1), di=-1))))
    fvIce = (0.5 * (dwatn + sh(dwatn, dj=-1)) * coswat * dv
             + sgn * sinwat * 0.5
             * (dwatn * 0.5 * (du + sh(du, di=1))
                + sh(dwatn, dj=-1) * 0.5
                * (sh(du, dj=-1) + sh(sh(du, di=1), dj=-1))))
    areaW = 0.5 * (ice.AREA + sh(ice.AREA, di=-1)) * p.stressFactor
    areaS = 0.5 * (ice.AREA + sh(ice.AREA, dj=-1)) * p.stressFactor
    return (1.0 - areaW) * fu + areaW * fuIce, (1.0 - areaS) * fv \
        + areaS * fvIce


def _former_hb87(si, ice, windTauX, windTauY, stressDivX, stressDivY, fu,
                 fv):
    p = si.p
    areaW = 0.5 * (ice.AREA + sh(ice.AREA, di=-1)) * p.stressFactor
    areaS = 0.5 * (ice.AREA + sh(ice.AREA, dj=-1)) * p.stressFactor
    return ((1.0 - areaW) * fu + areaW * windTauX
            + stressDivX * p.stressFactor,
            (1.0 - areaS) * fv + areaS * windTauY
            + stressDivY * p.stressFactor)


# S2's variants: (mode, the no-dynamics drag, the clip)
OCEAN_STRESS_CASES = {"LSR": (1, False, False),
                      "no dynamics": (1, True, False),
                      "EVP with clip": (1, False, True),
                      "HB87 with clip": (2, False, True),
                      "clip alone": (0, False, True)}


@pytest.mark.parametrize("case", OCEAN_STRESS_CASES)
def test_ocean_stress_twin_matches_former_code(case):
    """S2's twin: the former code's ocean_stress (on oceandrag's drag without
    the dynamics), ocean_stress_hb87 and clip."""
    mode, drag, clip = OCEAN_STRESS_CASES[case]
    si, ice, forc, fld = _ice_inputs(torch.float64, 7)
    uVel0, vVel0 = fld(-0.3, 0.3), fld(-0.3, 0.3)
    dwatn = si.oceandrag(ice.uIce, ice.vIce, uVel0, vVel0) if drag \
        else fld(0.0, 5.0, si.HEFFM)
    wind, div = (fld(-0.2, 0.2), fld(-0.2, 0.2)), (fld(-0.1, 0.1),
                                                   fld(-0.1, 0.1))
    got = si.ocean_stress(ice, None if drag else dwatn, uVel0, vVel0,
                          forc.fu, forc.fv, windTau=wind, stressDiv=div,
                          mode=mode, drag=drag, clip=clip)
    want = [None, None]
    if mode == 1:
        want = list(_former_ocean_stress(si, ice, dwatn, uVel0, vVel0,
                                         forc.fu, forc.fv))
    elif mode == 2:
        want = list(_former_hb87(si, ice, *wind, *div, forc.fu, forc.fv))
    want += ([ice.uIce.clamp(-0.40, 0.40), ice.vIce.clamp(-0.40, 0.40)]
             if clip else [None, None])
    check(list(got), want, case)


# --------------------------------------------------------- + gTr, kappas
@pytest.mark.parametrize("scheme", (33, 81))
def test_addend_twin_is_the_sum(scheme):
    """The advection's gTracer + gTr (the kernels' last sweep adds gTr):
    the twin's gTracer + gTr, as thermodynamics added it."""
    cfg = synthetic.ggl90_gyre_config(nx=16, ny=16, nr=12, depth=300.0)
    grid = synthetic.gyre_grid(cfg, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(8)
    shape = tuple(grid.hFacC.shape)
    u = rand(rng, shape, 0.05, torch.float64) * grid.maskW
    v = rand(rng, shape, 0.05, torch.float64) * grid.maskS
    w = rand(rng, shape, 1e-4, torch.float64) * grid.maskC
    tr = (15.0 + rand(rng, shape, 2.0, torch.float64)) * grid.maskC
    gTr = rand(rng, shape, 1e-5, torch.float64)
    if scheme == 81:
        sm = torch.zeros((som.NSOM,) + shape, dtype=torch.float64)
        got = som.som_advect(cfg, grid, u, v, w, tr, sm, scheme, 600.0,
                             add=gTr)
        want = som.som_advect(cfg, grid, u, v, w, tr, sm, scheme, 600.0)
        check([got[0], got[1]], [want[0] + gTr, want[1]], "SOM")
    else:
        flow = gad.calc_adv_flow(grid, u, v, w)
        got = gad.multidim_advection(cfg, grid, flow, u, v, w, tr, scheme,
                                     scheme, 600.0, add=gTr)
        want = gad.multidim_advection(cfg, grid, flow, u, v, w, tr, scheme,
                                      scheme, 600.0)
        check([got], [want + gTr], "multidim")


def test_constant_kappas_built_once():
    """The constant kappas are built once for each value, dtype, shape and
    device: two configurations on one grid with different diffKrT and
    viscAr get their own values, a repeat call the same tensor, and a
    step leaves them as built (no consumer writes into them)."""
    cfg = dataclasses.replace(synthetic.gyre_config(nx=16, ny=16, nr=4),
                              diffKrT=1e-5, viscAr=1e-4)
    other = dataclasses.replace(cfg, diffKrT=3e-5, viscAr=2e-4)
    grid, state, forcing, op = synthetic.gyre_setup(
        cfg, dtype=torch.float64, device="cpu")
    k1, k2 = (th.tracer_kappa(c, grid, c.diffKrT) for c in (cfg, other))
    assert k1 is th.tracer_kappa(cfg, grid, cfg.diffKrT)
    assert float(k1.max()) == float(k1.min()) == cfg.diffKrT
    assert float(k2.max()) == float(k2.min()) == other.diffKrT
    (u1, v1), (u2, v2) = (step.kappa_uv(c, grid) for c in (cfg, other))
    assert u1 is v1 and u2 is v2 and u1 is not u2
    assert float(u1.max()) == float(u1.min()) == cfg.viscAr
    assert float(u2.max()) == float(u2.min()) == other.viscAr
    assert tuple(u1.shape) == (cfg.nr + 1,) + tuple(grid.rA.shape)
    Experiment(cfg, grid, state, forcing, op).run(n_steps=2)
    assert float(k1.max()) == float(k1.min()) == cfg.diffKrT
    assert float(u1.max()) == float(u1.min()) == cfg.viscAr


def test_constant_kappas_kept_on_their_grid():
    """The constant kappas live on the grid that made them: another grid
    builds its own, and they are freed with their grid."""
    cfg = synthetic.gyre_config(nx=16, ny=16, nr=4)
    g1, g2 = (synthetic.gyre_grid(cfg, dtype=torch.float64, device="cpu")
              for _ in range(2))
    k1, k2 = (th.tracer_kappa(cfg, g, cfg.diffKrT) for g in (g1, g2))
    u1 = step.kappa_uv(cfg, g1)[0]
    assert k1 is not k2 and torch.equal(k1, k2)
    refs = [weakref.ref(k1), weakref.ref(u1)]
    del g1, k1, u1
    gc.collect()
    assert all(r() is None for r in refs)
    assert th.tracer_kappa(cfg, g2, cfg.diffKrT) is k2
