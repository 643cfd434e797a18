"""Nonlinear horizontal viscosities (mitgcm_tpu/model/mom_visc.py; reference
pkg/mom_common/mom_calc_visc.F, mom_init_fixed.F, mom_calc_tension.F,
mom_calc_strain.F, mom_hdissip.F): Smagorinsky, Leith and full Leith, the
grid-scaled viscosity with its grid and grid-Reynolds limits, at divergence
(D, cell centre) and vorticity (Z, corner) points, and the biharmonic
viscosity's Laplacian of (u, v) that both momentum forms take.

`calc_visc` runs kernel X (kernels/csrc/mom_visc.cu:mom_calc_visc) for
CUDA tensors and its plain twin `_calc_visc_plain` (the front end that
forms hDiv, vorticity, tension, strain and KE from u and v, then
`calc_visc_plain`, the twin of the JAX function) for CPU tensors or with
impl="plain". `del2uv` runs kernel Y (mom_visc.cu:mom_del2uv) in the
variant of the momentum form, or its twin: mom_fluxform.py's `_del2uv`
(flux form, with the closed-wall term) or mom_vecinv.py's `del2uv_plain`
(from the divergence and hFacZ times the vorticity). Both kernels write
every padded cell as the twins do, the zero fill of the shifts at the
array's edge included. Neither has a backward kernel: the wrappers raise
if an input requires grad, and ad/adjoint.py refuses every option that
runs them.

`length_scales` builds L2, L3 and L4rdt once per grid and time step, on
the host in float64 numpy from the grid's metrics as the JAX function
does, and casts them once to the grid's dtype. (Under jax_enable_x64 the
JAX function keeps them float64, so a float32 JAX run promotes the
viscosities and the dissipation to float64; the port keeps the fields'
dtype.)
"""

from __future__ import annotations

import numpy as np
import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.ops.stencil import shift as sh

# calls of the twins of kernels X and Y, for the card's runs to show that
# the main path never ran them
plain_calls = 0


def use_variable_visc(cfg: Config) -> bool:
    """set_parms.F:125-132 useVariableVisc."""
    return cfg.momViscosity and (
        cfg.viscAhGrid != 0.0 or cfg.viscA4Grid != 0.0
        or cfg.viscC2smag != 0.0 or cfg.viscC4smag != 0.0
        or cfg.viscC2leith != 0.0 or cfg.viscC2leithD != 0.0
        or cfg.viscC2LeithQG != 0.0
        or cfg.viscC4leith != 0.0 or cfg.viscC4leithD != 0.0)


def use_harmonic_visc(cfg: Config) -> bool:
    """set_parms.F:134-140 useHarmonicVisc."""
    return cfg.momViscosity and (
        cfg.viscAh != 0.0 or cfg.viscAhD != 0.0 or cfg.viscAhZ != 0.0
        or cfg.viscAhGrid != 0.0 or cfg.viscC2smag != 0.0
        or cfg.viscC2leith != 0.0 or cfg.viscC2leithD != 0.0
        or cfg.viscC2LeithQG != 0.0)


def use_biharmonic_visc(cfg: Config) -> bool:
    """set_parms.F:141-146 useBiharmonicVisc."""
    return cfg.momViscosity and (
        cfg.viscA4 != 0.0 or cfg.viscA4D != 0.0 or cfg.viscA4Z != 0.0
        or cfg.viscA4Grid != 0.0 or cfg.viscC4smag != 0.0
        or cfg.viscC4leith != 0.0 or cfg.viscC4leithD != 0.0)


def refusals(cfg: Config) -> dict:
    """The viscosity options that neither momentum form computes as the
    JAX package does, by name: LeithQG (JAX turns calcLeith on for it but
    no factor reads it, mom_visc.py:107-126)."""
    return {"viscC2LeithQG": cfg.viscC2LeithQG != 0.0}


def length_scales(cfg: Config, grid: Grid) -> dict:
    """mom_init_fixed.F:84-126: L2, L3 and L4rdt at D and Z points
    ([nyp, nxp] in the grid's dtype and device) and recip_dt (a float),
    from the grid's metrics in float64 numpy (mom_visc.py:52-72); built
    once per grid, time step and useAreaViscLength and kept on the grid
    (freed with it), read only."""
    key = (float(cfg.deltaTMom), bool(cfg.useAreaViscLength))
    # Grid is frozen: the cache is an attribute beside its fields
    cache = grid.__dict__.setdefault("_visc_length_scales", {})
    if key in cache:
        return cache[key]

    def host(t):
        return t.detach().to("cpu", torch.float64).numpy()

    recip_dt = 1.0 / cfg.deltaTMom if cfg.deltaTMom != 0.0 else 1.0
    rdx2 = host(grid.recip_dxF) ** 2 + host(grid.recip_dyF) ** 2
    L2_D = host(grid.rA).copy()
    if not cfg.useAreaViscLength:
        ok = rdx2 != 0.0
        L2_D = np.where(ok, 2.0 / np.where(ok, rdx2, 1.0), L2_D)
    rdz2 = host(grid.recip_dxV) ** 2 + host(grid.recip_dyU) ** 2
    L2_Z = host(grid.rAz).copy()
    if not cfg.useAreaViscLength:
        ok = rdz2 != 0.0
        L2_Z = np.where(ok, 2.0 / np.where(ok, rdz2, 1.0), L2_Z)
    like = grid.rA

    def field(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=like.dtype,
                               device=like.device)

    out = {}
    for tag, L2 in (("D", L2_D), ("Z", L2_Z)):
        out[f"L2_{tag}"] = field(L2)
        out[f"L3_{tag}"] = field(L2 ** 1.5)
        out[f"L4rdt_{tag}"] = field(0.03125 * recip_dt * L2 ** 2)
    out["recip_dt"] = recip_dt
    cache[key] = out
    return out


def calc_tension(grid: Grid, u, v):
    """mom_calc_tension.F: D_T = (d(dy u)/dx - d(dx v)/dy) / rA at C
    (no OBCS)."""
    return ((sh(grid.dyG * u, di=1) - grid.dyG * u)
            - (sh(grid.dxG * v, dj=1) - grid.dxG * v)) * grid.recip_rA


def calc_strain(grid: Grid, u, v):
    """mom_calc_strain.F: D_S = (d(dy v)/dx + d(dx u)/dy) / rAz at Z."""
    return ((grid.dyC * v - sh(grid.dyC * v, di=-1))
            + (grid.dxC * u - sh(grid.dxC * u, dj=-1))) * grid.recip_rAz


def factors(cfg: Config) -> dict:
    """The host numbers of mom_calc_visc.F (mom_visc.py:96-126), as Python
    floats: the Reynolds limits' factors, Smagorinsky's and Leith's, the
    switches calcSmag and calcLeith."""
    pi = np.pi
    out = dict(
        viscAhRe_max=(np.sqrt(2.0) / cfg.viscAhReMax
                      if (use_harmonic_visc(cfg) and cfg.viscAhReMax != 0.0)
                      else 0.0),
        viscA4Re_max=(0.125 * np.sqrt(2.0) / cfg.viscA4ReMax
                      if (use_biharmonic_visc(cfg)
                          and cfg.viscA4ReMax != 0.0) else 0.0))
    calcLeith = (cfg.viscC2leith != 0.0 or cfg.viscC2leithD != 0.0
                 or cfg.viscC4leith != 0.0 or cfg.viscC4leithD != 0.0
                 or cfg.viscC2LeithQG != 0.0)
    calcSmag = cfg.viscC2smag != 0.0 or cfg.viscC4smag != 0.0
    out["calcLeith"], out["calcSmag"] = calcLeith, calcSmag
    out["smag2fac"] = (cfg.viscC2smag / pi) ** 2 if calcSmag else 0.0
    out["smag4fac"] = 0.125 * (cfg.viscC4smag / pi) ** 2 if calcSmag else 0.0
    if calcLeith and cfg.useFullLeith:
        p, f4 = 6, 0.015625
    else:
        p, f4 = 3, 0.125
    if calcLeith:
        out["leith2fac"] = (cfg.viscC2leith / pi) ** p
        out["leithD2fac"] = (cfg.viscC2leithD / pi) ** p
        out["leith4fac"] = f4 * (cfg.viscC4leith / pi) ** p
        out["leithD4fac"] = f4 * (cfg.viscC4leithD / pi) ** p
    else:
        out.update(leith2fac=0.0, leithD2fac=0.0, leith4fac=0.0,
                   leithD4fac=0.0)
    return {k: v if isinstance(v, bool) else float(v)
            for k, v in out.items()}


def _sq(t):
    return t * t


def _limits(base, Lth, Smg, Uscl, grid_visc, Lrdt, gmin, gmax, vmax):
    """mom_visc.py:133-138, NaN propagating as jnp.maximum/minimum."""
    Alin = base + grid_visc * Lrdt + Lth + Smg
    vMin = torch.maximum(gmin * Lrdt, Uscl)
    out = torch.maximum(vMin, Alin)
    vMax = torch.clamp_max(gmax * Lrdt, vmax)
    return torch.minimum(vMax, out)


def calc_visc_plain(cfg: Config, grid: Grid, scales, hDiv, vort3, tension,
                    strain, KE):
    """The twin of mom_visc.py:calc_visc (:90-259), in its operation
    order: (viscAh_Z, viscAh_D, viscA4_Z, viscA4_D) per level from the
    divergence, the vorticity and strain with sideMaskFac at closed
    corners, the tension and KE, all [nr, nyp, nxp]."""
    f = factors(cfg)
    recip_dt = scales["recip_dt"]
    ReAh, ReA4 = f["viscAhRe_max"], f["viscA4Re_max"]
    calcLeith, full = f["calcLeith"], cfg.useFullLeith and f["calcLeith"]
    z = torch.zeros_like(hDiv)
    if calcLeith:
        divDx = (hDiv - sh(hDiv, di=-1)) * grid.recip_dxC
        divDy = (hDiv - sh(hDiv, dj=-1)) * grid.recip_dyC
        vrtDx = (sh(vort3, di=1) - vort3) * grid.recip_dxG * grid.maskS
        vrtDy = (sh(vort3, dj=1) - vort3) * grid.recip_dyG * grid.maskW

    def leith(grdVrt, grdDiv, L3, L5):
        if full:
            return (torch.sqrt(f["leith2fac"] * grdVrt
                               + f["leithD2fac"] * grdDiv) * L3,
                    torch.sqrt(f["leith4fac"] * grdVrt
                               + f["leithD4fac"] * grdDiv) * L5)
        return ((f["leith2fac"] * grdVrt + f["leithD2fac"] * grdDiv) * L3,
                (f["leith4fac"] * grdVrt + f["leithD4fac"] * grdDiv) * L5)

    def grad_max(a, b, c, d):
        return torch.maximum(torch.maximum(a.abs(), b.abs()),
                             torch.maximum(c.abs(), d.abs()))

    def grad_sq(a, b, c, d):
        return 0.25 * ((_sq(a) + _sq(b)) + (_sq(c) + _sq(d)))

    def smag(base_sq, L2):
        AhSmg_base = L2 * torch.sqrt(base_sq)
        return f["smag2fac"] * AhSmg_base, f["smag4fac"] * L2 * AhSmg_base

    out = {}
    for tag in ("D", "Z"):
        L2 = scales[f"L2_{tag}"]
        L2rdt = 0.25 * recip_dt * L2
        L3 = scales[f"L3_{tag}"]
        L4rdt = scales[f"L4rdt_{tag}"]
        L5 = L2 * L3
        if tag == "D":
            pos = KE > 0.0
            keM = torch.clamp_min(KE, 0.0)
            Uscl = (torch.where(pos, torch.sqrt(keM * L2) * ReAh, 0.0)
                    if ReAh > 0.0 else z)
            U4scl = (torch.where(pos, torch.sqrt(keM) * L3 * ReA4, 0.0)
                     if ReA4 > 0.0 else z)
            if calcLeith:
                parts = ((sh(vrtDx, dj=1), vrtDx, sh(vrtDy, di=1), vrtDy),
                         (sh(divDx, di=1), divDx, sh(divDy, dj=1), divDy))
        else:
            if ReAh > 0.0 or ReA4 > 0.0:
                keZ = 0.25 * ((KE + sh(sh(KE, di=-1), dj=-1))
                              + (sh(KE, di=-1) + sh(KE, dj=-1)))
                pos = keZ > 0.0
                keM = torch.clamp_min(keZ, 0.0)
                Uscl = torch.where(pos, torch.sqrt(keM * L2) * ReAh, 0.0)
                U4scl = torch.where(pos, torch.sqrt(keM) * L3 * ReA4, 0.0)
            else:
                Uscl = U4scl = z
            if calcLeith:
                parts = ((sh(vrtDx, di=-1), vrtDx, sh(vrtDy, dj=-1), vrtDy),
                         (sh(divDx, dj=-1), divDx, sh(divDy, di=-1), divDy))
        if calcLeith:
            grd = grad_sq if full else grad_max
            AhLth, A4Lth = leith(grd(*parts[0]), grd(*parts[1]), L3, L5)
        else:
            AhLth = A4Lth = z
        if f["calcSmag"]:
            if tag == "D":
                s = _sq(tension) + 0.25 * (
                    _sq(sh(strain, di=1)) + _sq(sh(strain, dj=1))
                    + _sq(strain) + _sq(sh(sh(strain, di=1), dj=1)))
            else:
                s = _sq(strain) + 0.25 * (
                    _sq(tension) + _sq(sh(tension, dj=-1))
                    + _sq(sh(tension, di=-1))
                    + _sq(sh(sh(tension, di=-1), dj=-1)))
            AhSmg, A4Smg = smag(s, L2)
        else:
            AhSmg = A4Smg = z
        out[f"viscAh_{tag}"] = _limits(
            getattr(cfg, f"viscAh{tag}"), AhLth, AhSmg, Uscl, cfg.viscAhGrid,
            L2rdt, cfg.viscAhGridMin, cfg.viscAhGridMax, cfg.viscAhMax)
        out[f"viscA4_{tag}"] = _limits(
            getattr(cfg, f"viscA4{tag}"), A4Lth, A4Smg, U4scl,
            cfg.viscA4Grid, L4rdt, cfg.viscA4GridMin, cfg.viscA4GridMax,
            cfg.viscA4Max)
    return (out["viscAh_Z"], out["viscAh_D"], out["viscA4_Z"],
            out["viscA4_D"])


def side_mask_fac(cfg: Config) -> float:
    """sideMaskFac (mom_vecinv.F:288-295): the vorticity and strain at a
    closed corner are scaled by sideDragFactor under no-slip, 0 else."""
    return cfg.sideDragFactor if cfg.no_slip_sides else 0.0


def visc_inputs(cfg: Config, grid: Grid, u, v):
    """What calc_visc reads, as both momentum forms form it
    (mom_fluxform.py:237-247, mom_vecinv.py:226-245): hDiv, the vorticity
    and the strain with sideMaskFac where hFacZ is 0, the tension and
    KE."""
    from mitgcm_tpu_torch.model.mom_fluxform import calc_hfacz, calc_ke
    from mitgcm_tpu_torch.model.mom_vecinv import calc_hdiv, calc_relvort3

    hFacZ = calc_hfacz(grid)
    fac = side_mask_fac(cfg)
    hDiv = calc_hdiv(grid, u, v)
    vort3 = calc_relvort3(grid, u, v)
    vort3 = torch.where(hFacZ == 0.0, fac * vort3, vort3)
    tension = calc_tension(grid, u, v)
    strain = calc_strain(grid, u, v)
    strain = torch.where(hFacZ == 0.0, fac * strain, strain)
    return hDiv, vort3, tension, strain, calc_ke(u, v)


def _calc_visc_plain(cfg: Config, grid: Grid, u, v):
    """Kernel X's twin: calc_visc_plain on visc_inputs, the biharmonic
    viscosities None without biharmonic viscosity (X writes none)."""
    out = calc_visc_plain(cfg, grid, length_scales(cfg, grid),
                          *visc_inputs(cfg, grid, u, v))
    return out if use_biharmonic_visc(cfg) else (out[0], out[1], None, None)


# grid fields kernel X reads, in the order of mom_visc.cuh:ViscArgs
_X_GRID3 = ("hFacW", "hFacS", "maskW", "maskS", "recip_hFacC")
_X_GRID2 = ("dyG", "dxG", "dyC", "dxC", "recip_rA", "recip_rAz",
            "recip_dxC", "recip_dyC", "recip_dxG", "recip_dyG")
_SCALES = ("L2_D", "L3_D", "L4rdt_D", "L2_Z", "L3_Z", "L4rdt_Z")


def x_flags(cfg: Config) -> tuple:
    """Kernel X's template flags: (Smagorinsky, Leith 0 none / 1 Leith /
    2 full Leith, the Reynolds limits, biharmonic output)."""
    f = factors(cfg)
    leith = (2 if cfg.useFullLeith else 1) if f["calcLeith"] else 0
    return (int(f["calcSmag"]), leith,
            int(f["viscAhRe_max"] > 0.0 or f["viscA4Re_max"] > 0.0),
            int(use_biharmonic_visc(cfg)))


def x_params(cfg: Config, scales) -> list:
    """Kernel X's parameter array, in the order of
    mom_visc.cuh:ViscParams."""
    f = factors(cfg)
    return [side_mask_fac(cfg), f["viscAhRe_max"], f["viscA4Re_max"],
            f["smag2fac"], f["smag4fac"], f["leith2fac"], f["leithD2fac"],
            f["leith4fac"], f["leithD4fac"], 0.25 * scales["recip_dt"],
            cfg.viscAhD, cfg.viscAhZ, cfg.viscA4D, cfg.viscA4Z,
            cfg.viscAhGrid, cfg.viscAhGridMin, cfg.viscAhGridMax,
            cfg.viscAhMax, cfg.viscA4Grid, cfg.viscA4GridMin,
            cfg.viscA4GridMax, cfg.viscA4Max]


def _calc_visc_kernel(cfg: Config, grid: Grid, u, v):
    """Kernel X on the card: the twin's outputs."""
    scales = length_scales(cfg, grid)
    bih = use_biharmonic_visc(cfg)
    nr, nyp, nxp = u.shape
    outs = [torch.empty_like(u), torch.empty_like(u)]
    outs += [torch.empty_like(u), torch.empty_like(u)] if bih \
        else [None, None]
    ins = dict(u=u, v=v, **{n: getattr(grid, n) for n in _X_GRID3},
               **{n: getattr(grid, n) for n in _X_GRID2},
               **{n: scales[n] for n in _SCALES})
    named = dict(zip(("viscAh_Z", "viscAh_D", "viscA4_Z", "viscA4_D"),
                     outs))
    kernels.check_fields(u.dtype, u.shape,
                         **{n: ins[n] for n in ("u", "v") + _X_GRID3},
                         **{n: t for n, t in named.items() if t is not None})
    kernels.check_fields(u.dtype, (nyp, nxp),
                         **{n: ins[n] for n in _X_GRID2 + _SCALES})
    table = [*ins.values(), *outs]
    params = x_params(cfg, scales)
    kernels.launch("mom_calc_visc", u.dtype, kernels.pointer_table(table),
                   len(table), kernels.doubles(params), len(params), nr,
                   nyp, nxp, *x_flags(cfg))
    return tuple(outs)


def calc_visc(cfg: Config, grid: Grid, u, v, impl: str = None):
    """(viscAh_Z, viscAh_D, viscA4_Z, viscA4_D) [nr, nyp, nxp] from u and
    v, the last two None without biharmonic viscosity: kernel X on CUDA
    tensors, its twin on CPU tensors or with impl="plain"."""
    global plain_calls
    grads = [n for n, t in (("u", u), ("v", v)) if t.requires_grad]
    if grads:
        raise ValueError(f"calc_visc: {grads} require grad; kernel X has "
                         "no backward kernel")
    if not kernels.use_kernel(u, impl):
        plain_calls += 1
        return _calc_visc_plain(cfg, grid, u, v)
    return _calc_visc_kernel(cfg, grid, u, v)


def hdissip_strain_tension_plain(grid: Grid, tension, strain, viscAh_s,
                                 viscAh_t):
    """The twin of mom_visc.py:hdissip_strain_tension (:262-286): the
    harmonic strain-tension dissipation (uDiss, vDiss), viscAh_s at Z
    (strain) points and viscAh_t at C (tension) points, fields or
    numbers."""
    ft = grid.dyF * grid.dyF * viscAh_t * tension
    fs = grid.dxV * grid.dxV * viscAh_s * strain
    uDiss = (_sq(grid.recip_dyG) * grid.recip_dxC * (ft - sh(ft, di=-1))
             + _sq(grid.recip_dxC) * grid.recip_dyG * (sh(fs, dj=1) - fs))
    fs2 = grid.dyU * grid.dyU * viscAh_s * strain
    ft2 = grid.dxF * grid.dxF * viscAh_t * tension
    vDiss = (_sq(grid.recip_dyC) * grid.recip_dxG * (sh(fs2, di=1) - fs2)
             - _sq(grid.recip_dxG) * grid.recip_dyC * (ft2 - sh(ft2, dj=-1)))
    return uDiss, vDiss


# the fields kernel Y reads in each variant, in the order of
# mom_visc.cuh:Del2Args (the other variant's slots are null)
_Y_FLUX3 = ("hFacC", "hFacW", "hFacS", "maskW", "maskS", "recip_hFacW",
            "recip_hFacS")
_Y_FLUX2 = ("dyF", "dxF", "recip_dxF", "recip_dyF", "dxV", "dyU",
            "recip_dxV", "recip_dyU", "recip_rAw", "recip_rAs")
_Y_VI3 = ("hFacW", "hFacS", "maskW", "maskS", "recip_hFacC", "recip_hFacW",
          "recip_hFacS")
_Y_VI2 = ("dyG", "dxG", "dyC", "dxC", "recip_rA", "recip_rAz", "recip_dxC",
          "recip_dyC", "recip_dxG", "recip_dyG")
_Y_SLOTS3 = ("hFacC", "hFacW", "hFacS", "maskW", "maskS", "recip_hFacC",
             "recip_hFacW", "recip_hFacS")
_Y_SLOTS2 = ("dyF", "dxF", "recip_dxF", "recip_dyF", "dxV", "dyU",
             "recip_dxV", "recip_dyU", "recip_rAw", "recip_rAs", "dyG",
             "dxG", "dyC", "dxC", "recip_rA", "recip_rAz", "recip_dxC",
             "recip_dyC", "recip_dxG", "recip_dyG")


def _del2uv_twin(cfg: Config, grid: Grid, u, v):
    """Kernel Y's twin in the variant of cfg's momentum form."""
    from mitgcm_tpu_torch.model.mom_fluxform import _del2uv, calc_hfacz
    from mitgcm_tpu_torch.model.mom_vecinv import del2uv_plain

    if cfg.vectorInvariantMomentum:
        return del2uv_plain(cfg, grid, u, v)
    return _del2uv(cfg, grid, u, v, calc_hfacz(grid))


def _del2uv_kernel(cfg: Config, grid: Grid, u, v):
    """Kernel Y on the card in the variant of cfg's momentum form."""
    vi = bool(cfg.vectorInvariantMomentum)
    nr, nyp, nxp = u.shape
    f3, f2 = (_Y_VI3, _Y_VI2) if vi else (_Y_FLUX3, _Y_FLUX2)
    outs = [torch.empty_like(u), torch.empty_like(u)]
    kernels.check_fields(u.dtype, u.shape, u=u, v=v,
                         **{n: getattr(grid, n) for n in f3},
                         d2u=outs[0], d2v=outs[1])
    kernels.check_fields(u.dtype, (nyp, nxp),
                         **{n: getattr(grid, n) for n in f2})
    kernels.check_fields(u.dtype, (nr,), drF=grid.drF,
                         recip_drF=grid.recip_drF)
    table = ([u, v] + [getattr(grid, n) if n in f3 else None
                       for n in _Y_SLOTS3]
             + [getattr(grid, n) if n in f2 else None for n in _Y_SLOTS2]
             + [None if vi else grid.drF, None if vi else grid.recip_drF]
             + outs)
    param = side_mask_fac(cfg) if vi else (1.0 if cfg.no_slip_sides
                                           else 0.0)
    kernels.launch("mom_del2uv", u.dtype, kernels.pointer_table(table),
                   len(table), nr, nyp, nxp, int(vi), param)
    return tuple(outs)


def del2uv(cfg: Config, grid: Grid, u, v, impl: str = None):
    """The Laplacian of (u, v) that biharmonic viscosity takes, in cfg's
    momentum form: kernel Y on CUDA tensors, the twin on CPU tensors or
    with impl="plain"."""
    global plain_calls
    grads = [n for n, t in (("u", u), ("v", v)) if t.requires_grad]
    if grads:
        raise ValueError(f"del2uv: {grads} require grad; kernel Y has no "
                         "backward kernel")
    if not kernels.use_kernel(u, impl):
        plain_calls += 1
        return _del2uv_twin(cfg, grid, u, v)
    return _del2uv_kernel(cfg, grid, u, v)


def fields(cfg: Config, grid: Grid, u, v, impl: str = None):
    """(visc, del2): X's viscosities with variable viscosity, else None;
    Y's Laplacian with biharmonic viscosity, else None; what B's and V's
    dissipation variants take."""
    visc = (calc_visc(cfg, grid, u, v, impl=impl)
            if use_variable_visc(cfg) else None)
    del2 = (del2uv(cfg, grid, u, v, impl=impl)
            if use_biharmonic_visc(cfg) else None)
    return visc, del2


def field_table(visc, del2) -> dict:
    """The first six slots of B's and V's dissipation variants' second
    table (mom_fluxform.cuh:MomViscArgs, mom_vecinv_tile.cuh:VecViscArgs):
    the viscosities (None: the constants) and the Laplacian (None: no
    biharmonic viscosity)."""
    AhZ, AhD, A4Z, A4D = visc if visc is not None else (None,) * 4
    d2u, d2v = del2 if del2 is not None else (None, None)
    return dict(viscAh_D=AhD, viscAh_Z=AhZ, viscA4_D=A4D, viscA4_Z=A4Z,
                del2u=d2u, del2v=d2v)
