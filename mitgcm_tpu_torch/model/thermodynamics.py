"""Tracer thermodynamics (mitgcm_tpu/model/thermodynamics.py): explicit
advection-diffusion step of theta (and salt when stepped) with AB-2 or
AB-3 on the tendency and the surface forcing inside the AB extrapolation,
then, with implicitDiffusion, the implicit vertical diffusion. With KPP
(model/kpp.py) its diffusivities take the place of the background profile
and its nonlocal flux joins the vertical flux; with GGL90 (model/ggl90.py)
its diffusivity is added to the profile. A tracer with a scheme of
gad.MULTIDIM_SCHEMES under multiDimAdvection is advected by the
multi-dimensional advection (gad.multidim_advection, kernels M, O and P),
one with scheme 80 or 81 by second-order moments (som.som_advect, kernel
H-SOM, which comes first, with or without multiDimAdvection, as in JAX),
and neither tendency is AB-extrapolated. With GM-Redi (model/gmredi.py)
its Kwz joins the interface diffusivities and its fluxes each tracer's,
and in the advective form the residual flow advects the tracers.
`calc_sigmaR` gives GGL90 and GM-Redi the vertical density gradient:
kernel R's eos_sigma_r (kernels/csrc/eos.cu) for CUDA tensors, its twin
`_calc_sigmaR_plain` otherwise. `kappa_ts` forms the tracers' vertical
diffusivities (the background, GM's Kwz, GGL90's, PP81's or MY82's
diffKr) or, with KPP, its nonlocal fluxes: kernel J-ts
(kernels/csrc/mix_glue.cu) for CUDA tensors, its twin `_kappa_ts_plain`
otherwise. Both run under
kernels.TwinVJP, their gradients the twins'. `surface_forcing` forms the
step's surface forcing once a step (the tracers', KPP's and GGL90's
surface stress and the momentum forcing's surface level): kernel Q
(kernels/csrc/forcing.cu, under kernels.TwinVJP) for CUDA tensors, its
twin `_surface_forcing_plain` otherwise. `constant_field` keeps the
constant background diffusivities and viscosity on their grid, built
once for each value.

`impldiff` (the tridiagonal column solve, also used for implicit vertical
viscosity by model/step.py) runs kernel T (kernels/csrc/impldiff.cu) for
CUDA tensors and the plain PyTorch twin `_impldiff_plain` for CPU tensors
or when impl="plain" is asked for. Kernel T has no backward kernel: its
wrapper raises if an input requires grad.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.core.state import Forcing, State
from mitgcm_tpu_torch.model import gad, gmredi, som
from mitgcm_tpu_torch.model.kpp import ghat_flux
from mitgcm_tpu_torch.ops import eos

# calls of the twins of kernel G's tracer_step, J-ts, R's sigmaR and Q,
# for the card's runs to show that the main path never ran them
plain_calls = 0


def _impldiff_plain(cfg: Config, grid: Grid, field, kappaR, recip_hFac,
                    deltaT: float):
    """Kernel T's twin: thermodynamics.py:impldiff (:24-73), the Thomas
    elimination of impldiff.F, with the JAX code's coefficients, guards
    and operation order. A column whose diagonal or pivot is 0 (land)
    keeps the guard's value 1 for its reciprocal."""
    nr = cfg.nr
    rdrF = grid.recip_drF[:, None, None]
    rdrC = grid.recip_drC[:, None, None]
    a = torch.zeros_like(field)
    c = torch.zeros_like(field)
    a[1:] = -deltaT * recip_hFac[1:] * rdrF[1:] * kappaR[1:nr] * rdrC[1:nr]
    a[1:] = torch.where(recip_hFac[:-1] == 0.0, 0.0, a[1:])
    c[:-1] = (-deltaT * recip_hFac[:-1] * rdrF[:-1] * kappaR[1:nr]
              * rdrC[1:nr])
    c[:-1] = torch.where(recip_hFac[1:] == 0.0, 0.0, c[:-1])
    b = 1.0 - (a + c)

    def recip(d):
        return torch.where(d != 0.0,
                           1.0 / torch.where(d != 0.0, d, 1.0), 1.0)

    bet = recip(b[0])
    y = [field[0] * bet]
    gam = [torch.zeros_like(bet)]
    for k in range(1, nr):
        gam.append(c[k - 1] * bet)
        bet = recip(b[k] - a[k] * gam[k])
        y.append(bet * (field[k] - a[k] * y[k - 1]))
    x = [y[nr - 1]]
    for k in range(nr - 2, -1, -1):
        x.append(y[k] - gam[k + 1] * x[-1])
    return torch.stack(x[::-1])


def impldiff(cfg: Config, grid: Grid, field, kappaR, recip_hFac,
             deltaT: float, impl: str = None):
    """Implicit vertical diffusion of `field` [nr, nyp, nxp] over deltaT
    (impldiff.F): kappaR [>= nr, nyp, nxp] interface diffusivities (index
    k = the interface above cell k; row 0 unused), recip_hFac the open
    fraction's reciprocal at the field's C, W or S points."""
    nr = cfg.nr
    if nr == 1:
        return field
    ins = dict(field=field, kappaR=kappaR, recip_hFac=recip_hFac,
               recip_drF=grid.recip_drF, recip_drC=grid.recip_drC)
    grads = [n for n, t in ins.items() if t.requires_grad]
    if grads:
        raise ValueError(f"impldiff: {grads} require grad; kernel T has no "
                         "backward kernel yet")
    if not kernels.use_kernel(field, impl):
        return _impldiff_plain(cfg, grid, field, kappaR, recip_hFac, deltaT)
    _, nyp, nxp = field.shape
    out = torch.empty_like(field)
    gam = torch.empty_like(field)    # the sweep's multipliers, per column
    kernels.check_tensors(field.dtype, **ins, out=out, gam=gam)
    kernels.check_shape("recip_hFac", recip_hFac, field.shape)
    if kappaR.shape[0] < nr or tuple(kappaR.shape[1:]) != (nyp, nxp):
        raise ValueError(f"kappaR: shape {tuple(kappaR.shape)}, need "
                         f"[>= {nr}, {nyp}, {nxp}]")
    kernels.check_shape("recip_drF", grid.recip_drF, (nr,))
    kernels.check_shape("recip_drC", grid.recip_drC, (nr + 1,))
    kernels.launch("impldiff", field.dtype, field.data_ptr(),
                   kappaR.data_ptr(), recip_hFac.data_ptr(),
                   grid.recip_drF.data_ptr(), grid.recip_drC.data_ptr(),
                   gam.data_ptr(), out.data_ptr(), nr, nyp * nxp,
                   float(deltaT))
    return out


def _tracer_step_plain(cfg: Config, grid: Grid, myIter: int, use_ab: bool,
                       gTr, tracer, gNm1, gNm2, sfc_forc):
    """Kernel G's tracer_step twin (thermodynamics.py:329-358 of the JAX
    package): the surface forcing into level ksurf0, the AB extrapolation
    when use_ab, and the explicit step. (tracer', gTr + gForc) with AB,
    (tracer',) without (the history passes through)."""
    from mitgcm_tpu_torch.model.step import adams_bashforth

    ks = cfg.ksurf0
    gForc = torch.zeros_like(tracer)
    gForc[ks] = sfc_forc * grid.recip_drF[ks] * grid.recip_hFacC[ks]
    gTr = gTr + gForc
    if not use_ab:
        return (tracer + cfg.deltaTTracer * gTr,)
    gTr_ab = adams_bashforth(cfg, gTr, gNm1, gNm2, myIter)[0]
    return tracer + cfg.deltaTTracer * gTr_ab, gTr


def _tracer_step_kernel(cfg: Config, grid: Grid, myIter: int, use_ab: bool,
                        gTr, tracer, gNm1, gNm2, sfc_forc):
    """Kernel G's tracer_step on the card (kernels/csrc/step_glue.cu):
    (tracer', g) with AB, (tracer',) without, as the twin."""
    from mitgcm_tpu_torch.model.step import ab_params

    order, abFac, ab0, ab1, ab2 = ab_params(cfg, myIter, use_ab)
    tr_new = torch.empty_like(tracer)
    outs = (tr_new, torch.empty_like(tracer)) if order else (tr_new,)
    # the slots that the launch does not touch (the history without AB or
    # under AB-2's gNm2, the raw tendency without AB) hold the tracer
    hist = {"gNm1": gNm1} if order else {}
    if order == 3:
        hist["gNm2"] = gNm2
    ksurf = grid.recip_hFacC[cfg.ksurf0]
    dtype = tracer.dtype
    kernels.check_fields(dtype, tracer.shape, gTr=gTr, tracer=tracer,
                         **hist, **{f"out{k}": t for k, t in enumerate(outs)})
    kernels.check_fields(dtype, tracer.shape[1:], sfc_forc=sfc_forc,
                         recip_hFacC_ks=ksurf)
    kernels.check_fields(dtype, (cfg.nr,), recip_drF=grid.recip_drF)
    table = [gTr, tracer, hist.get("gNm1", tracer), hist.get("gNm2", tracer),
             sfc_forc, ksurf, grid.recip_drF, tr_new, outs[-1]]
    kernels.launch("tracer_step", tracer.dtype, kernels.pointer_table(table),
                   len(table), *tracer.shape, cfg.ksurf0, order, abFac, ab0,
                   ab1, ab2, cfg.deltaTTracer)
    return outs


def tracer_step_vjp_plain(cfg: Config, grid: Grid, myIter: int,
                          use_ab: bool, tr_bar, g_bar=None):
    """Kernel G''s tracer_step_adj's plain version, in its operation order:
    the cotangents of (gTr, tracer, gNm1, gNm2, sfc_forc) from those of
    tracer' and, with AB, of the raw tendency g (the next gNm1); gNm1's is
    None without AB, gNm2's without AB-3 (they are not read)."""
    from mitgcm_tpu_torch.model.step import ab_params

    order, abFac, ab0, ab1, ab2 = ab_params(cfg, myIter, use_ab)
    c = tr_bar * cfg.deltaTTracer
    nm1 = nm2 = None
    if order == 0:
        g = c
    elif order == 2:
        t = c * abFac
        g, nm1 = (g_bar + c) + t, -t
    else:
        g, nm1, nm2 = (g_bar + c) + c * ab0, c * ab1, c * ab2
    ks = cfg.ksurf0
    sfc_bar = (g[ks] * grid.recip_hFacC[ks]) * grid.recip_drF[ks]
    return g, tr_bar, nm1, nm2, sfc_bar


def _tracer_step_adj_kernel(cfg: Config, grid: Grid, myIter: int,
                            use_ab: bool, need, tr_bar, g_bar=None):
    """Kernel G''s tracer_step_adj on the card (step_glue_adj.cu): the
    cotangents of (gTr, tracer, gNm1, gNm2, sfc_forc) that `need` asks for
    (tracer's is tracer''s own cotangent), fresh."""
    from mitgcm_tpu_torch.model.step import ab_params

    order, abFac, ab0, ab1, ab2 = ab_params(cfg, myIter, use_ab)
    reads = (True, True, order != 0, order == 3)
    outs = [tr_bar.new_empty(tr_bar.shape) if n and r else None
            for n, r in zip((need[0], need[2], need[3]), reads[:1] + reads[2:])]
    sfc = tr_bar.new_empty(tr_bar.shape[1:]) if need[4] else None
    ksurf = grid.recip_hFacC[cfg.ksurf0]
    dtype = tr_bar.dtype
    kernels.check_fields(dtype, tr_bar.shape, tr_bar=tr_bar, **(
        {"g_bar": g_bar} if order else {}), **{
            n: t for n, t in zip(("gTr_bar", "gNm1_bar", "gNm2_bar"), outs)
            if t is not None})
    kernels.check_fields(dtype, tr_bar.shape[1:], recip_hFacC_ks=ksurf,
                         **({} if sfc is None else {"sfc_bar": sfc}))
    kernels.check_fields(dtype, (cfg.nr,), recip_drF=grid.recip_drF)
    table = [tr_bar, g_bar if order else None, ksurf, grid.recip_drF, *outs,
             sfc]
    kernels.launch("tracer_step_adj", dtype, kernels.pointer_table(table),
                   len(table), *tr_bar.shape, cfg.ksurf0, order, abFac, ab0,
                   ab1, ab2, cfg.deltaTTracer)
    return outs[0], tr_bar, outs[1], outs[2], sfc


def tracer_step(cfg: Config, grid: Grid, gTr, tracer, gNm1, gNm2, sfc_forc,
                myIter: int, use_ab: bool, impl: str = None):
    """The tracer's explicit step (temp_integrate.F, timestep_tracer.F):
    (tracer', gNm1', gNm2'): the surface forcing sfc_forc into level
    ksurf0, with use_ab the AB extrapolation of the tendency (whose raw
    value is the next gNm1; without AB the history passes through), and
    tracer + deltaTTracer * gTr_ab. Kernel G's tracer_step on CUDA
    tensors, its twin on CPU tensors or with impl="plain"."""
    if kernels.use_kernel(tracer, impl):
        kernels.refuse_grad("tracer_step",
                            recip_hFacC=grid.recip_hFacC,
                            recip_drF=grid.recip_drF)
        outs = kernels.KernelVJP.apply(
            lambda *ts: _tracer_step_kernel(cfg, grid, myIter, use_ab, *ts),
            lambda need, *bars: _tracer_step_adj_kernel(
                cfg, grid, myIter, use_ab, need, *bars),
            gTr, tracer, gNm1, gNm2, sfc_forc)
    else:
        global plain_calls
        plain_calls += 1
        outs = _tracer_step_plain(cfg, grid, myIter, use_ab, gTr, tracer,
                                  gNm1, gNm2, sfc_forc)
    if not use_ab:
        return outs[0], gNm1, gNm2
    return outs[0], outs[1], (gNm1 if cfg.useAB3 else gNm2)


class SurfaceForcing(NamedTuple):
    """The step's surface forcing (kernel Q's outputs, [nyp, nxp] each):
    surfaceForcingT/S, the surface stress over rhoConst that KPP and GGL90
    read (fu, fv times mass2rUnit; None on the paths without them) and the
    momentum forcing's surface level (apply_forcing.F; kernel G adds 0
    below it)."""
    sfT: torch.Tensor
    sfS: torch.Tensor
    tauU: torch.Tensor
    tauV: torch.Tensor
    guExt: torch.Tensor
    gvExt: torch.Tensor


# the forcing fields kernel Q reads, in its twin's argument order after
# theta, salt and AREA
FORCING_INPUTS = ("SST", "SSS", "Qnet", "saltFlux", "EmPmR", "fu", "fv")


def _open_area(cfg: Config, state: State):
    """The post-seaice AREA whose open-water fraction 1 - AREA scales the
    relaxation (forcing_surf_relax.F:75-90; thermodynamics.py:84-95 of the
    JAX package), or None (no sea ice, or SEAICErestoreUnderIce)."""
    if (cfg.useSEAICE and cfg.seaice is not None
            and not cfg.seaice.restoreUnderIce
            and state.siAREA is not None and state.siAREA.dim() == 2):
        return state.siAREA
    return None


def _writes_tau(cfg: Config) -> bool:
    """Whether the step reads the surface stress tauU/tauV (KPP, GGL90)."""
    return bool(cfg.useKPP or cfg.useGGL90)


def _surface_forcing_plain(cfg: Config, grid: Grid, theta, salt, AREA, SST,
                           SSS, Qnet, saltFlux, EmPmR, fu, fv):
    """Kernel Q's twin: external_forcing_surf.F + forcing_surf_relax.F's
    surfaceForcingT/S (linear free surface, no shortwave penetration; the
    relaxation scaled by 1 - AREA when AREA is given) and apply_forcing.F's
    wind stress, its surface level only, as a SurfaceForcing (tauU, tauV
    None without KPP and GGL90)."""
    sfT = torch.zeros_like(fu)
    sfS = torch.zeros_like(fu)
    ks = cfg.ksurf0
    openFrac = 1.0 if AREA is None else 1.0 - AREA
    if cfg.tauThetaClimRelax > 0.0:
        lam = 1.0 / cfg.tauThetaClimRelax
        sfT = sfT - lam * openFrac * (theta[ks] - SST) \
            * grid.drF[ks] * grid.hFacC[ks]
    if cfg.tauSaltClimRelax > 0.0:
        lam = 1.0 / cfg.tauSaltClimRelax
        sfS = sfS - lam * openFrac * (salt[ks] - SSS) \
            * grid.drF[ks] * grid.hFacC[ks]
    recip_Cp = 1.0 / cfg.HeatCapacity_Cp
    sfT = sfT - Qnet * recip_Cp * cfg.mass2rUnit
    sfS = sfS - saltFlux * cfg.mass2rUnit
    # virtual E-P-R tracer flux (external_forcing_surf.F:130-208)
    if cfg.temp_EvPrRn is not None:
        sfT = sfT + EmPmR * (cfg.tRef[0] - cfg.temp_EvPrRn) * cfg.mass2rUnit
    if cfg.salt_EvPrRn is not None:
        sfS = sfS + EmPmR * (cfg.convertFW2Salt
                             - cfg.salt_EvPrRn) * cfg.mass2rUnit
    tauU = fu * cfg.mass2rUnit
    tauV = fv * cfg.mass2rUnit
    tau = _writes_tau(cfg)
    return SurfaceForcing(
        sfT, sfS, tauU if tau else None, tauV if tau else None,
        tauU * grid.recip_drF[0] * grid.recip_hFacW[0],
        tauV * grid.recip_drF[0] * grid.recip_hFacS[0])


def _forcing_flags(cfg: Config) -> int:
    """Kernel Q's flags (forcing.cuh): the relaxations of theta (1) and
    salt (2), the E-P-R fluxes of theta (4) and salt (8), the surface
    stress written (16)."""
    return (int(cfg.tauThetaClimRelax > 0.0)
            | 2 * int(cfg.tauSaltClimRelax > 0.0)
            | 4 * int(cfg.temp_EvPrRn is not None)
            | 8 * int(cfg.salt_EvPrRn is not None)
            | 16 * int(_writes_tau(cfg)))


def _variant_args(cfg: Config, args) -> tuple:
    """The twin's arguments after grid (theta, salt, AREA, then
    FORCING_INPUTS) with None where kernel Q's variant reads nothing (the
    relaxations' tracers, targets and AREA, the E-P-R flux)."""
    flags = _forcing_flags(cfg)
    reads = (flags & 1, flags & 2, flags & 3, flags & 1, flags & 2, 1, 1,
             flags & 12, 1, 1)
    return tuple(a if r else None for a, r in zip(args, reads))


def _surface_forcing_kernel(cfg: Config, grid: Grid, theta, salt, AREA, SST,
                            SSS, Qnet, saltFlux, EmPmR, fu, fv):
    """Kernel Q on the card (forcing.cu): the twin's SurfaceForcing."""
    flags = _forcing_flags(cfg)
    relax = flags & 3
    ks = cfg.ksurf0
    s2 = tuple(fu.shape)
    outs = [torch.empty_like(fu) for _ in SurfaceForcing._fields]
    if not flags & 16:
        outs[2] = outs[3] = None
    ins = dict(theta=theta[ks] if flags & 1 else None,
               salt=salt[ks] if flags & 2 else None,
               hFacC=grid.hFacC[ks] if relax else None,
               SST=SST if flags & 1 else None, SSS=SSS if flags & 2 else None,
               AREA=AREA if relax else None,
               drF=grid.drF[ks:ks + 1] if relax else None, Qnet=Qnet,
               saltFlux=saltFlux, EmPmR=EmPmR if flags & 12 else None, fu=fu,
               fv=fv, recip_drF=grid.recip_drF[:1],
               recip_hFacW=grid.recip_hFacW[0],
               recip_hFacS=grid.recip_hFacS[0])
    kernels.check_fields(fu.dtype, s2, **{
        n: t for n, t in ins.items() if t is not None and t.dim() == 2},
        **{n: t for n, t in zip(SurfaceForcing._fields, outs)
           if t is not None})
    kernels.check_fields(fu.dtype, (1,), **{
        n: t for n, t in ins.items() if t is not None and t.dim() == 1})
    table = kernels.pointer_table(list(ins.values()) + outs)
    params = kernels.doubles([
        1.0 / cfg.tauThetaClimRelax if flags & 1 else 0.0,
        1.0 / cfg.tauSaltClimRelax if flags & 2 else 0.0,
        1.0 / cfg.HeatCapacity_Cp, cfg.mass2rUnit,
        cfg.tRef[0] - cfg.temp_EvPrRn if flags & 4 else 0.0,
        cfg.convertFW2Salt - cfg.salt_EvPrRn if flags & 8 else 0.0])
    kernels.launch("surface_forcing", fu.dtype, table, len(table), params,
                   len(params), *s2, flags)
    return SurfaceForcing(*outs)


def surface_forcing(cfg: Config, grid: Grid, state: State, forcing: Forcing,
                    impl: str = None) -> SurfaceForcing:
    """The step's surface forcing from the post-seaice state and forcing,
    once a step (external_forcing_surf.F, forcing_surf_relax.F,
    apply_forcing.F's surface level): kernel Q on CUDA tensors, under
    kernels.TwinVJP for the inputs its variant reads (a relaxed tracer
    under an initial-condition control), its twin on CPU tensors or with
    impl="plain"."""
    args = (state.theta, state.salt, _open_area(cfg, state),
            *[getattr(forcing, n) for n in FORCING_INPUTS])
    if not kernels.use_kernel(forcing.fu, impl):
        global plain_calls
        plain_calls += 1
        return _surface_forcing_plain(cfg, grid, *args)
    kernels.refuse_grad("surface_forcing", hFacC=grid.hFacC, drF=grid.drF,
                        recip_drF=grid.recip_drF,
                        recip_hFacW=grid.recip_hFacW,
                        recip_hFacS=grid.recip_hFacS)
    return SurfaceForcing(*kernels.TwinVJP.apply(
        lambda *ts: tuple(_surface_forcing_kernel(cfg, grid, *ts)),
        lambda *ts: _surface_forcing_plain(cfg, grid, *ts),
        *_variant_args(cfg, args)))


def _calc_sigmaR_plain(cfg: Config, grid: Grid, rhoInSitu, theta, salt,
                       totPhiHyd=None):
    """Kernel R's eos_sigma_r twin: calc_sigmaR (thermodynamics.py:154-184
    of the JAX package) in z-coordinates, in its operation order."""
    nr = cfg.nr
    mC = grid.maskC
    m_km1 = torch.cat([torch.zeros_like(mC[:1]), mC[:-1]])
    sigKm1 = eos._find_rho_plain(cfg, grid, torch.cat([theta[:1], theta[:-1]]),
                                 torch.cat([salt[:1], salt[:-1]]), totPhiHyd,
                                 None)
    sigmaR = (mC * m_km1 * grid.recip_drC[:nr, None, None] * cfg.rkSign
              * (rhoInSitu - sigKm1))
    sigmaR[0] = 0.0
    return (sigmaR,)


def calc_sigmaR(cfg: Config, grid: Grid, rhoInSitu, theta, salt,
                totPhiHyd=None, impl: str = None) -> torch.Tensor:
    """The vertical potential-density gradient at the interfaces
    (grad_sigma.F:95-107 with do_oceanic_phys.F:807-830), z-coordinates:
    the density of the k-1 water at level k (find_rho with kRef = k)
    against the in-situ density rhoInSitu; 0 at the surface. Kernel R's
    eos_sigma_r on CUDA tensors (the LINEAR kind under kernels.TwinVJP),
    its twin on CPU tensors or with impl="plain". The nonlinear kinds
    refuse inputs that require grad, as find_rho does."""
    eos.refuse_grad(cfg, "calc_sigmaR", rhoInSitu=rhoInSitu, theta=theta,
                    salt=salt, totPhiHyd=totPhiHyd
                    if cfg.selectP_inEOS_Zc == 2 else None)
    if not kernels.use_kernel(theta, impl):
        global plain_calls
        plain_calls += 1
        return _calc_sigmaR_plain(cfg, grid, rhoInSitu, theta, salt,
                                  totPhiHyd)[0]
    if cfg.eosType.upper() != "LINEAR":
        return eos.sigma_r_kernel(cfg, grid, rhoInSitu, theta, salt,
                                  totPhiHyd)[0]
    return kernels.TwinVJP.apply(
        lambda *ts: eos.sigma_r_kernel(cfg, grid, *ts),
        lambda *ts: _calc_sigmaR_plain(cfg, grid, *ts),
        rhoInSitu, theta, salt, totPhiHyd)[0]


def constant_field(grid: Grid, value: float, shape: tuple) -> torch.Tensor:
    """A field of one value in grid's dtype on its device, built once for
    each value, shape, dtype and device and kept on the grid (freed with
    it), shared by every caller (two configurations on one grid with
    different values get different fields): read only, no consumer writes
    into it."""
    like = grid.rA
    key = (float(value), tuple(shape), like.dtype, like.device)
    # Grid is frozen: the cache is an attribute beside its fields
    cache = grid.__dict__.setdefault("_constant_fields", {})
    if key not in cache:
        cache[key] = torch.full(key[1], key[0], dtype=key[2],
                                device=key[3])
    return cache[key]


def tracer_kappa(cfg: Config, grid: Grid, diffKr: float) -> torch.Tensor:
    """calc_3d_diffusivity.F: the constant background profile [nr, ...]
    (constant_field's, read only)."""
    return constant_field(grid, diffKr, (cfg.nr,) + tuple(grid.rA.shape))


# the inputs of kappa_ts, in its twin's and its kernel's argument order
KAPPA_TS_INPUTS = ("Kwz", "diffKr", "diffKzT", "diffKzS", "ghat", "frac",
                   "sfT", "sfS", "Qsw", "maskUp")


def _kappa_ts_plain(cfg: Config, grid: Grid, Kwz, diffKr, diffKzT, diffKzS,
                    ghat, frac, sfT, sfS, Qsw, maskUp):
    """Kernel J-ts's twin: (kapT, kapS, dfT, dfS), the tracers' interface
    diffusivities and KPP's nonlocal fluxes (thermodynamics.py:283,
    :470-505, :524-540 of the JAX package). Without KPP (diffKzT None) the
    background profile, + Kwz * maskInC under GM (Kwz given), + (diffKr -
    diffKrS) under GGL90, PP81 or MY82 (diffKr given; their
    *_calc_diff.F add it alike), and no fluxes; with KPP its
    diffusivities and nonlocal fluxes, the latter on KPP's own
    diffusivities, then GM's Kwz joins."""
    dfT = dfS = None
    if diffKzT is None:
        kapT = tracer_kappa(cfg, grid, cfg.diffKrT)
        kapS = tracer_kappa(cfg, grid, cfg.diffKrS)
        if Kwz is not None:
            # gmredi_calc_diff.F: Kwz into the implicit solve
            kapT = kapT + Kwz * grid.maskInC
            kapS = kapS + Kwz * grid.maskInC
        if diffKr is not None:
            # ggl90_calc_diff.F: KappaRx += GGL90diffKr - diffKrNrS (and
            # pp81/my82_calc_diff.F with their diffKr)
            kapT = kapT + (diffKr - cfg.diffKrS)
            kapS = kapS + (diffKr - cfg.diffKrS)
    else:
        # KPP's diffusivities (kpp_calc_diff_t/s.F) and nonlocal flux, the
        # latter on KPP's own diffusivities; GM's Kwz joins after
        kapT, kapS = diffKzT, diffKzS
        recip_Cp = 1.0 / cfg.HeatCapacity_Cp
        qswT = (-Qsw * recip_Cp * (1.0 / cfg.rhoConst) * (1.0 - frac))
        dfT = ghat_flux(cfg, grid, kapT, ghat, sfT, qswT, maskUp)
        dfS = ghat_flux(cfg, grid, kapS, ghat, sfS, 0.0 * sfS, maskUp)
        if Kwz is not None:
            kapT = kapT + Kwz * grid.maskInC
            kapS = kapS + Kwz * grid.maskInC
    return kapT, kapS, dfT, dfS


def _kappa_ts_kernel(cfg: Config, grid: Grid, *ins):
    """Kernel J-ts on the card (mix_glue.cu): (kapT, kapS, dfT, dfS) as the
    twin gives them. It writes the diffusivities unless KPP's own pass
    through (KPP without GM), and KPP's fluxes."""
    named = dict(zip(KAPPA_TS_INPUTS, ins))
    kpp, gm = named["diffKzT"] is not None, named["Kwz"] is not None
    ggl90 = named["diffKr"] is not None
    dtype = grid.rA.dtype
    shape3 = (cfg.nr,) + tuple(grid.rA.shape)
    outs = {}
    if not kpp or gm:
        outs.update(kapT=grid.maskC.new_empty(shape3),
                    kapS=grid.maskC.new_empty(shape3))
    if kpp:
        outs.update(dfT=grid.maskC.new_empty(shape3),
                    dfS=grid.maskC.new_empty(shape3))
    fields3 = {n: t for n, t in named.items() if t is not None
               and n in ("Kwz", "diffKr", "diffKzT", "diffKzS", "ghat",
                         "maskUp")}
    fields2 = {n: t for n, t in named.items() if t is not None
               and n in ("frac", "sfT", "sfS", "Qsw")}
    if gm:
        fields2["maskInC"] = grid.maskInC
    if kpp:
        fields2["rA"] = grid.rA
    kernels.check_fields(dtype, shape3, **fields3, **outs)
    kernels.check_fields(dtype, shape3[1:], **fields2)
    table = [named["Kwz"], fields2.get("maskInC"), named["diffKr"],
             named["diffKzT"], named["diffKzS"], named["ghat"],
             named["maskUp"], fields2.get("rA"), named["sfT"], named["sfS"],
             named["Qsw"], named["frac"], outs.get("kapT"), outs.get("kapS"),
             outs.get("dfT"), outs.get("dfS")]
    params = kernels.doubles([cfg.diffKrT, cfg.diffKrS,
                              1.0 / cfg.HeatCapacity_Cp, 1.0 / cfg.rhoConst])
    kernels.launch("kappa_ts", dtype, kernels.pointer_table(table),
                   len(table), params, len(params), *shape3, int(kpp),
                   int(gm), int(ggl90))
    return (outs.get("kapT", named["diffKzT"]),
            outs.get("kapS", named["diffKzS"]), outs.get("dfT"),
            outs.get("dfS"))


def kappa_ts(cfg: Config, grid: Grid, forcing: Forcing, sfT, sfS, maskUp,
             kpp_fields=None, ggl90_fields=None, gm=None, impl: str = None,
             vmix_fields=None):
    """(kapT, kapS, dfT, dfS): the tracers' vertical diffusivities and, with
    KPP, its nonlocal fluxes for gad.calc_rhs's df (None without KPP; with
    KPP and no GM, kapT and kapS are KPP's diffKzT and diffKzS themselves).
    ggl90_fields or vmix_fields (PP81's or MY82's) give the diffKr that
    is added.
    Kernel J-ts on CUDA tensors (under kernels.TwinVJP), its twin on CPU
    tensors or with impl="plain". The background alone (no KPP, GM or
    GGL90) is two constant fills (the twin's torch.full) on any device:
    J-ts runs only where there is arithmetic."""
    # check_supported refuses GGL90 with PP81 or MY82
    added = (ggl90_fields or vmix_fields or {}).get("diffKr")
    ins = (None if gm is None else gm.Kwz, added,
           *((kpp_fields["diffKzT"], kpp_fields["diffKzS"],
              kpp_fields["ghat"], kpp_fields["frac"], sfT, sfS, forcing.Qsw,
              maskUp) if kpp_fields is not None else (None,) * 8))
    if kpp_fields is None and gm is None and added is None:
        return _kappa_ts_plain(cfg, grid, *ins)
    if not kernels.use_kernel(grid.maskC, impl):
        global plain_calls
        plain_calls += 1
        return _kappa_ts_plain(cfg, grid, *ins)
    return kernels.TwinVJP.apply(
        lambda *ts: _kappa_ts_kernel(cfg, grid, *ts),
        lambda *ts: _kappa_ts_plain(cfg, grid, *ts), *ins)


def tracer_integrate(cfg: Config, grid: Grid, flow: gad.AdvFlow, tracer,
                     gNm1, gNm2, kappaR, sfc_forc, diffKh: float,
                     myIter: int, impl: str = None, df=None,
                     schemes=(gad.ENUM_CENTERED_2ND, gad.ENUM_CENTERED_2ND),
                     uvw=None, som_state=None, gm=None):
    """temp_integrate.F for one tracer: (tracer', gNm1', gNm2', som'); df:
    an extra vertical flux for gad.calc_rhs (KPP's nonlocal flux) or None;
    schemes: the (horizontal, vertical) advection schemes; uvw: the
    velocities that the multi-dimensional and SOM advection advect with;
    som_state: the tracer's moments with scheme 80 or 81 (som' their update,
    else som_state passed through); gm: the GM-Redi tensor for calc_rhs, or
    None."""
    scheme, vert_scheme = schemes
    is_som = scheme in som.SOM_SCHEMES
    multidim = gad.is_multidim(cfg, scheme)
    gTr = gad.calc_rhs(cfg, grid, flow, tracer, kappaR, diffKh,
                       implicit_diffusion=cfg.implicitDiffusion, impl=impl,
                       df=df, calc_advection=not (multidim or is_som), gm=gm)
    som_new = som_state
    # the advection's gTracer + gTr (the kernels' last sweep adds gTr)
    if is_som:
        gTr, som_new = som.som_advect(cfg, grid, *uvw, tracer, som_state,
                                      scheme, cfg.deltaTTracer, impl=impl,
                                      add=gTr)
    elif multidim:
        gTr = gad.multidim_advection(cfg, grid, flow, *uvw, tracer, scheme,
                                     vert_scheme, cfg.deltaTTracer,
                                     impl=impl, add=gTr)
    # AB on the tendency only for the linear scheme (gad_init_fixed.F:
    # AdamsBashforthGt); the history of a non-linear one passes through
    tr_new, gNm1_new, gNm2_new = tracer_step(
        cfg, grid, gTr, tracer, gNm1, gNm2, sfc_forc, myIter,
        use_ab=scheme == gad.ENUM_CENTERED_2ND, impl=impl)
    if cfg.implicitDiffusion:
        tr_new = impldiff(cfg, grid, tr_new, kappaR, grid.recip_hFacC,
                          cfg.deltaTTracer, impl=impl)
    return tr_new, gNm1_new, gNm2_new, som_new


def thermodynamics(cfg: Config, grid: Grid, state: State, forcing: Forcing,
                   sf: SurfaceForcing, myIter: int, impl: str = None,
                   kpp_fields=None, ggl90_fields=None, gm=None, gm_psi=None,
                   vmix_fields=None):
    """thermodynamics.F: returns (theta, salt, gtNm1, gsNm1, gtNm2, gsNm2,
    somT, somS). sf: the step's surface forcing (surface_forcing);
    kpp_fields: KPP.calc's output, or None without KPP
    (thermodynamics.py:470-496, 524-533 of the JAX package); ggl90_fields:
    GGL90.calc's diffKr under "diffKr", or None (:501-503, :537-538);
    vmix_fields: PP81.calc's or MY82.calc's diffKr under "diffKr", added
    alike (:504-505, :539-540), or None; gm:
    the GM-Redi tensor (model/gmredi.py), whose Kwz joins the interface
    diffusivities and whose fluxes join each tracer's (:282-283, :490-495,
    :530-533), or None; gm_psi: the filled bolus streamfunction (psiX,
    psiY) of the advective form, whose residual flow advects the tracers
    (:443-453), or None."""
    theta, salt = state.theta, state.salt
    gtNm1, gsNm1 = state.gtNm1, state.gsNm1
    gtNm2, gsNm2 = state.gtNm2, state.gsNm2
    somT, somS = state.somT, state.somS
    if not (cfg.tempStepping or cfg.saltStepping):
        return theta, salt, gtNm1, gsNm1, gtNm2, gsNm2, somT, somS
    uvw = (state.uVel, state.vVel, state.wVel)
    if gm_psi is not None:
        uvw = gmredi.gm_residual_flow(cfg, grid, *gm_psi, *uvw, impl=impl)
    flow = gad.calc_adv_flow(grid, *uvw, impl=impl)
    sfT, sfS = sf.sfT, sf.sfS
    kapT, kapS, dfT, dfS = kappa_ts(
        cfg, grid, forcing, sfT, sfS, flow.maskUp, kpp_fields=kpp_fields,
        ggl90_fields=ggl90_fields, gm=gm, impl=impl,
        vmix_fields=vmix_fields)
    if cfg.tempStepping:
        theta, gtNm1, gtNm2, somT = tracer_integrate(
            cfg, grid, flow, theta, gtNm1, gtNm2, kapT, sfT, cfg.diffKhT,
            myIter, impl=impl, df=dfT, uvw=uvw, schemes=(
                cfg.tempAdvScheme,
                cfg.tempVertAdvScheme or cfg.tempAdvScheme), som_state=somT,
            gm=gm)
    if cfg.saltStepping:
        salt, gsNm1, gsNm2, somS = tracer_integrate(
            cfg, grid, flow, salt, gsNm1, gsNm2, kapS, sfS, cfg.diffKhS,
            myIter, impl=impl, df=dfS, uvw=uvw, schemes=(
                cfg.saltAdvScheme,
                cfg.saltVertAdvScheme or cfg.saltAdvScheme), som_state=somS,
            gm=gm)
    return theta, salt, gtNm1, gsNm1, gtNm2, gsNm2, somT, somS
