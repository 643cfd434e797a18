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
`calc_sigmaR` gives GGL90 and GM-Redi the vertical density gradient.

`impldiff` (the tridiagonal column solve, also used for implicit vertical
viscosity by model/step.py) runs kernel T (kernels/csrc/impldiff.cu) for
CUDA tensors and the plain PyTorch twin `_impldiff_plain` for CPU tensors
or when impl="plain" is asked for. Kernel T has no backward kernel: its
wrapper raises if an input requires grad.
"""

from __future__ import annotations

import torch

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.core.state import Forcing, State
from mitgcm_tpu_torch.model import gad, gmredi, som
from mitgcm_tpu_torch.model.kpp import ghat_flux
from mitgcm_tpu_torch.ops import eos

# calls of kernel G's tracer_step twin, for the card's runs to show that
# the main path never ran it
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


def tracer_step(cfg: Config, grid: Grid, gTr, tracer, gNm1, gNm2, sfc_forc,
                myIter: int, use_ab: bool, impl: str = None):
    """The tracer's explicit step (temp_integrate.F, timestep_tracer.F):
    (tracer', gNm1', gNm2'): the surface forcing sfc_forc into level
    ksurf0, with use_ab the AB extrapolation of the tendency (whose raw
    value is the next gNm1; without AB the history passes through), and
    tracer + deltaTTracer * gTr_ab. Kernel G's tracer_step on CUDA
    tensors, its twin on CPU tensors or with impl="plain"."""
    if kernels.use_kernel(tracer, impl):
        outs = kernels.TwinVJP.apply(
            lambda *ts: _tracer_step_kernel(cfg, grid, myIter, use_ab, *ts),
            lambda *ts: _tracer_step_plain(cfg, grid, myIter, use_ab, *ts),
            gTr, tracer, gNm1, gNm2, sfc_forc)
    else:
        global plain_calls
        plain_calls += 1
        outs = _tracer_step_plain(cfg, grid, myIter, use_ab, gTr, tracer,
                                  gNm1, gNm2, sfc_forc)
    if not use_ab:
        return outs[0], gNm1, gNm2
    return outs[0], outs[1], (gNm1 if cfg.useAB3 else gNm2)


def surface_forcing_ts(cfg: Config, grid: Grid, state: State,
                       forcing: Forcing):
    """external_forcing_surf.F + forcing_surf_relax.F: surfaceForcingT/S
    (linear free surface, no shortwave penetration). Under sea ice without
    SEAICErestoreUnderIce the relaxation is scaled by the open-water
    fraction 1 - AREA of the post-seaice state (forcing_surf_relax.F:75-90;
    thermodynamics.py:84-95 of the JAX package)."""
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
    # virtual E-P-R tracer flux (external_forcing_surf.F:130-208)
    if cfg.temp_EvPrRn is not None:
        sfT = sfT + forcing.EmPmR * (cfg.tRef[0]
                                     - cfg.temp_EvPrRn) * cfg.mass2rUnit
    if cfg.salt_EvPrRn is not None:
        sfS = sfS + forcing.EmPmR * (cfg.convertFW2Salt
                                     - cfg.salt_EvPrRn) * cfg.mass2rUnit
    return sfT, sfS


def calc_sigmaR(cfg: Config, grid: Grid, rhoInSitu, theta, salt,
                totPhiHyd=None, impl: str = None) -> torch.Tensor:
    """The vertical potential-density gradient at the interfaces
    (grad_sigma.F:95-107 with do_oceanic_phys.F:807-830), z-coordinates:
    the density of the k-1 water at level k (find_rho with kRef = k, kernel
    R on the card) against the in-situ density rhoInSitu; 0 at the
    surface."""
    nr = cfg.nr
    mC = grid.maskC
    m_km1 = torch.cat([torch.zeros_like(mC[:1]), mC[:-1]])
    sigKm1 = eos.find_rho(cfg, grid, torch.cat([theta[:1], theta[:-1]]),
                          torch.cat([salt[:1], salt[:-1]]),
                          totPhiHyd=totPhiHyd, impl=impl)
    sigmaR = (mC * m_km1 * grid.recip_drC[:nr, None, None] * cfg.rkSign
              * (rhoInSitu - sigKm1))
    sigmaR[0] = 0.0
    return sigmaR


def tracer_kappa(cfg: Config, grid: Grid, diffKr: float) -> torch.Tensor:
    """calc_3d_diffusivity.F: the constant background profile [nr, ...]."""
    return torch.full((cfg.nr,) + tuple(grid.rA.shape), diffKr,
                      dtype=grid.rA.dtype, device=grid.rA.device)


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
    if is_som:
        gSom, som_new = som.som_advect(cfg, grid, *uvw, tracer, som_state,
                                       scheme, cfg.deltaTTracer, impl=impl)
        gTr = gSom + gTr
    elif multidim:
        gTr = gad.multidim_advection(cfg, grid, flow, *uvw, tracer, scheme,
                                     vert_scheme, cfg.deltaTTracer,
                                     impl=impl) + gTr
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
                   myIter: int, impl: str = None, kpp_fields=None,
                   ggl90_fields=None, gm=None, gm_psi=None):
    """thermodynamics.F: returns (theta, salt, gtNm1, gsNm1, gtNm2, gsNm2,
    somT, somS). kpp_fields: KPP.calc's output, or None without KPP
    (thermodynamics.py:470-496, 524-533 of the JAX package); ggl90_fields:
    GGL90.calc's diffKr under "diffKr", or None (:501-503, :537-538); gm:
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
    flow = gad.calc_adv_flow(grid, *uvw)
    sfT, sfS = surface_forcing_ts(cfg, grid, state, forcing)
    dfT = dfS = None
    if kpp_fields is None:
        kapT = tracer_kappa(cfg, grid, cfg.diffKrT)
        kapS = tracer_kappa(cfg, grid, cfg.diffKrS)
        if gm is not None:
            # gmredi_calc_diff.F: Kwz into the implicit solve
            kapT = kapT + gm.Kwz * grid.maskInC
            kapS = kapS + gm.Kwz * grid.maskInC
        if ggl90_fields is not None:
            # ggl90_calc_diff.F: KappaRx += GGL90diffKr - diffKrNrS
            kapT = kapT + (ggl90_fields["diffKr"] - cfg.diffKrS)
            kapS = kapS + (ggl90_fields["diffKr"] - cfg.diffKrS)
    else:
        # KPP's diffusivities (kpp_calc_diff_t/s.F) and nonlocal flux, the
        # latter on KPP's own diffusivities; GM's Kwz joins after
        kapT, kapS = kpp_fields["diffKzT"], kpp_fields["diffKzS"]
        recip_Cp = 1.0 / cfg.HeatCapacity_Cp
        qswT = (-forcing.Qsw * recip_Cp * (1.0 / cfg.rhoConst)
                * (1.0 - kpp_fields["frac"]))
        dfT = ghat_flux(cfg, grid, kapT, kpp_fields["ghat"], sfT, qswT,
                        flow.maskUp)
        dfS = ghat_flux(cfg, grid, kapS, kpp_fields["ghat"], sfS, 0.0 * sfS,
                        flow.maskUp)
        if gm is not None:
            kapT = kapT + gm.Kwz * grid.maskInC
            kapS = kapS + gm.Kwz * grid.maskInC
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
