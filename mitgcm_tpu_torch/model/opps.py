"""OPPS penetrative plume convection (Paluszkiewicz & Romea), the port of
mitgcm_tpu/model/opps.py.

Reference: pkg/opps - opps_calc.F (a plume launched from each level in
turn, top down, descends while it is denser than its surroundings,
entraining them; the environment is then adjusted by the plume's mass
flux, so each launch sees the environment the last one left),
opps_interface.F (applied to the freshly stepped tracers from
tracers_correction_step.F:109), opps_readparms.F (the OPPS_PARM01
defaults).

`OPPS.apply` runs kernel Z (`opps_col`, kernels/csrc/opps.cu) on CUDA
tensors: one thread a column, looping over the launch levels, the descent,
the adjustment's time steps and its sub-steps as the reference does, a
column's environment, plume profile and mass flux in dynamic shared memory
(Z_SHARED_VALUES values a level of each of a warp's columns;
`kernels.max_nr(Z_SHARED_VALUES, dtype)` levels at most). On CPU tensors, or with impl="plain", the twin `_opps_plain` runs:
the JAX code's loops vectorized over all columns, alive masks standing in
for the reference's exits, in its operation order, so the kernel's
outputs are its bits. The twin skips only the iterations its masks leave
without effect (descent steps above the launch level or after every
column's plume has died, adjustment sub-steps after every column's last).
No gradient: the adjoint refuses useOPPS.
"""

from __future__ import annotations

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model.gad_ho import _rdiv
from mitgcm_tpu_torch.model.vertmix import _read_group
from mitgcm_tpu_torch.ops import eos

# the values a level of each of a warp's columns that kernel Z keeps in
# dynamic shared memory: 181 levels at most in float64, 363 in float32
Z_SHARED_VALUES = 5
# FIND_RHO_SCALAR's kinds in kernel Z (eos.cuh's numbering)
_KIND = {"JMD95Z": 0, "JMD95P": 0, "UNESCO": 0, "MDJWF": 1, "LINEAR": 2}

# calls of the twin (a run on the card reads it to show that its kernel
# path never did)
plain_calls = 0


class OPPS:
    """OPPS_PARM01 (opps_readparms.F defaults), kLowC (the wet levels of
    each column) and STATE1's pressure profiles."""

    def __init__(self, cfg: Config, grid: Grid, group: dict | None = None):
        self.cfg, self.grid = cfg, grid
        self.p = _read_group(dict(
            MAX_ABE_ITERATIONS=1, PlumeRadius=100.0,
            STABILITY_THRESHOLD=-1e-4, FRACTIONAL_AREA=0.1,
            MAX_FRACTIONAL_AREA=0.8, VERTICAL_VELOCITY=0.03,
            ENTRAINMENT_RATE=-0.05, useGCMwVel=False), group,
            "OPPS_PARM01", ("oppsdebuglevel", "oppsdumpfreq",
                            "oppswritestate"))
        if cfg.eosType.upper() not in _KIND:
            raise NotImplementedError(f"OPPS STATE1 eosType={cfg.eosType}")
        self.kLowC = grid.maskC.sum(dim=0).to(torch.int32).contiguous()
        # STATE1's reference pressure of each level (opps_calc.F:655-700):
        # phiRef, which totPhiHyd completes under selectP_inEOS_Zc = 2,
        # and the static -rhoConst rC g
        self.phiRef = (grid.rC - grid.rF[0]) * cfg.gravity * cfg.gravitySign
        self.pStatic = -cfg.rhoConst * grid.rC * cfg.gravity

    def apply(self, theta, salt, wVel, totPhiHyd, impl: str = None):
        """OPPS_INTERFACE + OPPS_CALC over all columns: (theta', salt',
        convectCount)."""
        w, phi = self.inputs(wVel, totPhiHyd)
        kernels.refuse_grad("OPPS.apply", theta=theta, salt=salt, wVel=w,
                            totPhiHyd=phi)
        if not kernels.use_kernel(theta, impl):
            global plain_calls
            plain_calls += 1
            return _opps_plain(self, theta, salt, w, phi)
        return opps_col(self, theta, salt, w, phi)

    def inputs(self, wVel, totPhiHyd):
        """(wVel, totPhiHyd) as kernel Z and its twin take them: wVel with
        useGCMwVel, totPhiHyd under selectP_inEOS_Zc = 2, else None."""
        return (wVel if self.p["useGCMwVel"] else None,
                totPhiHyd if self.cfg.selectP_inEOS_Zc == 2 else None)


def _rho_scalar(cfg: Config, t, s, p_pa):
    """FIND_RHO_SCALAR: the full density at a pressure in Pa (LINEAR on
    the surface tRef and sRef)."""
    et = cfg.eosType.upper()
    if et == "MDJWF":
        p1 = p_pa * eos._SI2DBAR
        s1 = torch.clamp_min(s, 0.0)
        return eos._mdjwf_num(t, s1, p1) * eos._mdjwf_den(t, s, p1)
    if et == "LINEAR":
        tref, sref = cfg.tRef[0], cfg.sRef[0]
        return (cfg.rhoNil * (cfg.sBeta * (s - sref) - cfg.tAlpha
                              * (t - tref)) + cfg.rhoNil)
    p_bar = p_pa * eos._SI2BAR
    rp0 = eos.rho_p0(t, s)
    return rp0 / (1.0 - p_bar / eos.bulkmod(p_bar, t, s))


def _state1(op: OPPS, s, t, kr: int, totPhiHyd):
    """STATE1: the density of (t, s) at level kr's reference pressure."""
    cfg, mk = op.cfg, op.grid.maskC[kr]
    if totPhiHyd is not None:
        pLoc = cfg.rhoConst * (totPhiHyd[kr] + op.phiRef[kr]) * mk
    else:
        pLoc = op.pStatic[kr] * mk
    return _rho_scalar(cfg, t, s, pLoc)


def _nz(x):
    """where(x == 0, 1, x): the reference's guard of a divisor."""
    return torch.where(x == 0.0, torch.ones_like(x), x)


def _shift_up(env):
    """[..., kk] <- [..., kk + 1], the last level kept."""
    return torch.cat([env[:, 1:], env[:, -1:]], dim=1)


def _opps_plain(op: OPPS, theta, salt, wVel, totPhiHyd, stats=None):
    """Kernel Z's twin (opps.py:86-283 of the JAX package): (theta',
    salt', convectCount). stats, when given, gathers the live iterations
    of the run: "launch" the (column, level) launches, "descent" the
    descent steps evaluated, "adjust" the levels updated in the
    adjustment's sub-steps."""
    cfg, grid, p = op.cfg, op.grid, op.p
    nr = cfg.nr
    drF, rdrF = grid.drF, grid.recip_drF
    dtts = cfg.deltaTTracer
    e2 = 2.0 * p["ENTRAINMENT_RATE"]
    kMax = op.kLowC
    shape2 = tuple(kMax.shape)
    if wVel is not None:
        w_kp1 = torch.cat([wVel[1:], torch.zeros_like(wVel[:1])], dim=0)
        Wd_launch = -0.5 * (wVel + w_kp1)
    else:
        Wd_launch = torch.full((nr,) + shape2, p["VERTICAL_VELOCITY"],
                               dtype=theta.dtype, device=theta.device)
    kk = torch.arange(nr, device=theta.device)[:, None, None]
    th, sl = theta, salt
    cnt = torch.zeros_like(theta)
    stats = {} if stats is None else stats
    for name in ("launch", "descent", "adjust"):
        stats.setdefault(name, 0)
    for k in range(nr - 1):
        active0 = (k < kMax - 1) & (kMax >= 1)
        if not bool(active0.any()):
            continue
        stats["launch"] += int(active0.sum())
        env = torch.stack([th, sl])
        Pd = torch.zeros_like(env)
        Pd[:, k] = env[:, k]
        Dd_k = _state1(op, sl[k], th[k], k, totPhiHyd)
        Dd = torch.zeros_like(th)
        Dd[k] = Dd_k
        De = torch.zeros_like(th)
        De[k] = Dd_k
        Wdk = Wd_launch[k]
        Wd = torch.zeros_like(th)
        Wd[k] = Wdk
        wsqr = Wdk * Wdk
        radius = torch.full(shape2, p["PlumeRadius"], dtype=th.dtype,
                            device=th.device)
        StartingFlux = radius * radius * Wdk * Dd_k
        oldflux = StartingFlux
        dz2 = drF[k].expand(shape2)
        PlumeEntr = torch.zeros_like(th)
        maxdepth = kMax - 1
        alive = active0
        for k2 in range(k, nr - 1):
            if not bool(alive.any()):
                break
            ip1 = k2 + 1
            inrange = (k2 <= kMax - 2) & alive
            stats["descent"] += int(inrange.sum())
            D1 = _state1(op, Pd[1, k2], Pd[0, k2], ip1, totPhiHyd)
            D2 = _state1(op, sl[ip1], th[ip1], ip1, totPhiHyd)
            De_n = torch.where(inrange, D2, De[ip1])
            De[ip1] = De_n
            go = (D2 - D1 < p["STABILITY_THRESHOLD"]) | (k2 != k)
            dz1 = dz2
            dz2n = drF[ip1].expand(shape2)
            newflux = oldflux + e2 * radius * Wd[k2] * Dd[k2] \
                * 0.5 * (dz1 + dz2n)
            pe = newflux / _nz(StartingFlux)
            flux_ok = newflux > 0.0
            entr = (newflux - oldflux) / torch.where(
                flux_ok, newflux, torch.ones_like(newflux))
            pmix = (dz1 * env[:, k2] + dz2n * env[:, ip1]) / (dz1 + dz2n)
            Pd_next = Pd[:, k2] - entr * (pmix - Pd[:, k2])
            Dd_next = _state1(op, Pd_next[1], Pd_next[0], ip1, totPhiHyd)
            De_k2 = De[k2]
            wsqr_n = wsqr - wsqr * torch.abs(entr) + cfg.gravity * (
                dz1 * (Dd[k2] - De_k2) / _nz(De_k2)
                + dz2n * (Dd_next - De_n) / _nz(De_n))
            w_ok = wsqr_n > 0.0
            step_ok = inrange & go & flux_ok & w_ok
            died = inrange & ~(go & flux_ok & w_ok)
            Pd[:, ip1] = torch.where(step_ok[None], Pd_next, Pd[:, ip1])
            Dd[ip1] = torch.where(step_ok, Dd_next, Dd[ip1])
            Wd[ip1] = torch.where(step_ok, torch.sqrt(torch.where(
                w_ok, wsqr_n, torch.ones_like(wsqr_n))), Wd[ip1])
            PlumeEntr[ip1] = torch.where(inrange & go & flux_ok, pe,
                                         PlumeEntr[ip1])
            denom = Wd[k2] * Dd[k2]
            radius = torch.where(step_ok, torch.sqrt(
                torch.clamp_min(newflux, 0.0) / _nz(denom)), radius)
            wsqr = torch.where(step_ok, wsqr_n, wsqr)
            oldflux = torch.where(step_ok, newflux, oldflux)
            dz2 = torch.where(inrange, dz2n, dz2)
            maxdepth = torch.where(died, torch.full_like(maxdepth, k2),
                                   maxdepth)
            alive = alive & ~died

        has_plume = active0 & (maxdepth > k)
        if not bool(has_plume.any()):
            continue
        # the environment's adjustment (Max_ABE_Iterations, default 1)
        for _ in range(p["MAX_ABE_ITERATIONS"]):
            Md = Wd[k] * p["FRACTIONAL_AREA"]
            Mdv = torch.where(kk == k, Md[None], Md[None] * PlumeEntr)
            Mdv = torch.where((kk >= k) & (kk <= maxdepth[None]), Mdv,
                              torch.zeros_like(Mdv))
            dt = torch.full(shape2, dtts, dtype=th.dtype, device=th.device)
            ntime = torch.ones(shape2, dtype=torch.int32, device=th.device)
            mda = torch.zeros_like(th)
            for k2 in range(k, nr - 1):
                ip1 = k2 + 1
                inr = (k2 <= maxdepth - 1) & has_plume
                W = Wd[k2]
                dt_n = torch.where(W != 0.0,
                                   torch.minimum(dt, drF[k2] / _nz(W)), dt)
                nt = (0.5 * _rdiv(dtts, dt_n).to(torch.int32).to(th.dtype)
                      + 0.5).to(torch.int32)
                nt = torch.clamp_min(nt, 1)
                dt = torch.where(inr, dt_n, dt)
                ntime = torch.where(inr, nt, ntime)
                m_avg = ((Mdv[k2] * drF[k2] + Mdv[ip1] * drF[ip1])
                         / (drF[k2] + drF[ip1]))
                mda[k2] = torch.where(inr, m_avg, mda[k2])
            dt = torch.clamp_max(dt, dtts)
            Pda = Pd
            Paa = _shift_up(env)
            kmx = maxdepth - 1
            kmx_c = torch.clamp(kmx, 0, nr - 1).to(torch.long)
            kb = torch.clamp(kmx + 1, 0, nr - 1).to(torch.long)
            mask_int = (kk > k) & (kk <= kmx[None])
            at_kb = kk == kb[None]
            nn = 0
            while True:
                act = has_plume & (nn < ntime)
                if not bool(act.any()):
                    break
                stats["adjust"] += int((act * (kmx - k + 2)).sum())
                dfl = mda * (Pda - Paa) * dt
                envn = env.clone()
                envn[:, k] = torch.where(
                    act, env[:, k] + -dfl[:, k] * rdrF[k], env[:, k])
                incr = (torch.cat([dfl[:, :1], dfl[:, :-1]], dim=1)
                        - dfl) * rdrF[:, None, None]
                envn = torch.where(mask_int & act, envn + incr, envn)
                fl_kmx = dfl.gather(1, kmx_c.expand((2, 1) + shape2))[:, 0]
                add_b = fl_kmx * rdrF[kb]
                envn = torch.where(at_kb & act, envn + add_b[:, None], envn)
                Paa = torch.where(act, _shift_up(envn), Paa)
                env = envn
                nn += 1
        th = torch.where(has_plume, env[0], th)
        sl = torch.where(has_plume, env[1], sl)
        cnt[k] = cnt[k] + has_plume.to(th.dtype)
    return th, sl, cnt


def z_params(op: OPPS) -> list:
    """Kernel Z's scalars (opps.cuh:OppsParams)."""
    cfg, p = op.cfg, op.p
    scale = eos._SI2DBAR if cfg.eosType.upper() == "MDJWF" else eos._SI2BAR
    return [cfg.rhoConst, cfg.rhoNil, cfg.tAlpha, cfg.sBeta, cfg.tRef[0],
            cfg.sRef[0], scale, cfg.gravity, cfg.deltaTTracer,
            2.0 * p["ENTRAINMENT_RATE"], p["STABILITY_THRESHOLD"],
            p["PlumeRadius"], p["FRACTIONAL_AREA"], p["VERTICAL_VELOCITY"]]


def opps_col(op: OPPS, theta, salt, wVel, totPhiHyd):
    """Kernel Z's opps_col on the card (opps.cu): the twin's outputs. wVel
    with useGCMwVel, else None; totPhiHyd under selectP_inEOS_Zc = 2, else
    None."""
    cfg, grid = op.cfg, op.grid
    nr, nyp, nxp = theta.shape
    kernels.check_nr("Z", nr, 1, kernels.max_nr(Z_SHARED_VALUES,
                                                  theta.dtype))
    prof = op.phiRef if totPhiHyd is not None else op.pStatic
    outs = [torch.empty_like(theta) for _ in range(3)]
    fields = dict(theta=theta, salt=salt, maskC=grid.maskC,
                  theta_out=outs[0], salt_out=outs[1], count=outs[2])
    if wVel is not None:
        fields["wVel"] = wVel
    if totPhiHyd is not None:
        fields["totPhiHyd"] = totPhiHyd
    kernels.check_fields(theta.dtype, theta.shape, **fields)
    kernels.check_fields(theta.dtype, (nr,), profile=prof, drF=grid.drF,
                         recip_drF=grid.recip_drF)
    kernels.check_int32("kLowC", op.kLowC, (nyp, nxp))
    table = [theta, salt, wVel, totPhiHyd, prof, grid.maskC, grid.drF,
             grid.recip_drF, op.kLowC, *outs]
    params = kernels.doubles(z_params(op))
    kernels.launch("opps_col", theta.dtype, kernels.pointer_table(table),
                   len(table), params, len(params), nr, nyp, nxp,
                   _KIND[cfg.eosType.upper()], int(totPhiHyd is not None),
                   op.p["MAX_ABE_ITERATIONS"])
    return tuple(outs)
