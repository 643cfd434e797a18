"""Prognostic state and surface forcing (mitgcm_tpu/core/state.py), holding
the fields of the ported paths: the DYNVARS.h velocities, tracers and free
surface, the AB-2/AB-3 tendency history, GGL90's TKE and IDEMIX's
internal-wave energy, the second-order moments of SOM tracers, the
non-hydrostatic pressure and w-tendency history, and FFIELDS.h's simple
forcing."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid


@dataclass
class State:
    uVel: torch.Tensor       # [nr, nyp, nxp] at W (west face) points
    vVel: torch.Tensor       # [nr, nyp, nxp] at S (south face) points
    wVel: torch.Tensor       # [nr, nyp, nxp] at upper faces
    theta: torch.Tensor
    salt: torch.Tensor
    etaN: torch.Tensor       # [nyp, nxp]
    etaH: torch.Tensor
    dEtaHdt: torch.Tensor
    guNm1: torch.Tensor      # tendency history: the last raw tendency
    gvNm1: torch.Tensor
    gtNm1: torch.Tensor
    gsNm1: torch.Tensor
    guNm2: torch.Tensor      # the one before it (AB-3 only; zeros on AB-2)
    gvNm2: torch.Tensor
    gtNm2: torch.Tensor
    gsNm2: torch.Tensor
    totPhiHyd: torch.Tensor  # hydrostatic potential anomaly of the last step
    PmEpR: torch.Tensor      # P-E+R seen by the next tracer forcing
    # GGL90's prognostic turbulent kinetic energy [nr, nyp, nxp] at the
    # interface above each cell (pkg/ggl90/GGL90.h); None unless useGGL90
    GGL90TKE: Optional[torch.Tensor] = None
    # IDEMIX's internal-wave energy [nr, nyp, nxp] at the interfaces
    # (ggl90_idemix.F); None unless GGL90 runs with useIDEMIX
    IDEMIX_E: Optional[torch.Tensor] = None
    # the SOM (Prather) sub-grid moments of theta and salt [9, nr, nyp, nxp]
    # (GAD_SOM_VARS.h som_T/som_S); zero-size unless the tracer's scheme is
    # 80 or 81
    somT: Optional[torch.Tensor] = None
    somS: Optional[torch.Tensor] = None
    # the non-hydrostatic pressure and the raw w tendencies of the last two
    # steps [nr, nyp, nxp] (NH_VARS.h phi_nh, gwNm1, gwNm2); None unless
    # nonHydrostatic (gwNm2 also unless AB-3)
    phi_nh: Optional[torch.Tensor] = None
    gwNm1: Optional[torch.Tensor] = None
    gwNm2: Optional[torch.Tensor] = None


@dataclass
class Forcing:
    """Surface forcing records [1, nyp, nxp] (one constant record)."""

    fu: torch.Tensor         # zonal wind stress [N/m2] at W points
    fv: torch.Tensor         # meridional wind stress at S points
    Qnet: torch.Tensor       # net upward surface heat flux [W/m2]
    Qsw: torch.Tensor
    EmPmR: torch.Tensor      # evap - precip - runoff [kg/m2/s]
    saltFlux: torch.Tensor
    SST: torch.Tensor        # climatological relaxation targets
    SSS: torch.Tensor


def init_state(cfg: Config, grid: Grid) -> State:
    """Cold start (ini_dynvars.F + ini_fields.F): rest, theta/salt at the
    reference profiles (masked), eta = 0, SOM moments 0, and with
    nonHydrostatic phi_nh and the w-tendency history 0."""
    dtype, device = grid.rA.dtype, grid.rA.device
    nyp, nxp = grid.rA.shape

    def z3():
        return torch.zeros((cfg.nr, nyp, nxp), dtype=dtype, device=device)

    def z2():
        return torch.zeros((nyp, nxp), dtype=dtype, device=device)

    def som(scheme):
        shape = (9, cfg.nr, nyp, nxp) if scheme in (80, 81) else (0,)
        return torch.zeros(shape, dtype=dtype, device=device)

    tref = torch.tensor(cfg.tRef, dtype=dtype, device=device)[:, None, None]
    sref = torch.tensor(cfg.sRef, dtype=dtype, device=device)[:, None, None]
    return State(
        uVel=z3(), vVel=z3(), wVel=z3(),
        theta=tref * torch.ones_like(grid.maskC) * grid.maskC,
        salt=sref * torch.ones_like(grid.maskC) * grid.maskC,
        etaN=z2(), etaH=z2(), dEtaHdt=z2(),
        guNm1=z3(), gvNm1=z3(), gtNm1=z3(), gsNm1=z3(),
        guNm2=z3(), gvNm2=z3(), gtNm2=z3(), gsNm2=z3(),
        totPhiHyd=z3(), PmEpR=z2(), somT=som(cfg.tempAdvScheme),
        somS=som(cfg.saltAdvScheme),
        phi_nh=z3() if cfg.nonHydrostatic else None,
        gwNm1=z3() if cfg.nonHydrostatic else None,
        gwNm2=z3() if cfg.nonHydrostatic and cfg.useAB3 else None)


def zero_forcing(cfg: Config, dtype: torch.dtype, device) -> Forcing:
    shape = (1, cfg.ny + 2 * cfg.oly, cfg.nx + 2 * cfg.olx)
    return Forcing(**{name: torch.zeros(shape, dtype=dtype, device=device)
                      for name in ("fu", "fv", "Qnet", "Qsw", "EmPmR",
                                   "saltFlux", "SST", "SSS")})
