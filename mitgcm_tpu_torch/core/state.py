"""Prognostic state and surface forcing (mitgcm_tpu/core/state.py), holding
the fields of the main path: the DYNVARS.h velocities, tracers and free
surface, the AB-2 tendency history, and FFIELDS.h's simple forcing."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mitgcm_tpu.core.config import Config
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
    guNm1: torch.Tensor      # AB-2 tendency history
    gvNm1: torch.Tensor
    gtNm1: torch.Tensor
    gsNm1: torch.Tensor
    totPhiHyd: torch.Tensor  # hydrostatic potential anomaly of the last step
    PmEpR: torch.Tensor      # P-E+R seen by the next tracer forcing


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
    reference profiles (masked), eta = 0."""
    dtype, device = grid.rA.dtype, grid.rA.device
    nyp, nxp = grid.rA.shape

    def z3():
        return torch.zeros((cfg.nr, nyp, nxp), dtype=dtype, device=device)

    def z2():
        return torch.zeros((nyp, nxp), dtype=dtype, device=device)

    tref = torch.tensor(cfg.tRef, dtype=dtype, device=device)[:, None, None]
    sref = torch.tensor(cfg.sRef, dtype=dtype, device=device)[:, None, None]
    return State(
        uVel=z3(), vVel=z3(), wVel=z3(),
        theta=tref * torch.ones_like(grid.maskC) * grid.maskC,
        salt=sref * torch.ones_like(grid.maskC) * grid.maskC,
        etaN=z2(), etaH=z2(), dEtaHdt=z2(),
        guNm1=z3(), gvNm1=z3(), gtNm1=z3(), gsNm1=z3(),
        totPhiHyd=z3(), PmEpR=z2())


def zero_forcing(cfg: Config, dtype: torch.dtype, device) -> Forcing:
    shape = (1, cfg.ny + 2 * cfg.oly, cfg.nx + 2 * cfg.olx)
    return Forcing(**{name: torch.zeros(shape, dtype=dtype, device=device)
                      for name in ("fu", "fv", "Qnet", "Qsw", "EmPmR",
                                   "saltFlux", "SST", "SSS")})
