"""Equation of state (mitgcm_tpu/ops/eos.py:find_rho), LINEAR only."""

from __future__ import annotations

import torch

from mitgcm_tpu.core.config import Config


def find_rho(cfg: Config, theta: torch.Tensor, salt: torch.Tensor
             ) -> torch.Tensor:
    """Density anomaly rho' = rho - rhoConst at every level (find_rho.F,
    LINEAR branch)."""
    if cfg.eosType.upper() != "LINEAR":
        raise NotImplementedError(f"eosType={cfg.eosType} is not ported")
    tref = torch.tensor(cfg.tRef, dtype=theta.dtype,
                        device=theta.device)[:, None, None]
    sref = torch.tensor(cfg.sRef, dtype=theta.dtype,
                        device=theta.device)[:, None, None]
    drho = cfg.rhoNil - cfg.rhoConst
    return cfg.rhoNil * (cfg.sBeta * (salt - sref)
                         - cfg.tAlpha * (theta - tref)) + drho
