"""Synthetic wind-driven gyre (mitgcm_tpu/utils/synthetic.py): a file-free
configuration for the entry point, the card smoke run and the tests. The
JAX module imports jax, so the same Config is built here directly."""

from __future__ import annotations

import numpy as np
import torch

from mitgcm_tpu.core.config import Config
from mitgcm_tpu_torch.core.grid import build_grid
from mitgcm_tpu_torch.core.state import init_state, zero_forcing
from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo
from mitgcm_tpu_torch.solver.cg2d import build_cg2d


def gyre_config(nx=64, ny=64, nr=4, dx=20.0e3, depth=5000.0,
                deltaT=1200.0, n_steps=10, olx=2, oly=2, **extra) -> Config:
    """A wind-driven beta-plane gyre (tutorial_barotropic_gyre-like) of
    any size, with stratified T when nr > 1. `extra` sets further Config
    fields before finalize()."""
    kwargs = dict(
        nx=nx, ny=ny, nr=nr, olx=olx, oly=oly,
        viscAh=4.0e2, f0=1.0e-4, beta=1.0e-11,
        rhoConst=1000.0, gBaro=9.81,
        implicitFreeSurface=True, rigidLid=False,
        tempStepping=nr > 1, saltStepping=False,
        tempAdvection=True,
        usingCartesianGrid=True, usingSphericalPolarGrid=False,
        delX=tuple([dx] * nx), delY=tuple([dx] * ny),
        delR=tuple([depth / nr] * nr),
        xgOrigin=-dx, ygOrigin=-dx,
        nIter0=0, nTimeSteps=n_steps, deltaT=deltaT,
        cg2dTargetResidual=1.0e-7, cg2dMaxIters=1000,
        diffKhT=1.0e3, diffKrT=1.0e-5,
        tRef=tuple(np.linspace(24.0, 10.0, nr)),
    )
    return Config(**{**kwargs, **extra}).finalize()


def vi_gyre_config(nx=64, ny=64, nr=4, deltaT=1200.0, n_steps=10,
                   eosType="JMD95Z", **kw) -> Config:
    """The gyre as a realistic ocean run sets it up (the "vi-gyre"):
    vector-invariant momentum, implicit vertical viscosity (viscAr 1e-3)
    and diffusion, a nonlinear EOS with salt stepped from a sRef profile
    of 35 to 34.5, and AB-3 (alph_AB 0.5, beta_AB 5/12). finalize()
    derives useAB3 and selectP_inEOS_Zc (2 for MDJWF, 0 for JMD95Z)."""
    vi = dict(vectorInvariantMomentum=True, implicitViscosity=True,
              implicitDiffusion=True, viscAr=1.0e-3, eosType=eosType,
              saltStepping=True, sRef=tuple(np.linspace(35.0, 34.5, nr)),
              diffKhS=1.0e3, diffKrS=1.0e-5, alph_AB=0.5,
              beta_AB=5.0 / 12.0)
    return gyre_config(nx=nx, ny=ny, nr=nr, deltaT=deltaT, n_steps=n_steps,
                       **{**vi, **kw})


def gyre_setup(cfg: Config, dtype: torch.dtype = torch.float32,
               device="cpu"):
    """(grid, state, forcing, op) with walls and a sinusoidal zonal wind."""
    nx, ny = cfg.nx, cfg.ny
    bathy = np.full((ny, nx), -sum(cfg.delR))
    bathy[0, :] = 0.0
    bathy[:, 0] = 0.0
    bathy[-1, :] = 0.0
    bathy[:, -1] = 0.0
    grid = build_grid(cfg, bathy=bathy, dtype=dtype, device=device)
    state = init_state(cfg, grid)
    forcing = zero_forcing(cfg, dtype, device)
    # zonal wind: tau = -0.1 cos(pi y / L)  (gendata.m of the reference deck)
    y = np.arange(ny) * cfg.delY[0]
    L = ny * cfg.delY[0]
    taux = -0.1 * np.cos(np.pi * (y[:, None] + 0.5 * cfg.delY[0]) / L)
    fu = np.zeros((ny + 2 * cfg.oly, nx + 2 * cfg.olx))
    fu[cfg.oly:cfg.oly + ny, cfg.olx:cfg.olx + nx] = taux
    forcing.fu = cyclic_fill_halo(
        torch.as_tensor(fu[None], dtype=dtype, device=device),
        cfg.oly, cfg.olx)
    return grid, state, forcing, build_cg2d(cfg, grid)
