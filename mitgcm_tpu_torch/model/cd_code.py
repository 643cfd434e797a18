"""The CD-scheme Coriolis for coarse grids (mitgcm_tpu/model/cd_code.py;
reference pkg/cd_code, cd_code_scheme.F). The D-grid velocities uVelD (at
V points) and vVelD (at U points) carry the Coriolis terms: each step they
take the AB-extrapolated surface-pressure gradient and tendencies, relax
toward the 4-point average of the C-grid velocity with weight
rCD = 1 - deltaTMom / tauCD, and give the C grid guCor = f vVelD and
gvCor = -f uVelD, which are added to the AB-extrapolated tendencies before
the predictor u* = u + deltaTMom (gU_ab + guCor) maskW. The staggered
time step's hydrostatic gradient term (phxFac) is 0: step.check_supported
refuses staggerTimeStep.

`cd_scheme` runs kernel CD (kernels/csrc/cd_code.cu) on CUDA tensors and
its plain PyTorch twin `cd_scheme_plain` on CPU tensors or with
impl="plain"; kernel CD has no backward kernel (the adjoint refuses
useCDscheme), so its wrapper differentiates through the twin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.ops.stencil import shift as sh

# calls of the twin (a run on the card reads it to show that its kernel
# path never did)
plain_calls = 0


class CDState(NamedTuple):
    uVelD: torch.Tensor
    vVelD: torch.Tensor
    uNM1: torch.Tensor
    vNM1: torch.Tensor
    etaNm1: torch.Tensor


def cd_params(cfg: Config, myIter: int) -> tuple:
    """(ab15, ab05, rCD, 1 - rCD): the D-grid step's AB weights, forward
    on iteration 0 (cd_code.py:34-37 of the JAX package), and the
    relaxation weight."""
    rCD = 1.0 - cfg.deltaTMom / cfg.tauCD if cfg.tauCD > 0.0 else 0.0
    eps = cfg.epsAB_CD if cfg.epsAB_CD is not None else cfg.abEps
    first = myIter == 0
    ab15 = 1.0 if first else 1.5 + eps
    ab05 = 0.0 if first else -0.5 - eps
    return ab15, ab05, rCD, 1.0 - rCD


def cd_scheme_plain(cfg: Config, grid: Grid, myIter: int, gU_ab, gV_ab, u,
                    v, uNM1, vNM1, uVelD, vVelD, etaN, etaNm1):
    """Kernel CD's twin (cd_code.py:30-83 of the JAX package, then
    step.py:275-277 and :317-318): (uStar, vStar, uVelD', vVelD'), the
    predictors from the AB-extrapolated tendencies with guCor and gvCor
    added, and the new D-grid velocities."""
    ab15, ab05, rCD, rCD1 = cd_params(cfg, myIter)
    dt = cfg.deltaTMom
    pf = grid.Bo_surf * (ab15 * etaN + ab05 * etaNm1)
    fC = grid.fCori
    fW = 0.5 * (fC + sh(fC, di=-1))   # f at U points
    fS = 0.5 * (fC + sh(fC, dj=-1))   # f at V points

    # vVelD (at U points)
    afV = ((gV_ab - (grid.recip_dyC * (pf - sh(pf, dj=-1))))
           * grid.maskS * sh(grid.maskInC, dj=-1) * grid.maskInC)
    vfW = (0.25 * ((afV + sh(afV, di=-1, dj=1))
                   + (sh(afV, di=-1) + sh(afV, dj=1))) * grid.maskW
           - fW * (ab15 * u + ab05 * uNM1))
    vD = vVelD + dt * vfW
    vAvgW = 0.25 * ((v + sh(v, di=-1, dj=1)) + (sh(v, di=-1) + sh(v, dj=1)))
    vNM1AvgW = 0.25 * ((vNM1 + sh(vNM1, di=-1, dj=1))
                       + (sh(vNM1, di=-1) + sh(vNM1, dj=1)))
    vD = (rCD * vD + rCD1 * (ab15 * vAvgW + ab05 * vNM1AvgW)) * grid.maskW
    guCor = fW * vD

    # uVelD (at V points)
    afU = ((gU_ab - (grid.recip_dxC * (pf - sh(pf, di=-1))))
           * grid.maskW * sh(grid.maskInC, di=-1) * grid.maskInC)
    vfS = (0.25 * ((afU + sh(afU, di=1, dj=-1))
                   + (sh(afU, di=1) + sh(afU, dj=-1))) * grid.maskS
           + fS * (ab15 * v + ab05 * vNM1))
    uD = uVelD + dt * vfS
    uAvgS = 0.25 * ((u + sh(u, di=1, dj=-1)) + (sh(u, dj=-1) + sh(u, di=1)))
    uNM1AvgS = 0.25 * ((uNM1 + sh(uNM1, di=1, dj=-1))
                       + (sh(uNM1, dj=-1) + sh(uNM1, di=1)))
    uD = (rCD * uD + rCD1 * (ab15 * uAvgS + ab05 * uNM1AvgS)) * grid.maskS
    gvCor = -fS * uD

    uStar = u + dt * (gU_ab + guCor) * grid.maskW
    vStar = v + dt * (gV_ab + gvCor) * grid.maskS
    return uStar, vStar, uD, vD


# the inputs of kernel CD in the order of kernels/csrc/cd_code.cuh:CdArgs
_IN3 = ("gU_ab", "gV_ab", "u", "v", "uNM1", "vNM1", "uVelD", "vVelD")
_GRID3 = ("maskW", "maskS")
_IN2 = ("etaN", "etaNm1")
_GRID2 = ("Bo_surf", "fCori", "recip_dxC", "recip_dyC", "maskInC")


def _cd_kernel(cfg: Config, grid: Grid, myIter: int, *tensors):
    """Kernel CD on the card (cd_code.cu): the twin's outputs."""
    u = tensors[2]
    ins3 = dict(zip(_IN3, tensors[:8]))
    ins2 = dict(zip(_IN2, tensors[8:]))
    g3 = {n: getattr(grid, n) for n in _GRID3}
    g2 = {n: getattr(grid, n) for n in _GRID2}
    outs = tuple(torch.empty_like(u) for _ in range(4))
    kernels.check_fields(u.dtype, u.shape, **ins3, **g3, **{
        f"out{k}": t for k, t in enumerate(outs)})
    kernels.check_fields(u.dtype, u.shape[1:], **ins2, **g2)
    table = [*ins3.values(), *g3.values(), *ins2.values(), *g2.values(),
             *outs]
    params = kernels.doubles(cd_params(cfg, myIter) + (cfg.deltaTMom,))
    kernels.launch("cd_scheme", u.dtype, kernels.pointer_table(table),
                   len(table), params, len(params), *u.shape)
    return outs


def cd_scheme(cfg: Config, grid: Grid, myIter: int, gU_ab, gV_ab, u, v,
              etaN, cd: CDState, impl: str = None):
    """The CD scheme's step (cd_code_scheme.F and timestep.F):
    (uStar, vStar, uVelD', vVelD') from kernel G's AB-extrapolated
    tendencies gU_ab, gV_ab, the start-of-step u, v and etaN and the D-grid
    state `cd`. Kernel CD on CUDA tensors (under kernels.TwinVJP), its
    twin on CPU tensors or with impl="plain"."""
    tensors = (gU_ab, gV_ab, u, v, cd.uNM1, cd.vNM1, cd.uVelD, cd.vVelD,
               etaN, cd.etaNm1)

    def twin(*ts):
        return cd_scheme_plain(cfg, grid, myIter, *ts)

    if not kernels.use_kernel(u, impl):
        global plain_calls
        plain_calls += 1
        return twin(*tensors)
    kernels.refuse_grad("cd_scheme", **{n: getattr(grid, n)
                                        for n in _GRID3 + _GRID2})
    return kernels.TwinVJP.apply(
        lambda *ts: _cd_kernel(cfg, grid, myIter, *ts), twin, *tensors)
