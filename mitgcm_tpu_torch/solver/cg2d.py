"""Two-dimensional preconditioned conjugate-gradient solver
(mitgcm_tpu/solver/cg2d.py; reference model/src/cg2d.F, ini_cg2d.F).

`cg2d` is differentiable in its right-hand side (CG2DSolve: the backward
pass is a second solve). On CUDA tensors the whole PCG loop is kernel A
(kernels/csrc/cg2d.cu, `cg2d_solve`): one persistent cooperative launch a
solve, whose blocks iterate together between grid-wide barriers and keep
the stop test, the iteration count and the min-residual selection on the
device; the host reads the iteration count once, after the launch. On CPU
tensors, or when `impl="plain"` is asked for, the loop runs on the host
through the kernel's plain twins, one host read of the residual an
iteration:
  stencil_dot  q = P r with dot(q, r), then q = A s with dot(s, q)
  s_update     s = q + beta s
  xr_update    x += alpha s, r -= alpha q, with dot(r, r)
Both paths make the same operations in the same order, dot products
included (common.cuh:grid_reduce's fixed order, `_grid_sum`), so on the
card they agree bit for bit, iterations included.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.ops.stencil import (cyclic_fill_halo, interior_mask,
                                          shift as sh)


@dataclass
class CG2DOperator:
    """aW/aS/aC: 5-point operator; pW/pS/pC: preconditioner; cg2dNorm: the
    normalisation factor (ini_cg2d.F myNorm); both scalars are 0-d."""
    aW: torch.Tensor
    aS: torch.Tensor
    aC: torch.Tensor
    pW: torch.Tensor
    pS: torch.Tensor
    pC: torch.Tensor
    cg2dNorm: torch.Tensor
    tolerance_sq: torch.Tensor


@dataclass
class CG2DResult:
    x: torch.Tensor
    first_residual: torch.Tensor   # 0-d
    last_residual: torch.Tensor    # 0-d
    n_iters: int
    host_syncs: int                # device-to-host reads the solve made


def build_cg2d(cfg: Config, grid: Grid) -> CG2DOperator:
    """ini_cg2d.F: vertically integrated transmissibilities and the
    preconditioner, in the JAX package's operation order."""
    dt, dev = grid.rA.dtype, grid.rA.device
    oly, olx = cfg.oly, cfg.olx
    drF = grid.drF[:, None, None]
    imask = interior_mask(grid.rA.shape, oly, olx, dt, dev)

    fac = cfg.implicSurfPress * cfg.implicDiv2Dflow
    # level-by-level accumulation in k-ascending order (ini_cg2d.F:88-103)
    termW = grid.dyG * drF * grid.hFacW * fac * grid.recip_dxC
    termS = grid.dxG * drF * grid.hFacS * fac * grid.recip_dyC
    aW = torch.zeros_like(grid.rA)
    aS = torch.zeros_like(grid.rA)
    for k in range(cfg.nr):
        aW = aW + termW[k]
        aS = aS + termS[k]
    aW = aW * grid.maskInC * sh(grid.maskInC, di=-1)
    aS = aS * grid.maskInC * sh(grid.maskInC, dj=-1)

    myNorm = torch.maximum(torch.max(torch.abs(aW) * imask),
                           torch.max(torch.abs(aS) * imask))
    myNorm = torch.where(myNorm != 0.0, 1.0 / myNorm,
                         torch.ones_like(myNorm))
    aW = cyclic_fill_halo(aW * myNorm, oly, olx)
    aS = cyclic_fill_halo(aS * myNorm, oly, olx)
    aC = -(aW + sh(aW, di=1) + aS + sh(aS, dj=1)
           + cfg.freeSurfFac * myNorm * grid.recip_Bo * grid.rA
           / cfg.deltaTMom / cfg.deltaTFreeSurf)
    aC = cyclic_fill_halo(aC, oly, olx)

    aCw = sh(aC, di=-1)
    aCs = sh(aC, dj=-1)
    one = torch.ones_like(aC)
    zero = torch.zeros_like(aC)
    pC = torch.where(aC == 0.0, one, 1.0 / torch.where(aC == 0.0, one, aC))
    offFac = cfg.cg2dpcOffDFac
    dW = offFac * (aCw + aC)
    dS = offFac * (aCs + aC)
    pW = torch.where(aC + aCw == 0.0, zero,
                     -aW / torch.where(aC + aCw == 0.0, one, dW * dW))
    pS = torch.where(aC + aCs == 0.0, zero,
                     -aS / torch.where(aC + aCs == 0.0, one, dS * dS))
    pC = cyclic_fill_halo(pC, oly, olx)
    pW = cyclic_fill_halo(pW, oly, olx)
    pS = cyclic_fill_halo(pS, oly, olx)

    # tolerance (ini_cg2d.F:150-162): normalised-RHS mode by default
    if cfg.cg2dTargetResWunit <= 0.0:
        tol = torch.tensor(cfg.cg2dTargetResidual, dtype=dt, device=dev)
    else:
        tol = (myNorm * cfg.cg2dTargetResWunit * grid.globalArea
               / cfg.deltaTMom)
    return CG2DOperator(aW=aW, aS=aS, aC=aC, pW=pW, pS=pS, pC=pC,
                        cg2dNorm=myNorm, tolerance_sq=tol * tol)


def _stencil5(cW, cS, cC, y, center_first: bool):
    """5-point stencil with zero-fill shifts, summed in the order of the
    JAX package's _apply_P (center first) or _apply_A (center last)."""
    terms = [cW * sh(y, di=-1), sh(cW, di=1) * sh(y, di=1),
             cS * sh(y, dj=-1), sh(cS, dj=1) * sh(y, dj=1)]
    terms = [cC * y] + terms if center_first else terms + [cC * y]
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


# thread block of the dot-producing kernels (kernels/csrc/common.cuh BX, BY)
_BX, _BY = 32, 8
_NT = _BX * _BY


def _tree(a):
    """Pairwise sum over the last axis (length _NT) in the order of the
    shared-memory tree of common.cuh:grid_sum."""
    s = _NT // 2
    while s > 0:
        a = a[..., :s] + a[..., s:2 * s]
        s //= 2
    return a[..., 0]


def _grid_sum(v, oly: int, olx: int):
    """Sum of v's interior in the fixed order of common.cuh:grid_sum (per
    32x8 block a tree; the block partials strided over 256 lanes, then a
    tree), so the twin's dot products are bit-equal to the kernels'."""
    v = v[oly:v.shape[0] - oly, olx:v.shape[1] - olx]
    ny, nx = v.shape
    nby, nbx = -(-ny // _BY), -(-nx // _BX)
    v = F.pad(v, (0, nbx * _BX - nx, 0, nby * _BY - ny))
    blocks = v.reshape(nby, _BY, nbx, _BX).permute(0, 2, 1, 3)
    partials = _tree(blocks.reshape(nby * nbx, _NT))
    lanes = F.pad(partials, (0, -partials.numel() % _NT)).reshape(-1, _NT)
    acc = torch.zeros_like(lanes[0])
    for row in lanes:
        acc = acc + row
    return _tree(acc)


class Workspace:
    """Scratch of cg3d's dot-producing kernels: one partial sum per 32 x 8
    tile and the last-block counter (0 between launches)."""

    def __init__(self, shape, oly: int, olx: int, dtype, device):
        ny, nx = shape[-2] - 2 * oly, shape[-1] - 2 * olx
        n = kernels.library().mitgcm_cg2d_num_partials(ny, nx)
        self.partials = torch.empty(n, dtype=dtype, device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)


def _set_interior(a, v, oly, olx):
    a[..., oly:a.shape[-2] - oly, olx:a.shape[-1] - olx] = \
        v[..., oly:v.shape[-2] - oly, olx:v.shape[-1] - olx]


def _check(dtype, shape, scalars, **fields):
    kernels.check_tensors(dtype, **fields, **scalars)
    for name, t in fields.items():
        kernels.check_shape(name, t, shape)
    for name, t in scalars.items():
        kernels.check_shape(name, t, ())


def stencil_dot(cW, cS, cC, y, out, dot_out, center_first: bool, oly: int,
                olx: int) -> None:
    """Twin: out[interior] = 5-point stencil of y (P's term order when
    center_first, else A's) and dot_out (0-d) = dot(out, y) over the
    interior. Reads y's interior and its cyclic wrap, never y's halo
    cells; leaves out's halo cells as they are."""
    y = cyclic_fill_halo(y, oly, olx, impl="plain")
    v = _stencil5(cW, cS, cC, y, center_first)
    _set_interior(out, v, oly, olx)
    dot_out.copy_(_grid_sum(v * y, oly, olx))


def s_update(q, s, eta_n, eta_nm1, oly: int, olx: int) -> None:
    """Twin: s[interior] = q + (eta_n / eta_nm1) * s, in place (0-d
    eta's)."""
    _set_interior(s, q + eta_n / eta_nm1 * s, oly, olx)


def xr_update(x, r, s, q, num, den, dot_out, oly: int, olx: int) -> None:
    """Twin, in place on the interior: x += alpha s and r -= alpha q with
    alpha = num / den (0-d); dot_out (0-d) = dot(r, r) over the
    interior."""
    alpha = num / den
    _set_interior(x, x + alpha * s, oly, olx)
    rn = r - alpha * q
    _set_interior(r, rn, oly, olx)
    dot_out.copy_(_grid_sum(rn * rn, oly, olx))


def cg2d_solve(op: CG2DOperator, b, x, max_iters: int, use_min: bool,
               oly: int, olx: int):
    """Kernel A: the PCG loop of `_pcg_plain` in one cooperative launch,
    from the normalised right-hand side b and the first guess x (its
    interior; the solution is written there). Returns (scalars, ctrl),
    device tensors: scalars[2] and [3] the first and last squared
    residual, ctrl[2] the iteration count. Raises if the card refuses the
    launch (a grid too large to be co-resident); nothing falls back."""
    _check(b.dtype, b.shape, {"tol_sq": op.tolerance_sq}, aW=op.aW,
           aS=op.aS, aC=op.aC, pW=op.pW, pS=op.pS, pC=op.pC, b=b, x=x)
    ny, nx = b.shape[-2] - 2 * oly, b.shape[-1] - 2 * olx
    tiles = kernels.library().mitgcm_cg2d_num_partials(ny, nx)
    # r, r', s, s', z = P r, q = A s and x_min; two partials per tile; the
    # barriers' sums and the residuals; the barrier's counters and the
    # iteration count (the arrival count must start at 0)
    work = b.new_empty((7,) + tuple(b.shape))
    partials = b.new_empty(2 * tiles)
    scalars = b.new_empty(4)
    ctrl = torch.zeros(3, dtype=torch.int32, device=b.device)
    kernels.launch("cg2d_solve", b.dtype, op.aW.data_ptr(),
                   op.aS.data_ptr(), op.aC.data_ptr(), op.pW.data_ptr(),
                   op.pS.data_ptr(), op.pC.data_ptr(), b.data_ptr(),
                   op.tolerance_sq.data_ptr(), x.data_ptr(),
                   work.data_ptr(), partials.data_ptr(), scalars.data_ptr(),
                   ctrl.data_ptr(), ny, nx, oly, olx, max_iters,
                   int(use_min))
    return scalars, ctrl


class CG2DSolve(torch.autograd.Function):
    """x = A^-1 b through the PCG loop, with the JAX package's custom VJP
    (cg2d.py:185-200): the solve is linear in b and A is symmetric, so
    b_bar = A^-1 x_bar, one more solve through the same loop (kernel A on
    the card) from a zero first guess. x0 gets a zero gradient; the
    residuals, iteration count and host-sync count are not
    differentiable. As in JAX, the adjoint solve reads only x_bar's
    interior: the cotangent on x's halo cells is dropped."""

    @staticmethod
    def forward(ctx, b, x0, cfg: Config, op: CG2DOperator, impl):
        res = _solve(cfg, op, b, x0, impl)
        ctx.cfg, ctx.op, ctx.impl = cfg, op, impl
        ctx.mark_non_differentiable(res.first_residual, res.last_residual)
        return (res.x, res.first_residual, res.last_residual, res.n_iters,
                res.host_syncs)

    @staticmethod
    def backward(ctx, x_bar, *_):
        with kernels.counting_as("adjoint"):
            adj = _solve(ctx.cfg, ctx.op, x_bar.contiguous(),
                         torch.zeros_like(x_bar), ctx.impl)
        return adj.x, torch.zeros_like(adj.x), None, None, None


def cg2d(cfg: Config, op: CG2DOperator, b, x0, impl: str = None
         ) -> CG2DResult:
    """Solve A x = b from first guess x0 (halo-padded 2-D tensors),
    differentiable in b (CG2DSolve)."""
    return CG2DResult(*CG2DSolve.apply(b, x0, cfg, op, impl))


def _solve(cfg: Config, op: CG2DOperator, b, x0, impl: str = None
           ) -> CG2DResult:
    """The solve (cg2d.py:_cg2d_raw) with interior-only dot products: RHS
    normalisation, then the PCG loop as kernel A on CUDA tensors
    (`cg2d_solve`, one host read) or as the twins' host loop
    (`_pcg_plain`); both write their work fields in place, so autograd
    must never trace them."""
    oly, olx = cfg.oly, cfg.olx
    imask = interior_mask(b.shape, oly, olx, b.dtype, b.device)
    # normalise the RHS (cg2d.F:105-135)
    b = b * op.cg2dNorm
    rhsMax = torch.max(torch.abs(b) * imask)
    normalise = cfg.cg2dTargetResWunit <= 0.0
    if normalise:
        rhsNorm = torch.where(rhsMax != 0.0, 1.0 / rhsMax,
                              torch.ones_like(rhsMax))
        b = b * rhsNorm
        x0 = x0 * rhsNorm
    use_min = cfg.cg2dUseMinResSol == 1
    x = x0 * imask
    if kernels.use_kernel(b, impl):
        scalars, ctrl = cg2d_solve(op, b, x, cfg.cg2dMaxIters, use_min,
                                   oly, olx)
        first_res, err_sq = torch.sqrt(scalars[2]), scalars[3]
        it, syncs = _iterations(ctrl), 1
    else:
        x, first_res, err_sq, it, syncs = _pcg_plain(
            op, b, x, cfg.cg2dMaxIters, use_min, oly, olx)
    if normalise:
        x = x / rhsNorm
    return CG2DResult(x=cyclic_fill_halo(x, oly, olx, impl=impl),
                      first_residual=first_res,
                      last_residual=torch.sqrt(err_sq), n_iters=it,
                      host_syncs=syncs)


def _iterations(ctrl) -> int:
    """The kernel path's one host read: the iteration count that
    cg2d_solve leaves in ctrl[2] (it waits for the launch to end)."""
    return int(ctrl[2].item())


def _pcg_plain(op: CG2DOperator, b, x, max_iters: int, use_min: bool,
               oly: int, olx: int):
    """Kernel A's twin: the PCG loop on the host through the twins, one
    host read of the residual an iteration. Halos of the work fields r, s
    and q are never filled: every twin reads the wrap. Returns (x, first
    residual, last squared residual, iterations, host reads)."""
    # device scalars: 1, eta (two slots that swap roles), dot(s, q), r.r
    one, eta_n, eta_nm1, sq, err_sq = torch.ones(
        5, dtype=b.dtype, device=b.device).unbind()
    r = b.clone()
    s = torch.zeros_like(b)
    q = torch.zeros_like(b)
    kw = dict(oly=oly, olx=olx)
    # r0 = b - A x0 is one xr step with alpha = 1 along a zero direction
    stencil_dot(op.aW, op.aS, op.aC, x, q, sq, False, **kw)
    xr_update(x, r, s, q, one, one, err_sq, **kw)
    first_res = torch.sqrt(err_sq)
    err, tol_sq, syncs = err_sq.item(), op.tolerance_sq.item(), 2
    x_min, min_err = x.clone(), err
    it = 0
    while err >= tol_sq and it < max_iters:
        stencil_dot(op.pW, op.pS, op.pC, r, q, eta_n, True, **kw)
        s_update(q, s, eta_n, eta_nm1, **kw)
        stencil_dot(op.aW, op.aS, op.aC, s, q, sq, False, **kw)
        xr_update(x, r, s, q, eta_n, sq, err_sq, **kw)
        err = err_sq.item()
        syncs += 1
        if use_min and err < min_err:
            x_min.copy_(x)
            min_err = err
        eta_n, eta_nm1 = eta_nm1, eta_n
        it += 1
    if use_min and err > min_err:
        x = x_min
    return x, first_res, err_sq, it, syncs
