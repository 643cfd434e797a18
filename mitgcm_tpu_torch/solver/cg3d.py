"""Three-dimensional preconditioned conjugate-gradient solver for the
non-hydrostatic pressure phi_nh (mitgcm_tpu/solver/cg3d.py; reference
model/src/cg3d.F and ini_cg3d.F).

`build_cg3d` is plain PyTorch, run once: the 7-point operator with the
free-surface term on the surface level's diagonal, scaled by myNorm and
cyclic-filled, and the LU-factored column tridiagonal preconditioner.
`cg3d` is differentiable in its right-hand side (CG3DSolve: the backward
pass is a second solve from a zero first guess). A solve's set-up (the
scaled and normalised right-hand side, the masked first guess, the zero
work fields) is kernel N2's two launches (kernels/csrc/cg3d_setup.cu,
cg3d_setup_scale and cg3d_setup_fill, rhsNorm kept on the device) with
the twin `_setup_plain`; its end divides x by that device scalar. One
PCG iteration is two calls, each a
hand-written CUDA kernel (kernels/csrc/cg3d.cu, kernel H-cg3d) for CUDA
tensors and its plain PyTorch twin for CPU tensors or when impl="plain"
is asked for:
  s_stencil_dot  s' = (q + beta s) imask, qA = (A s') imask, dot(s', qA)
  xr_precond     x += alpha s', r -= alpha qA, with dot(r, r); then the
                 next iteration's q = P^-1 r with dot(q, r)
The first residual r0 = b - A x0 is one call of each (s = 0, beta = 1,
alpha = 1), which also gives q0. The scalars live in 0-d device tensors.
On the kernel path the loop stays on the device: xr_precond counts the
iterations and sets a `done` word in `ctrl` (its last block, when dot(r,
r) < tol^2 or the count reaches cg3dMaxIters), every launch returns at
once while it is set, and the host enqueues BATCH iterations at a time
and reads `ctrl` once per batch. On the plain path the loop runs on the
host, as JAX's does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.ops.stencil import (cyclic_fill_halo, interior_mask,
                                          shift as sh)
from mitgcm_tpu_torch.solver.cg2d import _grid_sum, _set_interior

# iterations the kernel path enqueues between two reads of `done`
BATCH = 8

# calls of the twins (a run on the card reads it to show that its kernel
# path never made one)
plain_calls = 0


class Workspace:
    """Scratch of kernels H-cg3d's and N2's launches: two partial sums per
    32 x 8 tile (xr_precond reduces dot(r, r) and dot(q, r) together), the
    last-block counter (0 between launches), the pair of sums that
    xr_precond's last block copies out, N2's block maxima over the padded
    plane and its (rhsMax, rhsNorm)."""

    def __init__(self, shape, oly: int, olx: int, dtype, device):
        ny, nx = shape[-2] - 2 * oly, shape[-1] - 2 * olx
        lib = kernels.library()
        n = lib.mitgcm_cg2d_num_partials(ny, nx)
        self.partials = torch.empty(2 * n, dtype=dtype, device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)
        self.pair = torch.empty(2, dtype=dtype, device=device)
        self.maxima = torch.empty(
            lib.mitgcm_cg2d_num_partials(shape[-2], shape[-1]), dtype=dtype,
            device=device)
        self.scal = torch.empty(2, dtype=dtype, device=device)


@dataclass
class CG3DOperator:
    """aW/aS/aV: the 7-point operator's face coefficients [nr, nyp, nxp]
    (aV[0] = 0); aC: its diagonal; zMC/zML/zMU: the LU-factored column
    tridiagonal preconditioner (zMC holds the reciprocal pivots);
    cg3dNorm: the normalisation factor (ini_cg3d.F myNorm); both scalars
    are 0-d; imask3: the interior mask times maskC [nr, nyp, nxp], the
    solve's mask."""
    aW: torch.Tensor
    aS: torch.Tensor
    aV: torch.Tensor
    aC: torch.Tensor
    zMC: torch.Tensor
    zML: torch.Tensor
    zMU: torch.Tensor
    cg3dNorm: torch.Tensor
    tolerance_sq: torch.Tensor
    imask3: torch.Tensor


@dataclass
class CG3DResult:
    x: torch.Tensor
    first_residual: torch.Tensor   # 0-d
    last_residual: torch.Tensor    # 0-d
    n_iters: int
    host_syncs: int                # device-to-host reads the solve made


def _below(a):
    """a[k+1] along the level axis, zero below the bottom level."""
    return torch.cat([a[1:], torch.zeros_like(a[:1])])


def build_cg3d(cfg: Config, grid: Grid) -> CG3DOperator:
    """ini_cg3d.F (cg3d.py:42-128): face transmissibilities times
    implicitNHPress * implicDiv2Dflow, in the JAX package's operation
    order."""
    if cfg.implicitIntGravWave:
        raise NotImplementedError("implicitIntGravWave cg3d vertical term")
    dt, dev = grid.rA.dtype, grid.rA.device
    nr, oly, olx = cfg.nr, cfg.oly, cfg.olx
    drF = grid.drF[:, None, None]
    imask = interior_mask(grid.rA.shape, oly, olx, dt, dev)[None]

    def fill(a):
        return cyclic_fill_halo(a, oly, olx)

    fac = cfg.implicitNHPress * cfg.implicDiv2Dflow
    aW = grid.dyG * drF * grid.hFacW * grid.recip_dxC * fac
    aS = grid.dxG * drF * grid.hFacS * grid.recip_dyC * fac
    # vertical faces (ini_cg3d.F:92-110): rVel2wUnit = 1 in z-coordinates
    nh_fac = 1.0 / cfg.nh_Am2 if cfg.nh_Am2 != 0.0 else 0.0
    tmpFac = 1.0 / nh_fac if nh_fac > 0.0 else 0.0
    maskC_km1 = torch.cat([torch.zeros_like(grid.maskC[:1]),
                           grid.maskC[:-1]])
    aV = (grid.rA[None] * grid.maskC * maskC_km1
          * grid.recip_drC[:nr, None, None] * tmpFac * fac)
    aV[0] = 0.0

    myNorm = torch.maximum(
        torch.max(torch.abs(aW) * imask),
        torch.maximum(torch.max(torch.abs(aS) * imask),
                      torch.max(torch.abs(aV) * imask)))
    myNorm = torch.where(myNorm != 0.0, 1.0 / myNorm,
                         torch.ones_like(myNorm))

    aC = -(aW + sh(aW, di=1) + sh(aS, dj=1) + aS + aV + _below(aV))
    # free-surface term on the surface level's diagonal (ini_cg3d.F:170-184)
    k3 = torch.arange(nr, device=dev)[:, None, None]
    selS = (k3 == grid.kSurfC[None] - 1) & (grid.kSurfC[None] <= nr)
    surf = (cfg.freeSurfFac * grid.recip_Bo * grid.rA / cfg.deltaTMom
            / cfg.deltaTFreeSurf)
    aC = aC - torch.where(selS, surf[None], torch.zeros_like(surf[None]))

    aW = fill(aW * myNorm)
    aS = fill(aS * myNorm)
    aV = fill(aV * myNorm)
    aC = fill(aC * myNorm)

    # column tridiagonal preconditioner, LU-factored (ini_cg3d.F:236-280)
    dry = aC == 0.0
    one, zero = torch.ones_like(aC), torch.zeros_like(aC)
    zMC = torch.where(dry, one, aC)
    zML = torch.where(dry, zero, aV)
    zMU = torch.where(dry, zero, _below(aV))
    carry = torch.zeros_like(aC[0])
    mcs, mus = [], []
    for k in range(nr):
        mc = 1.0 / (zMC[k] - zML[k] * carry)
        carry = zMU[k] * mc
        mcs.append(mc)
        mus.append(carry)
    zMC = fill(torch.where(dry, one, torch.stack(mcs)))
    zMU = fill(torch.where(dry, zero, torch.stack(mus)))
    zML = fill(zML)

    if cfg.cg3dTargetResWunit <= 0.0:
        tol = torch.tensor(cfg.cg3dTargetResidual, dtype=dt, device=dev)
    else:
        tol = (myNorm * cfg.cg3dTargetResWunit * grid.globalArea
               / cfg.deltaTMom)
    return CG3DOperator(aW=aW, aS=aS, aV=aV, aC=aC, zMC=zMC, zML=zML,
                        zMU=zMU, cg3dNorm=myNorm, tolerance_sq=tol * tol,
                        imask3=imask * grid.maskC)


def apply_A(op: CG3DOperator, x):
    """The 7-point operator on a halo-filled x (cg3d.py:131-138), in its
    term order."""
    up = torch.cat([torch.zeros_like(x[:1]), x[:-1]])
    return (op.aW * sh(x, di=-1) + sh(op.aW, di=1) * sh(x, di=1)
            + op.aS * sh(x, dj=-1) + sh(op.aS, dj=1) * sh(x, dj=1)
            + op.aV * up + _below(op.aV) * _below(x) + op.aC * x)


def _col_sum(a, b, m, levels):
    """Per column, the sum over `levels` (in that order) of a * b * m: the
    column part of the kernels' dot products."""
    col = torch.zeros_like(a[0])
    for k in levels:
        col = col + a[k] * b[k] * m[k]
    return col


def _frozen(ctrl) -> bool:
    """The twins' reading of the kernels' `done` test (a host read); counts
    the twin's call."""
    global plain_calls
    plain_calls += 1
    return ctrl is not None and bool(ctrl[0])


def _dims(a, oly, olx):
    return (a.shape[0], a.shape[-2] - 2 * oly, a.shape[-1] - 2 * olx, oly,
            olx)


def _check(dtype, shape, scalars, **fields):
    kernels.check_tensors(dtype, **fields, **scalars)
    for name, t in fields.items():
        kernels.check_shape(name, t, shape)
    for name, t in scalars.items():
        kernels.check_shape(name, t, ())


def _check_ctrl(ctrl):
    if not (ctrl.is_cuda and ctrl.dtype == torch.int32
            and ctrl.is_contiguous() and tuple(ctrl.shape) == (2,)):
        raise ValueError("ctrl: need a contiguous int32 CUDA tensor of "
                         "shape (2,)")


def s_stencil_dot(op: CG3DOperator, maskC, q, s_in, s_out, qa, eta_n,
                  eta_nm1, dot_out, ctrl, oly: int, olx: int,
                  ws: Workspace = None, impl: str = None) -> None:
    """On the interior: s_out = (q + beta s_in) maskC with beta = eta_n /
    eta_nm1 (0-d), qa = (A s_out) maskC with s_out's cyclic wrap, and
    dot_out (0-d) = dot(s_out, qa). Reads q and s_in on the interior
    only; leaves the halo cells of s_out and qa as they are; does nothing
    while ctrl[0] is set."""
    if not kernels.use_kernel(q, impl):
        if _frozen(ctrl):
            return
        imask = interior_mask(q.shape, oly, olx, q.dtype, q.device) * maskC
        s = (q + eta_n / eta_nm1 * s_in) * imask
        _set_interior(s_out, s, oly, olx)
        a = apply_A(op, cyclic_fill_halo(s, oly, olx, impl="plain")) * imask
        _set_interior(qa, a, oly, olx)
        dot_out.copy_(_grid_sum(_col_sum(s, a, maskC, range(s.shape[0])),
                                oly, olx))
        return
    _check(q.dtype, q.shape, {"eta_n": eta_n, "eta_nm1": eta_nm1,
                              "dot_out": dot_out},
           aW=op.aW, aS=op.aS, aV=op.aV, aC=op.aC, maskC=maskC, q=q,
           s_in=s_in, s_out=s_out, qa=qa)
    _check_ctrl(ctrl)
    ws = ws or Workspace(q.shape, oly, olx, q.dtype, q.device)
    kernels.launch("cg3d_s_stencil_dot", q.dtype, op.aW.data_ptr(),
                   op.aS.data_ptr(), op.aV.data_ptr(), op.aC.data_ptr(),
                   maskC.data_ptr(), q.data_ptr(), s_in.data_ptr(),
                   s_out.data_ptr(), qa.data_ptr(), eta_n.data_ptr(),
                   eta_nm1.data_ptr(), dot_out.data_ptr(),
                   ws.partials.data_ptr(), ws.counter.data_ptr(),
                   ctrl.data_ptr(), *_dims(q, oly, olx))


def xr_precond(op: CG3DOperator, maskC, x, r, s, qa, q, num, den, err_out,
               eta_out, ctrl, tol_sq, max_iters: int, count_iter: bool,
               oly: int, olx: int, ws: Workspace = None,
               impl: str = None) -> None:
    """In place on the interior: x = (x + alpha s) maskC and r = (r -
    alpha qa) maskC with alpha = num / den (0-d), err_out (0-d) = dot(r,
    r), summed down each column; then q[interior] = P^-1 r (cg3d.py:
    _apply_P: forward substitution down each column, back substitution up)
    and eta_out (0-d) = dot(q, r) over the interior's wet cells, summed up
    each column from the bottom. Leaves the halo cells as they are. With
    ctrl (int32 [done, iterations]): adds count_iter to the iterations and
    sets done when dot(r, r) < tol_sq or the iterations reach max_iters;
    does nothing while done is set."""
    if not kernels.use_kernel(x, impl):
        if _frozen(ctrl):
            return
        imask = interior_mask(x.shape, oly, olx, x.dtype, x.device) * maskC
        alpha = num / den
        _set_interior(x, (x + alpha * s) * imask, oly, olx)
        rn = (r - alpha * qa) * imask
        _set_interior(r, rn, oly, olx)
        err_out.copy_(_grid_sum(_col_sum(rn, rn, maskC, range(rn.shape[0])),
                                oly, olx))
        qf, qkm1 = [], torch.zeros_like(rn[0])
        for k in range(rn.shape[0]):
            qkm1 = op.zMC[k] * (rn[k] - op.zML[k] * qkm1)
            qf.append(qkm1)
        qb, qkp1 = [None] * len(qf), torch.zeros_like(rn[0])
        for k in reversed(range(len(qf))):
            qkp1 = qf[k] - op.zMU[k] * qkp1
            qb[k] = qkp1
        qb = torch.stack(qb)
        _set_interior(q, qb, oly, olx)
        eta_out.copy_(_grid_sum(_col_sum(qb, rn, maskC,
                                         reversed(range(len(qb)))),
                                oly, olx))
        if ctrl is not None:
            it = int(ctrl[1]) + int(count_iter)
            ctrl[1] = it
            ctrl[0] = int(not float(err_out) >= float(tol_sq)
                          or it >= max_iters)
        return
    _check(x.dtype, x.shape, {"num": num, "den": den, "err_out": err_out,
                              "eta_out": eta_out, "tol_sq": tol_sq},
           x=x, r=r, s=s, qa=qa, maskC=maskC, zMC=op.zMC, zML=op.zML,
           zMU=op.zMU, q=q)
    _check_ctrl(ctrl)
    ws = ws or Workspace(x.shape, oly, olx, x.dtype, x.device)
    kernels.launch("cg3d_xr_precond", x.dtype, x.data_ptr(), r.data_ptr(),
                   s.data_ptr(), qa.data_ptr(), maskC.data_ptr(),
                   op.zMC.data_ptr(), op.zML.data_ptr(), op.zMU.data_ptr(),
                   q.data_ptr(), num.data_ptr(), den.data_ptr(),
                   err_out.data_ptr(), eta_out.data_ptr(),
                   ws.partials.data_ptr(), ws.counter.data_ptr(),
                   ws.pair.data_ptr(), ctrl.data_ptr(), tol_sq.data_ptr(),
                   *_dims(x, oly, olx), int(max_iters), int(count_iter))


class CG3DSolve(torch.autograd.Function):
    """x = A^-1 b through the PCG loop, with the JAX package's custom VJP
    (cg3d.py:180-183): A is symmetric, so b_bar = A^-1 x_bar, one more
    solve through the same loop (kernel H-cg3d on the card) from a zero
    first guess. x0 gets a zero gradient; the residuals and counts are not
    differentiable. As in JAX, the adjoint solve masks x_bar with the
    interior and maskC."""

    @staticmethod
    def forward(ctx, b, x0, cfg: Config, grid: Grid, op: CG3DOperator,
                impl):
        res = _solve(cfg, grid, op, b, x0, impl)
        ctx.args = (cfg, grid, op, impl)
        ctx.mark_non_differentiable(res.first_residual, res.last_residual)
        return (res.x, res.first_residual, res.last_residual, res.n_iters,
                res.host_syncs)

    @staticmethod
    def backward(ctx, x_bar, *_):
        cfg, grid, op, impl = ctx.args
        with kernels.counting_as("adjoint"):
            adj = _solve(cfg, grid, op, x_bar.contiguous(),
                         torch.zeros_like(x_bar), impl)
        return adj.x, torch.zeros_like(adj.x), None, None, None, None


def cg3d(cfg: Config, grid: Grid, op: CG3DOperator, b, x0,
         impl: str = None) -> CG3DResult:
    """Solve A x = b from the first guess x0 (halo-padded [nr, nyp, nxp]
    tensors; x0 is the last phi_nh), differentiable in b (CG3DSolve)."""
    return CG3DResult(*CG3DSolve.apply(b, x0, cfg, grid, op, impl))


def _setup_plain(op: CG3DOperator, b, x0, normalise: bool):
    """Kernel N2's twin: the start of cg3d.py:_cg3d_raw (cg3d.F:117-147)
    in its operation order: (r, x, s, s', q, qA, rhsNorm), r the
    right-hand side scaled by cg3dNorm, masked and, with normalise, scaled
    by rhsNorm = 1 / max |b| (1 where the max is 0; None without
    normalise), x the first guess likewise, the work fields zero."""
    imask = op.imask3
    b = b * op.cg3dNorm * imask
    rhsNorm = None
    if normalise:
        rhsMax = torch.max(torch.abs(b))
        rhsNorm = torch.where(rhsMax != 0.0, 1.0 / rhsMax,
                              torch.ones_like(rhsMax))
        b = b * rhsNorm
        x0 = x0 * rhsNorm
    return (b, x0 * imask, *(torch.zeros_like(b) for _ in range(4)),
            rhsNorm)


def _setup_kernel(op: CG3DOperator, b, x0, normalise: bool, ws: Workspace):
    """Kernel N2 on the card (cg3d_setup.cu): the twin's outputs, r in a
    fresh field and rhsNorm ws.scal[1] (on the device; None without
    normalise)."""
    outs = [torch.empty_like(b) for _ in range(6)]
    _check(b.dtype, b.shape, {"cg3dNorm": op.cg3dNorm}, b=b, x0=x0,
           imask3=op.imask3, **dict(zip(("r", "x", "s0", "s1", "q", "qa"),
                                        outs)))
    table = kernels.pointer_table(
        [b, x0, op.imask3, op.cg3dNorm, *outs, ws.maxima, ws.counter,
         ws.scal])
    for name in ("cg3d_setup_scale", "cg3d_setup_fill"):
        kernels.launch(name, b.dtype, table, len(table), *b.shape,
                       int(normalise))
    return (*outs, ws.scal[1:] if normalise else None)


def _solve(cfg: Config, grid: Grid, op: CG3DOperator, b, x0,
           impl: str = None) -> CG3DResult:
    """The PCG loop (cg3d.py:_cg3d_raw); it writes its work fields in
    place, so autograd must never trace it. The warm start is x0 on the
    interior's wet cells (JAX's r0 reads x0's dry cells only through zero
    coefficients)."""
    oly, olx = cfg.oly, cfg.olx
    maskC = grid.maskC
    normalise = cfg.cg3dTargetResWunit <= 0.0
    on_card = kernels.use_kernel(b, impl)
    ws = (Workspace(b.shape, oly, olx, b.dtype, b.device) if on_card
          else None)
    ctrl = (torch.zeros(2, dtype=torch.int32, device=b.device) if on_card
            else None)
    kw = dict(oly=oly, olx=olx, ws=ws, impl=impl)
    stop = dict(tol_sq=op.tolerance_sq, max_iters=cfg.cg3dMaxIters)
    # normalise the RHS (cg3d.F:117-147) and start from zero work fields
    if on_card:
        r, x, s0, s1, q, qa, rhsNorm = _setup_kernel(op, b, x0, normalise,
                                                     ws)
    else:
        global plain_calls
        plain_calls += 1
        r, x, s0, s1, q, qa, rhsNorm = _setup_plain(op, b, x0, normalise)
    s = [s0, s1]

    # device scalars: 1, eta (two slots that swap roles), dot(s, qA), r.r
    one, eta_n, eta_nm1, sq, err_sq = torch.ones(
        5, dtype=b.dtype, device=b.device).unbind()
    # r0 = b - A x0: A x0 through s_stencil_dot (s = 0, beta = 1), then one
    # xr step with alpha = 1 along the zero direction s[0], which also
    # gives q0 = P^-1 r0 and eta_0 = dot(q0, r0)
    s_stencil_dot(op, maskC, x, s[0], s[1], qa, one, one, sq, ctrl, **kw)
    xr_precond(op, maskC, x, r, s[0], qa, q, one, one, err_sq, eta_n, ctrl,
               count_iter=False, **stop, **kw)
    first_res = torch.sqrt(err_sq)

    def iterate(cur):
        # eta_nm1's slot takes the next iteration's eta
        s_stencil_dot(op, maskC, q, s[cur], s[1 - cur], qa, eta_n, eta_nm1,
                      sq, ctrl, **kw)
        xr_precond(op, maskC, x, r, s[1 - cur], qa, q, eta_n, sq, err_sq,
                   eta_nm1, ctrl, count_iter=True, **stop, **kw)

    cur, syncs = 0, 0
    if on_card:
        while True:
            for _ in range(BATCH):
                iterate(cur)
                eta_n, eta_nm1, cur = eta_nm1, eta_n, 1 - cur
            done, it = ctrl.tolist()
            syncs += 1
            if done:
                break
            if it >= cfg.cg3dMaxIters:
                raise RuntimeError(f"cg3d: {it} iterations counted and "
                                   f"`done` not set")
    else:
        err, tol_sq, it = err_sq.item(), op.tolerance_sq.item(), 0
        syncs = 1
        while err >= tol_sq and it < cfg.cg3dMaxIters:
            iterate(cur)
            eta_n, eta_nm1, cur = eta_nm1, eta_n, 1 - cur
            err = err_sq.item()
            syncs += 1
            it += 1
    if normalise:
        x = x / rhsNorm
    return CG3DResult(x=cyclic_fill_halo(x, oly, olx, impl=impl),
                      first_residual=first_res,
                      last_residual=torch.sqrt(err_sq), n_iters=it,
                      host_syncs=syncs)
