"""Stencil shift primitives on halo-padded tensors (mitgcm_tpu/ops/stencil.py).

All model fields live on tensors shaped [..., ny + 2*oly, nx + 2*olx].
`shift(a, dj, di)` returns b[..., j, i] = a[..., j+dj, i+di] with ZERO fill
at the array edge (not torch.roll, which would wrap). Cells whose stencil
reaches outside the padded array are garbage by design; consumers only
trust interior +/- (OL-1) cells between halo fills.

`cyclic_fill_halo`, the single-device halo exchange, runs kernel F
(kernels/csrc/halo.cu) on CUDA tensors and its twin, the gather, on CPU
tensors or with impl="plain"; its backward is kernel F' (halo_fold,
kernels/csrc/halo_adj.cu) after kernel F, the plain fold after the gather.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mitgcm_tpu_torch import kernels

# calls of kernel F's twin (the gather) and of its backward's (the fold),
# for the card's runs to show that the main path never ran them
plain_calls = 0
plain_folds = 0


def shift(a: torch.Tensor, dj: int = 0, di: int = 0) -> torch.Tensor:
    """b[..., j, i] = a[..., j+dj, i+di], zero-filled outside the array."""
    out = a
    if di > 0:
        out = F.pad(out[..., :, di:], (0, di))
    elif di < 0:
        out = F.pad(out[..., :, :di], (-di, 0))
    if dj > 0:
        out = F.pad(out[..., dj:, :], (0, 0, 0, dj))
    elif dj < 0:
        out = F.pad(out[..., :dj, :], (0, 0, -dj, 0))
    return out


def shift_k(a: torch.Tensor, dk: int) -> torch.Tensor:
    """b[k, j, i] = a[k+dk, j, i], zero-filled (vertical shifts, axis -3)."""
    if dk > 0:
        return F.pad(a[..., dk:, :, :], (0, 0, 0, 0, 0, dk))
    if dk < 0:
        return F.pad(a[..., :dk, :, :], (0, 0, 0, 0, -dk, 0))
    return a


def _fold(g: torch.Tensor, dim: int, ol: int) -> torch.Tensor:
    """Transpose of the cyclic gather along `dim`: the padded cotangent g
    (length n + 2*ol) summed onto the n interior cells it was read from,
    block by block in index order (no scatter, so the same bits on every
    run and device)."""
    n = g.shape[dim] - 2 * ol
    # zeros in front so that padded index p lands on (p - ol) mod n
    lead = -(-ol // n) * n - ol
    g = g.movedim(dim, -1)
    g = F.pad(g, (lead, -(lead + g.shape[-1]) % n))
    blocks = g.unflatten(-1, (-1, n)).unbind(-2)
    acc = blocks[0]
    for b in blocks[1:]:
        acc = acc + b
    return acc.movedim(-1, dim)


def _gather(a: torch.Tensor, oly: int, olx: int) -> torch.Tensor:
    """Kernel F's twin: the modular gather of the JAX package's
    ops/stencil.py:54-69."""
    ny = a.shape[-2] - 2 * oly
    nx = a.shape[-1] - 2 * olx
    inner = a[..., oly:oly + ny, olx:olx + nx]
    jj = torch.arange(-oly, ny + oly, device=a.device) % ny
    ii = torch.arange(-olx, nx + olx, device=a.device) % nx
    return inner.index_select(-2, jj).index_select(-1, ii)


def _halo_fill(a: torch.Tensor, oly: int, olx: int) -> torch.Tensor:
    """Kernel F (kernels/csrc/halo.cu): the wrap into a fresh tensor (of a
    contiguous copy of `a`, where `a` is a view)."""
    a = a.contiguous()
    out = torch.empty_like(a)
    kernels.check_tensors(a.dtype, a=a, out=out)
    ny = a.shape[-2] - 2 * oly
    nx = a.shape[-1] - 2 * olx
    planes = a.numel() // (a.shape[-2] * a.shape[-1])
    kernels.launch("halo_fill", a.dtype, a.data_ptr(), out.data_ptr(),
                   planes, ny, nx, oly, olx)
    return out


def halo_fold_vjp_plain(g: torch.Tensor, oly: int, olx: int) -> torch.Tensor:
    """Kernel F''s plain version: the fill's VJP, the padded cotangent g
    folded onto the interior along x, then along y (_fold), the halo cells
    0."""
    inner = _fold(_fold(g, -1, olx), -2, oly)
    return F.pad(inner, (olx, olx, oly, oly))


def _halo_fold(g: torch.Tensor, oly: int, olx: int) -> torch.Tensor:
    """Kernel F' (kernels/csrc/halo_adj.cu): halo_fold_vjp_plain's result
    into a fresh tensor."""
    g = g.contiguous()
    out = torch.empty_like(g)
    kernels.check_tensors(g.dtype, g=g, out=out)
    ny = g.shape[-2] - 2 * oly
    nx = g.shape[-1] - 2 * olx
    planes = g.numel() // (g.shape[-2] * g.shape[-1])
    kernels.launch("halo_fold", g.dtype, g.data_ptr(), out.data_ptr(),
                   planes, ny, nx, oly, olx)
    return out


class _CyclicFill(torch.autograd.Function):
    """The fill as kernel F on the card (its twin, the gather, on the
    CPU); its backward folds the halo cotangents into the interior in a
    fixed order, kernel F' after kernel F, the plain fold after the gather
    (index_select's own backward is an index_add, whose atomics on CUDA
    change the last bit from run to run). The input's halo cells get a
    zero gradient: they are not read."""

    @staticmethod
    def forward(ctx, a, oly: int, olx: int, kernel: bool):
        ctx.ol = (oly, olx)
        ctx.kernel = kernel
        return _halo_fill(a, oly, olx) if kernel else _gather(a, oly, olx)

    @staticmethod
    def backward(ctx, g):
        oly, olx = ctx.ol
        if ctx.kernel:
            return _halo_fold(g, oly, olx), None, None, None
        global plain_folds
        plain_folds += 1
        return halo_fold_vjp_plain(g, oly, olx), None, None, None


def cyclic_fill_halo(a: torch.Tensor, oly: int, olx: int,
                     impl: str = None) -> torch.Tensor:
    """Single-device halo exchange: cyclic wrap of the interior into the
    halos, as a modular gather (exact also when a halo is wider than the
    interior), with a deterministic backward. Kernel F on CUDA tensors,
    its twin on CPU tensors or with impl="plain"."""
    kernel = kernels.use_kernel(a, impl)
    if not kernel:
        global plain_calls
        plain_calls += 1
    return _CyclicFill.apply(a, oly, olx, kernel)


def interior(a: torch.Tensor, oly: int, olx: int) -> torch.Tensor:
    return a[..., oly:a.shape[-2] - oly, olx:a.shape[-1] - olx]


def interior_mask(shape, oly: int, olx: int, dtype: torch.dtype,
                  device) -> torch.Tensor:
    """1 on interior cells, 0 on halo cells, for a padded 2-D shape."""
    m = torch.zeros(tuple(shape[-2:]), dtype=dtype, device=device)
    m[oly:shape[-2] - oly, olx:shape[-1] - olx] = 1.0
    return m
