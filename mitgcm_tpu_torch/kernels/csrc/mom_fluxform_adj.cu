// Kernel B': the VJP of kernel B (the flux-form momentum tendencies).
//
// Replaces: the reverse-mode derivative that jax.grad takes of
// mitgcm_tpu/model/mom_fluxform.py:mom_fluxform (:122-451) on the gyre's
// branches, which XLA fused on the TPU. Given the cotangents of gU, gV,
// guDiss and gvDiss it writes u_bar, v_bar and w_bar. The kappas and the
// grid are constants and get no cotangent.
//
// The advection terms are quadratic in (u, v, w), the rest is linear, so
// the partial derivatives need u, v and w and nothing else of the forward
// pass: the kernel recomputes every transport, average and hFacZ it needs.
//
// Bound: bytes, like kernel B (its 3-D inputs plus 4 cotangents read, 3
// fields written per cell).
// Design: gather, not scatter. Each output cell sums the contributions of
// every interior output cell whose stencil read it, flux by flux, in a
// fixed order and with no atomics, so the result is the same bits on every
// run. The reach is +-1 in i, j and k plus the (+-1, +-1) corners of the
// Coriolis averages and of the cross transports. Kernel B's halo outputs
// are constant zeros, so the cotangents are read on interior cells only;
// the inputs are written everywhere, nonzero up to one cell outside the
// interior, where the forward pass read them. A column-walking tile
// (mom_fluxform_adj_tile.cuh, on tile.cuh as kernel B's) stages each level
// in shared memory and forms each face cotangent, each viscous coefficient
// and each vertical flux cotangent once. (One thread per (k, j, i)
// recomputing every neighbour's term from the inputs, before, issued well
// over 100 loads a cell; PERF.md has the times.)

#include "mom_fluxform_adj_tile.cuh"

#define MITGCM_MOM_ADJ_ENTRY_POINT(T, SUF)                                    \
  extern "C" int mitgcm_mom_fluxform_adj_##SUF(                               \
      const void* const* table, int n, int nr, int ny, int nx, int oly,       \
      int olx, double viscAhD, double viscAhZ, double sideDragFactor,         \
      double rkSign, void* stream) {                                          \
    return mitgcm::launch_mom_adj<T>(                                         \
        table, n, nr, ny, nx, oly, olx, viscAhD, viscAhZ, sideDragFactor,     \
        rkSign, mitgcm::OnStream{(cudaStream_t)stream});                      \
  }

MITGCM_MOM_ADJ_ENTRY_POINT(float, f32)
MITGCM_MOM_ADJ_ENTRY_POINT(double, f64)
