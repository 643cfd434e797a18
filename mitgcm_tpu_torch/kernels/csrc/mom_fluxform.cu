// Kernel B: flux-form momentum tendencies gU, gV, guDiss, gvDiss.
//
// Replaces: mitgcm_tpu/model/mom_fluxform.py:mom_fluxform (:122-469) on the
// branches the ported paths run: centred advection with the free-surface
// dmask correction (:155-230), constant harmonic viscosity and the explicit
// vertical viscous flux (:233-307), no-slip bottom drag (:343-381) and
// Coriolis scheme 0 (:420-445); two template flags pick the side condition
// (the no-slip side drag of :312-340, or free slip without it) and the 3-D
// Coriolis term of the non-hydrostatic path (_coriolis_3d_u, :454-469), so
// the gyres compile to the code they had before. XLA fused this chain of
// shifted products into a few sweeps on the TPU.
//
// Bound: bytes. Per cell it reads 11 3-D fields (u, v, w, the hFac and
// masks, two kappa levels) and writes 4, ~60 B/cell in float32, for a few
// hundred flops: well below the card's ~20 flops/byte.
// Design (mom_fluxform_tile.cuh): column-walking tiles of 32 x 4 columns
// that stage each level in shared memory and compute each face flux, each
// hFacZ and each vertical flux once, with 2-D metrics in registers for the
// whole column, so that the loads a cell issues are about the distinct
// values it needs, and each level's loads are issued while the level above
// is computed. (One thread per (k, j, i) recomputing every neighbour flux
// from the inputs, before, issued over 100 loads a cell and was bound by
// load instructions and L1/L2, not by DRAM; PERF.md's PR 14 section has
// the times.) Halo cells of the outputs are written as 0 by the blocks
// past the tiles; callers fill or mask them (step.py fills uStar/vStar and
// every prognostic field).
//
// Each expression keeps the JAX code's operation order, so with
// --fmad=false the outputs are bit-equal to the plain PyTorch twin.

#include "mom_fluxform_tile.cuh"

#define MITGCM_MOM_ENTRY_POINT(T, SUF)                                        \
  extern "C" int mitgcm_mom_fluxform_##SUF(                                   \
      const void* const* table, int n, int nr, int ny, int nx, int oly,       \
      int olx, int no_slip_sides, int coriolis_3d, double viscAhD,            \
      double viscAhZ, double sideDragFactor, double rkSign,                   \
      double gravitySign, void* stream) {                                     \
    return mitgcm::launch_mom<T>(table, n, nr, ny, nx, oly, olx,              \
                                 no_slip_sides, coriolis_3d, viscAhD,         \
                                 viscAhZ, sideDragFactor, rkSign,             \
                                 gravitySign,                                 \
                                 mitgcm::OnStream{(cudaStream_t)stream});     \
  }

MITGCM_MOM_ENTRY_POINT(float, f32)
MITGCM_MOM_ENTRY_POINT(double, f64)
