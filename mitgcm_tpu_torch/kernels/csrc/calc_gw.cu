// Kernel W: the vertical-momentum tendency of the non-hydrostatic path,
// gW (advection of w and the 3-D Coriolis term) and gwDiss (its harmonic
// and vertical viscous dissipation).
//
// Replaces: mitgcm_tpu/model/calc_gw.py:calc_gw (:29-166), the
// z-coordinate, Boussinesq, shallow-atmosphere case, in which the JAX
// code's rhoFac*, deepFac* and rVel2wUnit factors are exactly 1 and its
// products with them are left out (exact), as are the biharmonic terms
// (viscA4W = 0, refused otherwise: they add exact zeros). XLA fused the
// chain of shifted products into a few sweeps on the TPU.
//
// Bound: bytes. Per cell it reads six 3-D fields (u, v, w, maskC, hFacW,
// hFacS) and two kappa levels and writes two, ~40 B/cell in float32, for
// about 150 flops: far below the card's ~20 flops/byte.
// Design (calc_gw_tile.cuh): column-walking tiles of 32 x 4 columns over
// the whole padded plane that stage each level's w (and, with the 3-D
// Coriolis term, u and v) with a one-cell ring in shared memory, form each
// face flux once and carry the vertical fluxes, the transports' level
// products and the interface kappas from one level to the next in
// registers; a template variant with and without the 3-D Coriolis term.
// (One thread per padded cell (k, j, i) recomputing every neighbour's face
// and interface fluxes from the inputs, before, formed each face flux
// twice and summed eight kappas twice a cell; PERF.md's table of kernels
// has both times.) Every padded cell is computed, the halo cells with the zero
// fill of the JAX code's shifts, so the outputs are the twin's on whole
// arrays. Both outputs are 0 at k = 0.
//
// Each expression keeps the JAX code's operation order, so with
// --fmad=false the outputs are bit-equal to the plain PyTorch twin
// (model/calc_gw.py:_calc_gw_plain).

#include "calc_gw_tile.cuh"

#define MITGCM_CALC_GW_ENTRY_POINT(T, SUF)                                    \
  extern "C" int mitgcm_calc_gw_##SUF(const void* const* table, int n,        \
                                      int nr, int nyp, int nxp,               \
                                      int coriolis_3d, double viscAhW,        \
                                      double rkSign, double gravitySign,      \
                                      void* stream) {                         \
    return mitgcm::launch_calc_gw<T>(                                         \
        table, n, nr, nyp, nxp, coriolis_3d, viscAhW, rkSign, gravitySign,    \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_CALC_GW_ENTRY_POINT(float, f32)
MITGCM_CALC_GW_ENTRY_POINT(double, f64)
