// Kernel N1 (pre_cg3d): the nh-convection box's cg3d right-hand side after
// the cg2d solve, in one launch. The kernel and its launch are in
// pre_cg3d.cuh (a header of its own for the tests' host check); this file
// holds the entry point.

#include "pre_cg3d.cuh"

#define MITGCM_PRE_CG3D_ENTRY_POINT(T, SUF)                                   \
  extern "C" int mitgcm_pre_cg3d_##SUF(                                       \
      const void* const* t, int n, int nr, int nyp, int nxp, double psFac,    \
      double freeSurfFac, double deltaTFreeSurf, double deltaTMom,            \
      void* stream) {                                                         \
    return mitgcm::launch_pre_cg3d<T>(                                        \
        t, n, nr, nyp, nxp, psFac, freeSurfFac, deltaTFreeSurf, deltaTMom,    \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_PRE_CG3D_ENTRY_POINT(float, f32)
MITGCM_PRE_CG3D_ENTRY_POINT(double, f64)
