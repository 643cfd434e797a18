// Kernel E: the step's two column scans, the cg2d right-hand side (with, on
// the non-hydrostatic path, pre_cg3d's surface term) and the vertical
// velocity from continuity. The kernels and their launches are in
// step_scans.cuh (a header of its own for the tests' host check); this
// file holds the entry points.

#include "step_scans.cuh"

#define MITGCM_STEP_SCANS_ENTRY_POINTS(T, SUF)                                \
  extern "C" int mitgcm_cg2d_rhs_##SUF(                                       \
      const void* const* t, int n, int nr, int nyp, int nxp, int oly,         \
      int olx, int hydrostatic, double implicDiv2Dflow, double deltaTMom,     \
      double freeSurfFac, double deltaTFreeSurf, void* stream) {              \
    return mitgcm::launch_cg2d_rhs<T>(                                        \
        t, n, nr, nyp, nxp, oly, olx, hydrostatic, implicDiv2Dflow,           \
        deltaTMom, freeSurfFac, deltaTFreeSurf,                               \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }                                                                           \
  extern "C" int mitgcm_continuity_##SUF(const void* const* t, int n, int nr, \
                                         int nyp, int nxp, void* stream) {    \
    return mitgcm::launch_continuity<T>(                                      \
        t, n, nr, nyp, nxp, mitgcm::OnStream{(cudaStream_t)stream});          \
  }

MITGCM_STEP_SCANS_ENTRY_POINTS(float, f32)
MITGCM_STEP_SCANS_ENTRY_POINTS(double, f64)
