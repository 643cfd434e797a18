// Kernel E' (cg2d_rhs_adj, continuity_adj): the VJPs of kernel E's two
// column scans. The kernels and their launches are in step_scans_adj.cuh
// (a header of its own for the tests' host check); this file holds the
// entry points.

#include "step_scans_adj.cuh"

#define MITGCM_STEP_SCANS_ADJ_ENTRY_POINTS(T, SUF)                            \
  extern "C" int mitgcm_cg2d_rhs_adj_##SUF(                                   \
      const void* const* t, int n, int nr, int nyp, int nxp, int oly,         \
      int olx, double implicDiv2Dflow, double deltaTMom, double freeSurfFac,  \
      double deltaTFreeSurf, void* stream) {                                  \
    return mitgcm::launch_cg2d_rhs_adj<T>(                                    \
        t, n, nr, nyp, nxp, oly, olx, implicDiv2Dflow, deltaTMom,             \
        freeSurfFac, deltaTFreeSurf,                                          \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }                                                                           \
  extern "C" int mitgcm_continuity_adj_##SUF(                                 \
      const void* const* t, int n, int nr, int nyp, int nxp, void* stream) {  \
    return mitgcm::launch_continuity_adj<T>(                                  \
        t, n, nr, nyp, nxp, mitgcm::OnStream{(cudaStream_t)stream});          \
  }

MITGCM_STEP_SCANS_ADJ_ENTRY_POINTS(float, f32)
MITGCM_STEP_SCANS_ADJ_ENTRY_POINTS(double, f64)
