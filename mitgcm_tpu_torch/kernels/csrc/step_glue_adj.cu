// Kernel G' (mom_ab_step_adj, mom_correction_adj, tracer_step_adj): the
// VJPs of kernel G's three passes. The kernels and their launches are in
// step_glue_adj.cuh (a header of its own for the tests' host check); this
// file holds the entry points.

#include "step_glue_adj.cuh"

#define MITGCM_STEP_GLUE_ADJ_ENTRY_POINTS(T, SUF)                             \
  extern "C" int mitgcm_mom_ab_step_adj_##SUF(                                \
      const void* const* t, int n, int nr, int nyp, int nxp, int ab,          \
      double abFac, double ab0, double ab1, double ab2, double deltaTMom,     \
      void* stream) {                                                         \
    return mitgcm::launch_mom_ab_step_adj<T>(                                 \
        t, n, nr, nyp, nxp, ab, abFac, ab0, ab1, ab2, deltaTMom,              \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }                                                                           \
  extern "C" int mitgcm_mom_correction_adj_##SUF(                             \
      const void* const* t, int n, int nr, int nyp, int nxp, double dtPsFac,  \
      void* stream) {                                                         \
    return mitgcm::launch_mom_correction_adj<T>(                              \
        t, n, nr, nyp, nxp, dtPsFac, mitgcm::OnStream{(cudaStream_t)stream}); \
  }                                                                           \
  extern "C" int mitgcm_tracer_step_adj_##SUF(                                \
      const void* const* t, int n, int nr, int nyp, int nxp, int ks, int ab,  \
      double abFac, double ab0, double ab1, double ab2, double deltaT,        \
      void* stream) {                                                         \
    return mitgcm::launch_tracer_step_adj<T>(                                 \
        t, n, nr, nyp, nxp, ks, ab, abFac, ab0, ab1, ab2, deltaT,             \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_STEP_GLUE_ADJ_ENTRY_POINTS(float, f32)
MITGCM_STEP_GLUE_ADJ_ENTRY_POINTS(double, f64)
