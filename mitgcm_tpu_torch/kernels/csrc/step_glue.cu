// Kernel G: the step's pointwise glue around the momentum and tracer
// tendencies, three passes: mom_ab_step and tracer_step (step_glue.cuh)
// and mom_correction (mom_correction.cuh), each in a header of its own for
// the tests' host check; this file holds the entry points.

#include "mom_correction.cuh"
#include "step_glue.cuh"

#define MITGCM_STEP_GLUE_ENTRY_POINTS(T, SUF)                                 \
  extern "C" int mitgcm_mom_ab_step_##SUF(                                    \
      const void* const* table, int n, int nr, int nyp, int nxp, int ab,      \
      int mode, double abFac, double ab0, double ab1, double ab2,             \
      double deltaTMom, double wFac, void* stream) {                          \
    return mitgcm::launch_mom_ab_step<T>(                                     \
        table, n, nr, nyp, nxp, ab, mode, abFac, ab0, ab1, ab2, deltaTMom,    \
        wFac, mitgcm::OnStream{(cudaStream_t)stream});                        \
  }                                                                           \
  extern "C" int mitgcm_mom_correction_##SUF(                                 \
      const void* const* table, int n, int nr, int nyp, int nxp, int nh,      \
      double dtPsFac, double psFac, double nhFac, double deltaTMom,           \
      void* stream) {                                                         \
    return mitgcm::launch_mom_correction<T>(                                  \
        table, n, nr, nyp, nxp, nh, dtPsFac, psFac, nhFac, deltaTMom,         \
        mitgcm::kCorrMinBlocks, mitgcm::OnStream{(cudaStream_t)stream});      \
  }                                                                           \
  extern "C" int mitgcm_tracer_step_##SUF(                                    \
      const void* const* table, int n, int nr, int nyp, int nxp, int ks,      \
      int ab, double abFac, double ab0, double ab1, double ab2,               \
      double deltaT, void* stream) {                                          \
    return mitgcm::launch_tracer_step<T>(                                     \
        table, n, nr, nyp, nxp, ks, ab, abFac, ab0, ab1, ab2, deltaT,         \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_STEP_GLUE_ENTRY_POINTS(float, f32)
MITGCM_STEP_GLUE_ENTRY_POINTS(double, f64)
