// Kernel LA, seaice_advect_legacy: the entry point. The kernel and its
// launch are in seaice_advect_legacy.cuh (the tests' host check builds
// them too).

#include "seaice_advect_legacy.cuh"

#define MITGCM_SEAICE_ADVECT_LEGACY_ENTRY_POINT(T, SUF)                      \
  extern "C" int mitgcm_seaice_advect_legacy_##SUF(                          \
      const void* const* table, int n, const double* params, int nparams,    \
      int nyp, int nxp, int ol, int pass, void* stream) {                    \
    return mitgcm::launch_seaice_advect_legacy<T>(                           \
        table, n, params, nparams, nyp, nxp, ol, pass,                       \
        mitgcm::OnStream{(cudaStream_t)stream});                             \
  }

MITGCM_SEAICE_ADVECT_LEGACY_ENTRY_POINT(float, f32)
MITGCM_SEAICE_ADVECT_LEGACY_ENTRY_POINT(double, f64)
