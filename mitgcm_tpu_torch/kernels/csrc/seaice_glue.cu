// Kernels S1 (seaice_dynforcing) and S2 (seaice_ocean_stress): the sea
// ice's step set-up and its ocean stress, one 2-D launch each. The kernels
// and their launches are in seaice_glue.cuh (a header of its own for the
// tests' host check); this file holds the entry points.

#include "seaice_glue.cuh"

#define MITGCM_SEAICE_GLUE_ENTRY_POINTS(T, SUF)                               \
  extern "C" int mitgcm_seaice_dynforcing_##SUF(                              \
      const void* const* t, int n, const double* params, int np, int nyp,     \
      int nxp, int flags, void* stream) {                                     \
    return mitgcm::launch_seaice_dynforcing<T>(                               \
        t, n, params, np, nyp, nxp, flags,                                    \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }                                                                           \
  extern "C" int mitgcm_seaice_ocean_stress_##SUF(                            \
      const void* const* t, int n, const double* params, int np, int nyp,     \
      int nxp, int mode, int flags, void* stream) {                           \
    return mitgcm::launch_seaice_ocean_stress<T>(                             \
        t, n, params, np, nyp, nxp, mode, flags,                              \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_SEAICE_GLUE_ENTRY_POINTS(float, f32)
MITGCM_SEAICE_GLUE_ENTRY_POINTS(double, f64)
