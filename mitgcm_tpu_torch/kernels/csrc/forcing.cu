// Kernel Q (surface_forcing): the step's surface forcing in one 2-D launch
// a step. The kernel and its launch are in forcing.cuh (a header of its
// own for the tests' host check); this file holds the entry point.

#include "forcing.cuh"

#define MITGCM_FORCING_ENTRY_POINT(T, SUF)                                    \
  extern "C" int mitgcm_surface_forcing_##SUF(                                \
      const void* const* t, int n, const double* params, int np, int nyp,     \
      int nxp, int flags, void* stream) {                                     \
    return mitgcm::launch_surface_forcing<T>(                                 \
        t, n, params, np, nyp, nxp, flags,                                    \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_FORCING_ENTRY_POINT(float, f32)
MITGCM_FORCING_ENTRY_POINT(double, f64)
