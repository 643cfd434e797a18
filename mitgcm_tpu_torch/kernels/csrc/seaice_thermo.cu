// Kernel seaice_thermo and its tracer variant TP: the entry points. The
// kernel and its launch are in seaice_thermo.cuh (the tests' host check
// builds them too).

#include "seaice_thermo.cuh"

#define MITGCM_SEAICE_THERMO_ENTRY_POINT(T, SUF)                             \
  extern "C" int mitgcm_seaice_thermo_##SUF(                                 \
      const void* const* table, int n, const double* params, int nparams,    \
      int nyp, int nxp, int ol, int multDim, int imax, void* stream) {       \
    return mitgcm::launch_seaice_thermo<T, false>(                           \
        table, n, params, nparams, nullptr, 0, nullptr, nullptr, nyp, nxp,   \
        ol, multDim, imax, mitgcm::OnStream{(cudaStream_t)stream});          \
  }                                                                          \
  extern "C" int mitgcm_seaice_thermo_tr_##SUF(                              \
      const void* const* table, int n, const double* params, int nparams,    \
      const double* trparams, int ntrparams, const void* tr_in,              \
      void* tr_out, int nyp, int nxp, int ol, int multDim, int imax,         \
      void* stream) {                                                        \
    return mitgcm::launch_seaice_thermo<T, true>(                            \
        table, n, params, nparams, trparams, ntrparams, tr_in, tr_out, nyp,  \
        nxp, ol, multDim, imax, mitgcm::OnStream{(cudaStream_t)stream});     \
  }

MITGCM_SEAICE_THERMO_ENTRY_POINT(float, f32)
MITGCM_SEAICE_THERMO_ENTRY_POINT(double, f64)
