// Kernels J-uv (kappa_uv) and J-ts (kappa_ts): the step's vertical
// viscosities and diffusivities with KPP's, GGL90's and GM's terms, and
// KPP's nonlocal flux. The kernels and their launches are in mix_glue.cuh
// (a header of its own for the tests' host check); this file holds the
// entry points.

#include "mix_glue.cuh"

#define MITGCM_MIX_GLUE_ENTRY_POINTS(T, SUF)                                  \
  extern "C" int mitgcm_kappa_uv_##SUF(const void* const* table, int n,       \
                                       int nr, int nyp, int nxp, int mode,    \
                                       double viscAr, void* stream) {         \
    return mitgcm::launch_kappa_uv<T>(                                        \
        table, n, nr, nyp, nxp, mode, viscAr,                                 \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }                                                                           \
  extern "C" int mitgcm_kappa_ts_##SUF(                                       \
      const void* const* table, int n, const double* params, int np, int nr,  \
      int nyp, int nxp, int kpp, int gm, int ggl90, void* stream) {           \
    return mitgcm::launch_kappa_ts<T>(                                        \
        table, n, params, np, nr, nyp, nxp, kpp, gm, ggl90,                   \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_MIX_GLUE_ENTRY_POINTS(float, f32)
MITGCM_MIX_GLUE_ENTRY_POINTS(double, f64)
