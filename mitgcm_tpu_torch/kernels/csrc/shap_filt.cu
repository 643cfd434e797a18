// Kernels SH-uv (shap_uv) and SH-ts (shap_ts): one pass of the Shapiro
// filter's S2 function on the velocity pair or on a tracer, one thread a
// cell (shap_filt.cuh, a header of its own for the tests' host check; its
// design and bound are there).
//
// Replaces: each iteration of mitgcm_tpu/model/shap_filt.py:apply_uv
// (:150) and apply_ts (:224), which XLA ran as fused passes over [nr, nyp,
// nxp] arrays, and the halo fills between them.

#include "shap_filt.cuh"

#define MITGCM_SHAP_ENTRY(NAME, TS, SUF, T)                                  \
  extern "C" int mitgcm_##NAME##_##SUF(                                      \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int oly, int olx, int fill, int first, int last,     \
      int physical, int length, void* stream) {                              \
    return mitgcm::launch_shap<T>(                                           \
        TS, table, n, params, np, nr, nyp, nxp, oly, olx,                    \
        mitgcm::ShapFlags{fill, first, last, physical, length},              \
        mitgcm::OnStream{(cudaStream_t)stream});                             \
  }

MITGCM_SHAP_ENTRY(shap_uv, 0, f32, float)
MITGCM_SHAP_ENTRY(shap_uv, 0, f64, double)
MITGCM_SHAP_ENTRY(shap_ts, 1, f32, float)
MITGCM_SHAP_ENTRY(shap_ts, 1, f64, double)
