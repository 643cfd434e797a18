// Kernel TH (thsice_step): one step of Winton's three-layer thermodynamic
// sea ice, one thread a cell (thsice.cuh, a header of its own for the
// tests' host check; its design and bound are there).
//
// Replaces: mitgcm_tpu/model/thsice.py:ThSIce.step (:779-911), which XLA
// fused into pointwise passes over the 2-D fields on the TPU.

#include "thsice.cuh"

#define MITGCM_THSICE_ENTRY(SUF, T)                                          \
  extern "C" int mitgcm_thsice_step_##SUF(                                   \
      const void* const* table, int n, const double* params, int np,         \
      int nyp, int nxp, int oly, int olx, int nitMaxTsf, void* stream) {     \
    return mitgcm::launch_thsice_step<T>(                                    \
        table, n, params, np, nyp, nxp, oly, olx, nitMaxTsf,                 \
        mitgcm::OnStream{(cudaStream_t)stream});                             \
  }

MITGCM_THSICE_ENTRY(f32, float)
MITGCM_THSICE_ENTRY(f64, double)
