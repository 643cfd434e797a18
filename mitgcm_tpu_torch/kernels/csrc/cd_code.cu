// Kernel CD (cd_scheme): the CD scheme's D-grid step, guCor and gvCor added
// to the AB-extrapolated tendencies, and the predictors u* and v*, one
// thread a cell (cd_code.cuh, a header of its own for the tests' host
// check; its design and bound are there).
//
// Replaces: mitgcm_tpu/model/cd_code.py:cd_scheme (:30) with the step's
// use of it (mitgcm_tpu/model/step.py:269-277, :317-318), which XLA ran as
// fused elementwise passes over [nr, nyp, nxp] arrays.

#include "cd_code.cuh"

#define MITGCM_CD_ENTRY(SUF, T)                                              \
  extern "C" int mitgcm_cd_scheme_##SUF(const void* const* table, int n,     \
                                        const double* params, int np,        \
                                        int nr, int nyp, int nxp,            \
                                        void* stream) {                      \
    return mitgcm::launch_cd_scheme<T>(                                      \
        table, n, params, np, nr, nyp, nxp,                                  \
        mitgcm::OnStream{(cudaStream_t)stream});                             \
  }

MITGCM_CD_ENTRY(f32, float)
MITGCM_CD_ENTRY(f64, double)
