// Kernel Z (opps_col): OPPS penetrative plume convection, one thread a
// column (opps.cuh, a header of its own for the tests' host check; its
// design and bound are there).
//
// Replaces: mitgcm_tpu/model/opps.py:OPPS.apply (:86), which XLA ran as a
// fori_loop over the launch levels of fused passes over every column: the
// descent's fori_loop with STATE1 (:48) and FIND_RHO_SCALAR (:66), the
// time-step scan and the adjustment's while_loop.

#include "opps.cuh"

#define MITGCM_OPPS_ENTRY(SUF, T)                                            \
  extern "C" int mitgcm_opps_col_##SUF(                                      \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int kind, int use_phi, int max_abe, void* stream) {  \
    return mitgcm::launch_opps_col<T>(                                       \
        table, n, params, np, nr, nyp, nxp, kind, use_phi, max_abe,          \
        mitgcm::OnStream{(cudaStream_t)stream});                             \
  }

MITGCM_OPPS_ENTRY(f32, float)
MITGCM_OPPS_ENTRY(f64, double)
