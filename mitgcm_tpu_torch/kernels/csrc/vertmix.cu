// Kernel U (vertmix_calc): PP81's and MY82's Richardson-number vertical
// mixing, one thread a column (vertmix.cuh, a header of its own for the
// tests' host check; its design and bound are there).
//
// Replaces: mitgcm_tpu/model/vertmix.py:PP81.calc (:80) and MY82.calc
// (:129) with _ri_number (:34), which XLA ran as fused passes over [nr,
// nyp, nxp] arrays (two equations of state, the shear, the closure) and,
// for MY82, two reductions over the levels.

#include "vertmix.cuh"

#define MITGCM_VERTMIX_ENTRY(SUF, T)                                         \
  extern "C" int mitgcm_vertmix_calc_##SUF(                                  \
      const void* const* table, int n, const double* params, int np, int nr, \
      int nyp, int nxp, int my82, int kind, int use_phi, int nRi,            \
      void* stream) {                                                        \
    return mitgcm::launch_vertmix_calc<T>(                                   \
        table, n, params, np, nr, nyp, nxp, my82, kind, use_phi, nRi,        \
        mitgcm::OnStream{(cudaStream_t)stream});                             \
  }

MITGCM_VERTMIX_ENTRY(f32, float)
MITGCM_VERTMIX_ENTRY(f64, double)
