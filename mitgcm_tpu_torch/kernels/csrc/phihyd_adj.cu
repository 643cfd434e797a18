// Kernel D' (phihyd_adj): the VJP of kernel D, rho's cotangent from those
// of phiHydC, dPhiHydX and dPhiHydY. The kernel and its launch are in
// phihyd_adj.cuh (a header of its own for the tests' host check); this
// file holds the entry points.

#include "phihyd_adj.cuh"

#define MITGCM_PHIHYD_ADJ_ENTRY_POINT(T, SUF)                                 \
  extern "C" int mitgcm_phihyd_adj_##SUF(                                     \
      const void* const* t, int n, int nr, int nyp, int nxp, double gravity,  \
      double recip_rhoConst, void* stream) {                                  \
    return mitgcm::launch_phihyd_adj<T>(                                      \
        t, n, nr, nyp, nxp, gravity, recip_rhoConst,                          \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_PHIHYD_ADJ_ENTRY_POINT(float, f32)
MITGCM_PHIHYD_ADJ_ENTRY_POINT(double, f64)
