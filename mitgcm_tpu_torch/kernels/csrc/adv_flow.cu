// Kernel L (adv_flow): calc_adv_flow.F's transports, face areas and
// interface mask in one launch, and kernel L' (adv_flow_adj), its VJP in
// u, v and w. The kernels and their launches are in adv_flow.cuh (a header
// of its own for the tests' host check); this file holds the entry
// points.

#include "adv_flow.cuh"

#define MITGCM_ADV_FLOW_ENTRY_POINT(T, SUF)                                   \
  extern "C" int mitgcm_adv_flow_##SUF(const void* const* table, int n,       \
                                       int nr, int nyp, int nxp,              \
                                       void* stream) {                        \
    return mitgcm::launch_adv_flow<T>(                                        \
        table, n, nr, nyp, nxp, mitgcm::OnStream{(cudaStream_t)stream});      \
  }                                                                           \
  extern "C" int mitgcm_adv_flow_adj_##SUF(const void* const* table, int n,   \
                                           int nr, int nyp, int nxp,          \
                                           void* stream) {                    \
    return mitgcm::launch_adv_flow_adj<T>(                                    \
        table, n, nr, nyp, nxp, mitgcm::OnStream{(cudaStream_t)stream});      \
  }

MITGCM_ADV_FLOW_ENTRY_POINT(float, f32)
MITGCM_ADV_FLOW_ENTRY_POINT(double, f64)
