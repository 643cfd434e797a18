// Kernel F' (halo_fold): the transpose of kernel F's halo wrap, the
// backward of every halo fill on the card. The kernel and its launch are
// in halo_adj.cuh (a header of its own for the tests' host check); this
// file holds the entry points.

#include "halo_adj.cuh"

#define MITGCM_HALO_FOLD_ENTRY_POINT(T, SUF)                                  \
  extern "C" int mitgcm_halo_fold_##SUF(const void* g, void* out,            \
                                        int planes, int ny, int nx, int oly,  \
                                        int olx, void* stream) {              \
    return mitgcm::launch_halo_fold<T>(                                       \
        g, out, planes, ny, nx, oly, olx,                                     \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_HALO_FOLD_ENTRY_POINT(float, f32)
MITGCM_HALO_FOLD_ENTRY_POINT(double, f64)
