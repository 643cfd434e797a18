// Kernel N2 (cg3d_setup): the set-up of a cg3d solve in two launches
// (cg3d_setup_scale, cg3d_setup_fill). The kernels and their launches are
// in cg3d_setup.cuh (a header of its own for the tests' host check); this
// file holds the entry points.

#include "cg3d_setup.cuh"

#define MITGCM_CG3D_SETUP_ENTRY_POINTS(T, SUF)                                \
  extern "C" int mitgcm_cg3d_setup_scale_##SUF(                               \
      const void* const* t, int n, int nr, int nyp, int nxp, int normalise,   \
      void* stream) {                                                         \
    return mitgcm::launch_cg3d_setup_scale<T>(                                \
        t, n, nr, nyp, nxp, normalise,                                        \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }                                                                           \
  extern "C" int mitgcm_cg3d_setup_fill_##SUF(                                \
      const void* const* t, int n, int nr, int nyp, int nxp, int normalise,   \
      void* stream) {                                                         \
    return mitgcm::launch_cg3d_setup_fill<T>(                                 \
        t, n, nr, nyp, nxp, normalise,                                        \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_CG3D_SETUP_ENTRY_POINTS(float, f32)
MITGCM_CG3D_SETUP_ENTRY_POINTS(double, f64)
