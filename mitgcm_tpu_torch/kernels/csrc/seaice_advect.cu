// Kernel seaice_advect, with the ice tracers when there are any: the entry
// points. The kernels and their launch are in seaice_advect.cuh (the
// tests' host check builds them too).

#include "seaice_advect.cuh"

// HEFF, AREA and HSNOW, and ntr (0 or more) ice tracers besides: tr holds
// the old tracers [ntr, nyp, nxp], bit t of `mates` says tracer t rides on
// AREA (else HEFF)
#define MITGCM_SEAICE_ADVECT_ENTRY_POINTS(T, SUF)                            \
  extern "C" int mitgcm_seaice_advect_x_##SUF(                               \
      const void* const* table, int n, void* fld, const void* tr, void* dst, \
      int nyp, int nxp, int ol, int scheme, int ntr, int mates, double dt,   \
      void* stream) {                                                        \
    return mitgcm::launch_seaice_advect<T>(                                  \
        true, table, n, fld, nullptr, tr, dst, nyp, nxp, ol, scheme, ntr,    \
        mates, dt, 0.0, 0.0, 0.0, 0.0,                                       \
        mitgcm::OnStream{(cudaStream_t)stream});                             \
  }                                                                          \
  extern "C" int mitgcm_seaice_advect_y_##SUF(                               \
      const void* const* table, int n, const void* fld, const void* localT,  \
      const void* tr, void* dst, int nyp, int nxp, int ol, int scheme,       \
      int ntr, int mates, double dt, double kh0, double kh1, double kh2,     \
      double area_floor, void* stream) {                                     \
    return mitgcm::launch_seaice_advect<T>(                                  \
        false, table, n, fld, localT, tr, dst, nyp, nxp, ol, scheme, ntr,    \
        mates, dt, kh0, kh1, kh2, area_floor,                                \
        mitgcm::OnStream{(cudaStream_t)stream});                             \
  }

MITGCM_SEAICE_ADVECT_ENTRY_POINTS(float, f32)
MITGCM_SEAICE_ADVECT_ENTRY_POINTS(double, f64)
