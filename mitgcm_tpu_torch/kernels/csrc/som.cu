// Kernel H-SOM: second-order-moment (Prather 1986) tracer advection,
// schemes 80 (unlimited) and 81 (Prather's positive-definite limiter).
//
// Replaces: mitgcm_tpu/model/som.py:som_advect (:188-352) with
// _som_adv_horiz (:153-175), _face_fluxes (:51-90), _apply_updates
// (:93-150) and _limit_1d (:38-48), Cartesian grid, linear free surface,
// which XLA ran as fused passes over the tracer's content, volume and nine
// moments [9, nr, nyp, nxp].
//
// Three launches per tracer and step (som_tile.cuh, a header of its own
// for the tests' host check), each writing every cell of the padded array
// out of place:
//   som_x  the pass's start state from the tracer (volume rA drF hFacC +
//          (1 - maskC), content tracer times volume) and the moments smTr,
//          then the X pass: with scheme 81 Prather's limiter on the cell's
//          x moments (the JAX code limits the whole array first: each
//          cell's limited moments depend on that cell alone), the fluxes
//          through its west and east faces, and the updated volume,
//          content and nine moments.
//   som_y  the same in y on som_x's output.
//   som_r  the vertical limiter of scheme 81, the vertical pass with the
//          surface branch at k = 0 and the transport below it masked by
//          maskUp, the update of the interior columns, and gTracer =
//          (content - tracer volume) / (rA drF hFacC deltaT).
//
// Bound: bytes. Each pass reads the 11 fields of its input state and writes
// 11 (som_r: 10), with 2-5 grid and velocity fields: about 100 B/cell in
// float32 per pass, for ~300 flops and 4 divisions per cell. Design: each
// cell is loaded and limited once and each face's fluxes formed once, by
// a warp's lanes side by side in X and by walks down rows (Y) and columns
// (R) that carry them (som_tile.cuh). The
// JAX code computes every cell of the padded arrays with zero-filled shifts,
// so at the first padded column (X) and row (Y) the upwind cell it reads is
// all zeros and its volume 0: alp = fp_v / 0 is NaN or inf, and the update
// blend upd * new + (1 - upd) * old carries it into the cell. This kernel
// reproduces those cells as they are (the halo fill at the end of the step
// overwrites them). Each expression is written as the JAX code's (and the
// plain twins', model/som.py:_som_x_plain, _som_y_plain, _som_r_plain),
// keeping its operation order, the blends' 0 * x terms and the limiter's
// blend with its all-ones mask; the divisions are IEEE divisions, as the
// twins' tensor-by-tensor ones; built with --fmad=false the outputs are
// bit-equal to the twins, non-finite cells included.

#include "som_tile.cuh"

// table, its length; the pass's input volume, content and moments (the X
// pass starts from the tracer: null volume and content), its output volume,
// content and moments (null for R), gTracer (R only); nr, nyp, nxp,
// limiter (scheme % 10); deltaT; stream
#define MITGCM_SOM_ENTRY(SUF, T)                                              \
  extern "C" int mitgcm_som_x_##SUF(                                          \
      const void* const* table, int n, const void* volIn, const void* oIn,   \
      const void* smIn, void* volOut, void* oOut, void* smOut, void* gTr,    \
      const void* add, int nr, int nyp, int nxp, int limiter, double deltaT, \
      void* stream) {                                                        \
    return gTr != nullptr || add != nullptr                                  \
               ? (int)cudaErrorInvalidValue                                  \
               : mitgcm::som::launch_som_horiz<T, 0>(                        \
                     table, n, volIn, oIn, smIn, volOut, oOut, smOut, nr,    \
                     nyp, nxp, limiter, deltaT,                              \
                     mitgcm::OnStream{(cudaStream_t)stream});                \
  }                                                                          \
  extern "C" int mitgcm_som_y_##SUF(                                          \
      const void* const* table, int n, const void* volIn, const void* oIn,   \
      const void* smIn, void* volOut, void* oOut, void* smOut, void* gTr,    \
      const void* add, int nr, int nyp, int nxp, int limiter, double deltaT, \
      void* stream) {                                                        \
    return gTr != nullptr || add != nullptr                                  \
               ? (int)cudaErrorInvalidValue                                  \
               : mitgcm::som::launch_som_horiz<T, 1>(                        \
                     table, n, volIn, oIn, smIn, volOut, oOut, smOut, nr,    \
                     nyp, nxp, limiter, deltaT,                              \
                     mitgcm::OnStream{(cudaStream_t)stream});                \
  }                                                                          \
  extern "C" int mitgcm_som_r_##SUF(                                          \
      const void* const* table, int n, const void* volIn, const void* oIn,   \
      const void* smIn, void* volOut, void* oOut, void* smOut, void* gTr,    \
      const void* add, int nr, int nyp, int nxp, int limiter, double deltaT, \
      void* stream) {                                                        \
    return (volOut != nullptr || oOut != nullptr)                            \
               ? (int)cudaErrorInvalidValue                                  \
               : mitgcm::som::launch_som_r<T>(                               \
                     table, n, volIn, oIn, smIn, smOut, gTr, add, nr, nyp,   \
                     nxp, limiter, deltaT,                                   \
                     mitgcm::OnStream{(cudaStream_t)stream});                \
  }

MITGCM_SOM_ENTRY(f32, float)
MITGCM_SOM_ENTRY(f64, double)
