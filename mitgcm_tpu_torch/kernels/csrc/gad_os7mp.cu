// Kernel O: direction-split multi-dimensional advection of one tracer with
// OS7MP, the one-step seventh-order monotonicity-preserving scheme 7.
//
// Replaces: mitgcm_tpu/model/gad.py:os7mp_psi (:103-178), os7mp_flux_x/y
// (:181-204) with os7mp_band (:207-218), and _os7mp_flux_r (:221-266),
// inside multidim_advection's X, Y and R passes (:1120-1154), which XLA
// fused into one pass per direction over the padded [nr, nyp, nxp] arrays
// on the TPU.
//
// Three launches per tracer, one per sweep: gad_os7mp_x, _y and _r
// (gad_os7mp_tile.cuh, a header of its own for the tests' host check).
//
// Bound: bytes. Per sweep a cell reads its input field, the tracer, one
// transport and one velocity, recip_hFacC, the face mask and its column
// factors and writes one field (~7-8 fields, ~30 B/cell in float32). About
// 90 flops and nine IEEE divisions per face.
// Design: X stages tiles with the stencil's margin in shared memory; Y
// walks chunks of rows and R whole columns with the stencil's 8 rows or
// levels in registers; each forms each face's flux once. One evaluation of
// the scheme a face, on the upwind side's stencil picked by the
// transport's sign (JAX computes both upwind directions and
// selects; the selected one has the same bits). The write band (x columns
// / y rows [4, n - 3)) multiplies the flux as the JAX code does.
// Neighbours outside the padded array read 0 (the zero-filled shifts), and
// the vertical levels clamp at the column ends with the mask factors
// float(k_hi - k_lo) of the clamped indices. The discrete choices
// (sign(d) / max(|d|, Eps) with 1 / Eps where d == 0, the median and the
// PhiMin / PhiMax clips) are the twin's (model/gad_ho.py:os7mp_psi), and
// built with --fmad=false the result is bit-equal to it.

#include "gad_os7mp_tile.cuh"

#define MITGCM_O_ENTRY(NAME, DIR, SUF, T)                                      \
  extern "C" int mitgcm_gad_os7mp_##NAME##_##SUF(                              \
      const void* const* table, int n, const void* src, void* dst,           \
      const void* add, int nr,                                                 \
      int nyp, int nxp, int scheme, double deltaT, double rkSign,             \
      void* stream) {                                                          \
    return mitgcm::launch_os7mp<T, DIR>(                                      \
        table, n, src, dst, add, nr, nyp, nxp, scheme, deltaT, rkSign,        \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_O_ENTRY(x, 0, f32, float)
MITGCM_O_ENTRY(x, 0, f64, double)
MITGCM_O_ENTRY(y, 1, f32, float)
MITGCM_O_ENTRY(y, 1, f64, double)
MITGCM_O_ENTRY(r, 2, f32, float)
MITGCM_O_ENTRY(r, 2, f64, double)
