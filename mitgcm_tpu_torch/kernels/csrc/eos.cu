// Kernel R: in-situ density anomaly rho - rhoConst, and the vertical
// density gradient sigmaR that GGL90 and GM-Redi read.
//
// Replaces: mitgcm_tpu/ops/eos.py:find_rho (:218) on its z-coordinate
// branches LINEAR (:226-232), JMD95Z/JMD95P/UNESCO (:233-254: rho_p0 :44
// over one minus p over the secant bulk modulus bulkmod :56) and MDJWF
// (:270-275: _mdjwf_num :89 times the reciprocal _mdjwf_den :98), with the
// pressure of _pressure_for_eos (:72), and the step's rhoInSitu * maskC
// (mitgcm_tpu/model/step.py); and calc_sigmaR (mitgcm_tpu/model/
// thermodynamics.py:154-184) in z-coordinates, whose find_rho of the
// shifted tracers and difference XLA fused into one pass on the TPU.
//
// Bound: bytes. eos_find_rho reads theta and salt (and totPhiHyd when
// selectP_inEOS_Zc = 2, maskC when given) and writes rho, 12-20 B/cell in
// float32, for about 60 flops (JMD95), 40 and one division (MDJWF) or 6
// (LINEAR); eos_sigma_r reads theta, salt, maskC and rhoInSitu (and
// totPhiHyd) and writes sigmaR, 20-24 B/cell.
// Kernel R' (eos_linear_adj) is the LINEAR kind's VJP in theta and salt,
// the gyre's adjoint's (eos.cuh).
// Design: the kernels and their launches are in eos.cuh. eos_find_rho is
// one thread a cell over the flat [nr, nyp, nxp] array; eos_sigma_r one
// thread a padded cell of a cell_grid (common.cuh), reading theta[k-1] and
// salt[k-1] in place (no shifted copies) through the same Eos::rho. The
// pressure is the static profile[k] (bar or dbar, computed by the wrapper
// exactly as the twin does), or rhoConst * (totPhiHyd + profile[k]) + dp0
// scaled to bar or dbar; the LINEAR kind reads tRef and sRef, which the
// wrapper keeps on the card. Each polynomial keeps the JAX code's Horner
// order and its s * sqrt(max(s, 0)) guards, so with --fmad=false the
// results are bit-equal to the plain PyTorch twins (ops/eos.py:
// _find_rho_plain, model/thermodynamics.py:_calc_sigmaR_plain).

#include "eos.cuh"

#define MITGCM_EOS_ENTRY_POINTS(T, SUF)                                       \
  extern "C" int mitgcm_eos_find_rho_##SUF(                                   \
      const void* const* table, int n, const double* params, int np, int nr,  \
      int plane, int kind, int use_phi, int use_mask, void* stream) {         \
    return mitgcm::launch_find_rho<T>(                                        \
        table, n, params, np, nr, plane, kind, use_phi, use_mask,             \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }                                                                           \
  extern "C" int mitgcm_eos_sigma_r_##SUF(                                    \
      const void* const* table, int n, const double* params, int np, int nr,  \
      int nyp, int nxp, int kind, int use_phi, void* stream) {                \
    return mitgcm::launch_sigma_r<T>(                                         \
        table, n, params, np, nr, nyp, nxp, kind, use_phi,                    \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }                                                                           \
  extern "C" int mitgcm_eos_linear_adj_##SUF(                                 \
      const void* const* table, int n, int nr, int plane, double rhoNil,      \
      double tAlpha, double sBeta, void* stream) {                            \
    return mitgcm::launch_eos_linear_adj<T>(                                  \
        table, n, nr, plane, rhoNil, tAlpha, sBeta,                           \
        mitgcm::OnStream{(cudaStream_t)stream});                              \
  }

MITGCM_EOS_ENTRY_POINTS(float, f32)
MITGCM_EOS_ENTRY_POINTS(double, f64)
