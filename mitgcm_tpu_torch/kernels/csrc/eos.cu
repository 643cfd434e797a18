// Kernel R: in-situ density anomaly rho - rhoConst of the nonlinear
// equations of state.
//
// Replaces: mitgcm_tpu/ops/eos.py:find_rho (:218) on its z-coordinate
// branches JMD95Z/JMD95P/UNESCO (:233-254: rho_p0 :44 over one minus p over
// the secant bulk modulus bulkmod :56) and MDJWF (:270-275: _mdjwf_num :89
// times the reciprocal _mdjwf_den :98), with the pressure of
// _pressure_for_eos (:72). XLA fused the polynomials into one elementwise
// pass on the TPU.
//
// Bound: bytes. Per cell it reads theta and salt (and totPhiHyd when
// selectP_inEOS_Zc = 2) and writes rho, 12-16 B/cell in float32, for about
// 60 flops (JMD95) or 40 and one division (MDJWF).
// Design: one thread per cell, elementwise over the flat [nr, nyp, nxp]
// array. The pressure is the static profile[k] (bar or dbar, computed by
// the wrapper exactly as the twin does), or rhoConst * (totPhiHyd +
// profile[k]) + dp0 scaled to bar or dbar. Each polynomial keeps the JAX
// code's Horner order and its s * sqrt(max(s, 0)) guards, so with
// --fmad=false the result is bit-equal to the plain PyTorch twin
// (ops/eos.py:_find_rho_nonlinear_plain).

#include "eos.cuh"

namespace mitgcm {

template <typename T>
__global__ void eos_kernel(const T* __restrict__ theta,
                           const T* __restrict__ salt,
                           const T* __restrict__ phi,
                           const T* __restrict__ profile, T* __restrict__ rho,
                           int nr, int plane, int kind, int use_phi,
                           T rhoConst, T dp0, T scale) {
  const size_t n = static_cast<size_t>(nr) * plane;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= n) return;
  const int k = static_cast<int>(idx / plane);
  const T t = theta[idx], s = salt[idx];
  const T p = use_phi ? (rhoConst * (phi[idx] + profile[k]) + dp0) * scale
                      : profile[k];
  if (kind == 0) {
    const T rp0 = rho_p0(t, s);
    const T bm = bulkmod(p, t, s);
    rho[idx] = rp0 / (T(1) - p / bm) - rhoConst;
  } else {
    const T s1 = s > T(0) ? s : T(0);
    rho[idx] = mdjwf_num(t, s1, p) * mdjwf_recip_den(t, s, p) - rhoConst;
  }
}

template <typename T>
int launch_eos(const void* theta, const void* salt, const void* phi,
               const void* profile, void* rho, int nr, int plane, int kind,
               int use_phi, double rhoConst, double dp0, double scale,
               void* stream) {
  if (kind < 0 || kind > 1) return (int)cudaErrorInvalidValue;
  const size_t n = static_cast<size_t>(nr) * plane;
  const int threads = 256;
  const unsigned int blocks = static_cast<unsigned int>((n + threads - 1) /
                                                        threads);
  eos_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)theta, (const T*)salt, (const T*)phi, (const T*)profile,
      (T*)rho, nr, plane, kind, use_phi, T(rhoConst), T(dp0), T(scale));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

extern "C" int mitgcm_eos_find_rho_f32(const void* theta, const void* salt,
                                       const void* phi, const void* profile,
                                       void* rho, int nr, int plane,
                                       int kind, int use_phi,
                                       double rhoConst, double dp0,
                                       double scale, void* stream) {
  return mitgcm::launch_eos<float>(theta, salt, phi, profile, rho, nr, plane,
                                   kind, use_phi, rhoConst, dp0, scale,
                                   stream);
}

extern "C" int mitgcm_eos_find_rho_f64(const void* theta, const void* salt,
                                       const void* phi, const void* profile,
                                       void* rho, int nr, int plane,
                                       int kind, int use_phi,
                                       double rhoConst, double dp0,
                                       double scale, void* stream) {
  return mitgcm::launch_eos<double>(theta, salt, phi, profile, rho, nr,
                                    plane, kind, use_phi, rhoConst, dp0,
                                    scale, stream);
}
