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

#include "common.cuh"

namespace mitgcm {

// find_rhop0.F / find_bulkmod.F (Jackett & McDougall 1995)
template <typename T>
__device__ T rho_p0(T t, T s) {
  const T s3o2 = s * sqrt(s > T(0) ? s : T(0));
  const T rfresh =
      T(999.842594) +
      t * (T(6.793952e-2) +
           t * (T(-9.095290e-3) +
                t * (T(1.001685e-4) +
                     t * (T(-1.120083e-6) + t * T(6.536332e-9)))));
  const T rsalt =
      s * (T(8.244930e-1) +
           t * (T(-4.089900e-3) +
                t * (T(7.643800e-5) +
                     t * (T(-8.246700e-7) + t * T(5.387500e-9))))) +
      s3o2 * (T(-5.724660e-3) + t * (T(1.022700e-4) + t * T(-1.654600e-6))) +
      s * s * T(4.831400e-4);
  return rfresh + rsalt;
}

template <typename T>
__device__ T bulkmod(T p, T t, T s) {
  const T s3o2 = s * sqrt(s > T(0) ? s : T(0));
  const T bfresh =
      T(1.965933e4) +
      t * (T(1.444304e2) +
           t * (T(-1.706103) + t * (T(9.648704e-3) + t * T(-4.190253e-5))));
  const T bsalt =
      s * (T(5.284855e1) +
           t * (T(-3.101089e-1) + t * (T(6.283263e-3) + t * T(-5.084188e-5)))) +
      s3o2 * (T(3.886640e-1) + t * (T(9.085835e-3) + t * T(-4.619924e-4)));
  const T bpres =
      p * (T(3.186519) +
           t * (T(2.212276e-2) + t * (T(-2.984642e-4) + t * T(1.956415e-6)))) +
      p * s * (T(6.704388e-3) + t * (T(-1.847318e-4) + t * T(2.059331e-7))) +
      p * s3o2 * T(1.480266e-4) +
      p * p * (T(2.102898e-4) + t * (T(-1.202016e-5) + t * T(1.394680e-7))) +
      p * p * s * (T(-2.040237e-6) + t * (T(6.128773e-8) + t * T(6.207323e-10)));
  return bfresh + bsalt + bpres;
}

// FIND_RHONUM and 1 / FIND_RHODEN (McDougall, Jackett, Wright & Feistel
// 2003); s1 of the numerator is max(s, 0), the denominator takes s itself
template <typename T>
__device__ T mdjwf_num(T t1, T s1, T p1) {
  const T t2 = t1 * t1;
  return T(9.99843699e+02) +
         t1 * (T(7.35212840e+00) +
               t1 * (T(-5.45928211e-02) + T(3.98476704e-04) * t1)) +
         s1 * (T(2.96938239e+00) + T(-7.23268813e-03) * t1 +
               T(2.12382341e-03) * s1) +
         p1 * (T(1.04004591e-02) + T(1.03970529e-07) * t2 +
               T(5.18761880e-06) * s1 +
               p1 * (T(-3.24041825e-08) + T(-1.23869360e-11) * t2));
}

template <typename T>
__device__ T mdjwf_recip_den(T t1, T s, T p1) {
  const T t2 = t1 * t1;
  const T s1 = s > T(0) ? s : T(0);
  const T sp5 = sqrt(s1);
  const T p1t1 = p1 * t1;
  const T den =
      T(1.00000000e+00) +
      t1 * (T(7.28606739e-03) +
            t1 * (T(-4.60835542e-05) +
                  t1 * (T(3.68390573e-07) + t1 * T(1.80809186e-10)))) +
      s1 * (T(2.14691708e-03) +
            t1 * (T(-9.27062484e-06) + T(-1.78343643e-10) * t2) +
            sp5 * (T(4.76534122e-06) + T(1.63410736e-09) * t2)) +
      p1 * (T(5.30848875e-06) +
            p1t1 * (T(-3.03175128e-16) * t2 + T(-1.27934137e-17) * p1));
  return T(1) / den;
}

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
