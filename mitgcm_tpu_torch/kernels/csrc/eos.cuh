// The equations of state as device functions, shared by kernel R (eos.cu)
// and kernel K (kpp.cu): the density polynomials of Jackett & McDougall
// 1995 and McDougall, Jackett, Wright & Feistel 2003 (mitgcm_tpu/ops/
// eos.py:44-109), the linear EOS, and d(rho)/d(theta) and d(rho)/d(salt)
// (find_alpha :112, find_beta :175). Each keeps the association order of
// the JAX code and of the port's plain twins (ops/eos.py); a Python
// constant product such as 2.0 * c is formed in double, as Python forms it,
// and then rounded to T, so with --fmad=false the kernels agree with the
// twins bit for bit. Kernel R's two kernels and their launches are here
// too, for the tests' host check: eos_find_rho (rho - rhoConst of every
// cell, times maskC when given) and eos_sigma_r (calc_sigmaR's vertical
// density gradient).
#pragma once

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

// The EOS of one cell at reference level k: kind 0 (JMD95Z/JMD95P/UNESCO),
// 1 (MDJWF) or 2 (LINEAR). The pressure is profile[k], or, with use_phi,
// (rhoConst * (phi + profile[k]) + dp0) * scale from the hydrostatic
// potential phi of the cell at level k (ops/eos.py:_pressure_terms).
template <typename T>
struct Eos {
  int kind, use_phi;
  T rhoConst, dp0, scale, rhoNil, tAlpha, sBeta, drho, alpha_lin, beta_lin;
  const T *profile, *aprof, *tref, *sref;

  __device__ T pressure(const T* prof, int k, T phi) const {
    return use_phi ? (rhoConst * (phi + prof[k]) + dp0) * scale : prof[k];
  }
  // rho - rhoConst (find_rho)
  __device__ T rho(T t, T s, int k, T phi) const {
    if (kind == 2)
      return rhoNil * (sBeta * (s - sref[k]) - tAlpha * (t - tref[k])) +
             drho;
    const T p = pressure(profile, k, phi);
    if (kind == 0) return rho_p0(t, s) / (T(1) - p / bulkmod(p, t, s)) -
                          rhoConst;
    const T s1 = s > T(0) ? s : T(0);
    return mdjwf_num(t, s1, p) * mdjwf_recip_den(t, s, p) - rhoConst;
  }
  // d(rho)/d(theta) (find_alpha), the pressure from aprof
  __device__ T alpha(T t1, T salt, int k, T phi) const;
  // d(rho)/d(salt) (find_beta)
  __device__ T beta(T t1, T salt, int k, T phi) const;
};

template <typename T>
__device__ T Eos<T>::alpha(T t1, T salt, int k, T phi) const {
  if (kind == 2) return alpha_lin;
  const T p1 = pressure(aprof, k, phi);
  const T t2 = t1 * t1;
  const T s1 = salt > T(0) ? salt : T(0);
  if (kind == 1) {
    const T sp5 = sqrt(s1);
    const T p1t1 = p1 * t1;
    const T rhoDen = mdjwf_recip_den(t1, salt, p1);
    const T rhoLoc = mdjwf_num(t1, s1, p1);
    const T dnum_dt =
        T(7.35212840e+00) +
        t1 * (T(2.0 * -5.45928211e-02) + T(3.0 * 3.98476704e-04) * t1) +
        T(-7.23268813e-03) * s1 +
        p1t1 * (T(2.0 * 1.03970529e-07) + T(2.0 * -1.23869360e-11) * p1);
    const T dden_dt =
        T(7.28606739e-03) +
        t1 * (T(2.0 * -4.60835542e-05) +
              t1 * (T(3.0 * 3.68390573e-07) + T(4.0 * 1.80809186e-10) * t1)) +
        s1 * (T(-9.27062484e-06) +
              t1 * (T(3.0 * -1.78343643e-10) * t1 +
                    T(2.0 * 1.63410736e-09) * sp5)) +
        p1 * p1 * (T(3.0 * -3.03175128e-16) * t2 + T(-1.27934137e-17) * p1);
    return rhoDen * (dnum_dt - (rhoLoc * rhoDen) * dden_dt);
  }
  const T t3 = t2 * t1;
  const T s3o2 = sqrt(s1 * s1 * s1);
  const T p2 = p1 * p1;
  const T drhoP0dt =
      T(6.793952e-2) + T(2.0 * -9.095290e-3) * t1 +
      T(3.0 * 1.001685e-4) * t2 + T(4.0 * -1.120083e-6) * t3 +
      T(5.0 * 6.536332e-9) * t3 * t1 +
      s1 * (T(-4.089900e-3) + T(2.0 * 7.643800e-5) * t1 +
            T(3.0 * -8.246700e-7) * t2 + T(4.0 * 5.387500e-9) * t3) +
      s3o2 * (T(1.022700e-4) + T(2.0 * -1.654600e-6) * t1);
  const T dKdt =
      T(1.444304e2) + T(2.0 * -1.706103) * t1 + T(3.0 * 9.648704e-3) * t2 +
      T(4.0 * -4.190253e-5) * t3 +
      s1 * (T(-3.101089e-1) + T(2.0 * 6.283263e-3) * t1 +
            T(3.0 * -5.084188e-5) * t2) +
      s3o2 * (T(9.085835e-3) + T(2.0 * -4.619924e-4) * t1) +
      p1 * (T(2.212276e-2) + T(2.0 * -2.984642e-4) * t1 +
            T(3.0 * 1.956415e-6) * t2) +
      p1 * s1 * (T(-1.847318e-4) + T(2.0 * 2.059331e-7) * t1) +
      p2 * (T(-1.202016e-5) + T(2.0 * 1.394680e-7) * t1) +
      p2 * s1 * (T(6.128773e-8) + T(2.0 * 6.207323e-10) * t1);
  const T K = bulkmod(p1, t1, s1);
  const T rp0 = rho_p0(t1, s1);
  const T Kp = K - p1;
  return (K * K * drhoP0dt - K * p1 * drhoP0dt - rp0 * p1 * dKdt) /
         (Kp * Kp);
}

template <typename T>
__device__ T Eos<T>::beta(T t1, T salt, int k, T phi) const {
  if (kind == 2) return beta_lin;
  const T p1 = pressure(aprof, k, phi);
  const T t2 = t1 * t1;
  const T s1 = salt > T(0) ? salt : T(0);
  if (kind == 1) {
    const T sp5 = sqrt(s1);
    const T rhoDen = mdjwf_recip_den(t1, salt, p1);
    const T rhoLoc = mdjwf_num(t1, s1, p1);
    const T dnum_ds = T(2.96938239e+00) + T(-7.23268813e-03) * t1 +
                      T(2.0 * 2.12382341e-03) * s1 + T(5.18761880e-06) * p1;
    const T dden_ds =
        T(2.14691708e-03) +
        t1 * (T(-9.27062484e-06) + T(-1.78343643e-10) * t2) +
        T(1.5) * sp5 * (T(4.76534122e-06) + T(1.63410736e-09) * t2);
    return rhoDen * (dnum_ds - (rhoLoc * rhoDen) * dden_ds);
  }
  const T t3 = t2 * t1;
  const T s3o2 = T(1.5) * sqrt(s1);
  const T drhoP0dS =
      T(8.244930e-1) + T(-4.089900e-3) * t1 + T(7.643800e-5) * t2 +
      T(-8.246700e-7) * t3 + T(5.387500e-9) * t3 * t1 +
      s3o2 * (T(-5.724660e-3) + T(1.022700e-4) * t1 + T(-1.654600e-6) * t2) +
      T(2.0 * 4.831400e-4) * s1;
  const T dKdS =
      T(5.284855e1) + T(-3.101089e-1) * t1 + T(6.283263e-3) * t2 +
      T(-5.084188e-5) * t3 +
      s3o2 * (T(3.886640e-1) + T(9.085835e-3) * t1 + T(-4.619924e-4) * t2) +
      p1 * (T(6.704388e-3) + T(-1.847318e-4) * t1 + T(2.059331e-7) * t2) +
      s3o2 * p1 * T(1.480266e-4) +
      p1 * p1 * (T(-2.040237e-6) + T(6.128773e-8) * t1 + T(6.207323e-10) * t2);
  const T K = bulkmod(p1, t1, s1);
  const T rp0 = rho_p0(t1, s1);
  const T Kp = K - p1;
  return (K * K * drhoP0dS - K * p1 * drhoP0dS - rp0 * p1 * dKdS) /
         (Kp * Kp);
}

// Kernel R's pointers: eos_find_rho's theta, salt, totPhiHyd (read with
// use_phi), the pressure profile [nr] (nonlinear kinds), tRef and sRef [nr]
// (LINEAR), maskC (optional) and the output rho
template <typename T>
struct EosArgs {
  const T *theta, *salt, *phi, *profile, *tref, *sref, *mask;
  T* rho;
};
constexpr int kEosNumPointers = 8;

// eos_sigma_r's: those of eos_find_rho (maskC not optional), recip_drC
// [nr + 1], rhoInSitu and the output sigmaR
template <typename T>
struct SigmaRArgs {
  const T *theta, *salt, *phi, *profile, *tref, *sref, *maskC, *recip_drC,
      *rhoInSitu;
  T* sigmaR;
};
constexpr int kSigmaRNumPointers = 10;

// The Eos of a launch from its host parameters: rhoConst, dp0, the
// pressure scale, rhoNil, tAlpha, sBeta, rhoNil - rhoConst (each rounded to
// T as PyTorch rounds a Python number against a tensor)
template <typename T>
Eos<T> eos_of(const double* prm, int kind, int use_phi, const T* profile,
              const T* tref, const T* sref) {
  return Eos<T>{kind,        use_phi,     T(prm[0]), T(prm[1]), T(prm[2]),
                T(prm[3]),   T(prm[4]),   T(prm[5]), T(prm[6]), T(0),
                T(0),        profile,     profile,   tref,      sref};
}

// rho - rhoConst of every cell (find_rho with kRef = k), times maskC with
// use_mask (forward_step's rhoInSitu)
template <typename T>
__global__ void eos_find_rho_kernel(EosArgs<T> a, Eos<T> e, int nr,
                                    int plane, int use_mask) {
  const size_t n = static_cast<size_t>(nr) * plane;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= n) return;
  const int k = static_cast<int>(idx / plane);
  const T rho = e.rho(a.theta[idx], a.salt[idx], k,
                      e.use_phi ? a.phi[idx] : T(0));
  a.rho[idx] = use_mask ? rho * a.mask[idx] : rho;
}

// calc_sigmaR in z-coordinates (grad_sigma.F:95-107, do_oceanic_phys.F:
// 807-830; mitgcm_tpu/model/thermodynamics.py:154-184): below the surface
// the k-1 water's density at level k's pressure (theta[k-1] and salt[k-1]
// through Eos::rho at k, totPhiHyd[k] under use_phi) against rhoInSitu[k],
// (((maskC[k] * maskC[k-1]) * recip_drC[k]) * rkSign) * (rhoInSitu[k] -
// rho); 0 at the surface
template <typename T>
__global__ void eos_sigma_r_kernel(SigmaRArgs<T> a, Eos<T> e, int nyp,
                                   int nxp, T rkSign) {
  GridCell c;
  if (!grid_cell_of(nyp, nxp, c)) return;
  if (c.k == 0) {
    a.sigmaR[c.p] = T(0);
    return;
  }
  const size_t up = c.p - static_cast<size_t>(nyp) * nxp;
  const T rho = e.rho(a.theta[up], a.salt[up], c.k,
                      e.use_phi ? a.phi[c.p] : T(0));
  a.sigmaR[c.p] = (((a.maskC[c.p] * a.maskC[up]) * a.recip_drC[c.k]) *
                   rkSign) * (a.rhoInSitu[c.p] - rho);
}

// A kind's inputs: the pressure profile for the nonlinear kinds, tRef and
// sRef for LINEAR, totPhiHyd with use_phi
template <typename T>
bool eos_inputs_ok(int kind, int use_phi, const T* phi, const T* profile,
                   const T* tref, const T* sref) {
  if (kind < 0 || kind > 2 || (use_phi && !phi)) return false;
  return kind == 2 ? tref && sref && !use_phi : profile != nullptr;
}

template <typename T, typename Start>
int launch_find_rho(const void* const* table, int n, const double* params,
                    int np, int nr, int plane, int kind, int use_phi,
                    int use_mask, Start start) {
  EosArgs<T> a;
  if (!unpack(&a, table, n, kEosNumPointers) || np != 7 || nr < 1 ||
      plane < 1 ||
      !eos_inputs_ok(kind, use_phi, a.phi, a.profile, a.tref, a.sref) ||
      (use_mask && !a.mask))
    return (int)cudaErrorInvalidValue;
  const Eos<T> e = eos_of<T>(params, kind, use_phi, a.profile, a.tref,
                             a.sref);
  const size_t cells = static_cast<size_t>(nr) * plane;
  const unsigned blocks = static_cast<unsigned>((cells + NT - 1) / NT);
  start(eos_find_rho_kernel<T>, dim3(blocks), dim3(NT), a, e, nr, plane,
        use_mask);
  return (int)cudaGetLastError();
}

template <typename T, typename Start>
int launch_sigma_r(const void* const* table, int n, const double* params,
                   int np, int nr, int nyp, int nxp, int kind, int use_phi,
                   Start start) {
  SigmaRArgs<T> a;
  if (!unpack(&a, table, n, kSigmaRNumPointers) || np != 8 || nr < 1 ||
      nyp < 1 || nxp < 1 ||
      !eos_inputs_ok(kind, use_phi, a.phi, a.profile, a.tref, a.sref))
    return (int)cudaErrorInvalidValue;
  const Eos<T> e = eos_of<T>(params, kind, use_phi, a.profile, a.tref,
                             a.sref);
  start(eos_sigma_r_kernel<T>, cell_grid(nr, nyp, nxp), dim3(kCellX, kCellY),
        a, e, nyp, nxp, T(params[7]));
  return (int)cudaGetLastError();
}

// Kernel R' (eos_linear_adj): the VJP of eos_find_rho's LINEAR kind in
// theta and salt. Replaces the VJP that jax.grad took of find_rho's
// LINEAR branch (mitgcm_tpu/ops/eos.py:226-232) times the step's maskC:
// the map is linear, so with r = (rho_bar * maskC) * rhoNil (rho_bar * rhoNil
// without the mask), theta_bar = (-r) * tAlpha and salt_bar = r * sBeta.
// Bound: bytes, it reads rho_bar and maskC and writes up to two fields (16
// B/cell in float32). Design: gather form, one thread a cell of the flat
// array; an output that the caller does not want has a null pointer and is
// not written; the order of ops/eos.py:eos_linear_vjp_plain, bit-equal to
// it with --fmad=false.
template <typename T>
struct EosLinearAdjArgs {
  // rho_bar, maskC (null: no mask); outputs theta_bar, salt_bar (null: not
  // wanted)
  const T *rho_bar, *mask;
  T *theta_bar, *salt_bar;
};
constexpr int kEosLinearAdjNumPointers = 4;

template <typename T>
__global__ void eos_linear_adj_kernel(EosLinearAdjArgs<T> a, size_t n,
                                      T rhoNil, T tAlpha, T sBeta) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= n) return;
  const T g = a.mask ? a.rho_bar[idx] * a.mask[idx] : a.rho_bar[idx];
  const T r = g * rhoNil;
  if (a.theta_bar) a.theta_bar[idx] = (-r) * tAlpha;
  if (a.salt_bar) a.salt_bar[idx] = r * sBeta;
}

template <typename T, typename Start>
int launch_eos_linear_adj(const void* const* table, int n, int nr, int plane,
                          double rhoNil, double tAlpha, double sBeta,
                          Start start) {
  EosLinearAdjArgs<T> a;
  if (!unpack(&a, table, n, kEosLinearAdjNumPointers) || nr < 1 ||
      plane < 1 || !a.rho_bar)
    return (int)cudaErrorInvalidValue;
  const size_t cells = static_cast<size_t>(nr) * plane;
  const unsigned blocks = static_cast<unsigned>((cells + NT - 1) / NT);
  start(eos_linear_adj_kernel<T>, dim3(blocks), dim3(NT), a, cells,
        T(rhoNil), T(tAlpha), T(sBeta));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
