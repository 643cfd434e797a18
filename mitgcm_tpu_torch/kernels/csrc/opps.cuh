// Kernel Z (opps_col): OPPS penetrative plume convection, and its launch.
// Included by opps.cu, whose entry points start it on the card, and by the
// host check of the tests, which runs it on the CPU.
//
// One thread walks one (j, i) column of the whole padded plane, i fastest,
// as the reference's opps_calc.F walks one column: for each launch level k
// from the top (k < kLowC - 1), a plume of the level's water descends
// level by level, entraining its surroundings, while it is denser than
// them (the first step only if the interface is statically unstable by
// STABILITY_THRESHOLD), its mass flux stays positive and its vertical
// velocity real (mitgcm_tpu/model/opps.py:135-200); where it got below its
// launch level, the environment is then adjusted by the plume's mass flux
// over ntime sub-steps of dt (the time step that its velocity takes to
// cross a level, :207-275), MAX_ABE_ITERATIONS times, and the next launch
// sees the adjusted column. The JAX code runs every loop over every column
// with alive masks; the kernel runs the iterations that its masks leave
// live and skips the others, which change nothing: the descent from the
// launch level until the plume dies, the time-step scan (`dtloop`, folded
// into the descent: its live levels are the plume's successful steps) and
// ntime sub-steps over the levels from the launch to the plume's depth.
// Each expression keeps the twin's operation order (model/opps.py:
// _opps_plain, the JAX code's), FIND_RHO_SCALAR is eos.cuh's polynomials,
// divisions and square roots are IEEE, and int32 truncations are C's, so
// with --fmad=false the outputs are bit-equal to the twin's.
//
// Bound: the larger of bytes (theta, salt, maskC and totPhiHyd or w read,
// theta', salt' and the count written) and operations, which depend on the
// data: three equations of state a descent step, a few operations a level a
// sub-step (chip_smoke.py counts the live iterations of its inputs).
// Design: a column's environment (theta, salt), plume profile (Pd's theta
// and salt) and mass flux mda live in dynamic shared memory, five values a
// level of each of a block's 32 columns (slot k * 32 + lane, so a warp's
// accesses fall in distinct banks), and no per-thread array; the plume's
// other state (density, velocity, entrainment of the level above) rides in
// registers from one step to the next. Columns outside the interior are
// computed like the interior ones (the step's fill overwrites them).
#pragma once

#include "common.cuh"
#include "eos.cuh"

namespace mitgcm {

// theta, salt, wVel (read with useGCMwVel), totPhiHyd (read with use_phi),
// STATE1's pressure profile [nr] (phiRef with use_phi, else -rhoConst rC
// g), maskC, drF and recip_drF [nr], kLowC (int32 [nyp, nxp]); outputs
// theta', salt', convectCount
template <typename T>
struct OppsArgs {
  const T *theta, *salt, *w, *phi, *profile, *maskC, *drF, *recip_drF;
  const int* kLowC;
  T *theta_out, *salt_out, *count;
};
constexpr int kOppsPointers = 12;

// the launch's doubles (model/opps.py:z_params)
struct OppsParams {
  double rhoConst, rhoNil, tAlpha, sBeta, tref0, sref0, scale, gravity,
      dtts, e2, stab, radius, frac, vertVel;
};
constexpr int kOppsParams = 14;

constexpr int kZColumns = 32;
// The most levels a launch takes: five values a level of a block's
// columns within max_shared bytes.
inline int opps_max_nr(size_t max_shared, size_t bytes) {
  return static_cast<int>(max_shared / (5 * kZColumns * bytes));
}

// FIND_RHO_SCALAR: the full density at a pressure in Pa, kind 0
// (JMD95Z/JMD95P/UNESCO), 1 (MDJWF) or 2 (LINEAR on the surface tRef and
// sRef)
template <typename T>
__device__ __forceinline__ T rho_scalar(const OppsParams& q, int kind, T t,
                                        T s, T p_pa) {
  if (kind == 2)
    return T(q.rhoNil) * (T(q.sBeta) * (s - T(q.sref0)) -
                          T(q.tAlpha) * (t - T(q.tref0))) +
           T(q.rhoNil);
  const T p = p_pa * T(q.scale);
  if (kind == 1) {
    const T s1 = s > T(0) ? s : T(0);
    return mdjwf_num(t, s1, p) * mdjwf_recip_den(t, s, p);
  }
  return rho_p0(t, s) / (T(1) - p / bulkmod(p, t, s));
}

// where(x == 0, 1, x)
template <typename T>
__device__ __forceinline__ T nonzero(T x) {
  return x == T(0) ? T(1) : x;
}

template <typename T>
__global__ void opps_col_kernel(const OppsArgs<T> a, const OppsParams q,
                                int nr, int nyp, int nxp, int kind,
                                int use_phi, int max_abe) {
  constexpr int C = kZColumns;
  const int c = threadIdx.x, col = blockIdx.x * C + c;
  const int plane = nyp * nxp;
  if (col >= plane) return;
  const size_t P = static_cast<size_t>(plane);
  const size_t L = static_cast<size_t>(nr) * C;
  // the column's slots: the environment, the plume profile, the mass flux
  T* const envT = dynamic_shared<T>() + c;
  T* const envS = envT + L;
  T* const pdT = envS + L;
  T* const pdS = pdT + L;
  T* const mda = pdS + L;
  const T rhoConst = T(q.rhoConst), g = T(q.gravity), dtts = T(q.dtts);
  const T e2 = T(q.e2), stab = T(q.stab), frac = T(q.frac), half = T(0.5);
  // STATE1: the density of (t, s) at level kr's reference pressure
  auto state1 = [&](T s, T t, int kr) -> T {
    const size_t pk = kr * P + col;
    const T mk = a.maskC[pk];
    const T pLoc = use_phi ? (rhoConst * (a.phi[pk] + a.profile[kr])) * mk
                           : a.profile[kr] * mk;
    return rho_scalar(q, kind, t, s, pLoc);
  };

  for (int k = 0; k < nr; ++k) {
    envT[k * C] = a.theta[k * P + col];
    envS[k * C] = a.salt[k * P + col];
  }
  const int kMax = a.kLowC[col];
  for (int k = 0; k < nr - 1; ++k) {
    a.count[k * P + col] = T(0);
    if (!(k < kMax - 1 && kMax >= 1)) continue;
    // the launch (opps.py:111-133)
    const T tk = envT[k * C], sk = envS[k * C];
    pdT[k * C] = tk;
    pdS[k * C] = sk;
    const T Ddk = state1(sk, tk, k);
    const T Wdk = a.w ? T(-0.5) * (a.w[k * P + col] + a.w[(k + 1) * P + col])
                      : T(q.vertVel);
    T wsqr = Wdk * Wdk;
    T radius = T(q.radius);
    const T SF = ((radius * radius) * Wdk) * Ddk;
    T oldflux = SF, dz2 = a.drF[k];
    // level k2's plume density, environment density, velocity, profile
    // and entrainment, carried from the step that reached it
    T Dd = Ddk, De = Ddk, Wd = Wdk, Pt = tk, Ps = sk, PE = T(0);
    int maxdepth = kMax - 1;
    // the time-step scan, over the plume's successful steps
    T dt = dtts;
    int ntime = 1;
    const T Md = Wdk * frac;
    // the descent (:135-190)
    for (int k2 = k; k2 <= kMax - 2; ++k2) {
      const int ip1 = k2 + 1;
      const T D1 = state1(Ps, Pt, ip1);
      const T eT1 = envT[ip1 * C], eS1 = envS[ip1 * C];
      const T De_n = state1(eS1, eT1, ip1);
      const bool go = (De_n - D1 < stab) || k2 != k;
      const T dz1 = dz2, dz2n = a.drF[ip1];
      const T newflux =
          oldflux + ((((e2 * radius) * Wd) * Dd) * half) * (dz1 + dz2n);
      const T pe = newflux / nonzero(SF);
      const bool flux_ok = newflux > T(0);
      const T entr = (newflux - oldflux) / (flux_ok ? newflux : T(1));
      const T dzs = dz1 + dz2n;
      const T pmT = (dz1 * envT[k2 * C] + dz2n * eT1) / dzs;
      const T pmS = (dz1 * envS[k2 * C] + dz2n * eS1) / dzs;
      const T PtN = Pt - entr * (pmT - Pt);
      const T PsN = Ps - entr * (pmS - Ps);
      const T DdN = state1(PsN, PtN, ip1);
      const T wsqr_n = (wsqr - wsqr * fabs(entr)) +
                       g * ((dz1 * (Dd - De)) / nonzero(De) +
                            (dz2n * (DdN - De_n)) / nonzero(De_n));
      if (!(go && flux_ok && wsqr_n > T(0))) {
        maxdepth = k2;
        break;
      }
      const T WdN = sqrt(wsqr_n);
      const T denom = Wd * Dd;
      radius = sqrt(max_nan(newflux, T(0)) / nonzero(denom));
      wsqr = wsqr_n;
      oldflux = newflux;
      dz2 = dz2n;
      pdT[ip1 * C] = PtN;
      pdS[ip1 * C] = PsN;
      // dtloop's level k2 (:207-226): Wd[k2] is this step's Wd
      const T dt_n = Wd != T(0) ? min_nan(dt, a.drF[k2] / nonzero(Wd)) : dt;
      const int nt = static_cast<int>(
          half * static_cast<T>(static_cast<int>(dtts / dt_n)) + half);
      dt = dt_n;
      ntime = nt > 1 ? nt : 1;
      const T Mk2 = k2 == k ? Md : Md * PE;
      mda[k2 * C] = (Mk2 * a.drF[k2] + (Md * pe) * a.drF[ip1]) /
                    (a.drF[k2] + a.drF[ip1]);
      Dd = DdN;
      De = De_n;
      Wd = WdN;
      Pt = PtN;
      Ps = PsN;
      PE = pe;
    }
    if (!(maxdepth > k)) continue;
    // the environment's adjustment (:200-275): ntime sub-steps over the
    // levels k..kmx and the one below
    dt = min_nan(dt, dtts);
    const int kmx = maxdepth - 1;
    for (int it = 0; it < max_abe; ++it) {
      for (int nn = 0; nn < ntime; ++nn) {
        T prevT = T(0), prevS = T(0);
        for (int kk = k; kk <= kmx; ++kk) {
          const T m = mda[kk * C];
          const T dT = (m * (pdT[kk * C] - envT[(kk + 1) * C])) * dt;
          const T dS = (m * (pdS[kk * C] - envS[(kk + 1) * C])) * dt;
          const T r = a.recip_drF[kk];
          if (kk == k) {
            envT[kk * C] = envT[kk * C] + (-dT) * r;
            envS[kk * C] = envS[kk * C] + (-dS) * r;
          } else {
            envT[kk * C] = envT[kk * C] + (prevT - dT) * r;
            envS[kk * C] = envS[kk * C] + (prevS - dS) * r;
          }
          prevT = dT;
          prevS = dS;
        }
        const int kb = kmx + 1;
        envT[kb * C] = envT[kb * C] + prevT * a.recip_drF[kb];
        envS[kb * C] = envS[kb * C] + prevS * a.recip_drF[kb];
      }
    }
    a.count[k * P + col] = T(1);
  }
  a.count[(nr - 1) * P + col] = T(0);
  for (int k = 0; k < nr; ++k) {
    a.theta_out[k * P + col] = envT[k * C];
    a.salt_out[k * P + col] = envS[k * C];
  }
}

// Kernel Z's launch from its entry point's arguments: the table's and the
// flags' checks, the columns a block and their shared memory;
// start.shared(kernel, bytes, grid, block, args...) starts it (OnStream on
// the card), start.max_shared() is the card's limit of a block's shared
// memory.
template <typename T, typename Start>
int launch_opps_col(const void* const* table, int n, const double* params,
                    int np, int nr, int nyp, int nxp, int kind, int use_phi,
                    int max_abe, Start start) {
  static_assert(sizeof(OppsArgs<T>) == kOppsPointers * sizeof(void*),
                "OppsArgs must be a plain table of pointers");
  static_assert(sizeof(OppsParams) == kOppsParams * sizeof(double),
                "OppsParams must be a plain array of doubles");
  OppsArgs<T> a;
  if (!unpack(&a, table, n, kOppsPointers) || np != kOppsParams || nr < 1 ||
      nr > opps_max_nr(start.max_shared(), sizeof(T)) || nyp < 1 ||
      nxp < 1 || kind < 0 || kind > 2 || max_abe < 0 ||
      (use_phi && !a.phi) ||
      !(a.theta && a.salt && a.profile && a.maskC && a.drF && a.recip_drF &&
        a.kLowC && a.theta_out && a.salt_out && a.count))
    return (int)cudaErrorInvalidValue;
  OppsParams q;
  std::memcpy(&q, params, sizeof(q));
  const long long plane = static_cast<long long>(nyp) * nxp;
  const dim3 grid(static_cast<unsigned>((plane + kZColumns - 1) /
                                        kZColumns)),
      block(kZColumns);
  start.shared(opps_col_kernel<T>,
               5 * static_cast<size_t>(nr) * kZColumns * sizeof(T), grid,
               block, a, q, nr, nyp, nxp, kind, use_phi, max_abe);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
