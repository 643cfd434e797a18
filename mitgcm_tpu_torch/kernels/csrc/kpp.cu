// Kernel K: KPP boundary-layer mixing (Large, McWilliams & Doney 1994).
//
// Replaces: mitgcm_tpu/model/kpp.py:KPP.calc (:654-742) with STATEKPP
// (:197), kpp_forcing_surf.F without the reference-velocity estimate
// (:228-252), RI_IWMIX (:335), BLDEPTH (:374), WSCALE (:170), BLMIX (:449),
// ENHANCE (:524), KPPMIX (:555) and SMOOTH_HORIZ (:636), which XLA fused
// into a handful of passes over [nr+2, nyp, nxp] arrays on the TPU.
//
// Three launches per step:
//   kpp_pre    one thread per cell: the three densities of STATEKPP (the
//              cell's water, the water above it and the surface water, at
//              the cell's level), dbloc and Ritop with their masks, the
//              vertical shear with the KPP_SMOOTH_SHSQ blend and dVsq; the
//              surface threads also form ustar, bo and bosol (with
//              d(rho)/d(theta) and d(rho)/d(salt) of the surface water).
//   kpp_smooth one thread per cell (KPP_SMOOTH_DBLOC only): the masked
//              9-point filter of the raw dbloc.
//   kpp_col    one thread per column: RI_IWMIX, the two BLDEPTH searches and
//              the hbl interpolation with LimitHblStable, WSCALE's bilinear
//              table lookup, BLMIX, ENHANCE, the combine step, the transfer
//              masks and frac = swfrac(-hbl).
//
// Bound: bytes for kpp_pre and kpp_smooth (about 12 3-D fields read or
// written per cell, a few hundred flops); kpp_col reads 8 3-D fields and
// writes 4 (~48 B/cell in float32) but also makes ~3 nr wscale lookups per
// column into two 892 x 482 tables (1.7 MB each in float32), which stay in
// L2 and the read-only cache.
// Design: K-col keeps no per-level arrays. Every quantity that KPPMIX
// needs at a level (Rib, the interior diffusivities, the boundary-layer
// profiles) is a pure function of the level's inputs and a few column
// scalars, so it is recomputed where it is needed (the searches stop at
// their first hit), and the kernel has no maximum of nr. Each expression
// keeps the association order of the plain twins (model/kpp.py:
// _kpp_pre_plain, _kpp_col_plain), which replay the JAX code; the discrete
// choices (kbl, kn, casea, the first-index searches with their fall-backs
// and the clipped gathers) follow JAX's semantics; powers are the same
// products in both ((1-r^2)^3 as q*q*q, ustar^4 as (u*u)*(u*u)); exp and
// sqrt are CUDA's, which torch's CUDA kernels call. Built with
// --fmad=false, the outputs are bit-equal to the twins.

#include <cstring>

#include "kpp.cuh"

namespace mitgcm {

constexpr int kNNI = 890, kNNJ = 480;   // KPP_PARAMS.h:153

template <typename T>
__device__ __forceinline__ T fsign(T a, T b) {
  return b >= T(0) ? a : -a;
}
// max(x, c) and min(x, c) that keep a NaN x, as torch.clamp does
template <typename T>
__device__ __forceinline__ T maxp(T x, T c) {
  return x < c ? c : x;
}
template <typename T>
__device__ __forceinline__ T minp(T x, T c) {
  return x > c ? c : x;
}

// model/src/swfrac.F, Jerlov water type Ib
template <typename T>
__device__ T swfrac(T facz) {
  if (facz < T(-200.0)) return T(0);
  return T(0.62) * exp(facz / T(0.6)) + T(1.0 - 0.62) * exp(facz / T(20.0));
}

// ----------------------------------------------------------------------
// K-pre
// ----------------------------------------------------------------------

template <typename T>
__global__ void kpp_pre_kernel(const KppPreArgs<T> a, const Eos<T> e,
                               const KppPreParams q, int nr, int nyp,
                               int nxp, int smooth_shsq) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t c = static_cast<size_t>(j) * nxp + i;
  const size_t p = k * P + c;
  const T g = T(q.gravity), rhoConst = T(q.rhoConst);

  // STATEKPP: dbloc_f0(k+1) and dbsfc(k)
  T dbraw = T(0);
  if (k + 1 < nr) {
    const size_t pk = p + P;
    const T rc = e.rho(a.theta[pk], a.salt[pk], k + 1, a.phi[pk]);
    const T rkm1 = e.rho(a.theta[p], a.salt[p], k + 1, a.phi[pk]);
    dbraw = g * (rc - rkm1) / (rc + rhoConst);
  }
  T dbsfc = T(0);
  if (k > 0) {
    const T rc = e.rho(a.theta[p], a.salt[p], k, a.phi[p]);
    const T r1k = e.rho(a.theta[c], a.salt[c], k, a.phi[p]);
    dbsfc = g * (rc - r1k) / (rc + rhoConst);
  }
  const T mC = a.maskC[p];
  const T mkp1 = a.maskC[k + 1 < nr ? p + P : p];
  const bool at_bot = k == a.kmtj[c] - 1;
  a.dbraw[p] = dbraw;
  a.dbloc[p] = at_bot ? T(0) : dbraw * mC * mkp1;
  a.ritop[p] = a.rfac[k] * (at_bot ? T(0) : dbsfc * mC * a.maskC[c]);

  // the interface shear below the cell, zero-filled at the array's edge
  auto du = [&](int jj, int ii) -> T {
    if (jj < 0 || jj >= nyp || ii < 0 || ii >= nxp) return T(0);
    const size_t r = k * P + static_cast<size_t>(jj) * nxp + ii;
    return a.u[r] - a.u[r + P];
  };
  auto dv = [&](int jj, int ii) -> T {
    if (jj < 0 || jj >= nyp || ii < 0 || ii >= nxp) return T(0);
    const size_t r = k * P + static_cast<size_t>(jj) * nxp + ii;
    return a.v[r] - a.v[r + P];
  };
  T shsq = T(0);
  if (k + 1 < nr) {
    const T u0 = du(j, i), u1 = du(j, i + 1), v0 = dv(j, i),
            v1 = dv(j + 1, i);
    shsq = T(0.5) * (u0 * u0 + u1 * u1 + v0 * v0 + v1 * v1);
    if (smooth_shsq) {
      const T d1 = du(j - 1, i), d2 = du(j - 1, i + 1), d3 = du(j + 1, i),
              d4 = du(j + 1, i + 1), d5 = dv(j, i - 1), d6 = dv(j + 1, i - 1),
              d7 = dv(j, i + 1), d8 = dv(j + 1, i + 1);
      shsq = T(0.5) * shsq +
             T(0.125) * (d1 * d1 + d2 * d2 + d3 * d3 + d4 * d4 + d5 * d5 +
                         d6 * d6 + d7 * d7 + d8 * d8);
    }
  }
  a.shsq[p] = shsq;

  // dVsq: the velocity difference to the surface layer
  const bool east = i + 1 < nxp, north = j + 1 < nyp;
  const T du0 = a.u[c] - a.u[p];
  const T du1 = east ? a.u[c + 1] - a.u[p + 1] : T(0);
  const T dv0 = a.v[c] - a.v[p];
  const T dv1 = north ? a.v[c + nxp] - a.v[p + nxp] : T(0);
  a.dvsq[p] = T(0.5) * (du0 * du0 + du1 * du1 + dv0 * dv0 + dv1 * dv1);

  if (k != 0) return;
  // kpp_forcing_surf.F: ustar, bo, bosol
  const T t0 = a.theta[c], s0 = a.salt[c], phi0 = a.phi[c];
  const T rho1 = e.rho(t0, s0, 0, phi0) + rhoConst;
  const T alpha0 = e.alpha(t0, s0, 0, phi0);
  const T beta0 = e.beta(t0, s0, 0, phi0);
  const T su = a.sfU[c] + (east ? a.sfU[c + 1] : T(0));
  const T sv = a.sfV[c] + (north ? a.sfV[c + nxp] : T(0));
  const T work3 = su * su + sv * sv;
  a.ustar[c] = work3 < T(q.epsLocSq) ? T(q.ustar_min)
                                     : sqrt(sqrt(work3) * T(0.5));
  a.bo[c] = T(-q.gravity) * (alpha0 * a.sfT[c] + beta0 * a.sfS[c]) / rho1;
  a.bosol[c] = g * alpha0 * a.Qsw[c] * T(q.recip_Cp) * T(q.recip_rhoConst) /
               rho1;
}

// KPP_SMOOTH_DBLOC: SMOOTH_HORIZ of dbloc_f0(k+1) with the k+1 mask, then
// the masks of dbloc
template <typename T>
__global__ void kpp_smooth_kernel(const T* __restrict__ dbraw,
                                  const T* __restrict__ maskC,
                                  const int* __restrict__ kmtj,
                                  T* __restrict__ out, int nr, int nyp,
                                  int nxp) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t c = static_cast<size_t>(j) * nxp + i;
  const size_t p = k * P + c;
  const int kp1 = k + 1 < nr ? k + 1 : k;
  auto msk = [&](int jj, int ii) -> T {
    if (jj < 0 || jj >= nyp || ii < 0 || ii >= nxp) return T(0);
    return maskC[kp1 * P + static_cast<size_t>(jj) * nxp + ii];
  };
  auto fm = [&](int jj, int ii) -> T {
    if (jj < 0 || jj >= nyp || ii < 0 || ii >= nxp) return T(0);
    const size_t r = static_cast<size_t>(jj) * nxp + ii;
    return dbraw[k * P + r] * maskC[kp1 * P + r];
  };
  T sm = T(0);
  if (k + 1 < nr) {
    const T side_m = msk(j, i - 1) + msk(j, i + 1) + msk(j - 1, i) +
                     msk(j + 1, i);
    const T corn_m = msk(j - 1, i - 1) + msk(j + 1, i - 1) +
                     msk(j - 1, i + 1) + msk(j + 1, i + 1);
    const T w = T(0.25) * msk(j, i) + T(0.125) * side_m + T(0.0625) * corn_m;
    const T num =
        T(0.25) * fm(j, i) +
        T(0.125) * (fm(j, i - 1) + fm(j, i + 1) + fm(j - 1, i) +
                    fm(j + 1, i)) +
        T(0.0625) * (fm(j - 1, i - 1) + fm(j + 1, i - 1) + fm(j - 1, i + 1) +
                     fm(j + 1, i + 1));
    sm = w >= T(0.25) ? num / (w == T(0) ? T(1) : w) : dbraw[p];
  }
  const bool at_bot = k == kmtj[c] - 1;
  out[p] = at_bot ? T(0) : sm * maskC[p] * maskC[kp1 * P + c];
}

// ----------------------------------------------------------------------
// K-col
// ----------------------------------------------------------------------

template <typename T>
struct KppColumn {
  const KppColArgs<T>& a;
  const KppColParams& q;
  int nr;
  size_t P, c;
  int kmtj;
  T ustar;

  // F-indexed views of the cell-indexed inputs: level k lives in cell k-1
  __device__ T cell(const T* f, int k) const {
    return f[(k - 1) * P + c];
  }
  __device__ T zg(int k) const {   // zgrid, index clipped to 0..nr+1
    return a.zg[k < 0 ? 0 : (k > nr + 1 ? nr + 1 : k)];
  }
  __device__ T hw(int k) const {
    return a.hw[k < 0 ? 0 : (k > nr + 1 ? nr + 1 : k)];
  }

  // WSCALE: wm (when wm != nullptr) and ws
  __device__ void wscale(T sigma, T depth, T bfsfc, T* wm, T* ws) const {
    const T zehat = T(q.vonk) * sigma * depth * bfsfc;
    const T zdiff = zehat - T(q.zmin);
    T fz = floor(zdiff / T(q.deltaz));
    fz = fz < T(0) ? T(0) : (fz > T(kNNI) ? T(kNNI) : fz);
    const T udiff = ustar - T(q.umin);
    T fu = floor(udiff / T(q.deltau));
    fu = fu < T(0) ? T(0) : (fu > T(kNNJ) ? T(kNNJ) : fu);
    const int iz = static_cast<int>(fz), ju = static_cast<int>(fu);
    const T zfrac = zdiff / T(q.deltaz) - fz;
    const T ufrac = udiff / T(q.deltau) - fu;
    const T zf = T(1) - zfrac;
    const T u3 = ustar * ustar * ustar;
    const bool in_table = zehat <= T(q.zmax);
    const T w_stable = T(q.vonk) * ustar * u3 / (u3 + T(q.conc1) * zehat);
    const int r0 = iz * (kNNJ + 2) + ju, r1 = r0 + (kNNJ + 2);
    auto bilin = [&](const T* tab) -> T {
      const T wa = zf * __ldg(tab + r0 + 1) + zfrac * __ldg(tab + r1 + 1);
      const T wb = zf * __ldg(tab + r0) + zfrac * __ldg(tab + r1);
      return (T(1) - ufrac) * wb + ufrac * wa;
    };
    if (wm) *wm = in_table ? bilin(a.wmt) : w_stable;
    *ws = in_table ? bilin(a.wst) : w_stable;
  }

  // RI_IWMIX at F level k (1..nr) before the floor mask: visc, difs, dift
  __device__ void ri_iwmix(int k, T* out) const {
    T Ri = T(0), N2 = T(0);
    if (kmtj > 1) {
      const int src = k < kmtj - 1 ? k : kmtj - 1;
      const T dz = a.dz[src - 1];
      Ri = cell(a.dblocSm, src) * dz / maxp(cell(a.shsq, src), T(q.phepsi));
      N2 = cell(a.dbloc, src) / dz;
    }
    const T bvsqcon = T(q.BVSQcon);
    T Rig = maxp(N2, bvsqcon);
    T ratio = minp((bvsqcon - Rig) / bvsqcon, T(1));
    T r = T(1) - ratio * ratio;
    const T fcon = r * r * r;
    Rig = maxp(Ri, T(0));
    ratio = minp(Rig / T(q.Riinfty), T(1));
    r = T(1) - ratio * ratio;
    const T fRi = r * r * r;
    const int kp1 = k + 1 < nr ? k + 1 : nr;
    out[0] = T(q.viscAr) + fcon * T(q.difmcon) + fRi * T(q.difm0);
    out[1] = cell(a.difS, kp1) + fcon * T(q.difscon) + fRi * T(q.difs0);
    out[2] = cell(a.difT, kp1) + fcon * T(q.diftcon) + fRi * T(q.dift0);
  }
  // the interior profiles (diffus) at F level k, clipped to 0..nr+1: zero
  // at the pads and at and below the sea floor
  __device__ void diffus(int k, T* out) const {
    k = k < 0 ? 0 : (k > nr + 1 ? nr + 1 : k);
    if (k == 0 || k >= kmtj || k == nr + 1) {
      out[0] = out[1] = out[2] = T(0);
      return;
    }
    ri_iwmix(k, out);
  }

  // BLDEPTH's bulk Richardson number at F level kl (2..nr)
  __device__ T rib(int kl, T bo, T bosol) const {
    const T bf = bo + bosol * (T(1) - a.worka[kl - 2]);
    const T st = T(0.5) + fsign(T(0.5), bf);
    const T sigma = st + (T(1) - st) * T(q.epsilon);
    const T depth = -a.zg[kl];
    T ws;
    wscale(sigma, depth, bf, nullptr, &ws);
    const T bvsq = T(0.5) * (cell(a.dbloc, kl - 1) / a.dz[kl - 2] +
                             cell(a.dbloc, kl) / a.dz[kl - 1]);
    const T vtsq = bvsq == T(0) ? T(0)
                                : depth * ws * sqrt(fabs(bvsq)) * T(q.Vtc);
    return cell(a.ritop, kl) /
           maxp(cell(a.dvsq, kl) + vtsq, T(q.phepsi));
  }
  __device__ T rib_f(int k, T bo, T bosol) const {   // clipped to 0..nr
    k = k < 0 ? 0 : (k > nr ? nr : k);
    return k < 2 ? T(0) : rib(k, bo, bosol);
  }
  __device__ void bf_at(T h, T bo, T bosol, T* b, T* st) const {
    const T wk = swfrac(-h);
    T bf = bo + bosol * (T(1) - wk);
    *st = T(0.5) + fsign(T(0.5), bf);
    *b = fsign(T(1), bf) * maxp(fabs(bf), T(q.phepsi));
  }
};

// hbl * w * sig * (1 + sig * G(sig))
template <typename T>
__device__ __forceinline__ T bl_shape(T sig, T hbl, T wx, T gat1, T dat1) {
  const T a1 = sig - T(2);
  const T a2 = T(3) - T(2) * sig;
  const T a3 = sig - T(1);
  const T G = a1 + a2 * gat1 + a3 * dat1;
  return hbl * wx * sig * (T(1) + sig * G);
}

template <typename T>
__global__ void kpp_col_kernel(const KppColArgs<T> a, const KppColParams q,
                               int nr, int plane, int limitHblStable) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= plane) return;
  KppColumn<T> C{a, q, nr, static_cast<size_t>(plane),
                 static_cast<size_t>(col), a.kmtj[col], a.ustar[col]};
  const int kmtj = C.kmtj;
  const T ustar = C.ustar, bo = a.bo[col], bosol = a.bosol[col];
  const T eps = T(q.epsilon), phepsi = T(q.phepsi);

  // ---- BLDEPTH: the first Rib > Ricr, the hbl interpolation ----
  int kbl = kmtj;
  for (int kl = 2; kl <= nr; ++kl) {
    if (C.rib(kl, bo, bosol) > T(q.Ricr)) {
      kbl = kl;
      break;
    }
  }
  if (kmtj < 1) kbl = 1;
  T hbl = -C.zg(kmtj < 1 ? 1 : kmtj);
  if (kbl > 1 && kbl < kmtj) {
    const T RibK = C.rib_f(kbl, bo, bosol);
    const T RibKm = C.rib_f(kbl - 1, bo, bosol);
    const T z1 = C.zg(kbl - 1), z2 = C.zg(kbl);
    hbl = -z1 + (z1 - z2) * (T(q.Ricr) - RibKm) /
                    (RibK == RibKm ? T(1) : RibK - RibKm);
  }
  T bfsfc, stable;
  C.bf_at(hbl, bo, bosol, &bfsfc, &stable);
  if (limitHblStable) {
    const T hekman =
        T(q.cekman) * ustar / maxp(fabs(a.fCori[col]), phepsi);
    const T hmonob = T(q.cmonob) * (ustar * ustar * ustar) / T(q.vonk) /
                     (bfsfc == T(0) ? T(1) : bfsfc);
    const T hlimit = stable * (hmonob < hekman ? hmonob : hekman) +
                     (stable - T(1)) * T(q.zg_nr);
    if (bfsfc > T(0)) hbl = hlimit < hbl ? hlimit : hbl;
  }
  hbl = maxp(hbl, T(q.minKPPhbl));
  // the second search: the first level deeper than hbl
  kbl = kmtj;
  for (int kk = 2; kk <= nr; ++kk) {
    if (-a.zg[kk] > hbl) {
      kbl = kk;
      break;
    }
  }
  if (kmtj < 1) kbl = 1;
  C.bf_at(hbl, bo, bosol, &bfsfc, &stable);
  const T casea =
      T(0.5) + fsign(T(0.5), -C.zg(kbl) - T(0.5) * C.hw(kbl) - hbl);

  // ---- BLMIX: the coefficients at hbl and at level kbl-1 ----
  const T sigma = stable * T(1) + (T(1) - stable) * eps;
  T wm, ws;
  C.wscale(sigma, hbl, bfsfc, &wm, &ws);
  wm = fsign(T(1), wm) * maxp(fabs(wm), phepsi);
  ws = fsign(T(1), ws) * maxp(fabs(ws), phepsi);
  const int caseaInt = static_cast<int>(casea + phepsi);
  const int kn = caseaInt * (kbl - 1) + (1 - caseaInt) * kbl;
  const T hw_kn = C.hw(kn), hw_knp1 = C.hw(kn + 1);
  const T delhat = T(0.5) * hw_kn - C.zg(kn) - hbl;
  const T R = T(1) - delhat / hw_kn;
  const T u2 = ustar * ustar;
  const T f1 = stable * T(q.conc1) * bfsfc / maxp(u2 * u2, phepsi);
  T dm1[3], d0[3], dp1[3];
  C.diffus(kn - 1, dm1);
  C.diffus(kn, d0);
  C.diffus(kn + 1, dp1);
  T gat1[3], dat1[3];
  for (int md = 0; md < 3; ++md) {
    const T wx = md == 0 ? wm : ws;
    const T dvdzup = (dm1[md] - d0[md]) / hw_kn;
    const T dvdzdn = (d0[md] - dp1[md]) / hw_knp1;
    const T viscp = T(0.5) * ((T(1) - R) * (dvdzup + fabs(dvdzup)) +
                              R * (dvdzdn + fabs(dvdzdn)));
    const T visch = d0[md] + viscp * delhat;
    gat1[md] = visch / hbl / wx;
    dat1[md] = minp(-viscp / wx + f1 * visch, T(0));
  }
  const T sig1 = -C.zg(kbl - 1) / hbl;
  const T sigma1 = stable * sig1 + (T(1) - stable) * minp(sig1, eps);
  T wm1, ws1;
  C.wscale(sigma1, hbl, bfsfc, &wm1, &ws1);
  T dkm1[3];
  for (int md = 0; md < 3; ++md)
    dkm1[md] = bl_shape(sig1, hbl, md == 0 ? wm1 : ws1, gat1[md], dat1[md]);

  // ---- ENHANCE at level kbl-1 ----
  const int ki = kbl - 1;
  const bool valid = ki >= 1 && ki < nr;
  const T zki = C.zg(ki);
  const T delta = (hbl + zki) / (valid ? zki - C.zg(ki + 1) : T(1));
  T dki[3];
  C.diffus(ki, dki);

  // ---- combine and transfer, level by level ----
  T bot[3];
  bot[0] = T(q.viscAr);
  bot[1] = C.cell(a.difS, nr);
  bot[2] = C.cell(a.difT, nr);
  const size_t P = C.P;
  const T m0 = a.maskC[col];
  T* outs[3] = {a.viscAz, a.diffKzS, a.diffKzT};
  for (int md = 0; md < 3; ++md) outs[md][col] = T(0) * m0;
  for (int k = 1; k <= nr; ++k) {
    const T sig = a.sigz[k - 1] / hbl;
    const T sigk = stable * sig + (T(1) - stable) * minp(sig, eps);
    T wmk, wsk;
    C.wscale(sigk, hbl, bfsfc, &wmk, &wsk);
    T blmc[3];
    for (int md = 0; md < 3; ++md)
      blmc[md] = bl_shape(sig, hbl, md == 0 ? wmk : wsk, gat1[md], dat1[md]);
    T ghat_k = (T(1) - stable) * T(q.cg) / maxp(wsk * hbl, phepsi);
    if (valid && k == ki) {
      for (int md = 0; md < 3; ++md) {
        const T dkmp5 = casea * dki[md] + (T(1) - casea) * blmc[md];
        const T qd = T(1) - delta;
        const T dstar = qd * qd * dkm1[md] + delta * delta * dkmp5;
        blmc[md] = (T(1) - delta) * dki[md] + delta * dstar;
      }
      ghat_k = (T(1) - casea) * ghat_k;
    }
    const bool inbl = k < kbl;
    const size_t p = (k - 1) * P + col;   // the cell above interface k+1
    const T mm_above = a.maskC[p] * a.maskC[k >= 2 ? p - P : p];
    a.ghat[p] = (inbl ? ghat_k : T(0)) * mm_above;
    if (k < nr) {
      T dk[3];
      C.diffus(k, dk);
      const size_t pk = p + P;   // interface k is the top of cell k
      const T mm = a.maskC[pk] * a.maskC[p];
      for (int md = 0; md < 3; ++md) {
        const T b = blmc[md] < bot[md] ? bot[md] : blmc[md];
        outs[md][pk] = (inbl ? b : dk[md]) * mm;
      }
    }
  }
  const T h = hbl * m0;
  a.hbl[col] = h;
  a.frac[col] = swfrac(-h);
  a.kbl[col] = kbl;
}

// ----------------------------------------------------------------------
// launchers
// ----------------------------------------------------------------------

template <typename T>
int launch_kpp_pre(const void* const* table, int n, const double* params,
                   int nparams, int nr, int nyp, int nxp, int kind,
                   int use_phi, int smooth_shsq, void* stream) {
  static_assert(sizeof(KppPreArgs<T>) == kKppPrePointers * sizeof(void*),
                "KppPreArgs must be a plain table of pointers");
  if (n != kKppPrePointers ||
      nparams != static_cast<int>(sizeof(KppPreParams) / sizeof(double)) ||
      kind < 0 || kind > 2 || nr < 2)
    return (int)cudaErrorInvalidValue;
  KppPreArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  KppPreParams q;
  std::memcpy(&q, params, sizeof(q));
  const Eos<T> e{kind,       use_phi,    T(q.rhoConst), T(q.dp0),
                 T(q.scale), T(q.rhoNil), T(q.tAlpha),  T(q.sBeta),
                 T(q.drho),  T(q.alpha_lin), T(q.beta_lin), a.profile,
                 a.aprof,    a.tref,     a.sref};
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, nr);
  kpp_pre_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      a, e, q, nr, nyp, nxp, smooth_shsq);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kpp_smooth(const void* dbraw, const void* maskC, const void* kmtj,
                      void* out, int nr, int nyp, int nxp, void* stream) {
  if (nr < 2) return (int)cudaErrorInvalidValue;
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, nr);
  kpp_smooth_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      (const T*)dbraw, (const T*)maskC, (const int*)kmtj, (T*)out, nr, nyp,
      nxp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kpp_col(const void* const* table, int n, const double* params,
                   int nparams, int nr, int nyp, int nxp, int limitHblStable,
                   void* stream) {
  static_assert(sizeof(KppColArgs<T>) == kKppColPointers * sizeof(void*),
                "KppColArgs must be a plain table of pointers");
  if (n != kKppColPointers ||
      nparams != static_cast<int>(sizeof(KppColParams) / sizeof(double)) ||
      nr < 2)
    return (int)cudaErrorInvalidValue;
  KppColArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  KppColParams q;
  std::memcpy(&q, params, sizeof(q));
  const int plane = nyp * nxp;
  const int threads = 128;
  kpp_col_kernel<T><<<(plane + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(a, q, nr, plane,
                                              limitHblStable);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define KPP_ENTRY(SUF, T)                                                     \
  extern "C" int mitgcm_kpp_pre_##SUF(                                        \
      const void* const* table, int n, const double* params, int nparams,     \
      int nr, int nyp, int nxp, int kind, int use_phi, int smooth_shsq,       \
      void* stream) {                                                         \
    return mitgcm::launch_kpp_pre<T>(table, n, params, nparams, nr, nyp, nxp, \
                                     kind, use_phi, smooth_shsq, stream);     \
  }                                                                           \
  extern "C" int mitgcm_kpp_smooth_##SUF(const void* dbraw,                   \
                                         const void* maskC, const void* kmtj, \
                                         void* out, int nr, int nyp, int nxp, \
                                         void* stream) {                      \
    return mitgcm::launch_kpp_smooth<T>(dbraw, maskC, kmtj, out, nr, nyp,     \
                                        nxp, stream);                         \
  }                                                                           \
  extern "C" int mitgcm_kpp_col_##SUF(                                        \
      const void* const* table, int n, const double* params, int nparams,     \
      int nr, int nyp, int nxp, int limitHblStable, void* stream) {           \
    return mitgcm::launch_kpp_col<T>(table, n, params, nparams, nr, nyp, nxp, \
                                     limitHblStable, stream);                 \
  }

KPP_ENTRY(f32, float)
KPP_ENTRY(f64, double)
