// Kernels seaice_lsr_prep and seaice_lsr_tridiag: the sea ice's LSR
// (line successive relaxation) dynamics, one Picard pass at a time.
//
// Replaces: mitgcm_tpu/model/seaice.py:SeaIce.lsr's pass body (:912-972:
// strainrates :513, viscosities :540, oceandrag :593, _lsr_rhs_u/_v
// :609/:633, _lsr_coeffs :654 and the land closure), and the linear loop
// _lsr_iterate (:991-1056) with the zebra line solves _tridiagU/_tridiagV
// (:806/:843) and _tridiag_rows (:713), which XLA ran on the TPU as fused
// 2-D passes, a scan per tile line and a while_loop.
//
// seaice_lsr_prep is two launches per pass, one thread per padded cell:
//   seaice_lsr_visc    the strain rates, eta, zeta and the replacement
//                      pressure at C points, into scratch
//   seaice_lsr_coeffs  the Z-point eta, the ocean drag dwatn, the
//                      FORCEX/Y terms with Coriolis, rhsU/V, the ten
//                      tridiagonal coefficient fields and the closure
// (the Z-point averages read eta at neighbours, which one launch would be
// computing at the same time). Every shifted read is the JAX code's
// zero-filled shift, so every padded cell is bit-equal to the twin.
// seaice_lsr_tridiag is one launch per half-sweep (U: rows along x; V:
// columns along y; lines of parity k), one thread per (tile, line) running
// the Thomas recursion in _tridiag_rows' order with real divisions, then
// the relaxation uTmp + WFA (x - uTmp), in place in u. A line reads the
// lines beside it from u when they lie in its own tile (the k = 1 half-sweep
// sees the k = 0 lines its tile has just solved) and from uTmp, the values
// at the iteration's entry, when they are the tile's halo; the edge closure
// (AA3) reads uTmp too, never a neighbouring tile's update of the same call.
// seaice_lsr_check ends an iteration (:1020-1044): m += 1, every
// SOLV_NCHECK iterations the masked interior max of |u - uTmp| and
// |v - vTmp| (a max is exact in any order), the WFAU/WFAV freeze, the stop
// under LSR_ERROR with ICOUNT1/2, `done`, the halo fill of u and v and
// uTmp, vTmp := u, v. Its last block updates the control words, which
// every launch reads first: with `done` set (or a component stopped, for
// its sweeps) a launch returns at once, so the host enqueues batches of
// iterations and reads the words once a batch.
//
// Bound: bytes for prep and check (prep reads ~34 2-D fields and writes
// 13); the line solves are latency-bound: a thread walks its 64 cells in
// sequence, two divisions a cell, and a half-sweep has only nTiles * sNy / 2
// threads (8192 at 1024 x 1024 with 64 x 64 tiles).

#include <cstring>

#include "gad_advect.cuh"

namespace mitgcm {

template <typename T>
struct Fld {   // a [nyp, nxp] field read with the JAX code's zero fill
  const T* f;
  int nyp, nxp;
  __device__ T operator()(int j, int i) const {
    return (i < 0 || i >= nxp || j < 0 || j >= nyp)
               ? T(0) : f[static_cast<size_t>(j) * nxp + i];
  }
};

__device__ __forceinline__ bool in2(int j, int i, int nyp, int nxp) {
  return i >= 0 && i < nxp && j >= 0 && j < nyp;
}

// ---------------------------------------------------------------------
// seaice_lsr_visc
// ---------------------------------------------------------------------
template <typename T>
struct ViscArgs {
  const T *uC, *vC, *press0, *zMax, *heffm, *recip_dxF, *recip_dyF,
      *recip_dyU, *recip_dxV, *rAz, *recip_rA;
  T *eta, *zeta, *press;
};
constexpr int kViscPointers = 14;

struct ViscParams {
  double zetaMin, deltaMin, recip_e2, pressReplFac, tns;
};

template <typename T>
__device__ T hm4_at(const Fld<T>& hm, int j, int i) {
  return hm(j, i) * hm(j, i - 1) * hm(j - 1, i) * hm(j - 1, i - 1);
}

template <typename T>
__global__ void seaice_lsr_visc_kernel(const ViscArgs<T> a,
                                       const ViscParams q, int nyp,
                                       int nxp) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const Fld<T> u{a.uC, nyp, nxp}, v{a.vC, nyp, nxp}, hm{a.heffm, nyp, nxp};
  // rAz e12^2 at (jj, ii), 0 outside the array
  auto rze = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    const size_t r = static_cast<size_t>(jj) * nxp + ii;
    const T dudy = (u(jj, ii) - u(jj - 1, ii)) * a.recip_dyU[r];
    const T dvdx = (v(jj, ii) - v(jj, ii - 1)) * a.recip_dxV[r];
    const T e12 = T(0.5) * (dudy + dvdx) * hm4_at(hm, jj, ii);
    return a.rAz[r] * (e12 * e12);
  };
  const T e11 = a.recip_dxF[p] * (u(j, i + 1) - u(j, i));
  const T e22 = a.recip_dyF[p] * (v(j + 1, i) - v(j, i));
  const T e12Csq = T(0.25) * a.recip_rA[p] *
                   (rze(j, i) + rze(j, i + 1) + rze(j + 1, i) +
                    rze(j + 1, i + 1));
  const T ep = e11 + e22;
  const T em = e11 - e22;
  const T shearDefSq = em * em + T(4.0) * e12Csq;
  const T deltaC = sqrt(ep * ep + T(q.recip_e2) * shearDefSq);
  const T deltaCreg = nmax(deltaC, T(q.deltaMin));
  const T press0 = a.press0[p];
  T zeta = T(0.5) * press0 * T(1.0 + q.tns) / deltaCreg;
  zeta = nmin(a.zMax[p], zeta);
  zeta = nmax(T(q.zetaMin), zeta);
  zeta = zeta * a.heffm[p];
  a.zeta[p] = zeta;
  a.press[p] = (press0 * T(1.0 - q.pressReplFac) +
                T(2.0) * zeta * deltaC * T(q.pressReplFac) / T(1.0 + q.tns)) *
               T(1.0 - q.tns);
  a.eta[p] = zeta * T(q.recip_e2);
}

// ---------------------------------------------------------------------
// seaice_lsr_coeffs
// ---------------------------------------------------------------------
template <typename T>
struct CoeffArgs {
  const T *eta, *zeta, *press, *uIce, *vIce, *uC, *vC, *uVel0, *vVel0,
      *fxTmp, *fyTmp, *areaW, *areaS, *massC, *massU, *massV, *fCori, *yC,
      *heffm, *maskInC, *maskInW, *maskInS, *maskU, *maskV, *recip_dxF,
      *recip_dyF, *recip_dxV, *recip_dyU, *dxF, *dyF, *dxV, *dyU, *recip_rAw,
      *recip_rAs;
  T *AU, *BU, *CU, *AV, *BV, *CV, *uRt1, *uRt2, *vRt1, *vRt2, *rhsU, *rhsV,
      *dwatn;
};
constexpr int kCoeffPointers = 47;

struct CoeffParams {
  double coswat, sinwat, recip_dt, dragNorth, dragSouth, dWatMin, dWatMinSq,
      guardZeroDiag;
};

template <typename T>
__global__ void seaice_lsr_coeffs_kernel(const CoeffArgs<T> a,
                                         const CoeffParams q, int nyp,
                                         int nxp) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const Fld<T> E{a.eta, nyp, nxp}, Z{a.zeta, nyp, nxp}, hm{a.heffm, nyp, nxp},
      uC{a.uC, nyp, nxp}, vC{a.vC, nyp, nxp}, u0{a.uVel0, nyp, nxp},
      v0{a.vVel0, nyp, nxp}, mU{a.maskU, nyp, nxp}, mV{a.maskV, nyp, nxp},
      mIn{a.maskInC, nyp, nxp};
  const T coswat = T(q.coswat), sinwat = T(q.sinwat);
  auto at = [&](const T* f, int jj, int ii) -> T {
    return f[static_cast<size_t>(jj) * nxp + ii];
  };
  // the Z-point eta (seaice.py:576-590), 0 outside the array
  auto etaZ = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    const T s = hm(jj, ii) + hm(jj, ii - 1) + hm(jj - 1, ii) +
                hm(jj - 1, ii - 1);
    const T sumNorm = s > T(0) ? T(1) / s : T(0);
    return sumNorm * (E(jj, ii) + E(jj, ii - 1) + E(jj - 1, ii) +
                      E(jj - 1, ii - 1)) * hm4_at(hm, jj, ii);
  };
  auto epz = [&](int jj, int ii) -> T { return E(jj, ii) + Z(jj, ii); };
  auto zme = [&](int jj, int ii) -> T { return Z(jj, ii) - E(jj, ii); };
  // oceandrag (seaice.py:593), 0 outside the array
  auto dwatn = [&](int jj, int ii) -> T {
    if (!in2(jj, ii, nyp, nxp)) return T(0);
    auto du = [&](int y, int x) -> T {
      if (!in2(y, x, nyp, nxp)) return T(0);
      return (at(a.uC, y, x) - at(a.uVel0, y, x)) * at(a.maskInW, y, x);
    };
    auto dv = [&](int y, int x) -> T {
      if (!in2(y, x, nyp, nxp)) return T(0);
      return (at(a.vC, y, x) - at(a.vVel0, y, x)) * at(a.maskInS, y, x);
    };
    const T sa = du(jj, ii) + du(jj, ii + 1);
    const T sb = dv(jj, ii) + dv(jj + 1, ii);
    const T tempVar = T(0.25) * (sa * sa + sb * sb);
    const T dc = at(a.yC, jj, ii) < T(0) ? T(q.dragSouth) : T(q.dragNorth);
    const T cw = dc * dc * tempVar > T(q.dWatMinSq) ? dc * sqrt(tempVar)
                                                   : T(q.dWatMin);
    return cw * hm(jj, ii);
  };
  auto dvC = [&](int y, int x) -> T { return v0(y, x) - vC(y, x); };
  auto duC = [&](int y, int x) -> T { return u0(y, x) - uC(y, x); };
  auto mfv = [&](int y, int x) -> T {
    if (!in2(y, x, nyp, nxp)) return T(0);
    return at(a.massC, y, x) * at(a.fCori, y, x) *
           (T(0.5) * (vC(y, x) + vC(y + 1, x)));
  };
  auto mfu = [&](int y, int x) -> T {
    if (!in2(y, x, nyp, nxp)) return T(0);
    return at(a.massC, y, x) * at(a.fCori, y, x) *
           (T(0.5) * (uC(y, x) + uC(y, x + 1)));
  };
  auto a11 = [&](int y, int x) -> T {   // dyF sig11
    if (!in2(y, x, nyp, nxp)) return T(0);
    const T sig11 = zme(y, x) * (vC(y + 1, x) - vC(y, x)) *
                        at(a.recip_dyF, y, x) - T(0.5) * at(a.press, y, x);
    return at(a.dyF, y, x) * sig11;
  };
  auto a12 = [&](int y, int x) -> T {   // dxV sig12 of the U equation
    if (!in2(y, x, nyp, nxp)) return T(0);
    const T ez = etaZ(y, x);
    const T rdx = at(a.recip_dxV, y, x);
    const T sig12 = ez * ((vC(y, x) - vC(y, x - 1)) * rdx) * hm4_at(hm, y, x) +
                    ez * rdx * (vC(y, x) + vC(y, x - 1)) *
                        (mV(y, x) - mV(y, x - 1)) * T(2.0);
    return at(a.dxV, y, x) * sig12;
  };
  auto b22 = [&](int y, int x) -> T {   // dxF sig22
    if (!in2(y, x, nyp, nxp)) return T(0);
    const T sig22 = zme(y, x) * (uC(y, x + 1) - uC(y, x)) *
                        at(a.recip_dxF, y, x) - T(0.5) * at(a.press, y, x);
    return at(a.dxF, y, x) * sig22;
  };
  auto b12 = [&](int y, int x) -> T {   // dyU sig12 of the V equation
    if (!in2(y, x, nyp, nxp)) return T(0);
    const T ez = etaZ(y, x);
    const T rdy = at(a.recip_dyU, y, x);
    const T sig12 = ez * ((uC(y, x) - uC(y - 1, x)) * rdy) * hm4_at(hm, y, x) +
                    ez * rdy * (uC(y, x) + uC(y - 1, x)) *
                        (mU(y, x) - mU(y - 1, x)) * T(2.0);
    return at(a.dyU, y, x) * sig12;
  };
  auto UXX = [&](int y, int x) -> T {
    if (!in2(y, x, nyp, nxp)) return T(0);
    return at(a.dyF, y, x) * epz(y, x) * at(a.recip_dxF, y, x);
  };
  auto UYY = [&](int y, int x) -> T {
    if (!in2(y, x, nyp, nxp)) return T(0);
    return at(a.dxV, y, x) * etaZ(y, x) * at(a.recip_dyU, y, x);
  };
  auto VXX = [&](int y, int x) -> T {
    if (!in2(y, x, nyp, nxp)) return T(0);
    return at(a.dyU, y, x) * etaZ(y, x) * at(a.recip_dxV, y, x);
  };
  auto VYY = [&](int y, int x) -> T {
    if (!in2(y, x, nyp, nxp)) return T(0);
    return at(a.dxF, y, x) * epz(y, x) * at(a.recip_dyF, y, x);
  };

  const T fC = a.fCori[p];
  const T sgn = fC < T(0) ? T(-1) : T(1);
  const T dw = dwatn(j, i), dw_im = dwatn(j, i - 1), dw_jm = dwatn(j - 1, i);
  const T sgs = sgn * sinwat * T(0.5);
  T frcU = a.fxTmp[p] +
           (T(0.5) * (dw + dw_im) * coswat * a.uVel0[p] -
            sgs * (dw * T(0.5) * (dvC(j, i) + dvC(j + 1, i)) +
                   dw_im * T(0.5) * (dvC(j, i - 1) + dvC(j + 1, i - 1)))) *
               a.areaW[p];
  T frcV = a.fyTmp[p] +
           (T(0.5) * (dw + dw_jm) * coswat * a.vVel0[p] +
            sgs * (dw * T(0.5) * (duC(j, i) + duC(j, i + 1)) +
                   dw_jm * T(0.5) * (duC(j - 1, i) + duC(j - 1, i + 1)))) *
               a.areaS[p];
  frcU = frcU + T(0.5) * (mfv(j, i) + mfv(j, i - 1));
  frcV = frcV - T(0.5) * (mfu(j, i) + mfu(j - 1, i));
  const T mu = a.maskU[p], mv = a.maskV[p];
  frcU = frcU * mu;
  frcV = frcV * mv;
  const T rAw = a.recip_rAw[p], rAs = a.recip_rAs[p];
  T rhsU = frcU + rAw * mu *
                      (a11(j, i) - a11(j, i - 1) + a12(j + 1, i) - a12(j, i));
  T rhsV = frcV + rAs * mv *
                      (b12(j, i + 1) - b12(j, i) + b22(j, i) - b22(j - 1, i));
  // _lsr_coeffs (seaice.py:654-711, the metric terms 0 on this grid)
  const T uxx = UXX(j, i), uxx_im = UXX(j, i - 1);
  const T uyy = UYY(j, i), uyy_jp = UYY(j + 1, i);
  const T vxx = VXX(j, i), vxx_ip = VXX(j, i + 1);
  const T vyy = VYY(j, i), vyy_jm = VYY(j - 1, i);
  const T recip_dt = T(q.recip_dt);
  T AU = -uxx_im * mu;
  T CU = -uxx * mu;
  T BU = (T(1) - mu) + (uxx_im + uxx + uyy_jp + uyy) * mu;
  const T mu_jm = mU(j - 1, i), mu_jp = mU(j + 1, i);
  BU = BU + mu * ((T(1) - mu_jm) * uyy + (T(1) - mu_jp) * uyy_jp);
  T uRt1 = uyy * mu_jm * rAw;
  T uRt2 = uyy_jp * mu_jp * rAw;
  AU = AU * rAw;
  CU = CU * rAw;
  BU = BU * rAw + mu * (recip_dt * a.massU[p] +
                        T(0.5) * (dw * coswat + dw_im * coswat) * a.areaW[p]);
  T AV = -vyy_jm * mv;
  T CV = -vyy * mv;
  T BV = (T(1) - mv) + (vxx + vxx_ip + vyy + vyy_jm) * mv;
  const T mv_im = mV(j, i - 1), mv_ip = mV(j, i + 1);
  BV = BV + mv * ((T(1) - mv_im) * vxx + (T(1) - mv_ip) * vxx_ip);
  T vRt1 = vxx * mv_im * rAs;
  T vRt2 = vxx_ip * mv_ip * rAs;
  AV = AV * rAs;
  CV = CV * rAs;
  BV = BV * rAs + mv * (recip_dt * a.massV[p] +
                        T(0.5) * (dw * coswat + dw_jm * coswat) * a.areaS[p]);
  // the open-boundary / land closure and the zero-diagonal guard
  const T mI = mIn(j, i);
  if (mI * mIn(j, i - 1) == T(0)) {
    AU = T(0); BU = T(1); CU = T(0); uRt1 = T(0); uRt2 = T(0);
    rhsU = a.uIce[p];
  }
  if (mI * mIn(j - 1, i) == T(0)) {
    AV = T(0); BV = T(1); CV = T(0); vRt1 = T(0); vRt2 = T(0);
    rhsV = a.vIce[p];
  }
  if (q.guardZeroDiag != 0.0) {
    if (BU == T(0)) BU = T(1);
    if (BV == T(0)) BV = T(1);
  }
  a.AU[p] = AU; a.BU[p] = BU; a.CU[p] = CU;
  a.AV[p] = AV; a.BV[p] = BV; a.CV[p] = CV;
  a.uRt1[p] = uRt1; a.uRt2[p] = uRt2; a.vRt1[p] = vRt1; a.vRt2[p] = vRt2;
  a.rhsU[p] = rhsU; a.rhsV[p] = rhsV; a.dwatn[p] = dw;
}

// ---------------------------------------------------------------------
// seaice_lsr_tridiag_u / _v
// ---------------------------------------------------------------------
// ctrl: [done, m, it4u, it4v, ICOUNT1, ICOUNT2]; wf: [WFAU, WFAV, S1A, S2A]
template <typename T, bool X>
__global__ void seaice_lsr_tridiag_kernel(
    const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ C,
    const T* __restrict__ r1, const T* __restrict__ r2,
    const T* __restrict__ rhs, const T* __restrict__ mask, T* u,
    const T* __restrict__ uTmp, T* __restrict__ cuu, const int* ctrl,
    const T* wf, int nxp, int ol, int sNy, int sNx, int nSy, int nSx, int k) {
  if (ctrl[0] || !ctrl[X ? 2 : 3]) return;
  // lines of parity k across the line direction, per tile
  const int across = X ? sNy : sNx;
  const int len = X ? sNx : sNy;
  const int nLines = (across - k + 1) / 2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nSy * nSx * nLines) return;
  const int tile = t / nLines;
  const int pos = k + 2 * (t % nLines);   // the line's place in its tile
  const int ty = tile / nSx, tx = tile % nSx;
  const int J0 = ol + ty * sNy, I0 = ol + tx * sNx;
  const size_t sa = X ? 1 : static_cast<size_t>(nxp);   // along the line
  const size_t sx = X ? static_cast<size_t>(nxp) : 1;   // across it
  const size_t base = X ? static_cast<size_t>(J0 + pos) * nxp + I0
                        : static_cast<size_t>(J0) * nxp + I0 + pos;
  const T* um = pos > 0 ? u : uTmp;             // the line before
  const T* up = pos + 1 < across ? u : uTmp;    // the line after
  const T wfa = wf[X ? 0 : 1];
  T cuu_m = T(0), urt_m = T(0);
  for (int s = 0; s < len; ++s) {
    const size_t p = base + s * sa;
    T r = rhs[p] + r1[p] * um[p - sx] + r2[p] * up[p + sx];
    if (s == 0) r = r + (-A[p]) * uTmp[p - sa];
    if (s == len - 1) r = r + (-C[p]) * uTmp[p + sa];
    r = r * mask[p];
    T c_, u_;
    if (s == 0) {
      c_ = C[p] / B[p];
      u_ = r / B[p];
    } else {
      const T bet = B[p] - A[p] * cuu_m;
      c_ = C[p] / bet;
      u_ = (r - A[p] * urt_m) / bet;
    }
    cuu[p] = c_;
    u[p] = u_;        // urt, until the back substitution
    cuu_m = c_;
    urt_m = u_;
  }
  T x = T(0);
  for (int s = len - 1; s >= 0; --s) {
    const size_t p = base + s * sa;
    x = s == len - 1 ? u[p] : u[p] - cuu[p] * x;
    const T t0 = uTmp[p];
    u[p] = t0 + wfa * (x - t0);
  }
}

// ---------------------------------------------------------------------
// seaice_lsr_check
// ---------------------------------------------------------------------
struct Max {
  template <typename T>
  __device__ T operator()(T a, T b) const { return nmax(a, b); }
};

template <typename T>
__global__ void seaice_lsr_check_kernel(
    T* u, T* v, T* __restrict__ uTmp, T* __restrict__ vTmp,
    const T* __restrict__ maskU, const T* __restrict__ maskV, int* ctrl,
    T* wf, T* partials, unsigned int* counter, int ny, int nx, int ol,
    int ncheck, int maxIter, T lsrError) {
  if (ctrl[0]) return;   // the same for every block of the launch
  __shared__ T sh[2][NT];
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int nxp = nx + 2 * ol, nyp = ny + 2 * ol;
  const int m = ctrl[1] + 1;
  const bool chk = m % ncheck == 0;
  const bool chku = chk && ctrl[2], chkv = chk && ctrl[3];
  T s1 = T(0), s2 = T(0);
  if (i < nxp && j < nyp) {
    const size_t p = static_cast<size_t>(j) * nxp + i;
    const bool inside = j >= ol && j < ny + ol && i >= ol && i < nx + ol;
    if (inside) {
      const T uu = u[p], vv = v[p];
      if (chku) s1 = fabs((uu - uTmp[p]) * maskU[p]);
      if (chkv) s2 = fabs((vv - vTmp[p]) * maskV[p]);
      uTmp[p] = uu;
      vTmp[p] = vv;
    } else {   // the halo fill (cyclic), and the snapshot of it
      const size_t q = static_cast<size_t>(wrap(j, ol, ny)) * nxp +
                       wrap(i, ol, nx);
      const T uu = u[q], vv = v[q];
      u[p] = uu;
      v[p] = vv;
      uTmp[p] = uu;
      vTmp[p] = vv;
    }
  }
  // the two maxima over the grid (a max is exact in any order)
  const T s12[2] = {s1, s2};
  T smax[2];
  if (!grid_reduce(s12, Max(), &sh[0][0], partials, counter, smax)) return;
  const bool chks[2] = {chku, chkv};
  for (int c = 0; c < 2; ++c) {
    if (!chks[c]) continue;
    const T s = smax[c];
    if (m > 1 && s > wf[2 + c]) wf[c] = T(0);
    wf[2 + c] = s;
    if (s < lsrError) {
      ctrl[4 + c] = m;
      ctrl[2 + c] = 0;
    }
  }
  ctrl[1] = m;
  ctrl[0] = (m < maxIter && (ctrl[2] || ctrl[3])) ? 0 : 1;
}

template <typename T, typename Args, int N>
bool table_of(const void* const* table, int n, Args* a) {
  static_assert(sizeof(Args) == N * sizeof(void*),
                "the argument struct must be a plain table of pointers");
  if (n != N) return false;
  std::memcpy(a, table, sizeof(*a));
  return true;
}

template <typename T>
int launch_lsr_visc(const void* const* table, int n, const double* params,
                    int nparams, int nyp, int nxp, cudaStream_t stream) {
  ViscArgs<T> a;
  if (!table_of<T, ViscArgs<T>, kViscPointers>(table, n, &a) ||
      nparams != static_cast<int>(sizeof(ViscParams) / sizeof(double)))
    return (int)cudaErrorInvalidValue;
  ViscParams q;
  std::memcpy(&q, params, sizeof(q));
  seaice_lsr_visc_kernel<T><<<grid2d(nyp, nxp), dim3(BX, BY), 0, stream>>>(
      a, q, nyp, nxp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lsr_coeffs(const void* const* table, int n, const double* params,
                      int nparams, int nyp, int nxp, cudaStream_t stream) {
  CoeffArgs<T> a;
  if (!table_of<T, CoeffArgs<T>, kCoeffPointers>(table, n, &a) ||
      nparams != static_cast<int>(sizeof(CoeffParams) / sizeof(double)))
    return (int)cudaErrorInvalidValue;
  CoeffParams q;
  std::memcpy(&q, params, sizeof(q));
  seaice_lsr_coeffs_kernel<T><<<grid2d(nyp, nxp), dim3(BX, BY), 0, stream>>>(
      a, q, nyp, nxp);
  return (int)cudaGetLastError();
}

template <typename T, bool X>
int launch_lsr_tridiag(const void* const* c, void* u, const void* uTmp,
                       void* cuu, const void* ctrl, const void* wf, int nxp,
                       int ol, int sNy, int sNx, int nSy, int nSx, int k,
                       cudaStream_t stream) {
  const int across = X ? sNy : sNx;
  const int threads = nSy * nSx * ((across - k + 1) / 2);
  if (threads <= 0) return (int)cudaErrorInvalidValue;
  constexpr int kBlock = 64;
  seaice_lsr_tridiag_kernel<T, X>
      <<<(threads + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
          (const T*)c[0], (const T*)c[1], (const T*)c[2], (const T*)c[3],
          (const T*)c[4], (const T*)c[5], (const T*)c[6], (T*)u,
          (const T*)uTmp, (T*)cuu, (const int*)ctrl, (const T*)wf, nxp, ol,
          sNy, sNx, nSy, nSx, k);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

using mitgcm::BX;
using mitgcm::BY;
using mitgcm::grid2d;

// The coefficient table of the sweeps: A, B, C, Rt1, Rt2, rhs, the mask.
#define MITGCM_SEAICE_LSR_ENTRY_POINTS(T, SUF)                                \
  extern "C" int mitgcm_seaice_lsr_visc_##SUF(                                \
      const void* const* table, int n, const double* params, int nparams,     \
      int nyp, int nxp, void* stream) {                                       \
    return mitgcm::launch_lsr_visc<T>(table, n, params, nparams, nyp, nxp,    \
                                      (cudaStream_t)stream);                  \
  }                                                                           \
  extern "C" int mitgcm_seaice_lsr_coeffs_##SUF(                              \
      const void* const* table, int n, const double* params, int nparams,     \
      int nyp, int nxp, void* stream) {                                       \
    return mitgcm::launch_lsr_coeffs<T>(table, n, params, nparams, nyp, nxp,  \
                                        (cudaStream_t)stream);                \
  }                                                                           \
  extern "C" int mitgcm_seaice_lsr_tridiag_u_##SUF(                           \
      const void* const* c, int n, void* u, const void* uTmp, void* cuu,      \
      const void* ctrl, const void* wf, int nxp, int ol, int sNy, int sNx,    \
      int nSy, int nSx, int k, void* stream) {                                \
    if (n != 7) return (int)cudaErrorInvalidValue;                            \
    return mitgcm::launch_lsr_tridiag<T, true>(c, u, uTmp, cuu, ctrl, wf,     \
                                               nxp, ol, sNy, sNx, nSy, nSx,   \
                                               k, (cudaStream_t)stream);      \
  }                                                                           \
  extern "C" int mitgcm_seaice_lsr_tridiag_v_##SUF(                           \
      const void* const* c, int n, void* u, const void* uTmp, void* cuu,      \
      const void* ctrl, const void* wf, int nxp, int ol, int sNy, int sNx,    \
      int nSy, int nSx, int k, void* stream) {                                \
    if (n != 7) return (int)cudaErrorInvalidValue;                            \
    return mitgcm::launch_lsr_tridiag<T, false>(c, u, uTmp, cuu, ctrl, wf,    \
                                                nxp, ol, sNy, sNx, nSy, nSx,  \
                                                k, (cudaStream_t)stream);     \
  }                                                                           \
  extern "C" int mitgcm_seaice_lsr_check_##SUF(                               \
      void* u, void* v, void* uTmp, void* vTmp, const void* maskU,            \
      const void* maskV, void* ctrl, void* wf, void* partials, void* counter, \
      int ny, int nx, int ol, int ncheck, int maxIter, double lsrError,       \
      void* stream) {                                                         \
    mitgcm::seaice_lsr_check_kernel<T>                                        \
        <<<grid2d(ny + 2 * ol, nx + 2 * ol), dim3(BX, BY), 0,                 \
           (cudaStream_t)stream>>>(                                           \
            (T*)u, (T*)v, (T*)uTmp, (T*)vTmp, (const T*)maskU,                \
            (const T*)maskV, (int*)ctrl, (T*)wf, (T*)partials,                \
            (unsigned int*)counter, ny, nx, ol, ncheck, maxIter,              \
            T(lsrError));                                                     \
    return (int)cudaGetLastError();                                           \
  }

MITGCM_SEAICE_LSR_ENTRY_POINTS(float, f32)
MITGCM_SEAICE_LSR_ENTRY_POINTS(double, f64)
