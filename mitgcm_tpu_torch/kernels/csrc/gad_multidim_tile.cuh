// Kernel M's three sweeps, and their launches. Included by gad_multidim.cu,
// whose entry points start them on the card, and by the host check of the
// tests, which runs them on the CPU.
//
// Each face's flux is formed once, by one evaluation of the scheme on its
// stencil: the source at the cells i-2 .. i+1 of a face i and the face
// masks at the faces i-1 .. i+1 (the JAX code's shifts, 0 outside the
// padded array), the transport and the Courant number of the face.
//  - X (md_x_kernel): a warp takes 32 cells of a row, i0 - 2 .. i0 + 29,
//    a lane each, 0 outside the padded array, and walks 8 levels with the
//    next level's loads in flight. Each lane takes its stencil's source
//    and face masks (maskW maskInW) from its neighbours by warp shuffles
//    and forms the flux of its west face once (lanes 2 .. 30); lanes
//    2 .. 29 update their cell from the flux and transport that the lane
//    east of them passes. Warps overlap by four cells: 28 cells a warp.
//    (A block tile staged in shared memory with two barriers a level, as
//    O's X sweep is, with the derived values below formed at the load, was
//    about 1.5 times slower; PERF.md's PR 19 section has the times.)
//  - Y (md_y_kernel): one thread walks 32 rows of a column and level, with
//    a ring of the stencil's 4 rows of the source and 3 face masks
//    (maskS maskInS, 0 outside the array) in registers; it forms each
//    face's flux once and carries it to the next row as its southern flux.
//  - R (md_r_kernel): one thread a column walks the levels down with a
//    ring of 4 levels of the source and of maskC (clamped to the column:
//    the neighbours max(0, k-2) and min(nr-1, k+1) of interface k) in
//    registers, forms each interface's flux once and carries it to the
//    next level as that level's upper flux; the surface flux is 0.
// Each sweep issues a level's or row's loads a level or row ahead, and
// forms the values derived from them (the face masks, the Courant
// numbers) only when the level or row is computed: a product formed at the
// load waits for it (Y was about 12 % slower so). Each
// kernel is a template on the scheme, so each scheme's code is compiled
// alone and reads only what it needs (no masks for schemes 1 and 20, no
// velocity for scheme 1). The arithmetic of each flux (gad_advect.cuh:
// flux_h, and flux_r below) and of each update is the JAX code's, in its
// order (the twin is model/gad.py:_md_plain_x/_y/_r), so built with
// --fmad=false every output is bit-equal to the twin's.
#pragma once

#include "gad_advect.cuh"

namespace mitgcm {

// whether a horizontal scheme reads the face masks, and the velocity
template <int S>
constexpr bool kMdMasks = S != kUpwind1 && S != kDst2;
template <int S>
constexpr bool kMdVel = S != kUpwind1;

// the flux of a horizontal face from its stencil (gad.py:adv_flux_x/_y):
// the source at the cells i-2 .. i+1 and the face masks at i-1 .. i+1
template <typename T, int S>
__device__ __forceinline__ T md_flux_h(T trans, T vdt, T qm2, T qm1, T q0,
                                       T qp1, T mm1, T m0, T mp1) {
  if (!kMdMasks<S>)
    return flux_h<T, S>(trans, vdt, q0, qm1, T(0), T(0), T(0));
  const T Rjp = (qp1 - q0) * mp1;
  const T Rj = (q0 - qm1) * m0;
  const T Rjm = (qm1 - qm2) * mm1;
  return flux_h<T, S>(trans, vdt, q0, qm1, Rjp, Rj, Rjm);
}

// the flux at interface k, the top of cell k (gad.py:adv_flux_r), for
// 0 < k < nr: q the source at max(0, k-2), k-1, k, min(nr-1, k+1), m maskC
// at the same levels, wdt the vertical velocity times deltaT over drC
template <typename T, int S>
__device__ __forceinline__ T md_flux_r(int k, int nr, T rT, T wdt,
                                       const T (&q)[4], const T (&m)[4]) {
  const T tkm2 = q[0], tkm1 = q[1], t = q[2], tkp1 = q[3];
  const T mkm2 = m[0], mkm1 = m[1], mC = m[2], mkp1 = m[3];
  const T absT = fabs(rT);
  if (S == kCentered2) return mkm1 * rT * T(0.5) * (t + tkm1);
  if (S == kUpwind1 || S == kDst2) {
    // gad_dst2u1_adv_r.F: rkSign flips the upwind direction in r
    const T limit = S == kUpwind1 ? T(1) : fabs(wdt);
    return mkm1 * T(0.5) * (rT * (t + tkm1) + absT * limit * (t - tkm1));
  }
  if (S == kCentered4) {
    // 4th-order centred; the upwind correction only next to the top and
    // the bottom: maskBound = 0 at interfaces k + 1 <= 2 or >= nr
    const T maskPM = (k + 1 <= 2 || k + 1 >= nr) ? T(0) : T(1);
    const T maskBound = maskPM * mkm2 * mkp1;
    const T Rjp = (tkp1 - t) * mkp1;
    const T Rj = t - tkm1;
    const T Rjm = (tkm1 - tkm2) * mkm1;
    const T Rjjp = Rjp - Rj, Rjjm = Rj - Rjm;
    return mkm1 *
           (rT * ((t + tkm1) * T(0.5) - (Rjjm + Rjjp) * T(1.0 / 12.0)) +
            absT * T(1.0 / 6.0) * (Rjjm - Rjjp) * T(0.5) *
                (T(1) - maskBound));
  }
  if (S == kUpwind3) {
    // gad_u3_adv_r.F: its R's run top-down, Rjm masked with m(k-2)
    const T Rjjp = (tkp1 - t) * mkp1 - (t - tkm1);
    const T Rjjm = (t - tkm1) - (tkm1 - tkm2) * mkm2;
    return mkm1 * (rT * ((t + tkm1) * T(0.5) -
                         T(1.0 / 6.0) * (Rjjm + Rjjp) * T(0.5)) +
                   absT * T(1.0 / 6.0) * (Rjjm - Rjjp) * T(0.5));
  }
  const T wCFL = fabs(wdt);
  if (S == kFluxLimit) {
    const T Rjp = (tkp1 - t) * mkp1;
    const T Rj = t - tkm1;
    const T Rjm = (tkm1 - tkm2) * mkm2;
    const T lim = superbee(Rj, rT < T(0) ? Rjm : Rjp);
    return mkm1 * (rT * (t + tkm1) * T(0.5) +
                   absT * ((T(1) - lim) + wCFL * lim) * Rj * T(0.5));
  }
  const T Rjp = (t - tkp1) * mkp1;
  const T Rj = (tkm1 - t) * mC * mkm1;
  const T Rjm = (tkm2 - tkm1) * mkm1;
  const T sixth = T(1.0 / 6.0);
  const T d0 = (T(2.0) - wCFL) * (T(1) - wCFL) * sixth;
  const T d1 = (T(1) - wCFL * wCFL) * sixth;
  if (S == kDst3)
    return T(0.5) * (rT + absT) * (t + (d0 * Rj + d1 * Rjp)) +
           T(0.5) * (rT - absT) * (tkm1 - (d0 * Rj + d1 * Rjm));
  const T psiP = dst3fl_psi(Rj, Rjm, wCFL, d0, d1);
  const T psiM = dst3fl_psi(Rj, Rjp, wCFL, d0, d1);
  return T(0.5) * (rT + absT) * (t + psiM * Rj) +
         T(0.5) * (rT - absT) * (tkm1 - psiP * Rj);
}

// The X sweep: a warp takes a segment of a row, its lanes the cells
// i0 - 2 .. i0 + 29, and walks kMdLevels levels; the stencil's neighbours
// come by warp shuffles. Lanes 2 .. 30 form the flux of their west face,
// lanes 2 .. 29 update their cell: kMdXCells cells a warp. A block's
// warps take BY rows.
constexpr int kMdXCells = BX - 4;
constexpr int kMdLevels = 8;

// What a lane of the X sweep loads for one level: the source, maskW, the
// transport and velocity of its cell's west face, and the tracer and
// recip_hFacC of its cell (the face mask maskW maskInW and the Courant
// number are formed when the level is computed, once the loads are in)
template <typename T>
struct MdXLevel {
  T q = T(0), mW = T(0), tr = T(0), u = T(0), trc = T(0), rh = T(0);
};

template <typename T, int S>
__global__ void __launch_bounds__(NT) md_x_kernel(
    const AdvArgs<T> a, const T* __restrict__ src, T* __restrict__ dst,
    int nr, int nyp, int nxp, T deltaT) {
  constexpr bool masks = kMdMasks<S>;
  constexpr unsigned kAll = 0xffffffffu;
  const int l = threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int i = blockIdx.x * kMdXCells - 2 + l;
  const int k0 = blockIdx.z * kMdLevels;
  const int k1 = k0 + kMdLevels < nr ? k0 + kMdLevels : nr;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  // the lane's cell, 0 outside the padded array (a zero-filled read);
  // whether it forms its face's flux and updates its cell
  const bool in = j < nyp && i >= 0 && i < nxp;
  const bool face = in && l >= 2 && l <= BX - 2;
  const bool cell = in && l >= 2 && l < BX - 2;
  const size_t c = in ? static_cast<size_t>(j) * nxp + i : 0;
  const T mIn2 = masks && in ? a.maskInW[c] : T(0);
  const T rdC = kMdVel<S> && in ? a.recip_dxC[c] : T(0);
  const T rA = cell ? a.recip_rA[c] : T(0);
  const T mInC = cell ? a.maskInC[c] : T(0);
  auto fetch = [&](int k) {
    MdXLevel<T> v;
    const size_t p = k * P + c;
    if (in) {
      v.q = src[p];
      if (masks) v.mW = a.maskW[p];
      v.tr = a.uTrans[p];
      if (kMdVel<S>) v.u = a.uVel[p];
    }
    if (cell) v.trc = a.tracer[p], v.rh = a.recip_hFacC[p];
    return v;
  };
  MdXLevel<T> cur;
  if (k0 < k1) cur = fetch(k0);
  for (int k = k0; k < k1; ++k) {
    MdXLevel<T> nxt;
    if (k + 1 < k1) nxt = fetch(k + 1);
    const T qm1 = __shfl_up_sync(kAll, cur.q, 1);
    const T qm2 = __shfl_up_sync(kAll, cur.q, 2);
    const T qp1 = __shfl_down_sync(kAll, cur.q, 1);
    T m = T(0), mm1 = T(0), mp1 = T(0);
    if (masks) {
      m = cur.mW * mIn2;
      mm1 = __shfl_up_sync(kAll, m, 1);
      mp1 = __shfl_down_sync(kAll, m, 1);
    }
    // the west face's flux, once; 0 for a face outside the array
    T f = T(0);
    if (face) {
      const T vdt = kMdVel<S> ? cur.u * deltaT * rdC : T(0);
      f = md_flux_h<T, S>(cur.tr, vdt, qm2, qm1, cur.q, qp1, mm1, m, mp1);
    }
    const T fE = __shfl_down_sync(kAll, f, 1);
    const T uE = __shfl_down_sync(kAll, cur.tr, 1);
    if (cell) {
      const T vol = deltaT * cur.rh * a.recip_drF[k] * rA;
      dst[k * P + c] =
          cur.q - vol * ((fE - f) - cur.trc * (uE - cur.tr)) * mInC;
    }
    cur = nxt;
  }
}

// The Y walk: a thread walks kMdWalkRows rows of one column and level, in
// blocks of kMdYWarps warps. The walk's first face and its ring (4 rows)
// are formed or loaded once more by the walk south of it.
constexpr int kMdWalkRows = 32;
constexpr int kMdYWarps = 4;

// what the Y walk loads for cell j: the source, maskS and maskInS at the
// ring's new row j + 2, the transport, velocity and recip_dyC at face
// j + 1, and the tracer, recip_hFacC, recip_rA and maskInC of cell j (the
// face mask, the Courant number and the volume factor are formed a row
// later, when the loads are in)
template <typename T>
struct MdRow {
  T q = T(0), mS = T(0), mIn2 = T(0), tr = T(0), v = T(0), rd = T(0),
    trc = T(0), rh = T(0), rA = T(0), mIn = T(0);
};

template <typename T, int S>
__global__ void __launch_bounds__(BX * kMdYWarps) md_y_kernel(
    const AdvArgs<T> a, const T* __restrict__ src, T* __restrict__ dst,
    int nr, int nyp, int nxp, T deltaT) {
  constexpr bool masks = kMdMasks<S>;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int walks = (nyp + kMdWalkRows - 1) / kMdWalkRows;
  const int g = blockIdx.y * kMdYWarps + threadIdx.y;
  if (i >= nxp || g >= walks * nr) return;
  const int k = g / walks;
  const int j0 = (g - k * walks) * kMdWalkRows;
  const int j1 = j0 + kMdWalkRows < nyp ? j0 + kMdWalkRows : nyp;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t plane = k * P;
  auto q2 = [&](int j) { return static_cast<size_t>(j) * nxp + i; };
  auto Qat = [&](int j) {
    return j >= 0 && j < nyp ? src[plane + q2(j)] : T(0);
  };
  auto Mat = [&](int j) {
    return masks && j >= 0 && j < nyp
               ? a.maskS[plane + q2(j)] * a.maskInS[q2(j)]
               : T(0);
  };
  auto Vdt = [&](T v, T rd) { return kMdVel<S> ? v * deltaT * rd : T(0); };
  // the flux through the south face of row f from the ring at face f:
  // Q the source at rows f-2 .. f+1, M the face masks at f-1 .. f+1
  auto flux = [&](T trans, T vdt, const T (&Q)[4], const T (&M)[3]) {
    return md_flux_h<T, S>(trans, vdt, Q[0], Q[1], Q[2], Q[3], M[0], M[1],
                           M[2]);
  };
  auto row = [&](int j) {
    MdRow<T> v;
    if (j < j1) {
      v.q = Qat(j + 2);
      if (masks && j + 2 < nyp) {
        v.mS = a.maskS[plane + q2(j + 2)];
        v.mIn2 = a.maskInS[q2(j + 2)];
      }
      if (j + 1 < nyp) {
        v.tr = a.vTrans[plane + q2(j + 1)];
        if (kMdVel<S>) {
          v.v = a.vVel[plane + q2(j + 1)];
          v.rd = a.recip_dyC[q2(j + 1)];
        }
      }
      const size_t c = q2(j);
      v.trc = a.tracer[plane + c];
      v.rh = a.recip_hFacC[plane + c];
      v.rA = a.recip_rA[c];
      v.mIn = a.maskInC[c];
    }
    return v;
  };
  // the ring at face j0 and its flux
  T Q[4], M[3];
#pragma unroll
  for (int o = 0; o < 4; ++o) Q[o] = Qat(j0 + o - 2);
#pragma unroll
  for (int o = 0; o < 3; ++o) M[o] = Mat(j0 + o - 1);
  T uS = a.vTrans[plane + q2(j0)];
  T fS = flux(uS,
              Vdt(kMdVel<S> ? a.vVel[plane + q2(j0)] : T(0),
                  kMdVel<S> ? a.recip_dyC[q2(j0)] : T(0)),
              Q, M);
  MdRow<T> cur = row(j0);
  const T rdrF = a.recip_drF[k];
  for (int j = j0; j < j1; ++j) {
    const MdRow<T> nxt = row(j + 1);
    // the ring at face j + 1
#pragma unroll
    for (int o = 0; o < 3; ++o) Q[o] = Q[o + 1];
    Q[3] = cur.q;
#pragma unroll
    for (int o = 0; o < 2; ++o) M[o] = M[o + 1];
    M[2] = cur.mS * cur.mIn2;
    const T fN = j + 1 < nyp ? flux(cur.tr, Vdt(cur.v, cur.rd), Q, M) : T(0);
    const T vol = deltaT * cur.rh * rdrF * cur.rA;
    dst[plane + q2(j)] =
        Q[1] - vol * ((fN - fS) - cur.trc * (cur.tr - uS)) * cur.mIn;
    fS = fN;
    uS = cur.tr;
    cur = nxt;
  }
}

// what the R walk loads for cell k: the source and maskC at the ring's new
// level lev(k + 2), the transport and velocity at interface k + 1, and the
// tracer and recip_hFacC of cell k
template <typename T>
struct MdLevel {
  // ad: the R sweep's addend at the level (0 without one)
  T q = T(0), m = T(0), rT = T(0), w = T(0), tr = T(0), rh = T(0), ad = T(0);
};

// whether a vertical scheme reads the velocity
template <int S>
constexpr bool kMdWVel = S != kUpwind1 && S != kCentered2 &&
                         S != kUpwind3 && S != kCentered4;

// The R sweep, gTr = (localT - tracer) / deltaT, one thread a column.
template <typename T, int S>
__global__ void __launch_bounds__(NT) md_r_kernel(
    const AdvArgs<T> a, const T* __restrict__ src, T* __restrict__ dst,
    const T* __restrict__ add, int nr, int nyp, int nxp, T deltaT,
    T rkSign) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q2 = static_cast<size_t>(j) * nxp + i;
  auto lev = [&](int l) { return l < 0 ? 0 : (l > nr - 1 ? nr - 1 : l); };
  auto level = [&](int k) {
    MdLevel<T> v;
    if (k < nr) {
      const size_t pq = lev(k + 2) * P + q2;
      v.q = src[pq];
      v.m = a.maskC[pq];
      if (k + 1 < nr) {
        v.rT = a.rTrans[(k + 1) * P + q2];
        if (kMdWVel<S>) v.w = a.wVel[(k + 1) * P + q2];
      }
      v.tr = a.tracer[k * P + q2];
      v.rh = a.recip_hFacC[k * P + q2];
      if (add) v.ad = add[k * P + q2];
    }
    return v;
  };
  // the ring at interface 0: the source and maskC at lev(o - 2)
  T Q[4], M[4];
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    Q[o] = src[lev(o - 2) * P + q2];
    M[o] = a.maskC[lev(o - 2) * P + q2];
  }
  const T rA = a.recip_rA[q2], mIn = a.maskInC[q2];
  MdLevel<T> cur = level(0);
  T fK = T(0), rTk = a.rTrans[q2];
  for (int k = 0; k < nr; ++k) {
    const MdLevel<T> nxt = level(k + 1);
    // the ring at interface k + 1: lev(k - 1), k, k + 1, lev(k + 2)
#pragma unroll
    for (int o = 0; o < 3; ++o) Q[o] = Q[o + 1], M[o] = M[o + 1];
    Q[3] = cur.q;
    M[3] = cur.m;
    T fK1 = T(0);
    if (k + 1 < nr) {
      const T wdt =
          kMdWVel<S> ? cur.w * deltaT * a.recip_drC[k + 1] : T(0);
      fK1 = md_flux_r<T, S>(k + 1, nr, cur.rT, wdt, Q, M);
    }
    const size_t p = k * P + q2;
    const T vol = deltaT * cur.rh * a.recip_drF[k] * rA;
    const T localT =
        Q[1] - vol * ((fK1 - fK) - cur.tr * (cur.rT - rTk)) * rkSign * mIn;
    const T g = (localT - cur.tr) / deltaT;
    dst[p] = add ? g + cur.ad : g;
    fK = fK1;
    rTk = cur.rT;
    cur = nxt;
  }
}

// Start sweep DIR (0 X, 1 Y, 2 R) of scheme S with start(kernel, grid,
// block, args...) (OnStream on the card).
template <typename T, int DIR, int S, typename Start>
void launch_md(const AdvArgs<T>& a, const T* s, T* d, const T* add, int nr,
               int nyp, int nxp, double deltaT, double rkSign, Start start) {
  if constexpr (DIR == 2) {
    start(md_r_kernel<T, S>, grid2d(nyp, nxp), dim3(BX, BY), a, s, d, add,
          nr, nyp, nxp, T(deltaT), T(rkSign));
  } else if constexpr (DIR == 1) {
    const int walks = (nyp + kMdWalkRows - 1) / kMdWalkRows;
    start(md_y_kernel<T, S>,
          dim3((nxp + BX - 1) / BX, (walks * nr + kMdYWarps - 1) / kMdYWarps),
          dim3(BX, kMdYWarps), a, s, d, nr, nyp, nxp, T(deltaT));
  } else {
    start(md_x_kernel<T, S>,
          dim3((nxp + kMdXCells - 1) / kMdXCells, (nyp + BY - 1) / BY,
               (nr + kMdLevels - 1) / kMdLevels),
          dim3(BX, BY), a, s, d, nr, nyp, nxp, T(deltaT));
  }
}

// the schemes M owns: 1, 20, 30, 33, 77 in X and Y, and 2, 3, 4 besides in
// R; add (R only, else null): a field the R sweep adds to gTr, gTr + add
// (the tracer's other tendency, thermodynamics.py's `+ gTr`)
template <typename T, int DIR, typename Start>
int launch_multidim(const void* const* table, int n, const void* src,
                    void* dst, const void* add, int nr, int nyp, int nxp,
                    int scheme, double deltaT, double rkSign, Start start) {
  AdvArgs<T> a;
  // the tiles index a level's plane with an int
  if (!adv_args(table, n, &a) || nr < 1 || nyp < 1 || nxp < 1 ||
      static_cast<long long>(nyp) * nxp > 0x7fffffffLL || src == nullptr ||
      dst == nullptr || (DIR != 2 && add != nullptr))
    return (int)cudaErrorInvalidValue;
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  const T* ad = static_cast<const T*>(add);
#define MITGCM_MD_CASE(S)                                                   \
  case S:                                                                   \
    launch_md<T, DIR, S>(a, s, d, ad, nr, nyp, nxp, deltaT, rkSign, start); \
    break;
  switch (scheme) {
    MITGCM_MD_CASE(kUpwind1)
    MITGCM_MD_CASE(kDst2)
    MITGCM_MD_CASE(kDst3)
    MITGCM_MD_CASE(kDst3FluxLimit)
    MITGCM_MD_CASE(kFluxLimit)
    default:
      if constexpr (DIR == 2) {
        switch (scheme) {
          MITGCM_MD_CASE(kCentered2)
          MITGCM_MD_CASE(kUpwind3)
          MITGCM_MD_CASE(kCentered4)
          default:
            return (int)cudaErrorInvalidValue;
        }
      } else {
        return (int)cudaErrorInvalidValue;
      }
  }
#undef MITGCM_MD_CASE
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
