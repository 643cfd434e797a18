// Kernel O's three sweeps, and their launches. Included by gad_os7mp.cu,
// whose entry points start them on the card, and by the host check of the
// tests, which runs them on the CPU.
//
// Each face's flux is formed once, by one evaluation of os7mp_psi on the
// stencil of the transport's upwind side: the seven source values and six
// face masks are picked by index arithmetic (X) or selects (Y, R) on the
// transport's sign, so that a warp whose transports change sign runs one
// evaluation, not both. A zero (or NaN) transport gives a zero flux, as
// the twin's where() does.
//  - X (os7mp_x_kernel): a block stages a tile of 31 cells of 8 rows with
//    the stencil's margin in shared memory: the source at cells i0 - 4 ..
//    i0 + 34 and the face masks maskW maskInW at faces i0 - 3 .. i0 + 34,
//    0 outside the padded array (the zero-filled shifts). It forms the
//    flux of the 32 faces i0 .. i0 + 31 once, times the write band, and
//    the transport of each, into shared memory; then each of the 31 cells
//    is updated from its two faces. Tiles overlap by one face: the face
//    i0 + 31 is the next tile's first. The block does so at 8 levels in
//    turn, the next level's loads in flight while it computes one.
//  - Y (os7mp_y_kernel): one thread walks 32 rows of a column and level,
//    with a ring of the stencil's 8 rows of the source and 7 face masks
//    (maskS maskInS, 0 outside the array) in registers; it forms each
//    face's flux once and carries it to the next row as its southern flux.
//  - R (os7mp_r_kernel): one thread a column walks the levels down with a
//    ring of 8 levels of the source and 7 level-step masks (maskC of a
//    clamped level times float(its level - the level above it), the
//    twin's column-end factors) in registers, forms each interface's flux
//    once and carries it to the next level as that level's upper flux.
// The walks issue each row's or level's loads a row or level ahead. The
// arithmetic of each flux and update is the JAX code's, in its order (the
// twin is model/gad_ho.py), so built with --fmad=false every output is
// bit-equal to the twin's.
#pragma once

#include "gad_advect.cuh"

namespace mitgcm {

// 1 / d as the scheme takes it: sign(d) / max(|d|, Eps), 1 / Eps at d == 0
template <typename T>
__device__ __forceinline__ T os7mp_recip(T d) {
  const T Eps = T(1.0e-20);
  if (d == T(0)) return T(1.0 / 1.0e-20);
  return (d > T(0) ? T(1) : (d < T(0) ? T(-1) : d)) / nmax(fabs(d), Eps);
}

// the median-curvature bound of gad.py:154-167
template <typename T>
__device__ __forceinline__ T os7mp_curv(T d2m, T d2p) {
  const T A = T(4.0) * d2m - d2p;
  const T B = T(4.0) * d2p - d2m;
  return nmax(nmin(nmin(A, B), nmin(d2m, d2p)), T(0)) +
         nmin(nmax(nmax(A, B), nmax(d2m, d2p)), T(0));
}

// gad.py:os7mp_psi: the OS7MP flux of one upwind direction, with the
// upwind-ordered stencils q = (Qippp .. Qimmm) and m = (MskIpp .. MskImmm)
template <typename T>
__device__ T os7mp_psi(T trans, T cfl, const T (&q)[7], const T (&m)[6]) {
  const T Eps = T(1.0e-20);
  const T Qippp = q[0], Qipp = q[1], Qip = q[2], Qi = q[3], Qim = q[4],
          Qimm = q[5], Qimmm = q[6];
  const T MskIpp = m[0], MskIp = m[1], MskI = m[2], MskIm = m[3],
          MskImm = m[4], MskImmm = m[5];
  const T DelP = (Qip - Qi) * MskI;
  T Phi = DelP;
  T Fac = (cfl + T(1)) / T(3.0);
  const T DelM = (Qi - Qim) * MskIm;
  const T Del2 = DelP - DelM;
  Phi = Phi - Fac * Del2;
  Fac = Fac * (cfl - T(2.0)) / T(4.0);
  const T DelPP = (Qipp - Qip) * MskIp * MskI;
  const T Del2P = DelPP - DelP;
  const T Del3P = Del2P - Del2;
  Phi = Phi + Fac * Del3P;
  Fac = Fac * (cfl - T(3.0)) / T(5.0);
  const T DelMM = (Qim - Qimm) * MskImm * MskIm;
  const T Del2M = DelM - DelMM;
  const T Del3M = Del2 - Del2M;
  const T Del4 = Del3P - Del3M;
  Phi = Phi + Fac * Del4;
  Fac = Fac * (cfl + T(2.0)) / T(6.0);
  const T DelPPP = (Qippp - Qipp) * MskIpp * MskIp * MskI;
  const T Del2PP = DelPP - DelP;
  const T Del3PP = Del2PP - Del2P;
  const T Del4P = Del3PP - Del3P;
  const T Del5P = Del4P - Del4;
  Phi = Phi + Fac * Del5P;
  Fac = Fac * (cfl + T(2.0)) / T(7.0);
  const T DelMMM = (Qimm - Qimmm) * MskImmm * MskImm * MskIm;
  const T Del2MM = DelMM - DelMMM;
  const T Del3MM = Del2M - Del2MM;
  const T Del4M = Del3M - Del3MM;
  const T Del5M = Del4 - Del4M;
  const T Del6 = Del5P - Del5M;
  Phi = Phi - Fac * Del6;
  const T DelIp = (Qip - Qi) * MskI;
  const T recip_DelIp = os7mp_recip(DelIp);
  Phi = Phi * recip_DelIp;
  const T DelI = (Qi - Qim) * MskIm;
  const T recip_DelI = os7mp_recip(DelI);
  const T rp1h = DelI * recip_DelIp;
  const T rp1h_cfl = rp1h / (cfl + Eps);
  const T dp1h = os7mp_curv(Del2, Del2P);
  const T dm1h = os7mp_curv(Del2M, Del2);
  const T PhiMD = T(1) / (T(1) - cfl) * (DelIp - dp1h) * recip_DelIp;
  const T PhiLC = rp1h_cfl * (T(1) + dm1h * recip_DelI);
  const T PhiMin = nmax(nmin(PhiMD, T(0)),
                        nmin(nmin(T(2.0) * rp1h_cfl, T(0)), PhiLC));
  const T PhiMax = nmin(nmax(T(2.0) / (T(1) - cfl), PhiMD),
                        nmax(nmax(T(2.0) * rp1h_cfl, T(0)), PhiLC));
  Phi = nmax(PhiMin, nmin(Phi, PhiMax));
  const T Psi = Phi * T(0.5) * (T(1) - cfl);
  return trans * (Qi + Psi * DelIp);
}

// the flux of a nonzero transport, else 0 (NaN included, as the twin's
// where(trans > 0, fp, where(trans < 0, fn, 0)))
template <typename T>
__device__ __forceinline__ T os7mp_select(T trans, T psi) {
  return (trans > T(0) || trans < T(0)) ? psi : T(0);
}

// blocks an SM that the walks' registers must allow in float32: four of
// 256 threads for R (at most 64 registers a thread), seven of 128 for Y
// (72)
template <typename T>
constexpr int kOsWalkBlocks = sizeof(T) == 4 ? 4 : 1;
constexpr int kOsYWarps = 4;
template <typename T>
constexpr int kOsYBlocks = sizeof(T) == 4 ? 7 : 1;

// The X tile: kOsFaces faces of kOsRows rows (a face a thread), the first
// kOsCells cells of each row updated, at kOsLevels levels in turn.
constexpr int kOsFaces = BX;
constexpr int kOsCells = kOsFaces - 1;
constexpr int kOsRows = BY;
constexpr int kOsQ = kOsCells + 8;    // source: cells i0 - 4 .. i0 + 34
constexpr int kOsM = kOsFaces + 6;    // face masks: i0 - 3 .. i0 + 34
constexpr int kOsLevels = 8;
// the staged values of each array a thread stores
constexpr int kOsStage = 2;
static_assert(kOsQ * kOsRows <= kOsStage * NT &&
                  kOsM * kOsRows <= kOsStage * NT,
              "two staged values of each array a thread");

// What a thread of the X tile loads for one level: its share of the staged
// source and face masks (maskW times the 2-D maskInW, loaded once), the
// transport and Courant number of its face, and the tracer and
// recip_hFacC of its cell.
template <typename T>
struct Os7mpXLevel {
  T q[kOsStage], m[kOsStage], tr, cfl, trc, rh;
};

// The X sweep of a tile (blockIdx.z: its chunk of levels). Each level:
// stage, barrier, issue the next level's loads, form the faces' fluxes,
// barrier, update the cells.
template <typename T>
__global__ void __launch_bounds__(NT) os7mp_x_kernel(
    const AdvArgs<T> a, const T* __restrict__ src, T* __restrict__ dst,
    int nr, int nyp, int nxp, T deltaT) {
  __shared__ T sQ[kOsRows][kOsQ], sM[kOsRows][kOsM], sF[kOsRows][kOsFaces],
      sU[kOsRows][kOsFaces];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * BX + tx;
  const int k0 = blockIdx.z * kOsLevels;
  const int k1 = k0 + kOsLevels < nr ? k0 + kOsLevels : nr;
  const int i0 = blockIdx.x * kOsCells, j0 = blockIdx.y * kOsRows;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  // the 2-D index of (row jr of the tile, column i), -1 outside the padded
  // array (a zero-filled read)
  auto at2 = [&](int jr, int i) {
    const int j = j0 + jr;
    return i >= 0 && i < nxp && j < nyp ? j * nxp + i : -1;
  };
  // this thread's staged values, face and cell, and their 2-D fields
  int qi[kOsStage], mi[kOsStage];
  T mIn2[kOsStage];
#pragma unroll
  for (int r = 0; r < kOsStage; ++r) {
    const int e = t + r * NT;
    qi[r] = e < kOsQ * kOsRows ? at2(e / kOsQ, i0 - 4 + e % kOsQ) : -1;
    mi[r] = e < kOsM * kOsRows ? at2(e / kOsM, i0 - 3 + e % kOsM) : -1;
    mIn2[r] = mi[r] >= 0 ? a.maskInW[mi[r]] : T(0);
  }
  const int fi = at2(ty, i0 + tx);
  const int ci = tx < kOsCells ? fi : -1;
  const T rdC = fi >= 0 ? a.recip_dxC[fi] : T(0);
  const T rA = ci >= 0 ? a.recip_rA[ci] : T(0);
  const T mInC = ci >= 0 ? a.maskInC[ci] : T(0);
  auto fetch = [&](int k, Os7mpXLevel<T>& v) {
    const size_t plane = k * P;
#pragma unroll
    for (int r = 0; r < kOsStage; ++r) {
      v.q[r] = qi[r] >= 0 ? src[plane + qi[r]] : T(0);
      v.m[r] = mi[r] >= 0 ? a.maskW[plane + mi[r]] * mIn2[r] : T(0);
    }
    v.tr = fi >= 0 ? a.uTrans[plane + fi] : T(0);
    v.cfl = fi >= 0 ? fabs(a.uVel[plane + fi] * deltaT * rdC) : T(0);
    v.trc = ci >= 0 ? a.tracer[plane + ci] : T(0);
    v.rh = ci >= 0 ? a.recip_hFacC[plane + ci] : T(0);
  };
  Os7mpXLevel<T> cur, nxt;
  if (k0 < k1) fetch(k0, cur);
  for (int k = k0; k < k1; ++k) {
#pragma unroll
    for (int r = 0; r < kOsStage; ++r) {
      const int e = t + r * NT;
      if (e < kOsQ * kOsRows) sQ[e / kOsQ][e % kOsQ] = cur.q[r];
      if (e < kOsM * kOsRows) sM[e / kOsM][e % kOsM] = cur.m[r];
    }
    __syncthreads();
    if (k + 1 < k1) fetch(k + 1, nxt);
    // this thread's face's flux, once: the upwind stencil starts 2 past the
    // face for a positive transport (read backwards), 3 before it for a
    // negative one
    const int i = i0 + tx;
    T f = T(0);
    if (i < nxp) {
      const bool pos = cur.tr > T(0);
      const int dir = pos ? -1 : 1;
      const int q0 = tx + 4 + (pos ? 2 : -3);
      const int m0 = tx + 3 + (pos ? 2 : -2);
      T q[7], mk[6];
#pragma unroll
      for (int s = 0; s < 7; ++s) q[s] = sQ[ty][q0 + dir * s];
#pragma unroll
      for (int s = 0; s < 6; ++s) mk[s] = sM[ty][m0 + dir * s];
      const T band = (i >= 4 && i < nxp - 3) ? T(1) : T(0);
      f = os7mp_select(cur.tr, os7mp_psi(cur.tr, cur.cfl, q, mk)) * band;
    }
    sF[ty][tx] = f;
    sU[ty][tx] = cur.tr;
    const T srcc = sQ[ty][tx + 4];
    __syncthreads();
    // this thread's cell from its two faces
    if (ci >= 0) {
      const T vol = deltaT * cur.rh * a.recip_drF[k] * rA;
      dst[k * P + ci] =
          srcc - vol * ((sF[ty][tx + 1] - sF[ty][tx]) -
                        cur.trc * (sU[ty][tx + 1] - sU[ty][tx])) *
                     mInC;
    }
    cur = nxt;
  }
}

// The Y walk: a thread walks kOsWalkRows rows of one column and level. The
// walk's first face and its ring (7 rows) are formed or loaded once more
// by the walk south of it.
constexpr int kOsWalkRows = 32;

// what the Y walk loads for cell j: the source and face mask at the ring's
// new row j + 4, the transport, velocity and recip_dyC at face j + 1, and
// the tracer, recip_hFacC, recip_rA and maskInC of cell j (the Courant
// number and the volume factor are formed a row later, when the loads are
// in)
template <typename T>
struct Os7mpRow {
  T q = T(0), m = T(0), tr = T(0), v = T(0), rd = T(0), trc = T(0),
    rh = T(0), rA = T(0), mIn = T(0);
};

template <typename T>
__global__ void __launch_bounds__(BX * kOsYWarps, kOsYBlocks<T>)
    os7mp_y_kernel(
    const AdvArgs<T> a, const T* __restrict__ src, T* __restrict__ dst,
    int nr, int nyp, int nxp, T deltaT) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int walks = (nyp + kOsWalkRows - 1) / kOsWalkRows;
  const int g = blockIdx.y * kOsYWarps + threadIdx.y;
  if (i >= nxp || g >= walks * nr) return;
  const int k = g / walks;
  const int j0 = (g - k * walks) * kOsWalkRows;
  const int j1 = j0 + kOsWalkRows < nyp ? j0 + kOsWalkRows : nyp;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t plane = k * P;
  auto q2 = [&](int j) { return static_cast<size_t>(j) * nxp + i; };
  auto Qat = [&](int j) {
    return j >= 0 && j < nyp ? src[plane + q2(j)] : T(0);
  };
  auto Mat = [&](int j) {
    return j >= 0 && j < nyp ? a.maskS[plane + q2(j)] * a.maskInS[q2(j)]
                             : T(0);
  };
  // the flux through the south face of row f, from the ring at face f:
  // Q[o] the source of row f + o - 4, M[o] the face mask of row f + o - 3;
  // upwind from the south (trans > 0): q = Q(2 .. -4), masks 2 .. -3; from
  // the north: q = Q(-3 .. 3), masks -2 .. 3
  auto flux = [&](int f, T trans, T vel, T rd, const T (&Q)[8],
                  const T (&M)[7]) {
    const bool pos = trans > T(0);
    T q[7], mk[6];
#pragma unroll
    for (int s = 0; s < 7; ++s) q[s] = pos ? Q[6 - s] : Q[s + 1];
#pragma unroll
    for (int s = 0; s < 6; ++s) mk[s] = pos ? M[5 - s] : M[s + 1];
    const T cfl = fabs(vel * deltaT * rd);
    const T band = (f >= 4 && f < nyp - 3) ? T(1) : T(0);
    return os7mp_select(trans, os7mp_psi(trans, cfl, q, mk)) * band;
  };
  auto row = [&](int j) {
    Os7mpRow<T> v;
    if (j < j1) {
      v.q = Qat(j + 4);
      v.m = Mat(j + 4);
      if (j + 1 < nyp) {
        const size_t f = q2(j + 1);
        v.tr = a.vTrans[plane + f];
        v.v = a.vVel[plane + f];
        v.rd = a.recip_dyC[f];
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
  T Q[8], M[7];
#pragma unroll
  for (int o = 0; o < 8; ++o) Q[o] = Qat(j0 + o - 4);
#pragma unroll
  for (int o = 0; o < 7; ++o) M[o] = Mat(j0 + o - 3);
  T uS = a.vTrans[plane + q2(j0)];
  T fS = flux(j0, uS, a.vVel[plane + q2(j0)], a.recip_dyC[q2(j0)], Q, M);
  Os7mpRow<T> cur = row(j0);
  const T rdrF = a.recip_drF[k];
  for (int j = j0; j < j1; ++j) {
    const Os7mpRow<T> nxt = row(j + 1);
    // the ring at face j + 1
#pragma unroll
    for (int o = 0; o < 7; ++o) Q[o] = Q[o + 1];
    Q[7] = cur.q;
#pragma unroll
    for (int o = 0; o < 6; ++o) M[o] = M[o + 1];
    M[6] = cur.m;
    const T fN = j + 1 < nyp ? flux(j + 1, cur.tr, cur.v, cur.rd, Q, M)
                             : T(0);
    const T vol = deltaT * cur.rh * rdrF * cur.rA;
    dst[plane + q2(j)] =
        Q[3] - vol * ((fN - fS) - cur.trc * (cur.tr - uS)) * cur.mIn;
    fS = fN;
    uS = cur.tr;
    cur = nxt;
  }
}

// what the R walk loads for cell k: the source and maskC at the ring's new
// level lev(k + 4), the transport and velocity at interface k + 1, and the
// tracer and recip_hFacC of cell k
template <typename T>
struct Os7mpLevel {
  // ad: the addend at the level (0 without one)
  T q = T(0), m = T(0), rT = T(0), w = T(0), tr = T(0), rh = T(0), ad = T(0);
};

// The R sweep, gTr = (localT - tracer) / deltaT, one thread a column.
template <typename T>
__global__ void __launch_bounds__(NT, kOsWalkBlocks<T>) os7mp_r_kernel(
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
    Os7mpLevel<T> v;
    if (k < nr) {
      const size_t pq = lev(k + 4) * P + q2;
      v.q = src[pq];
      v.m = a.maskC[pq] * T(lev(k + 4) - lev(k + 3));
      if (k + 1 < nr) {
        v.rT = a.rTrans[(k + 1) * P + q2];
        v.w = a.wVel[(k + 1) * P + q2];
      }
      v.tr = a.tracer[k * P + q2];
      v.rh = a.recip_hFacC[k * P + q2];
      if (add) v.ad = add[k * P + q2];
    }
    return v;
  };
  // the ring at interface 0: Q[o] the source at lev(o - 4), M[o] maskC at
  // lev(o - 3) times float(lev(o - 3) - lev(o - 4))
  T Q[8], M[7];
#pragma unroll
  for (int o = 0; o < 8; ++o) Q[o] = src[lev(o - 4) * P + q2];
#pragma unroll
  for (int o = 0; o < 7; ++o)
    M[o] = a.maskC[lev(o - 3) * P + q2] * T(lev(o - 3) - lev(o - 4));
  const T rA = a.recip_rA[q2], mIn = a.maskInC[q2];
  Os7mpLevel<T> cur = level(0);
  T fK = T(0), rTk = a.rTrans[q2];
  for (int k = 0; k < nr; ++k) {
    const Os7mpLevel<T> nxt = level(k + 1);
    // the ring at interface k + 1
#pragma unroll
    for (int o = 0; o < 7; ++o) Q[o] = Q[o + 1];
    Q[7] = cur.q;
#pragma unroll
    for (int o = 0; o < 6; ++o) M[o] = M[o + 1];
    M[6] = cur.m;
    T fK1 = T(0);
    if (k + 1 < nr) {
      // upwind from below (rT > 0): q = Q(-3 .. 3), masks of steps -2 .. 3;
      // from above: q = Q(2 .. -4), masks of steps 2 .. -3
      const bool pos = cur.rT > T(0);
      T q[7], mk[6];
#pragma unroll
      for (int s = 0; s < 7; ++s) q[s] = pos ? Q[s + 1] : Q[6 - s];
#pragma unroll
      for (int s = 0; s < 6; ++s) mk[s] = pos ? M[s + 1] : M[5 - s];
      const T cflK = fabs(cur.w * deltaT * a.recip_drC[k + 1]);
      fK1 = os7mp_select(cur.rT, os7mp_psi(cur.rT, cflK, q, mk));
    }
    const size_t p = k * P + q2;
    const T vol = deltaT * cur.rh * a.recip_drF[k] * rA;
    const T localT =
        Q[3] - vol * ((fK1 - fK) - cur.tr * (cur.rT - rTk)) * rkSign * mIn;
    const T g = (localT - cur.tr) / deltaT;
    dst[p] = add ? g + cur.ad : g;
    fK = fK1;
    rTk = cur.rT;
    cur = nxt;
  }
}

// Start sweep DIR (0 X, 1 Y, 2 R) with start(kernel, grid, block, args...)
// (OnStream on the card); add as launch_multidim's.
template <typename T, int DIR, typename Start>
int launch_os7mp(const void* const* table, int n, const void* src, void* dst,
                 const void* add, int nr, int nyp, int nxp, int scheme,
                 double deltaT, double rkSign, Start start) {
  AdvArgs<T> a;
  // the tiles index a level's plane with an int
  if (!adv_args(table, n, &a) || scheme != 7 || nr < 1 || nyp < 1 ||
      nxp < 1 || static_cast<long long>(nyp) * nxp > 0x7fffffffLL ||
      src == nullptr || dst == nullptr || (DIR != 2 && add != nullptr))
    return (int)cudaErrorInvalidValue;
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  if constexpr (DIR == 2) {
    start(os7mp_r_kernel<T>, grid2d(nyp, nxp), dim3(BX, BY), a, s, d,
          static_cast<const T*>(add), nr, nyp, nxp, T(deltaT), T(rkSign));
  } else if constexpr (DIR == 1) {
    const int walks = (nyp + kOsWalkRows - 1) / kOsWalkRows;
    start(os7mp_y_kernel<T>,
          dim3((nxp + BX - 1) / BX, (walks * nr + kOsYWarps - 1) / kOsYWarps),
          dim3(BX, kOsYWarps), a, s, d, nr, nyp, nxp, T(deltaT));
  } else {
    start(os7mp_x_kernel<T>,
          dim3((nxp + kOsCells - 1) / kOsCells, (nyp + kOsRows - 1) / kOsRows,
               (nr + kOsLevels - 1) / kOsLevels),
          dim3(BX, BY), a, s, d, nr, nyp, nxp, T(deltaT));
  }
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
