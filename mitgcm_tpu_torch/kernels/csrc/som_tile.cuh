// Kernel H-SOM's three passes, and their launches. Included by som.cu,
// whose entry points start them on the card, and by the host check of the
// tests, which runs them on the CPU.
//
// Each pass loads and limits each cell once and forms each face's two
// fluxes once: fp, leaving the face's low cell (from that cell), and fn,
// leaving its high cell. A cell's outgoing fluxes are its own: fn through
// its low face, fp through its high face; its incoming ones are its
// neighbours'.
//  - som_x: a warp a row of 32 cells, 30 of them updated (the tiles
//    overlap by one cell on either side); each lane forms its cell's two
//    outgoing fluxes and takes the incoming ones from the lanes beside it
//    (warp shuffles).
//  - som_y: a thread walks 32 rows of one column, carrying the cell it
//    updates and the fluxes of the face between it and the next row.
//  - som_r: a thread walks a whole column down, carrying cell k's limited
//    state and interface k's fluxes (the surface branch at k = 0).
// The walks issue the next row's or level's loads before the current one's
// arithmetic. Every expression is the JAX code's, in its order, as the
// plain twins (model/som.py) replay it, so built with --fmad=false the
// outputs are bit-equal to the twins', the non-finite cells of the first
// padded column (X) and row (Y) included.
#pragma once

#include <cstring>

#include "common.cuh"

namespace mitgcm {
namespace som {

constexpr int kNsom = 9;
// slot indices within the 9-moment state (x, y, z, xx, yy, zz, xy, xz, yz)
constexpr int IX = 0, IY = 1, IZ = 2, IXX = 3, IYY = 4, IZZ = 5, IXY = 6,
              IXZ = 7, IYZ = 8;

template <typename T>
struct SomArgs {
  // [nr, nyp, nxp]
  const T *uVel, *vVel, *wVel, *tracer, *hFacW, *hFacS, *hFacC, *maskC,
      *recip_hFacC;
  // [nyp, nxp]
  const T *dyG, *dxG, *rA, *recip_rA, *maskInC;
  // [nr]
  const T *drF, *recip_drF;
};
constexpr int kSomPointers = 16;

// a pass's roles of the moments (som.py:_ROLES): the slope and curvature
// along the pass, the two (moment, cross moment) pairs, the three passive
// moments
template <int DIR>
struct Roles;
template <>
struct Roles<0> {
  static constexpr int A = IX, AA = IXX, M1 = IY, C1 = IXY, M2 = IZ,
                       C2 = IXZ, P1 = IYY, P2 = IZZ, P3 = IYZ;
};
template <>
struct Roles<1> {
  static constexpr int A = IY, AA = IYY, M1 = IX, C1 = IXY, M2 = IZ,
                       C2 = IYZ, P1 = IXX, P2 = IZZ, P3 = IXZ;
};
template <>
struct Roles<2> {
  static constexpr int A = IZ, AA = IZZ, M1 = IX, C1 = IXZ, M2 = IY,
                       C2 = IYZ, P1 = IXX, P2 = IYY, P3 = IXY;
};

// torch.minimum / maximum (a NaN in either gives NaN)
template <typename T>
__device__ __forceinline__ T smin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T smax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
// torch.clamp(x, lo, hi)
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return smin(smax(x, lo), hi);
}

// a cell's state: volume, content, moments
template <typename T>
struct Cell {
  T v, o, m[kNsom];
};
// the fluxes through a face in one sense, and their Courant fraction
template <typename T>
struct Flux {
  T v, o, m[kNsom], al;
};

template <typename T>
__device__ __forceinline__ void zero(Cell<T>& c) {
  c.v = c.o = T(0);
  for (int s = 0; s < kNsom; ++s) c.m[s] = T(0);
}
template <typename T>
__device__ __forceinline__ void zero(Flux<T>& f) {
  f.v = f.o = f.al = T(0);
  for (int s = 0; s < kNsom; ++s) f.m[s] = T(0);
}

// Prather's limiter (som.py:_limit_1d) on the slope A, the curvature AA and
// the cross moments C1, C2 of DIR's roles; blend (the horizontal passes)
// mixes the result in with the JAX code's all-ones mask lim_mask.
template <typename T, int DIR>
__device__ __forceinline__ void limit(Cell<T>& c, bool blend) {
  using R = Roles<DIR>;
  const T slpmax = smax(c.o, T(0));
  const T s1max = slpmax * T(1.5);
  const T s1new = clip(c.m[R::A], -s1max, s1max);
  const T s2new = clip(c.m[R::AA], fabs(s1new) - slpmax,
                       T(2.0) * slpmax - fabs(s1new) / T(3.0));
  const T c1new = clip(c.m[R::C1], -slpmax, slpmax);
  const T c2new = clip(c.m[R::C2], -slpmax, slpmax);
  if (blend) {
    // lim_mask * new + (1 - lim_mask) * old with lim_mask = 1: the 0 * old
    // term keeps a non-finite old moment non-finite, as in the JAX code
    const T lm = T(1);
    c.m[R::A] = lm * s1new + (T(1) - lm) * c.m[R::A];
    c.m[R::AA] = lm * s2new + (T(1) - lm) * c.m[R::AA];
    c.m[R::C1] = lm * c1new + (T(1) - lm) * c.m[R::C1];
    c.m[R::C2] = lm * c2new + (T(1) - lm) * c.m[R::C2];
  } else {
    c.m[R::A] = s1new;
    c.m[R::AA] = s2new;
    c.m[R::C1] = c1new;
    c.m[R::C2] = c2new;
  }
}

// the fluxes leaving the 'up' cell (positive transport; som.py:63-75)
template <typename T, int DIR>
__device__ __forceinline__ void flux_up(T trans_dt, const Cell<T>& up,
                                        Flux<T>& fp) {
  using R = Roles<DIR>;
  const T* sm_up = up.m;
  fp.v = smax(trans_dt, T(0));
  const T alp = fp.v / up.v;
  const T alpq = alp * alp;
  const T alp1 = T(1.0) - alp;
  fp.al = alp;
  fp.o = alp * (up.o + alp1 * sm_up[R::A] +
                alp1 * (alp1 - alp) * sm_up[R::AA]);
  fp.m[R::A] = alpq * (sm_up[R::A] + T(3.0) * alp1 * sm_up[R::AA]);
  fp.m[R::AA] = alp * alpq * sm_up[R::AA];
  fp.m[R::M1] = alp * (sm_up[R::M1] + alp1 * sm_up[R::C1]);
  fp.m[R::C1] = alpq * sm_up[R::C1];
  fp.m[R::M2] = alp * (sm_up[R::M2] + alp1 * sm_up[R::C2]);
  fp.m[R::C2] = alpq * sm_up[R::C2];
  fp.m[R::P1] = alp * sm_up[R::P1];
  fp.m[R::P2] = alp * sm_up[R::P2];
  fp.m[R::P3] = alp * sm_up[R::P3];
}

// the fluxes leaving the 'dn' cell (negative transport; som.py:77-89)
template <typename T, int DIR>
__device__ __forceinline__ void flux_dn(T trans_dt, const Cell<T>& dn,
                                        Flux<T>& fn) {
  using R = Roles<DIR>;
  const T* sm_dn = dn.m;
  fn.v = smax(-trans_dt, T(0));
  const T aln = fn.v / dn.v;
  const T alnq = aln * aln;
  const T aln1 = T(1.0) - aln;
  fn.al = aln;
  fn.o = aln * (dn.o - aln1 * sm_dn[R::A] +
                aln1 * (aln1 - aln) * sm_dn[R::AA]);
  fn.m[R::A] = alnq * (sm_dn[R::A] - T(3.0) * aln1 * sm_dn[R::AA]);
  fn.m[R::AA] = aln * alnq * sm_dn[R::AA];
  fn.m[R::M1] = aln * (sm_dn[R::M1] - aln1 * sm_dn[R::C1]);
  fn.m[R::C1] = alnq * sm_dn[R::C1];
  fn.m[R::M2] = aln * (sm_dn[R::M2] - aln1 * sm_dn[R::C2]);
  fn.m[R::C2] = alnq * sm_dn[R::C2];
  fn.m[R::P1] = aln * sm_dn[R::P1];
  fn.m[R::P2] = aln * sm_dn[R::P2];
  fn.m[R::P3] = aln * sm_dn[R::P3];
}

// The two update sweeps of a pass for one cell c (som.py:_apply_updates,
// and :299-347 in the vertical), in the JAX code's order of terms: fOutLo
// and fOutHi the fluxes leaving c (in X and Y through its low face, then
// its high face; in R through its bottom, then its top), fIn and fInHi the
// fluxes entering it (in X and Y through its low face, then its high face;
// in R through its bottom, then its top). Writes the updated state into
// out, blended with the update mask upd.
template <typename T, int DIR>
__device__ __forceinline__ void update(const Cell<T>& c, const Flux<T>& fIn,
                                       const Flux<T>& fOutLo,
                                       const Flux<T>& fOutHi,
                                       const Flux<T>& fInHi, T upd,
                                       Cell<T>& out) {
  using R = Roles<DIR>;
  const T* sm = c.m;
  // sweep 1: remove outgoing
  const T alf1a = T(1.0) - fOutLo.al - fOutHi.al;
  const T alf1qa = alf1a * alf1a;
  const T alpmna = fOutHi.al - fOutLo.al;
  const T v1 = c.v - fOutLo.v - fOutHi.v;
  const T o1 = c.o - fOutLo.o - fOutHi.o;
  T sm1[kNsom];
  sm1[R::A] = alf1qa * (sm[R::A] - T(3.0) * alpmna * sm[R::AA]);
  sm1[R::AA] = alf1a * alf1qa * sm[R::AA];
  sm1[R::C1] = alf1qa * sm[R::C1];
  sm1[R::C2] = alf1qa * sm[R::C2];
  sm1[R::M1] = sm[R::M1] - fOutLo.m[R::M1] - fOutHi.m[R::M1];
  sm1[R::M2] = sm[R::M2] - fOutLo.m[R::M2] - fOutHi.m[R::M2];
  sm1[R::P1] = sm[R::P1] - fOutLo.m[R::P1] - fOutHi.m[R::P1];
  sm1[R::P2] = sm[R::P2] - fOutLo.m[R::P2] - fOutHi.m[R::P2];
  sm1[R::P3] = sm[R::P3] - fOutLo.m[R::P3] - fOutHi.m[R::P3];

  // sweep 2: add incoming
  const T v2 = v1 + fIn.v + fInHi.v;
  const T alfp = fIn.v / v2;
  const T alfn = fInHi.v / v2;
  const T alf1 = T(1.0) - alfp - alfn;
  const T alp1 = T(1.0) - alfp;
  const T aln1 = T(1.0) - alfn;
  const T alpmn = alfp - alfn;
  const T locTp = alfp * o1 - alp1 * fIn.o;
  const T locTn = alfn * o1 - aln1 * fInHi.o;
  T sm2[kNsom];
  sm2[R::AA] = alf1 * alf1 * sm1[R::AA] + alfp * alfp * fIn.m[R::AA] +
               alfn * alfn * fInHi.m[R::AA] -
               T(5.0) * (-alpmn * alf1 * sm1[R::A] +
                         alfp * alp1 * fIn.m[R::A] -
                         alfn * aln1 * fInHi.m[R::A] +
                         T(2.0) * alfp * alfn * o1 + (alp1 - alfp) * locTp +
                         (aln1 - alfn) * locTn);
  sm2[R::C1] = alf1 * sm1[R::C1] + alfp * fIn.m[R::C1] +
               alfn * fInHi.m[R::C1] +
               T(3.0) * (alpmn * sm1[R::M1] - alp1 * fIn.m[R::M1] +
                         aln1 * fInHi.m[R::M1]);
  sm2[R::C2] = alf1 * sm1[R::C2] + alfp * fIn.m[R::C2] +
               alfn * fInHi.m[R::C2] +
               T(3.0) * (alpmn * sm1[R::M2] - alp1 * fIn.m[R::M2] +
                         aln1 * fInHi.m[R::M2]);
  sm2[R::A] = alf1 * sm1[R::A] + alfp * fIn.m[R::A] +
              alfn * fInHi.m[R::A] + T(3.0) * (locTp - locTn);
  const T o2 = o1 + fIn.o + fInHi.o;
  sm2[R::M1] = sm1[R::M1] + fIn.m[R::M1] + fInHi.m[R::M1];
  sm2[R::M2] = sm1[R::M2] + fIn.m[R::M2] + fInHi.m[R::M2];
  sm2[R::P1] = sm1[R::P1] + fIn.m[R::P1] + fInHi.m[R::P1];
  sm2[R::P2] = sm1[R::P2] + fIn.m[R::P2] + fInHi.m[R::P2];
  sm2[R::P3] = sm1[R::P3] + fIn.m[R::P3] + fInHi.m[R::P3];

  // blend with the update mask
  out.v = upd * v2 + (T(1.0) - upd) * c.v;
  out.o = upd * o2 + (T(1.0) - upd) * c.o;
  for (int s = 0; s < kNsom; ++s)
    out.m[s] = upd * sm2[s] + (T(1.0) - upd) * sm[s];
}

// the pass's input state of cell p: from (volIn, oIn) or, for the X pass
// (volIn null), from the tracer; the moments from smIn (N cells per slot)
template <typename T>
__device__ __forceinline__ void load(const SomArgs<T>& a, const T* volIn,
                                     const T* oIn, const T* smIn, size_t N,
                                     size_t p, size_t q2, int k, Cell<T>& c) {
  if (volIn == nullptr) {
    const T vol0 = a.rA[q2] * a.drF[k] * a.hFacC[p];
    c.v = vol0 + (T(1.0) - a.maskC[p]);
    c.o = a.tracer[p] * vol0;
  } else {
    c.v = volIn[p];
    c.o = oIn[p];
  }
  for (int s = 0; s < kNsom; ++s) c.m[s] = smIn[s * N + p];
}

template <typename T>
__device__ __forceinline__ void store(const Cell<T>& c, T* volOut, T* oOut,
                                      T* smOut, size_t N, size_t p) {
  if (volOut != nullptr) {
    volOut[p] = c.v;
    oOut[p] = c.o;
  }
  for (int s = 0; s < kNsom; ++s) smOut[s * N + p] = c.m[s];
}

// the 12 values of a flux from the lane `delta` below (__shfl_up_sync) or
// above (__shfl_down_sync) in the warp
template <typename T>
__device__ __forceinline__ Flux<T> shfl_flux(const Flux<T>& f, int delta) {
  constexpr unsigned kAll = 0xffffffffu;
  auto mv = [&](T v) {
    return delta < 0 ? __shfl_up_sync(kAll, v, -delta)
                     : __shfl_down_sync(kAll, v, delta);
  };
  Flux<T> g;
  g.v = mv(f.v);
  g.o = mv(f.o);
  g.al = mv(f.al);
#pragma unroll
  for (int s = 0; s < kNsom; ++s) g.m[s] = mv(f.m[s]);
  return g;
}

// The X pass: a warp a row of 32 cells, i from blockIdx.x * kSomXCells -
// 1, of which lanes 1 .. kSomXCells update theirs. Each lane loads and
// limits its own cell and forms the two fluxes that leave it: fn through
// its west face and fp through its east face; the fluxes that enter it
// come from its neighbours' lanes. Lane 0's cell is the tile's western
// neighbour (the zero cell west of the array), lane 31's its eastern one.
constexpr int kSomXCells = BX - 2;

template <typename T>
__global__ void __launch_bounds__(NT) som_x_kernel(
    const SomArgs<T> a, const T* volIn, const T* oIn, const T* smIn,
    T* volOut, T* oOut, T* smOut, int nr, int nyp, int nxp, bool lim, T dt) {
  const int lane = threadIdx.x;
  const int i = blockIdx.x * kSomXCells - 1 + lane;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (j >= nyp) return;   // the whole warp: its shuffles stay whole
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t N = P * nr;
  const bool in = i >= 0 && i < nxp;
  const size_t q2 = static_cast<size_t>(j) * nxp + (in ? i : 0);
  const size_t p = k * P + q2;
  Cell<T> c;
  T tLo = T(0);   // transport times deltaT through the west face
  if (in) {
    load(a, volIn, oIn, smIn, N, p, q2, k, c);
    if (lim) limit<T, 0>(c, true);
    tLo = a.uVel[p] * (a.dyG[q2] * a.drF[k] * a.hFacW[p]) * dt;
  } else {
    zero(c);
  }
  const T tHi = __shfl_down_sync(0xffffffffu, tLo, 1);
  Flux<T> fnLo, fpHi;
  if (in) flux_dn<T, 0>(tLo, c, fnLo);
  else zero(fnLo);
  if (i + 1 < nxp) flux_up<T, 0>(tHi, c, fpHi);   // 0 past the array's edge
  else zero(fpHi);
  const Flux<T> fpLo = shfl_flux(fpHi, -1);
  const Flux<T> fnHi = shfl_flux(fnLo, 1);
  if (!in || lane < 1 || lane > kSomXCells) return;
  const T upd = (i >= 1 && i <= nxp - 2) ? T(1) : T(0);
  Cell<T> out;
  update<T, 0>(c, fpLo, fnLo, fpHi, fnHi, upd, out);
  store(out, volOut, oOut, smOut, N, p);
}

// The Y pass: a thread walks kSomYRows rows of one column and level, j0 ..
// j0 + kSomYRows - 1, carrying its cell's limited state and the fluxes of
// the face between it and the next, so that each cell is loaded and
// limited once and each face's fluxes formed once (the walk's first cell
// and face, and the cell past its last, once more by the walk beside it).
// The next cell's loads are issued a row ahead.
constexpr int kSomYRows = 32;

template <typename T>
__global__ void __launch_bounds__(NT) som_y_kernel(
    const SomArgs<T> a, const T* volIn, const T* oIn, const T* smIn,
    T* volOut, T* oOut, T* smOut, int nr, int nyp, int nxp, bool lim, T dt) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int walks = (nyp + kSomYRows - 1) / kSomYRows;
  const int g = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || g >= walks * nr) return;
  const int k = g / walks;
  const int j0 = (g - k * walks) * kSomYRows;
  const int j1 = j0 + kSomYRows < nyp ? j0 + kSomYRows : nyp;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t N = P * nr;
  const T drF = a.drF[k];
  auto q2_at = [&](int j) { return static_cast<size_t>(j) * nxp + i; };
  auto cell = [&](int j, Cell<T>& c) {
    const size_t q2 = q2_at(j);
    load(a, volIn, oIn, smIn, N, k * P + q2, q2, k, c);
  };
  // transport times deltaT through the south face of row j
  auto trans_dt = [&](int j) -> T {
    const size_t q2 = q2_at(j);
    return a.vVel[k * P + q2] * (a.dxG[q2] * drF * a.hFacS[k * P + q2]) *
           dt;
  };
  // a row's input state and the transport through its south face
  struct Row {
    Cell<T> c;
    T t;
  };
  auto row = [&](int j, Row& r) {
    cell(j, r.c);
    r.t = trans_dt(j);
  };
  Cell<T> lo, c;
  if (j0 > 0) {
    cell(j0 - 1, lo);
    if (lim) limit<T, 1>(lo, true);
  } else {
    zero(lo);
  }
  Row cur, nxt;
  row(j0, cur);
  if (j0 + 1 < nyp) row(j0 + 1, nxt);
  c = cur.c;
  if (lim) limit<T, 1>(c, true);
  Flux<T> fpLo, fnLo;
  flux_up<T, 1>(cur.t, lo, fpLo);
  flux_dn<T, 1>(cur.t, c, fnLo);
  for (int j = j0; j < j1; ++j) {
    Cell<T> hi;
    Flux<T> fpHi, fnHi;
    if (j + 1 < nyp) {
      cur = nxt;
      if (j + 1 < j1 && j + 2 < nyp) row(j + 2, nxt);
      hi = cur.c;
      if (lim) limit<T, 1>(hi, true);
      flux_up<T, 1>(cur.t, c, fpHi);
      flux_dn<T, 1>(cur.t, hi, fnHi);
    } else {
      zero(hi);
      zero(fpHi);
      zero(fnHi);
    }
    const T upd = (j >= 1 && j <= nyp - 2) ? T(1) : T(0);
    Cell<T> out;
    update<T, 1>(c, fpLo, fnLo, fpHi, fnHi, upd, out);
    store(out, volOut, oOut, smOut, N, k * P + q2_at(j));
    c = hi;
    fpLo = fpHi;
    fnLo = fnHi;
  }
}

// The vertical limiter and pass, and gTracer (som.py:222-351): a thread
// walks its column down, carrying cell k's limited state and the two
// fluxes through interface k (fp leaving cell k upward, fn entering it
// from above: the surface branch at k = 0) to the next level, whose loads
// are issued a level ahead.
template <typename T>
__global__ void __launch_bounds__(NT) som_r_kernel(
    const SomArgs<T> a, const T* volIn, const T* oIn, const T* smIn,
    T* smOut, T* gTr, const T* add, int nr, int nyp, int nxp, bool lim,
    T dt) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t N = P * nr;
  const size_t q2 = static_cast<size_t>(j) * nxp + i;
  const T rA = a.rA[q2], rrA = a.recip_rA[q2], upd = a.maskInC[q2];
  // a level's input state, vertical velocity, maskC, tracer,
  // recip_hFacC and addend (0 without one)
  struct Level {
    Cell<T> c;
    T w, m, tr, rh, ad;
  };
  auto level = [&](int k, Level& v) {
    const size_t p = k * P + q2;
    load(a, volIn, oIn, smIn, N, p, q2, k, v.c);
    v.w = a.wVel[p];
    v.m = a.maskC[p];
    v.tr = a.tracer[p];
    v.rh = a.recip_hFacC[p];
    v.ad = add ? add[p] : T(0);
  };
  Level cur, nxt;
  level(0, cur);
  if (nr > 1) level(1, nxt);
  Cell<T> c = cur.c;
  if (lim) limit<T, 2>(c, false);
  T mC = cur.m, trC = cur.tr, rhC = cur.rh, adC = cur.ad;
  // interface 0: fp leaves cell 0 upward; fn enters it from above, the
  // surface branch (cell 0 itself, no z-structure)
  Flux<T> fpK, fnK;
  const T wdt0 = cur.w * rA * dt;
  flux_up<T, 2>(wdt0, c, fpK);
  fnK.v = smax(-wdt0, T(0));
  const T aln0 = fnK.v / c.v;
  fnK.al = aln0;
  fnK.o = aln0 * c.o;
  fnK.m[IZ] = fnK.m[IZZ] = fnK.m[IXZ] = fnK.m[IYZ] = T(0.0);
  fnK.m[IX] = aln0 * c.m[IX];
  fnK.m[IY] = aln0 * c.m[IY];
  fnK.m[IXX] = aln0 * c.m[IXX];
  fnK.m[IYY] = aln0 * c.m[IYY];
  fnK.m[IXY] = aln0 * c.m[IXY];
  for (int k = 0; k < nr; ++k) {
    // through interface k+1 (0 past the bottom): fp leaves cell k+1
    // upward, fn leaves cell k downward, its transport masked by maskUp
    Cell<T> dn;
    Flux<T> fpD, fnD;
    if (k + 1 < nr) {
      cur = nxt;
      if (k + 2 < nr) level(k + 2, nxt);
      dn = cur.c;
      if (lim) limit<T, 2>(dn, false);
      flux_up<T, 2>(cur.w * rA * dt, dn, fpD);
      flux_dn<T, 2>(mC * cur.m * (cur.w * rA) * dt, c, fnD);
    } else {
      zero(dn);
      zero(fpD);
      zero(fnD);
    }
    const size_t p = k * P + q2;
    Cell<T> out;
    update<T, 2>(c, fpD, fnD, fpK, fnK, upd, out);
    for (int s = 0; s < kNsom; ++s) smOut[s * N + p] = out.m[s];
    const T g = (out.o - trC * out.v) * rrA * a.recip_drF[k] * rhC / dt;
    gTr[p] = add ? g + adC : g;
    c = dn;
    mC = cur.m;
    trC = cur.tr;
    adC = cur.ad;
    rhC = cur.rh;
    fpK = fpD;
    fnK = fnD;
  }
}

inline bool som_args_ok(int n, int nr, int nyp, int nxp, int limiter) {
  return n == kSomPointers && nr >= 1 && nyp >= 1 && nxp >= 1 &&
         (limiter == 0 || limiter == 1);
}

// Start the X (DIR 0) or Y (DIR 1) pass with start(kernel, grid, block,
// args...) (OnStream on the card).
template <typename T, int DIR, typename Start>
int launch_som_horiz(const void* const* table, int n, const void* volIn,
                     const void* oIn, const void* smIn, void* volOut,
                     void* oOut, void* smOut, int nr, int nyp, int nxp,
                     int limiter, double deltaT, Start start) {
  static_assert(sizeof(SomArgs<T>) == kSomPointers * sizeof(void*),
                "SomArgs must be a plain table of pointers");
  if (!som_args_ok(n, nr, nyp, nxp, limiter) || smIn == nullptr ||
      volOut == nullptr || oOut == nullptr || smOut == nullptr ||
      (DIR == 1 && volIn == nullptr))
    return (int)cudaErrorInvalidValue;
  SomArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  const auto kernel = DIR == 0 ? som_x_kernel<T> : som_y_kernel<T>;
  const int walks = (nyp + kSomYRows - 1) / kSomYRows;
  const dim3 g = DIR == 0 ? dim3((nxp + kSomXCells - 1) / kSomXCells,
                                 (nyp + BY - 1) / BY, nr)
                          : dim3((nxp + BX - 1) / BX,
                                 (walks * nr + BY - 1) / BY, 1);
  start(kernel, g, dim3(BX, BY), a, (const T*)volIn, (const T*)oIn,
        (const T*)smIn, (T*)volOut, (T*)oOut, (T*)smOut, nr, nyp, nxp,
        limiter == 1, T(deltaT));
  return (int)cudaGetLastError();
}

// add (null: none): a field added to gTr, gTr + add (the tracer's other
// tendency, thermodynamics.py's `gSom + gTr`)
template <typename T, typename Start>
int launch_som_r(const void* const* table, int n, const void* volIn,
                 const void* oIn, const void* smIn, void* smOut, void* gTr,
                 const void* add, int nr, int nyp, int nxp, int limiter,
                 double deltaT, Start start) {
  if (!som_args_ok(n, nr, nyp, nxp, limiter) || volIn == nullptr ||
      oIn == nullptr || smIn == nullptr || smOut == nullptr || gTr == nullptr)
    return (int)cudaErrorInvalidValue;
  SomArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  start(som_r_kernel<T>, grid2d(nyp, nxp), dim3(BX, BY), a, (const T*)volIn,
        (const T*)oIn, (const T*)smIn, (T*)smOut, (T*)gTr, (const T*)add, nr,
        nyp, nxp, limiter == 1, T(deltaT));
  return (int)cudaGetLastError();
}

}  // namespace som
}  // namespace mitgcm
