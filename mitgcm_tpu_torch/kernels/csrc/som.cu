// Kernel H-SOM: second-order-moment (Prather 1986) tracer advection,
// schemes 80 (unlimited) and 81 (Prather's positive-definite limiter).
//
// Replaces: mitgcm_tpu/model/som.py:som_advect (:188-352) with
// _som_adv_horiz (:153-175), _face_fluxes (:51-90), _apply_updates
// (:93-150) and _limit_1d (:38-48), Cartesian grid, linear free surface,
// which XLA ran as fused passes over the tracer's content, volume and nine
// moments [9, nr, nyp, nxp].
//
// Three launches per tracer and step, one thread per cell of the whole
// padded array (i fastest):
//   som_x  the pass's start state from the tracer (volume rA drF hFacC +
//          (1 - maskC), content tracer times volume) and the moments smTr,
//          then the X pass: with scheme 81 each thread limits its own cell's
//          x moments and those of its two x neighbours (the JAX code limits
//          the whole array first: each cell's limited moments depend on that
//          cell alone), computes the fluxes through its west face (from the
//          upwind cell i-1 and itself) and its east face (from itself and
//          cell i+1), and writes the updated volume, content and nine
//          moments out of place, since its neighbours read the old ones.
//   som_y  the same in y on som_x's output.
//   som_r  the vertical limiter of scheme 81 (on the fly, for the cell and
//          its neighbours k-1 and k+1), the vertical pass with the surface
//          branch at k = 0 and the transport below it masked by maskUp,
//          the update of the interior columns, and gTracer = (content -
//          tracer volume) / (rA drF hFacC deltaT).
//
// Bound: bytes. Each pass reads the 11 fields of its input state and writes
// 11 (som_r: 10), with 2-5 grid and velocity fields: about 100 B/cell in
// float32 per pass, for ~400 flops and 6 divisions per cell (the face
// fluxes are computed twice, once by each cell they join). Design: the
// three cells a thread reads are neighbours of its warp's, so the reloads
// hit L1/L2; nothing is kept in shared memory in this first version. The
// JAX code computes every cell of the padded arrays with zero-filled shifts,
// so at the first padded column (X) and row (Y) the upwind cell it reads is
// all zeros and its volume 0: alp = fp_v / 0 is NaN or inf, and the update
// blend upd * new + (1 - upd) * old carries it into the cell. This kernel
// reproduces those cells as they are (the halo fill at the end of the step
// overwrites them). Each expression is written as the JAX code's (and the
// plain twins', model/som.py:_som_x_plain, _som_y_plain, _som_r_plain),
// keeping its operation order, the blends' 0 * x terms and the limiter's
// blend with its all-ones mask; the divisions are IEEE divisions, as the
// twins' tensor-by-tensor ones; built with --fmad=false the outputs are
// bit-equal to the twins, non-finite cells included.

#include <cstring>

#include "common.cuh"

namespace mitgcm {

namespace {

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

// The X (DIR 0) or Y (DIR 1) pass (som.py:_som_adv_horiz).
template <typename T, int DIR>
__global__ void som_horiz_kernel(const SomArgs<T> a, const T* volIn,
                                 const T* oIn, const T* smIn, T* volOut,
                                 T* oOut, T* smOut, int nr, int nyp, int nxp,
                                 bool lim, T dt) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t N = P * nr;
  const int n = DIR == 0 ? nxp : nyp;       // cells along the pass
  const int at = DIR == 0 ? i : j;          // this cell's index along it
  const size_t step = DIR == 0 ? 1 : static_cast<size_t>(nxp);
  const size_t q2 = static_cast<size_t>(j) * nxp + i;
  const size_t p = k * P + q2;

  // the cells at - 1, at, at + 1 (zeros outside the array), limited
  Cell<T> lo, c, hi;
  if (at > 0) {
    load(a, volIn, oIn, smIn, N, p - step, q2 - step, k, lo);
    if (lim) limit<T, DIR>(lo, true);
  } else {
    zero(lo);
  }
  load(a, volIn, oIn, smIn, N, p, q2, k, c);
  if (lim) limit<T, DIR>(c, true);
  const bool hasHi = at + 1 < n;
  if (hasHi) {
    load(a, volIn, oIn, smIn, N, p + step, q2 + step, k, hi);
    if (lim) limit<T, DIR>(hi, true);
  }
  // transport times deltaT through the face at index f (its low-side face)
  auto trans_dt = [&](size_t f, size_t f2) -> T {
    const T tr = DIR == 0 ? a.uVel[f] * (a.dyG[f2] * a.drF[k] * a.hFacW[f])
                          : a.vVel[f] * (a.dxG[f2] * a.drF[k] * a.hFacS[f]);
    return tr * dt;
  };
  // the low face: fp from the low neighbour, fn from this cell
  Flux<T> fpLo, fnLo, fpHi, fnHi;
  const T tLo = trans_dt(p, q2);
  flux_up<T, DIR>(tLo, lo, fpLo);
  flux_dn<T, DIR>(tLo, c, fnLo);
  // the high face (0 past the array's edge): fp from this cell, fn from
  // the high neighbour
  if (hasHi) {
    const T tHi = trans_dt(p + step, q2 + step);
    flux_up<T, DIR>(tHi, c, fpHi);
    flux_dn<T, DIR>(tHi, hi, fnHi);
  } else {
    zero(fpHi);
    zero(fnHi);
  }
  const T upd = (at >= 1 && at <= n - 2) ? T(1) : T(0);
  Cell<T> out;
  update<T, DIR>(c, fpLo, fnLo, fpHi, fnHi, upd, out);
  store(out, volOut, oOut, smOut, N, p);
}

// The vertical limiter and pass, and gTracer (som.py:222-351).
template <typename T>
__global__ void som_r_kernel(const SomArgs<T> a, const T* volIn,
                             const T* oIn, const T* smIn, T* smOut, T* gTr,
                             int nr, int nyp, int nxp, bool lim, T dt) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t N = P * nr;
  const size_t q2 = static_cast<size_t>(j) * nxp + i;
  const size_t p = k * P + q2;

  // the cells k-1 (k > 0), k and k+1 (k < nr-1), with the vertical limiter
  Cell<T> up, c, dn;
  if (k > 0) {
    load(a, volIn, oIn, smIn, N, p - P, q2, k - 1, up);
    if (lim) limit<T, 2>(up, false);
  }
  load(a, volIn, oIn, smIn, N, p, q2, k, c);
  if (lim) limit<T, 2>(c, false);
  const bool hasDn = k + 1 < nr;
  if (hasDn) {
    load(a, volIn, oIn, smIn, N, p + P, q2, k + 1, dn);
    if (lim) limit<T, 2>(dn, false);
  }
  const T rA = a.rA[q2];
  // rT * deltaT through interface kk (the top of cell kk), unmasked for fp,
  // masked by maskUp below the surface for fn
  auto wdt = [&](size_t f) -> T { return a.wVel[f] * rA * dt; };
  auto wdt_n = [&](size_t f) -> T {
    return a.maskC[f - P] * a.maskC[f] * (a.wVel[f] * rA) * dt;
  };

  // fp leaves cell k upward through interface k
  Flux<T> fpK, fnK, fpD, fnD;
  flux_up<T, 2>(wdt(p), c, fpK);
  // fn enters cell k from above through interface k: the surface branch at
  // k = 0 (cell 0 itself, no z-structure), else from cell k-1
  if (k == 0) {
    fnK.v = smax(-wdt(p), T(0));
    const T aln0 = fnK.v / c.v;
    fnK.al = aln0;
    fnK.o = aln0 * c.o;
    fnK.m[IZ] = fnK.m[IZZ] = fnK.m[IXZ] = fnK.m[IYZ] = T(0.0);
    fnK.m[IX] = aln0 * c.m[IX];
    fnK.m[IY] = aln0 * c.m[IY];
    fnK.m[IXX] = aln0 * c.m[IXX];
    fnK.m[IYY] = aln0 * c.m[IYY];
    fnK.m[IXY] = aln0 * c.m[IXY];
  } else {
    flux_dn<T, 2>(wdt_n(p), up, fnK);
  }
  // through interface k+1 (0 past the bottom): fp leaves cell k+1 upward,
  // fn leaves cell k downward
  if (hasDn) {
    flux_up<T, 2>(wdt(p + P), dn, fpD);
    flux_dn<T, 2>(wdt_n(p + P), c, fnD);
  } else {
    zero(fpD);
    zero(fnD);
  }
  Cell<T> out;
  update<T, 2>(c, fpD, fnD, fpK, fnK, a.maskInC[q2], out);
  for (int s = 0; s < kNsom; ++s) smOut[s * N + p] = out.m[s];
  gTr[p] = (out.o - a.tracer[p] * out.v) * a.recip_rA[q2] * a.recip_drF[k] *
           a.recip_hFacC[p] / dt;
}

bool som_args_ok(int n, int nr, int limiter) {
  return n == kSomPointers && nr >= 1 && (limiter == 0 || limiter == 1);
}

}  // namespace

template <typename T, int DIR>
int launch_som_horiz(const void* const* table, int n, const void* volIn,
                     const void* oIn, const void* smIn, void* volOut,
                     void* oOut, void* smOut, int nr, int nyp, int nxp,
                     int limiter, double deltaT, void* stream) {
  static_assert(sizeof(SomArgs<T>) == kSomPointers * sizeof(void*),
                "SomArgs must be a plain table of pointers");
  if (!som_args_ok(n, nr, limiter) || smIn == nullptr || volOut == nullptr ||
      oOut == nullptr || smOut == nullptr || (DIR == 1 && volIn == nullptr))
    return (int)cudaErrorInvalidValue;
  SomArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, nr);
  som_horiz_kernel<T, DIR><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      a, (const T*)volIn, (const T*)oIn, (const T*)smIn, (T*)volOut,
      (T*)oOut, (T*)smOut, nr, nyp, nxp, limiter == 1, T(deltaT));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_som_r(const void* const* table, int n, const void* volIn,
                 const void* oIn, const void* smIn, void* smOut, void* gTr,
                 int nr, int nyp, int nxp, int limiter, double deltaT,
                 void* stream) {
  if (!som_args_ok(n, nr, limiter) || volIn == nullptr || oIn == nullptr ||
      smIn == nullptr || smOut == nullptr || gTr == nullptr)
    return (int)cudaErrorInvalidValue;
  SomArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, nr);
  som_r_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      a, (const T*)volIn, (const T*)oIn, (const T*)smIn, (T*)smOut, (T*)gTr,
      nr, nyp, nxp, limiter == 1, T(deltaT));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

// table, its length; the pass's input volume, content and moments (the X
// pass starts from the tracer: null volume and content), its output volume,
// content and moments (null for R), gTracer (R only); nr, nyp, nxp,
// limiter (scheme % 10); deltaT; stream
#define MITGCM_SOM_ENTRY(SUF, T)                                              \
  extern "C" int mitgcm_som_x_##SUF(                                          \
      const void* const* table, int n, const void* volIn, const void* oIn,   \
      const void* smIn, void* volOut, void* oOut, void* smOut, void* gTr,    \
      int nr, int nyp, int nxp, int limiter, double deltaT, void* stream) {  \
    return gTr != nullptr ? (int)cudaErrorInvalidValue                       \
                          : mitgcm::launch_som_horiz<T, 0>(                  \
                                table, n, volIn, oIn, smIn, volOut, oOut,    \
                                smOut, nr, nyp, nxp, limiter, deltaT,        \
                                stream);                                     \
  }                                                                          \
  extern "C" int mitgcm_som_y_##SUF(                                          \
      const void* const* table, int n, const void* volIn, const void* oIn,   \
      const void* smIn, void* volOut, void* oOut, void* smOut, void* gTr,    \
      int nr, int nyp, int nxp, int limiter, double deltaT, void* stream) {  \
    return gTr != nullptr ? (int)cudaErrorInvalidValue                       \
                          : mitgcm::launch_som_horiz<T, 1>(                  \
                                table, n, volIn, oIn, smIn, volOut, oOut,    \
                                smOut, nr, nyp, nxp, limiter, deltaT,        \
                                stream);                                     \
  }                                                                          \
  extern "C" int mitgcm_som_r_##SUF(                                          \
      const void* const* table, int n, const void* volIn, const void* oIn,   \
      const void* smIn, void* volOut, void* oOut, void* smOut, void* gTr,    \
      int nr, int nyp, int nxp, int limiter, double deltaT, void* stream) {  \
    return (volOut != nullptr || oOut != nullptr)                            \
               ? (int)cudaErrorInvalidValue                                  \
               : mitgcm::launch_som_r<T>(table, n, volIn, oIn, smIn, smOut,  \
                                         gTr, nr, nyp, nxp, limiter, deltaT, \
                                         stream);                            \
  }

MITGCM_SOM_ENTRY(f32, float)
MITGCM_SOM_ENTRY(f64, double)
