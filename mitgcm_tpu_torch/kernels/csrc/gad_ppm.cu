// Kernel P: direction-split multi-dimensional advection of one tracer with
// the Lagrangian piecewise parabolic (PPM, schemes 40-42) and quartic (PQM,
// 50-52) methods, each with the null, monotone and WENO limiters.
//
// Replaces: mitgcm_tpu/model/gad.py:_ppm_pqm_flux_h (:565-600) with
// _p3e_edge / _p5e_edge (:410-448), _osc_hat / _osc_mul / _osc_ends
// (:451-485, :603-627), _ppm_pqm_hat (:488-526), _plm_slope (:275),
// _ppm_coef / _ppm_mono / _pqm_coef / _pqm_mono (:289-407), _sl_flux
// (:529-545) and ppm_pqm_band (:548-562), and _ppm_pqm_flux_r (:630-780),
// inside multidim_advection's X, Y and R passes (:1120-1154), which XLA
// fused into one pass per direction over the padded [nr, nyp, nxp] arrays
// on the TPU.
//
// One entry per sweep (gad_ppm_x, _y, _r), each two launches of one thread
// per cell of the whole padded array:
//   (a) ppm_coef  the cell polynomial of the sweep's input field: 3 (PPM)
//                 or 5 (PQM) coefficients per cell into a scratch buffer
//                 [ncoef, nr, nyp, nxp] that the wrapper allocates;
//   (b) adv_sweep the semi-Lagrangian flux of each of the cell's two faces,
//                 the upwind cell's polynomial integrated over the swept
//                 interval, and the update of gad_advect.cuh.
// Bound: bytes. Per sweep a cell reads its input field, the tracer, a
// transport and a velocity, maskC, recip_hFacC and the spacings and writes
// one field (~7 fields, ~28 B/cell in float32); the scratch adds 3 or 5
// writes and as many reads per cell, which the bound does not count (the
// JAX code keeps the polynomials in registers of its fused pass). The
// stage (a) stencil reaches i-3 .. i+3 (edges, the WENO window) and hits
// L1/L2. A PQM cell costs ~300 flops, 2 divisions and a square root.
// Design: two stages so that each cell's polynomial, which the fluxes of
// three faces need, is computed once; everything else in JAX's operation
// order, so that the kernel is bit-equal to its plain twin
// (model/gad_ho.py) with --fmad=false. The traps of the JAX code, kept:
// every intermediate is shifted with zero fill (the right edge of the last
// cell is 0, not an edge computed from data; the upwind coefficients of
// the first face are 0; the WENO window reads derivatives of 0 and masks of
// 0 outside the array), _osc_ends replaces the derivatives of the first and
// last cell of each row with one-sided ones, and the vertical column is
// padded with 3 ghost copies of its end values whose mask is 0. The
// discrete choices (extrema, limL/limR, condA/condB, limDL/limDR, the
// QUADROOT roots, bindm/bindp, the pops c1/c2, ok and blend) are the
// twin's, compared exactly.

#include "gad_advect.cuh"

namespace mitgcm {

constexpr int kPpmNull = 40, kPpmMono = 41, kPpmWeno = 42, kPqmNull = 50,
              kPqmMono = 51, kPqmWeno = 52;

// The cells along the sweep's axis through one cell: position p is i (X),
// j (Y) or k (R). Horizontally the field and maskC read 0 outside the
// padded array (the zero-filled shifts); vertically the field clamps to the
// column (the ghost copies of _ppm_pqm_flux_r) and maskC reads 0 outside.
// rdC and dF are the reciprocal spacing between cell centres at the left
// edge and the cell width along the axis (recip_dxC / dxF, recip_dyC / dyF,
// recip_drC / drF).
template <typename T, int DIR>
struct Line {
  const T *f, *m, *rdC, *dF;
  ptrdiff_t stride, stride2;
  int n;

  __device__ T F(int p) const {
    if (DIR == 2) return f[(p < 0 ? 0 : (p >= n ? n - 1 : p)) * stride];
    return (p < 0 || p >= n) ? T(0) : f[p * stride];
  }
  __device__ T M(int p) const {
    return (p < 0 || p >= n) ? T(0) : m[p * stride];
  }
  // the number of edges: one per cell horizontally, nr + 1 vertically
  __device__ int edges() const { return DIR == 2 ? n + 1 : n; }
};

template <typename T, int DIR>
__device__ Line<T, DIR> line_at(const AdvArgs<T>& a, const T* src, int k,
                                int j, int i, int nr, int nyp, int nxp) {
  const ptrdiff_t P = static_cast<ptrdiff_t>(nyp) * nxp;
  const ptrdiff_t j2 = static_cast<ptrdiff_t>(j) * nxp;
  if (DIR == 0) {
    const ptrdiff_t o = k * P + j2;
    return {src + o, a.maskC + o, a.recip_dxC + j2, a.dxF + j2, 1, 1, nxp};
  }
  if (DIR == 1) {
    const ptrdiff_t o = k * P + i;
    return {src + o, a.maskC + o, a.recip_dyC + i, a.dyF + i, nxp, nxp, nyp};
  }
  const ptrdiff_t o = j2 + i;
  return {src + o, a.maskC + o, a.recip_drC, a.drF, P, 1, nr};
}

// GAD_PPM_P3E: the 3rd-order value at the left edge of cell p, with the
// outward mask-expansion of the 4-point stencil (gad.py:_p3e_edge)
template <typename T, int DIR>
__device__ T p3e_edge(const Line<T, DIR>& l, int p) {
  const T f = l.F(p), fm1 = l.F(p - 1), mask = l.M(p);
  const T mm1 = l.M(p - 1);
  const T fm1v = f + mm1 * (fm1 - f);
  const T f0v = fm1 + mask * (f - fm1);
  const T mm2 = l.M(p - 2) * mm1;
  T tmp = T(2.0) * fm1v - f0v;
  const T fm2v = tmp + mm2 * (l.F(p - 2) - tmp);
  const T mp1 = l.M(p + 1) * mask;
  tmp = T(2.0) * f0v - fm1v;
  const T fp1v = tmp + mp1 * (l.F(p + 1) - tmp);
  return T(-(1.0 / 12.0)) * (fm2v + fp1v) + T(7.0 / 12.0) * (fm1v + f0v);
}

// GAD_PQM_P5E: the 5th-order edge value e1 and slope e2 at the left edge of
// cell p (gad.py:_p5e_edge)
template <typename T, int DIR>
__device__ void p5e_edge(const Line<T, DIR>& l, int p, T& e1, T& e2) {
  const T f = l.F(p), fm1 = l.F(p - 1), mask = l.M(p);
  const T mm1 = l.M(p - 1);
  const T fm1v = f + mm1 * (fm1 - f);
  const T f0v = fm1 + mask * (f - fm1);
  const T mm2 = l.M(p - 2) * mm1;
  const T mm3 = l.M(p - 3) * mm2;
  T tmp = T(2.0) * fm1v - f0v;
  const T fm2v = tmp + mm2 * (l.F(p - 2) - tmp);
  tmp = T(2.0) * fm2v - fm1v;
  const T fm3v = tmp + mm3 * (l.F(p - 3) - tmp);
  const T mp1 = l.M(p + 1) * mask;
  const T mp2 = l.M(p + 2) * mp1;
  tmp = T(2.0) * f0v - fm1v;
  const T fp1v = tmp + mp1 * (l.F(p + 1) - tmp);
  tmp = T(2.0) * fp1v - f0v;
  const T fp2v = tmp + mp2 * (l.F(p + 2) - tmp);
  e1 = T(1.0 / 60.0) * (fm3v + fp2v) - T(8.0 / 60.0) * (fm2v + fp1v) +
       T(37.0 / 60.0) * (fm1v + f0v);
  e2 = (T(-(1.0 / 90.0)) * (fm3v - fp2v) + T(5.0 / 36.0) * (fm2v - fp1v) -
        T(49.0 / 36.0) * (fm1v - f0v)) *
       l.rdC[p * l.stride2];
}

// the WENO derivatives (d1, d2) of cell p (gad.py:_osc_hat), with the
// one-sided first and last cell of a horizontal row (_osc_ends) and 0
// outside it (the zero-filled shift of _osc_mul)
template <typename T, int DIR>
__device__ void osc_hat(const Line<T, DIR>& l, int p, T& d1, T& d2) {
  if (DIR != 2) {
    if (p < 0 || p >= l.n) {
      d1 = d2 = T(0);
      return;
    }
    if (p == 0) {
      const T f0 = l.F(0);
      const T f1 = f0 + l.M(1) * (l.F(1) - f0);
      const T f2 = f1 + l.M(2) * (l.F(2) - f1);
      d1 = T(0.5) * (f1 - f0);
      d2 = T(0.25) * f2 - T(0.5) * f1 + T(0.25) * f0;
      return;
    }
    if (p == l.n - 1) {
      const T h0 = l.F(p);
      const T h1 = h0 + l.M(p - 1) * (l.F(p - 1) - h0);
      const T h2 = h1 + l.M(p - 2) * (l.F(p - 2) - h1);
      d1 = T(0.5) * (h0 - h1);
      d2 = T(0.25) * h0 - T(0.5) * h1 + T(0.25) * h2;
      return;
    }
  }
  const T f = l.F(p);
  const T fm1 = f + l.M(p - 1) * (l.F(p - 1) - f);
  const T fp1 = f + l.M(p + 1) * (l.F(p + 1) - f);
  d1 = T(0.25) * (fp1 - fm1);
  d2 = T(0.25) * fp1 - T(0.5) * f + T(0.25) * fm1;
}

// GAD_OSC_MUL with hh = 2: the WENO weights (s1, s2) of cell p
// (gad.py:_osc_mul and :712-726)
template <typename T, int DIR>
__device__ void osc_mul(const Line<T, DIR>& l, int p, T& s1, T& s2) {
  T omin = T(0), omax = T(0), mval = T(0);
  for (int off = -2; off <= 2; ++off) {
    T dd1, dd2;
    osc_hat(l, p + off, dd1, dd2);
    const T dfs1 = dd1 + dd2 * T(2.0 * off);
    const T x = T(2.0) * dfs1, y = T(4.0) * dd2;
    const T oval = x * x + y * y;
    const T m = l.M(p + off);
    omin = off == -2 ? oval : nmin(omin, oval);
    omax = off == -2 ? oval : nmax(omax, oval);
    mval = off == -2 ? m : mval * m;
  }
  const T r = (omax + T(1.0e-20)) / (omin + T(1.0e-20));
  const T q = r * (r * r);
  const bool ok = mval > T(0);
  s1 = ok ? T(1.0e5) / (q + T(1.0e5)) : T(0);
  s2 = ok ? q / (q + T(1.0e5)) : T(1);
}

template <typename T>
__device__ void ppm_coef(T ff00, T fell, T ferr, T (&h)[3]) {
  h[0] = T(1.5) * ff00 - T(0.25) * (ferr + fell);
  h[1] = T(0.5) * (ferr - fell);
  h[2] = T(-1.5) * ff00 + T(0.75) * (ferr + fell);
}

template <typename T>
__device__ void pqm_coef(T ff00, T fell, T ferr, T dell, T derr, T (&h)[5]) {
  h[0] = T(30.0 / 16.0) * ff00 - T(7.0 / 16.0) * (ferr + fell) +
         T(1.0 / 16.0) * (derr - dell);
  h[1] = T(3.0 / 4.0) * (ferr - fell) - T(1.0 / 4.0) * (derr + dell);
  h[2] = T(-(30.0 / 8.0)) * ff00 + T(15.0 / 8.0) * (ferr + fell) -
         T(3.0 / 8.0) * (derr - dell);
  h[3] = T(-(1.0 / 4.0)) * (ferr - fell - derr - dell);
  h[4] = T(30.0 / 16.0) * ff00 - T(15.0 / 16.0) * (ferr + fell) +
         T(5.0 / 16.0) * (derr - dell);
}

// GAD_PPM_FUN_MONO (gad.py:_ppm_mono); returns the mono flag
template <typename T>
__device__ bool ppm_mono(T ff00, T ffll, T ffrr, T fell, T ferr, T d0,
                         T (&h)[3]) {
  const bool extrema = (ffrr - ff00) * (ff00 - ffll) <= T(0);
  const bool limL = (ffll - fell) * (fell - ff00) <= T(0);
  const bool limR = (ffrr - ferr) * (ferr - ff00) <= T(0);
  if (limL) fell = ff00 - d0;
  if (limR) ferr = ff00 + d0;
  ppm_coef(ff00, fell, ferr, h);
  const bool has_turn = fabs(h[2]) > fabs(h[1]) * T(0.5);
  const T turn = T(-0.5) * h[1] / (h[2] == T(0) ? T(1) : h[2]);
  const bool condA = has_turn && turn >= T(-1) && turn <= T(0);
  const bool condB = has_turn && turn > T(0) && turn <= T(1);
  if (condA) ferr = T(3.0) * ff00 - T(2.0) * fell;
  if (condB) fell = T(3.0) * ff00 - T(2.0) * ferr;
  if (condA || condB) ppm_coef(ff00, fell, ferr, h);
  if (extrema) {
    h[0] = ff00;
    h[1] = h[2] = T(0);
  }
  return extrema || limL || limR || condA || condB;
}

// the derivative of the quartic at x (gad.py:362-363)
template <typename T>
__device__ __forceinline__ T pqm_dflx(const T (&h)[5], T x) {
  return h[1] + x * h[2] * T(2.0) + x * x * h[3] * T(3.0) +
         x * (x * x) * h[4] * T(4.0);
}

// GAD_PQM_FUN_MONO (gad.py:_pqm_mono) with the QUADROOT inflexion test and
// the edge 'pop' branches; returns the mono flag
template <typename T>
__device__ bool pqm_mono(T ff00, T ffll, T ffrr, T fell, T ferr, T dell,
                         T derr, T dfm, T d0, T dfp, T (&h)[5]) {
  const bool extrema = (ffrr - ff00) * (ff00 - ffll) <= T(0);
  const bool limL = (ffll - fell) * (fell - ff00) <= T(0);
  const bool limR = (ffrr - ferr) * (ferr - ff00) <= T(0);
  if (limL) fell = ff00 - d0;
  if (limR) ferr = ff00 + d0;
  const bool limDL = dell * dfm < T(0);
  const bool limDR = derr * dfp < T(0);
  if (limDL) dell = dfm;
  if (limDR) derr = dfp;
  pqm_coef(ff00, fell, ferr, dell, derr, h);

  // QUADROOT on 12 h5 x^2 + 6 h4 x + 2 h3 (the second derivative)
  const T aa = T(12.0) * h[4], bb = T(6.0) * h[3], cc = T(2.0) * h[2];
  const T sq = bb * bb - T(4.0) * aa * cc;
  const bool hasA = fabs(aa) > T(0) && sq >= T(0);
  const bool hasB = fabs(aa) <= T(0) && fabs(bb) > T(0);
  const T sqr = sqrt(nmax(sq, T(0)));
  const T ra = T(0.5) / (aa == T(0) ? T(1) : aa);
  const T rb = -cc / (bb == T(0) ? T(1) : bb);
  const T x1 = hasA ? (-bb + sqr) * ra : (hasB ? rb : T(2.0));
  const T x2 = hasA ? (-bb - sqr) * ra : (hasB ? rb : T(2.0));
  const bool bad1 =
      x1 > T(-1) && x1 < T(1) && pqm_dflx(h, x1) * d0 < T(0);
  const bool bad2 =
      x2 > T(-1) && x2 < T(1) && pqm_dflx(h, x2) * d0 < T(0);
  const bool anybad = bad1 || bad2;
  if (anybad) {
    const bool bindm = fabs(dell) < fabs(derr);
    T el, er, dl, dr;
    if (bindm) {
      // pop the inflexion onto the lower (-1) edge
      el = fell;
      er = ferr;
      dr = T(-5.0) * ff00 + T(3.0) * ferr + T(2.0) * fell;
      dl = T(5.0 / 3.0) * ff00 - T(1.0 / 3.0) * ferr - T(4.0 / 3.0) * fell;
      if (dl * dfm < T(0)) {
        er = T(5.0) * ff00 - T(4.0) * el;
        dr = T(10.0) * ff00 - T(10.0) * el;
        dl = T(0);
      }
      if (dr * dfp < T(0)) {
        el = T(5.0 / 2.0) * ff00 - T(3.0 / 2.0) * er;
        dl = T(-(5.0 / 3.0)) * ff00 + T(5.0 / 3.0) * er;
        dr = T(0);
      }
    } else {
      // pop the inflexion onto the upper (+1) edge
      el = fell;
      er = ferr;
      dr = T(-(5.0 / 3.0)) * ff00 + T(4.0 / 3.0) * ferr +
           T(1.0 / 3.0) * fell;
      dl = T(5.0) * ff00 - T(2.0) * ferr - T(3.0) * fell;
      if (dl * dfm < T(0)) {
        er = T(5.0 / 2.0) * ff00 - T(3.0 / 2.0) * el;
        dr = T(5.0 / 3.0) * ff00 - T(5.0 / 3.0) * el;
        dl = T(0);
      }
      if (dr * dfp < T(0)) {
        el = T(5.0) * ff00 - T(4.0) * er;
        dl = T(-10.0) * ff00 + T(10.0) * er;
        dr = T(0);
      }
    }
    pqm_coef(ff00, el, er, dl, dr, h);
  }
  if (extrema) {
    h[0] = ff00;
    h[1] = h[2] = h[3] = h[4] = T(0);
  }
  return extrema || limL || limR || limDL || limDR || anybad;
}

template <int S>
__host__ __device__ constexpr int ncoef() {
  return S < kPqmNull ? 3 : 5;
}

// the cell polynomial of cell p (gad.py:_ppm_pqm_hat, the PQM dry-cell
// zeroing, and the cell part of _ppm_pqm_flux_r)
template <typename T, int DIR, int S>
__device__ void ppm_hat(const Line<T, DIR>& l, int p, T (&h)[ncoef<S>()]) {
  constexpr bool pqm = S >= kPqmNull;
  const T ff00 = l.F(p);
  const T ffll = ff00 + l.M(p - 1) * (l.F(p - 1) - ff00);
  const T ffrr = ff00 + l.M(p + 1) * (l.F(p + 1) - ff00);
  const bool right = p + 1 < l.edges();   // else the edge reads 0
  T fell, ferr, dell = T(0), derr = T(0);
  if constexpr (pqm) {
    const T xhat = l.dF[p * l.stride2] * T(0.5);
    T e2l, e1r = T(0), e2r = T(0);
    p5e_edge(l, p, fell, e2l);
    if (right) p5e_edge(l, p + 1, e1r, e2r);
    ferr = e1r;
    dell = e2l * xhat;
    derr = e2r * xhat;
  } else {
    fell = p3e_edge(l, p);
    ferr = right ? p3e_edge(l, p + 1) : T(0);
  }
  if constexpr (S == kPpmNull) {
    ppm_coef(ff00, fell, ferr, h);
  } else if constexpr (S == kPqmNull) {
    pqm_coef(ff00, fell, ferr, dell, derr, h);
  } else {
    // _plm_slope
    const T dm = ff00 - ffll, dp = ffrr - ff00;
    T d0 = T(0.5) * (T(0.5) * (ff00 + ffrr) - T(0.5) * (ffll + ff00));
    const T scal =
        nmin(nmin(fabs(dm), fabs(dp)) / nmax(fabs(d0), T(1.0e-16)), T(1));
    d0 = dm * dp > T(0) ? scal * d0 : T(0);
    bool mono;
    if constexpr (pqm)
      mono = pqm_mono(ff00, ffll, ffrr, fell, ferr, dell, derr, T(0.5) * dm,
                      d0, T(0.5) * dp, h);
    else
      mono = ppm_mono(ff00, ffll, ffrr, fell, ferr, d0, h);
    if constexpr (S == kPpmWeno || S == kPqmWeno) {
      const T fdel = fabs(ffrr - ff00) + fabs(ff00 - ffll);
      const T fmag = fabs(ffll) + fabs(ff00) + fabs(ffrr);
      if (mono && fdel > T(1.0e-6) * fmag) {
        T s1, s2;
        osc_mul(l, p, s1, s2);
        T u[ncoef<S>()];
        if constexpr (pqm)
          pqm_coef(ff00, fell, ferr, dell, derr, u);
        else
          ppm_coef(ff00, fell, ferr, u);
        for (int n = 0; n < ncoef<S>(); ++n) h[n] = s1 * u[n] + s2 * h[n];
      }
    }
  }
  if constexpr (pqm) {
    const T mask = l.M(p);
    for (int n = 0; n < 5; ++n) h[n] = h[n] * mask;
  }
}

// stage (a): the coefficients of every cell into coef[n][k][j][i]
template <typename T, int DIR, int S>
__global__ void ppm_coef_kernel(const AdvArgs<T> a, const T* __restrict__ src,
                                T* __restrict__ coef, int nr, int nyp,
                                int nxp) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const Line<T, DIR> l = line_at<T, DIR>(a, src, k, j, i, nr, nyp, nxp);
  const int p = DIR == 0 ? i : (DIR == 1 ? j : k);
  T h[ncoef<S>()];
  ppm_hat<T, DIR, S>(l, p, h);
  const size_t cells = static_cast<size_t>(nr) * nyp * nxp;
  const size_t q = (static_cast<size_t>(k) * nyp + j) * nxp + i;
  for (int n = 0; n < ncoef<S>(); ++n) coef[n * cells + q] = h[n];
}

// the upwind polynomial of NC coefficients integrated over [ss11, ss22]
// (gad.py:532-536, :760-764), ss22 = +-1
template <typename T, int NC>
__device__ T ppm_integ(T ss11, T ss22, const T* c, size_t cells) {
  T tot = T(0), x = T(1), y = ss11, y2 = ss11 * ss11;
  for (int n = 1; n <= NC; ++n) {
    x = x * ss22;   // ss22^n, exact
    // ss11^n as JAX's integer_pow multiplies it out
    const T yn = n == 1 ? y : (n == 2 ? y2 : (n == 3 ? y * y2
                                         : (n == 4 ? y2 * y2 : y * (y2 * y2))));
    tot = tot + (x - yn) * T(1.0 / n) * c[(n - 1) * cells];
  }
  return tot;
}

// stage (b): the flux at the west (X), south (Y) or top (R) face of
// (k, j, i) from the coefficients of its upwind cell (gad.py:_sl_flux,
// :751-780)
template <typename T, int DIR, int NC>
struct PpmFlux {
  const T* coef;

  __device__ T operator()(const AdvCell<T>& c, int k, int j, int i) const {
    const size_t cells = static_cast<size_t>(c.nr) * c.nyp * c.nxp;
    const size_t p = c.i3(k, j, i);
    if (DIR == 2) {
      if (k == 0 || k >= c.nr) return T(0);
      const size_t P = static_cast<size_t>(c.nyp) * c.nxp;
      const T w = c.a.wVel[p];
      const T cfl_m = w * c.deltaT * c.a.recip_drF[k - 1];
      const T cfl_p = w * c.deltaT * c.a.recip_drF[k];
      const bool neg = w < T(0);
      const T intF = neg ? ppm_integ<T, NC>(T(1) + T(2.0) * cfl_m, T(1),
                                            coef + p - P, cells)
                         : ppm_integ<T, NC>(T(-1) + T(2.0) * cfl_p, T(-1),
                                            coef + p, cells);
      const T wcfl = neg ? cfl_m : cfl_p;
      const T mag = nmax(fabs(wcfl), T(1.0e-20));
      const T f = T(-0.5) * intF / (wcfl >= T(0) ? mag : -mag);
      const T facR = c.a.rTrans[p] * c.a.maskC[p - P];
      return w == T(0) ? T(0) : facR * f;
    }
    const int n = DIR == 0 ? c.nxp : c.nyp;
    const int pos = DIR == 0 ? i : j;
    if (pos >= n) return T(0);
    const size_t q2 = c.i2(j, i);
    // the stride along the axis, the same in the 2-D and 3-D arrays
    const ptrdiff_t s2 = DIR == 0 ? 1 : c.nxp;
    const T* rdF = DIR == 0 ? c.a.recip_dxF : c.a.recip_dyF;
    const T vel = DIR == 0 ? c.a.uVel[p] : c.a.vVel[p];
    const T trans = DIR == 0 ? c.a.uTrans[p] : c.a.vTrans[p];
    const bool pos_ = vel > T(0);
    T intF, ucfl;
    if (pos_) {
      ucfl = vel * c.deltaT * (pos > 0 ? rdF[q2 - s2] : T(0));
      if (pos > 0) {
        intF = ppm_integ<T, NC>(T(1) - T(2.0) * ucfl, T(1), coef + p - s2,
                                cells);
      } else {
        const T zero[1] = {T(0)};
        intF = ppm_integ<T, NC>(T(1) - T(2.0) * ucfl, T(1), zero, 0);
      }
    } else {
      ucfl = vel * c.deltaT * rdF[q2];
      intF = ppm_integ<T, NC>(T(-1) - T(2.0) * ucfl, T(-1), coef + p, cells);
    }
    const T mag = nmax(fabs(ucfl), T(1.0e-20));
    intF = T(0.5) * intF / (ucfl >= T(0) ? mag : -mag);
    const int margin = NC == 3 ? 3 : 4;
    const T band = (pos >= margin && pos < n - margin + 1) ? T(1) : T(0);
    return (vel == T(0) ? T(0) : trans * intF) * band;
  }
};

template <typename T, int DIR, int S>
void launch_ppm_s(const AdvArgs<T>& a, const void* src, void* dst,
                  void* scratch, int nr, int nyp, int nxp, double deltaT,
                  double rkSign, cudaStream_t stream) {
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, nr);
  ppm_coef_kernel<T, DIR, S><<<g, dim3(BX, BY), 0, stream>>>(
      a, (const T*)src, (T*)scratch, nr, nyp, nxp);
  launch_sweep<T, DIR>(a, PpmFlux<T, DIR, ncoef<S>()>{(const T*)scratch},
                       src, dst, nr, nyp, nxp, deltaT, rkSign, stream);
}

template <typename T, int DIR>
int launch_ppm(const void* const* table, int n, const void* src, void* dst,
               void* scratch, int nr, int nyp, int nxp, int scheme,
               double deltaT, double rkSign, void* stream) {
  AdvArgs<T> a;
  if (!adv_args(table, n, &a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define MITGCM_PPM_CASE(S)                                                    \
  case S:                                                                     \
    launch_ppm_s<T, DIR, S>(a, src, dst, scratch, nr, nyp, nxp, deltaT,      \
                            rkSign, st);                                      \
    break;
  switch (scheme) {
    MITGCM_PPM_CASE(kPpmNull)
    MITGCM_PPM_CASE(kPpmMono)
    MITGCM_PPM_CASE(kPpmWeno)
    MITGCM_PPM_CASE(kPqmNull)
    MITGCM_PPM_CASE(kPqmMono)
    MITGCM_PPM_CASE(kPqmWeno)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MITGCM_PPM_CASE
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_P_ENTRY(NAME, DIR, SUF, T)                                      \
  extern "C" int mitgcm_gad_ppm_##NAME##_##SUF(                                \
      const void* const* table, int n, const void* src, void* dst,            \
      void* scratch, int nr, int nyp, int nxp, int scheme, double deltaT,     \
      double rkSign, void* stream) {                                           \
    return mitgcm::launch_ppm<T, DIR>(table, n, src, dst, scratch, nr, nyp,   \
                                      nxp, scheme, deltaT, rkSign, stream);   \
  }

MITGCM_P_ENTRY(x, 0, f32, float)
MITGCM_P_ENTRY(x, 0, f64, double)
MITGCM_P_ENTRY(y, 1, f32, float)
MITGCM_P_ENTRY(y, 1, f64, double)
MITGCM_P_ENTRY(r, 2, f32, float)
MITGCM_P_ENTRY(r, 2, f64, double)
