// Kernel P's three sweeps, and their launches. Included by gad_ppm.cu, whose
// entry points start them on the card, and by the host check of the tests,
// which runs them on the CPU.
//
// One launch a sweep. Along the sweep's axis each edge value (and PQM's edge
// slope), each WENO derivative pair, each cell polynomial and each face's
// semi-Lagrangian flux is formed once, and each cell is updated from the
// fluxes of its two faces:
//  - X (ppm_x_kernel): a warp owns a row segment of kPpmCells cells, a
//    block 8 rows, and walks kPpmLevels levels with the next level's loads
//    in flight. Per level a warp stages the source and maskC at cells
//    i0 - 4 .. i0 + kPpmCells + 3 in shared memory, 0 outside the padded
//    array (the zero-filled shifts), then forms in turn, each stage in
//    shared memory and a __syncwarp between them: the edges at i0 - 1 ..
//    i0 + kPpmCells + 1, the WENO derivatives at i0 - 3 ..
//    i0 + kPpmCells + 2, the polynomials of cells i0 - 1 ..
//    i0 + kPpmCells, the fluxes of faces i0 .. i0 + kPpmCells, and the
//    cells' updates. The 2-D spacings each lane needs stay in registers.
//  - Y (ppm_y_kernel): a thread walks kPpmWalk rows of a column and level
//    and R (ppm_r_kernel) a whole column, with a ring of the source and
//    maskC at the 7 rows or levels f - 2 .. f + 4 about face f in
//    registers. A step at face f forms the edge of f + 1, the WENO
//    derivatives of cell f + 2, the polynomial of cell f, the flux of
//    face f (from the polynomial of f - 1, carried, or of f, by the
//    velocity's sign) and updates cell f - 1 from the fluxes of faces
//    f - 1 (carried) and f. A walk starts 2 faces early (5 for WENO) so
//    that what its first cell needs is formed; each step's loads are issued
//    a step ahead.
// The rules of the JAX code, kept: horizontally the right edge of the last
// cell of a row or column is 0 and every stencil reads 0 outside the padded
// array, the polynomial of the cell before the first is 0 with a spacing of
// 0, and the first and last cell take one-sided WENO derivatives
// (_osc_ends), 0 outside; vertically the column reads its end values
// beyond its ends (3 ghost copies) with maskC 0 there, its nr + 1 edges are
// all formed, and the fluxes at the surface and below the bottom are 0.
// The arithmetic of each value is the JAX code's in its order (the twin is
// model/gad_ho.py), so built with --fmad=false every output is bit-equal
// to the twin's.
#pragma once

#include "gad_advect.cuh"

namespace mitgcm {

constexpr int kPpmNull = 40, kPpmMono = 41, kPpmWeno = 42, kPqmNull = 50,
              kPqmMono = 51, kPqmWeno = 52;

template <int S>
__host__ __device__ constexpr int ncoef() {
  return S < kPqmNull ? 3 : 5;
}
template <int S>
__host__ __device__ constexpr bool pqm() {
  return S >= kPqmNull;
}
template <int S>
__host__ __device__ constexpr bool weno() {
  return S == kPpmWeno || S == kPqmWeno;
}

// GAD_PPM_P3E: the 3rd-order value at the left edge of cell p, with the
// outward mask-expansion of the 4-point stencil (gad.py:_p3e_edge); f and m
// hold the source and maskC at p - 3 .. p + 2
template <typename T>
__device__ __forceinline__ T p3e_edge(const T* f, const T* m) {
  const T F = f[3], fm1 = f[2], mask = m[3];
  const T mm1 = m[2];
  const T fm1v = F + mm1 * (fm1 - F);
  const T f0v = fm1 + mask * (F - fm1);
  const T mm2 = m[1] * mm1;
  T tmp = T(2.0) * fm1v - f0v;
  const T fm2v = tmp + mm2 * (f[1] - tmp);
  const T mp1 = m[4] * mask;
  tmp = T(2.0) * f0v - fm1v;
  const T fp1v = tmp + mp1 * (f[4] - tmp);
  return T(-(1.0 / 12.0)) * (fm2v + fp1v) + T(7.0 / 12.0) * (fm1v + f0v);
}

// GAD_PQM_P5E: the 5th-order edge value e1 and slope e2 at the left edge of
// cell p (gad.py:_p5e_edge), from the same stencil and the reciprocal
// spacing rdC at the edge
template <typename T>
__device__ __forceinline__ void p5e_edge(const T* f, const T* m, T rdC,
                                         T& e1, T& e2) {
  const T F = f[3], fm1 = f[2], mask = m[3];
  const T mm1 = m[2];
  const T fm1v = F + mm1 * (fm1 - F);
  const T f0v = fm1 + mask * (F - fm1);
  const T mm2 = m[1] * mm1;
  const T mm3 = m[0] * mm2;
  T tmp = T(2.0) * fm1v - f0v;
  const T fm2v = tmp + mm2 * (f[1] - tmp);
  tmp = T(2.0) * fm2v - fm1v;
  const T fm3v = tmp + mm3 * (f[0] - tmp);
  const T mp1 = m[4] * mask;
  const T mp2 = m[5] * mp1;
  tmp = T(2.0) * f0v - fm1v;
  const T fp1v = tmp + mp1 * (f[4] - tmp);
  tmp = T(2.0) * fp1v - f0v;
  const T fp2v = tmp + mp2 * (f[5] - tmp);
  e1 = T(1.0 / 60.0) * (fm3v + fp2v) - T(8.0 / 60.0) * (fm2v + fp1v) +
       T(37.0 / 60.0) * (fm1v + f0v);
  e2 = (T(-(1.0 / 90.0)) * (fm3v - fp2v) + T(5.0 / 36.0) * (fm2v - fp1v) -
        T(49.0 / 36.0) * (fm1v - f0v)) *
       rdC;
}

// the left edge of cell p into e1 (and PQM's slope into e2), f and m at
// p - 3 .. p + 2
template <typename T, int S>
__device__ __forceinline__ void ppm_edge(const T* f, const T* m, T rdC,
                                         T& e1, T& e2) {
  if constexpr (pqm<S>()) {
    p5e_edge(f, m, rdC, e1, e2);
  } else {
    e1 = p3e_edge(f, m);
    e2 = T(0);
  }
}

// the WENO derivatives (d1, d2) of cell p (gad.py:_osc_hat), f and m at
// p - 1 .. p + 1
template <typename T>
__device__ __forceinline__ void osc_inner(const T* f, const T* m, T& d1,
                                          T& d2) {
  const T F = f[1];
  const T fm1 = F + m[0] * (f[0] - F);
  const T fp1 = F + m[2] * (f[2] - F);
  d1 = T(0.25) * (fp1 - fm1);
  d2 = T(0.25) * fp1 - T(0.5) * F + T(0.25) * fm1;
}

// _osc_ends: the first cell of a row or column, f and m at 0 .. 2
template <typename T>
__device__ __forceinline__ void osc_first(const T* f, const T* m, T& d1,
                                          T& d2) {
  const T f0 = f[0];
  const T f1 = f0 + m[1] * (f[1] - f0);
  const T f2 = f1 + m[2] * (f[2] - f1);
  d1 = T(0.5) * (f1 - f0);
  d2 = T(0.25) * f2 - T(0.5) * f1 + T(0.25) * f0;
}

// _osc_ends: the last cell, f and m at n - 3 .. n - 1
template <typename T>
__device__ __forceinline__ void osc_last(const T* f, const T* m, T& d1,
                                         T& d2) {
  const T h0 = f[2];
  const T h1 = h0 + m[1] * (f[1] - h0);
  const T h2 = h1 + m[0] * (f[0] - h1);
  d1 = T(0.5) * (h0 - h1);
  d2 = T(0.25) * h0 - T(0.5) * h1 + T(0.25) * h2;
}

// the horizontal derivatives of cell p of a row or column of n cells: 0
// outside it, one-sided at its ends; f and m point at cell p (the stencil
// reaches p - 2 .. p + 2)
template <typename T>
__device__ __forceinline__ void osc_h(const T* f, const T* m, int p, int n,
                                      T& d1, T& d2) {
  if (p < 0 || p >= n) {
    d1 = d2 = T(0);
  } else if (p == 0) {
    osc_first(f, m, d1, d2);
  } else if (p == n - 1) {
    osc_last(f - 2, m - 2, d1, d2);
  } else {
    osc_inner(f - 1, m - 1, d1, d2);
  }
}

// GAD_OSC_MUL with hh = 2: the WENO weights (s1, s2) from the derivatives
// and maskC of cells p - 2 .. p + 2 (gad.py:_osc_mul and :712-726)
template <typename T>
__device__ __forceinline__ void osc_weights(const T* d1, const T* d2,
                                            const T* m, T& s1, T& s2) {
  T omin = T(0), omax = T(0), mval = T(0);
#pragma unroll
  for (int off = -2; off <= 2; ++off) {
    const T dd1 = d1[off + 2], dd2 = d2[off + 2];
    const T dfs1 = dd1 + dd2 * T(2.0 * off);
    const T x = T(2.0) * dfs1, y = T(4.0) * dd2;
    const T oval = x * x + y * y;
    const T mk = m[off + 2];
    omin = off == -2 ? oval : nmin(omin, oval);
    omax = off == -2 ? oval : nmax(omax, oval);
    mval = off == -2 ? mk : mval * mk;
  }
  const T r = (omax + T(1.0e-20)) / (omin + T(1.0e-20));
  const T q = r * (r * r);
  const bool ok = mval > T(0);
  s1 = ok ? T(1.0e5) / (q + T(1.0e5)) : T(0);
  s2 = ok ? q / (q + T(1.0e5)) : T(1);
}

template <typename T>
__device__ __forceinline__ void ppm_coef(T ff00, T fell, T ferr, T (&h)[3]) {
  h[0] = T(1.5) * ff00 - T(0.25) * (ferr + fell);
  h[1] = T(0.5) * (ferr - fell);
  h[2] = T(-1.5) * ff00 + T(0.75) * (ferr + fell);
}

template <typename T>
__device__ __forceinline__ void pqm_coef(T ff00, T fell, T ferr, T dell,
                                         T derr, T (&h)[5]) {
  h[0] = T(30.0 / 16.0) * ff00 - T(7.0 / 16.0) * (ferr + fell) +
         T(1.0 / 16.0) * (derr - dell);
  h[1] = T(3.0 / 4.0) * (ferr - fell) - T(1.0 / 4.0) * (derr + dell);
  h[2] = T(-(30.0 / 8.0)) * ff00 + T(15.0 / 8.0) * (ferr + fell) -
         T(3.0 / 8.0) * (derr - dell);
  h[3] = T(-(1.0 / 4.0)) * (ferr - fell - derr - dell);
  h[4] = T(30.0 / 16.0) * ff00 - T(15.0 / 16.0) * (ferr + fell) +
         T(5.0 / 16.0) * (derr - dell);
}

// GAD_PPM_FUN_MONO (gad.py:_ppm_mono); returns the mono flag. What the
// twin computes and its selects discard is not computed: nothing past the
// extremum test at an extremum (flat, mono), the turning point only where
// it has one (h[2] != 0 there).
template <typename T>
__device__ bool ppm_mono(T ff00, T ffll, T ffrr, T fell, T ferr, T d0,
                         T (&h)[3]) {
  if ((ffrr - ff00) * (ff00 - ffll) <= T(0)) {
    h[0] = ff00;
    h[1] = h[2] = T(0);
    return true;
  }
  const bool limL = (ffll - fell) * (fell - ff00) <= T(0);
  const bool limR = (ffrr - ferr) * (ferr - ff00) <= T(0);
  if (limL) fell = ff00 - d0;
  if (limR) ferr = ff00 + d0;
  ppm_coef(ff00, fell, ferr, h);
  bool condA = false, condB = false;
  if (fabs(h[2]) > fabs(h[1]) * T(0.5)) {
    const T turn = T(-0.5) * h[1] / h[2];
    condA = turn >= T(-1) && turn <= T(0);
    condB = turn > T(0) && turn <= T(1);
  }
  if (condA) ferr = T(3.0) * ff00 - T(2.0) * fell;
  if (condB) fell = T(3.0) * ff00 - T(2.0) * ferr;
  if (condA || condB) ppm_coef(ff00, fell, ferr, h);
  return limL || limR || condA || condB;
}

// the derivative of the quartic at x (gad.py:362-363)
template <typename T>
__device__ __forceinline__ T pqm_dflx(const T (&h)[5], T x) {
  return h[1] + x * h[2] * T(2.0) + x * x * h[3] * T(3.0) +
         x * (x * x) * h[4] * T(4.0);
}

// GAD_PQM_FUN_MONO (gad.py:_pqm_mono) with the QUADROOT inflexion test and
// the edge 'pop' branches; returns the mono flag. As ppm_mono, nothing past
// the extremum test at an extremum, and of QUADROOT's two forms only the
// one its test selects (aa or bb != 0 there).
template <typename T>
__device__ bool pqm_mono(T ff00, T ffll, T ffrr, T fell, T ferr, T dell,
                         T derr, T dfm, T d0, T dfp, T (&h)[5]) {
  if ((ffrr - ff00) * (ff00 - ffll) <= T(0)) {
    h[0] = ff00;
    h[1] = h[2] = h[3] = h[4] = T(0);
    return true;
  }
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
  T x1 = T(2.0), x2 = T(2.0);
  if (fabs(aa) > T(0) && sq >= T(0)) {
    const T sqr = sqrt(nmax(sq, T(0)));
    const T ra = T(0.5) / aa;
    x1 = (-bb + sqr) * ra;
    x2 = (-bb - sqr) * ra;
  } else if (fabs(aa) <= T(0) && fabs(bb) > T(0)) {
    x1 = x2 = -cc / bb;
  }
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
  return limL || limR || limDL || limDR || anybad;
}

// The polynomial of cell p (gad.py:_ppm_pqm_hat, PQM's dry-cell zeroing,
// and the cell part of _ppm_pqm_flux_r): f and m hold the source and maskC
// at p - 2 .. p + 2; (fell, e2l) and (ferr, e2r) its left and right edges
// (e2: PQM's slopes), dF its width; d1 and d2 the WENO derivatives at
// p - 2 .. p + 2.
template <typename T, int S>
__device__ __forceinline__ void ppm_poly(const T* f, const T* m, T fell,
                                         T e2l, T ferr, T e2r, T dF,
                                         const T* d1, const T* d2,
                                         T (&h)[ncoef<S>()]) {
  const T ff00 = f[2];
  const T ffll = ff00 + m[1] * (f[1] - ff00);
  const T ffrr = ff00 + m[3] * (f[3] - ff00);
  T dell = T(0), derr = T(0);
  if constexpr (pqm<S>()) {
    const T xhat = dF * T(0.5);
    dell = e2l * xhat;
    derr = e2r * xhat;
  }
  if constexpr (S == kPpmNull) {
    ppm_coef(ff00, fell, ferr, h);
  } else if constexpr (S == kPqmNull) {
    pqm_coef(ff00, fell, ferr, dell, derr, h);
  } else {
    // _plm_slope (its scale only where it is taken)
    const T dm = ff00 - ffll, dp = ffrr - ff00;
    T d0 = T(0);
    if (dm * dp > T(0)) {
      const T c0 =
          T(0.5) * (T(0.5) * (ff00 + ffrr) - T(0.5) * (ffll + ff00));
      const T scal =
          nmin(nmin(fabs(dm), fabs(dp)) / nmax(fabs(c0), T(1.0e-16)), T(1));
      d0 = scal * c0;
    }
    bool mono;
    if constexpr (pqm<S>())
      mono = pqm_mono(ff00, ffll, ffrr, fell, ferr, dell, derr, T(0.5) * dm,
                      d0, T(0.5) * dp, h);
    else
      mono = ppm_mono(ff00, ffll, ffrr, fell, ferr, d0, h);
    if constexpr (weno<S>()) {
      const T fdel = fabs(ffrr - ff00) + fabs(ff00 - ffll);
      const T fmag = fabs(ffll) + fabs(ff00) + fabs(ffrr);
      if (mono && fdel > T(1.0e-6) * fmag) {
        T s1, s2;
        osc_weights(d1, d2, m, s1, s2);
        T u[ncoef<S>()];
        if constexpr (pqm<S>())
          pqm_coef(ff00, fell, ferr, dell, derr, u);
        else
          ppm_coef(ff00, fell, ferr, u);
#pragma unroll
        for (int n = 0; n < ncoef<S>(); ++n) h[n] = s1 * u[n] + s2 * h[n];
      }
    }
  }
  if constexpr (pqm<S>()) {
    const T mask = m[2];
#pragma unroll
    for (int n = 0; n < 5; ++n) h[n] = h[n] * mask;
  }
}

// the upwind polynomial of NC coefficients c integrated over [ss11, ss22]
// (gad.py:532-536, :760-764), ss22 = +-1
template <typename T, int NC>
__device__ __forceinline__ T ppm_integ(T ss11, T ss22, const T* c) {
  T tot = T(0), x = T(1), y = ss11, y2 = ss11 * ss11;
#pragma unroll
  for (int n = 1; n <= NC; ++n) {
    x = x * ss22;   // ss22^n, exact
    // ss11^n as JAX's integer_pow multiplies it out
    const T yn = n == 1 ? y : (n == 2 ? y2 : (n == 3 ? y * y2
                                         : (n == 4 ? y2 * y2 : y * (y2 * y2))));
    tot = tot + (x - yn) * T(1.0 / n) * c[n - 1];
  }
  return tot;
}

// the horizontal flux through the face between cells p - 1 and p
// (gad.py:_sl_flux): vel and trans at the face, rdFm and rdF0 the
// reciprocal widths of the cells (rdFm 0 before the first cell, whose
// polynomial hm is then 0), band the write band's factor
template <typename T, int NC>
__device__ __forceinline__ T ppm_flux_h(T vel, T trans, T deltaT, T rdFm,
                                        T rdF0, const T* hm, const T* h0,
                                        T band) {
  T intF, ucfl;
  if (vel > T(0)) {
    ucfl = vel * deltaT * rdFm;
    intF = ppm_integ<T, NC>(T(1) - T(2.0) * ucfl, T(1), hm);
  } else {
    ucfl = vel * deltaT * rdF0;
    intF = ppm_integ<T, NC>(T(-1) - T(2.0) * ucfl, T(-1), h0);
  }
  const T mag = nmax(fabs(ucfl), T(1.0e-20));
  intF = T(0.5) * intF / (ucfl >= T(0) ? mag : -mag);
  return (vel == T(0) ? T(0) : trans * intF) * band;
}

// the flux through interface k, 0 < k < nr (gad.py:751-780): w and rT at
// the interface, mAbove maskC of cell k - 1, rdFm and rdF0 recip_drF of
// cells k - 1 and k, hm and h0 their polynomials
template <typename T, int NC>
__device__ __forceinline__ T ppm_flux_r(T w, T rT, T mAbove, T deltaT, T rdFm,
                                        T rdF0, const T* hm, const T* h0) {
  T intF, wcfl;
  if (w < T(0)) {
    wcfl = w * deltaT * rdFm;
    intF = ppm_integ<T, NC>(T(1) + T(2.0) * wcfl, T(1), hm);
  } else {
    wcfl = w * deltaT * rdF0;
    intF = ppm_integ<T, NC>(T(-1) + T(2.0) * wcfl, T(-1), h0);
  }
  const T mag = nmax(fabs(wcfl), T(1.0e-20));
  const T f = T(-0.5) * intF / (wcfl >= T(0) ? mag : -mag);
  const T facR = rT * mAbove;
  return w == T(0) ? T(0) : facR * f;
}

// the write band of gad.py:ppm_pqm_band: faces [margin, n - margin + 1),
// margin 3 for PPM and 4 for PQM
template <int S>
__device__ __forceinline__ bool ppm_band(int f, int n) {
  constexpr int margin = pqm<S>() ? 4 : 3;
  return f >= margin && f < n - margin + 1;
}

// ---------------------------------------------------------------- X --

constexpr int kPpmCells = BX - 3;          // cells a warp updates a level
constexpr int kPpmFaces = kPpmCells + 1;   // faces i0 .. i0 + kPpmCells
constexpr int kPpmPolys = kPpmCells + 2;   // cells i0 - 1 .. i0 + kPpmCells
constexpr int kPpmEdges = kPpmCells + 3;   // edges i0 - 1 .. i0 + kPpmCells + 1
constexpr int kPpmDerivs = kPpmCells + 6;  // cells i0 - 3 .. i0 + kPpmCells + 2
constexpr int kPpmQ = kPpmCells + 8;       // cells i0 - 4 .. i0 + kPpmCells + 3
constexpr int kPpmRows = BY;
constexpr int kPpmLevels = 8;
static_assert(kPpmPolys <= BX, "at most a polynomial a lane");
static_assert(kPpmQ <= 2 * BX && kPpmEdges <= 2 * BX &&
                  kPpmDerivs <= 2 * BX,
              "at most two staged values, edges or derivatives a lane");

// a warp's row of the X tile: each stage's values, in shared memory
template <typename T, int S>
struct PpmXRow {
  T q[kPpmQ], m[kPpmQ];
  T e1[kPpmEdges], e2[pqm<S>() ? kPpmEdges : 1];
  T d1[weno<S>() ? kPpmDerivs : 1], d2[weno<S>() ? kPpmDerivs : 1];
  T h[ncoef<S>()][kPpmPolys];
  T fl[kPpmFaces], tr[kPpmFaces];
};

// what a lane of the X tile loads for one level: its two staged source and
// maskC values, the velocity and transport of its face, and the tracer and
// recip_hFacC of its cell
template <typename T>
struct PpmXLevel {
  T q[2], m[2], vel, trans, trc, rh;
};

template <typename T, int S>
__global__ void __launch_bounds__(NT) ppm_x_kernel(
    const AdvArgs<T> a, const T* __restrict__ src, T* __restrict__ dst,
    int nr, int nyp, int nxp, T deltaT) {
  constexpr int NC = ncoef<S>();
  __shared__ PpmXRow<T, S> rows[kPpmRows];
  const int lane = threadIdx.x, ty = threadIdx.y;
  PpmXRow<T, S>& s = rows[ty];
  const int k0 = blockIdx.z * kPpmLevels;
  const int k1 = k0 + kPpmLevels < nr ? k0 + kPpmLevels : nr;
  const int i0 = blockIdx.x * kPpmCells, j = blockIdx.y * kPpmRows + ty;
  const bool row = j < nyp;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t r2 = static_cast<size_t>(row ? j : 0) * nxp;
  // the 2-D index of column i of this row, -1 outside the padded array
  auto at = [&](int i) { return row && i >= 0 && i < nxp ? r2 + i : P; };
  auto get2 = [&](const T* f, int i) {
    const size_t q = at(i);
    return q < P ? f[q] : T(0);
  };
  // this lane's staged cells, face and cell
  size_t qi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = lane + r * BX;
    qi[r] = e < kPpmQ ? at(i0 - 4 + e) : P;
  }
  const int fi = i0 + lane;   // the lane's face, and cell
  const bool face = lane < kPpmFaces && row && fi < nxp;
  const bool cell = lane < kPpmCells && row && fi < nxp;
  // the 2-D spacings: rdC at the lane's edges (PQM), dF of its polynomial
  // (PQM), recip_dxF of the cells beside its face, the volume factors of
  // its cell
  T rdC[2] = {T(0), T(0)}, dF = T(0);
  if constexpr (pqm<S>()) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (lane + r * BX < kPpmEdges)
        rdC[r] = get2(a.recip_dxC, i0 - 1 + lane + r * BX);
    if (lane < kPpmPolys) dF = get2(a.dxF, i0 - 1 + lane);
  }
  const T rdFm = get2(a.recip_dxF, fi - 1), rdF0 = get2(a.recip_dxF, fi);
  const T band = ppm_band<S>(fi, nxp) ? T(1) : T(0);
  const T rA = cell ? a.recip_rA[r2 + fi] : T(0);
  const T mIn = cell ? a.maskInC[r2 + fi] : T(0);
  auto fetch = [&](int k, PpmXLevel<T>& v) {
    const size_t plane = k * P;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      v.q[r] = qi[r] < P ? src[plane + qi[r]] : T(0);
      v.m[r] = qi[r] < P ? a.maskC[plane + qi[r]] : T(0);
    }
    v.vel = face ? a.uVel[plane + r2 + fi] : T(0);
    v.trans = face ? a.uTrans[plane + r2 + fi] : T(0);
    v.trc = cell ? a.tracer[plane + r2 + fi] : T(0);
    v.rh = cell ? a.recip_hFacC[plane + r2 + fi] : T(0);
  };
  PpmXLevel<T> cur, nxt;
  if (k0 < k1) fetch(k0, cur);
  for (int k = k0; k < k1; ++k) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = lane + r * BX;
      if (e < kPpmQ) {
        s.q[e] = cur.q[r];
        s.m[e] = cur.m[r];
      }
    }
    __syncwarp();
    if (k + 1 < k1) fetch(k + 1, nxt);
    // the edges at i0 - 1 + e: the stencil i0 - 4 + e .. i0 + 1 + e; the
    // right edge of the last cell (and beyond) is 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = lane + r * BX;
      if (e < kPpmEdges) {
        T e1 = T(0), e2 = T(0);
        if (i0 - 1 + e < nxp) ppm_edge<T, S>(s.q + e, s.m + e, rdC[r], e1, e2);
        s.e1[e] = e1;
        if constexpr (pqm<S>()) s.e2[e] = e2;
      }
    }
    // the WENO derivatives of cell i0 - 3 + d, staged at d + 1 (its
    // stencil stays inside the staged cells)
    if constexpr (weno<S>()) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = lane + r * BX;
        if (d < kPpmDerivs)
          osc_h(s.q + d + 1, s.m + d + 1, i0 - 3 + d, nxp, s.d1[d], s.d2[d]);
      }
    }
    __syncwarp();
    // the polynomial of cell i0 - 1 + lane (0 before the first cell)
    if (lane < kPpmPolys) {
      T h[NC];
      if (i0 - 1 + lane >= 0) {
        T e2l = T(0), e2r = T(0);
        const T *d1 = nullptr, *d2 = nullptr;
        if constexpr (pqm<S>()) e2l = s.e2[lane], e2r = s.e2[lane + 1];
        if constexpr (weno<S>()) d1 = s.d1 + lane, d2 = s.d2 + lane;
        ppm_poly<T, S>(s.q + lane + 1, s.m + lane + 1, s.e1[lane], e2l,
                       s.e1[lane + 1], e2r, dF, d1, d2, h);
      } else {
#pragma unroll
        for (int n = 0; n < NC; ++n) h[n] = T(0);
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) s.h[n][lane] = h[n];
    }
    __syncwarp();
    // the flux of face i0 + lane, from the polynomial of cell i0 - 1 +
    // lane or i0 + lane
    if (lane < kPpmFaces) {
      T f = T(0);
      if (face) {
        T hm[NC], h0[NC];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          hm[n] = s.h[n][lane];
          h0[n] = s.h[n][lane + 1];
        }
        f = ppm_flux_h<T, NC>(cur.vel, cur.trans, deltaT, rdFm, rdF0, hm, h0,
                              band);
      }
      s.fl[lane] = f;
      s.tr[lane] = cur.trans;
    }
    __syncwarp();
    // the update of cell i0 + lane from its two faces
    if (cell) {
      const T vol = deltaT * cur.rh * a.recip_drF[k] * rA;
      dst[k * P + r2 + fi] =
          s.q[lane + 4] - vol * ((s.fl[lane + 1] - s.fl[lane]) -
                                 cur.trc * (s.tr[lane + 1] - s.tr[lane])) *
                              mIn;
    }
    cur = nxt;
  }
}

// ----------------------------------------------------------- Y and R --

// Y: a thread walks kPpmWalk rows of a column and level, kPpmYWarps walks a
// block
constexpr int kPpmWalk = 32;
constexpr int kPpmYWarps = 4;

// what a walk loads for its step at face f: the source and maskC at the
// ring's new position f + 4, the velocity and transport of face f, the
// spacings (recip_dxF/dyF or recip_drF of cell f, recip_dyC or recip_drC
// at edge f + 1, dyF or drF of cell f), and the tracer, recip_hFacC,
// recip_rA and maskInC of cell f - 1
template <typename T>
struct PpmStep {
  // ad: the R sweep's addend at cell f - 1 (0 without one)
  T q = T(0), m = T(0), vel = T(0), trans = T(0), rdF = T(0), rdC = T(0),
    dF = T(0), trc = T(0), rh = T(0), rA = T(0), mIn = T(0), ad = T(0);
};

// What a walk carries from step to step, and its step at face f. Positions
// count along the walk's axis; DIR 1 (Y) or 2 (R).
template <typename T, int S, int DIR>
struct PpmWalk {
  static constexpr int NC = ncoef<S>();
  // the ring: the source and maskC at f - 2 .. f + 4
  T q[7], m[7];
  // the edge of f (e2: PQM's slope), the derivatives of f - 2 .. f + 1
  // (then f + 2), the polynomial and reciprocal width of cell f - 1
  T e1 = T(0), e2 = T(0);
  T d1[5], d2[5];
  T hm[NC];
  T rdFm = T(0);

  __device__ PpmWalk() {
#pragma unroll
    for (int o = 0; o < 5; ++o) d1[o] = d2[o] = T(0);
#pragma unroll
    for (int n = 0; n < NC; ++n) hm[n] = T(0);
  }

  // Step at face f of a line of n cells with the loads v (v.q the source at
  // f + 4): returns the flux of face f; afterwards the carried values are
  // face f's and the ring is at f + 1 .. f + 5 less its last value.
  __device__ T step(int f, int n, const PpmStep<T>& v, T deltaT) {
    q[6] = v.q;
    m[6] = v.m;
    // the edge of f + 1 from f - 2 .. f + 3 (horizontally 0 from n on)
    T ne1 = T(0), ne2 = T(0);
    if (DIR == 2 || f + 1 < n) ppm_edge<T, S>(q, m, v.rdC, ne1, ne2);
    // the derivatives of cell f + 2 from f .. f + 4
    if constexpr (weno<S>()) {
      if (DIR == 2)
        osc_inner(q + 3, m + 3, d1[4], d2[4]);
      else
        osc_h(q + 4, m + 4, f + 2, n, d1[4], d2[4]);
    }
    // the polynomial of cell f (0 before the first)
    T h[NC];
    if (f >= 0) {
      ppm_poly<T, S>(q, m, e1, e2, ne1, ne2, v.dF, d1, d2, h);
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) h[c] = T(0);
    }
    // the flux of face f
    T fl = T(0);
    if (DIR == 2) {
      if (f > 0 && f < n)
        fl = ppm_flux_r<T, NC>(v.vel, v.trans, m[1], deltaT, rdFm, v.rdF, hm,
                               h);
    } else if (f >= 0 && f < n) {
      fl = ppm_flux_h<T, NC>(v.vel, v.trans, deltaT, rdFm, v.rdF, hm, h,
                             ppm_band<S>(f, n) ? T(1) : T(0));
    }
    // carry
#pragma unroll
    for (int o = 0; o < 6; ++o) {
      q[o] = q[o + 1];
      m[o] = m[o + 1];
    }
    e1 = ne1;
    e2 = ne2;
    if constexpr (weno<S>()) {
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        d1[o] = d1[o + 1];
        d2[o] = d2[o + 1];
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) hm[c] = h[c];
    rdFm = v.rdF;
    return fl;
  }
};

// the first face a walk steps at: 2 (5 for WENO) before its first cell
template <int S>
__host__ __device__ constexpr int ppm_lead() {
  return weno<S>() ? 5 : 2;
}

template <typename T, int S>
__global__ void __launch_bounds__(BX * kPpmYWarps) ppm_y_kernel(
    const AdvArgs<T> a, const T* __restrict__ src, T* __restrict__ dst,
    int nr, int nyp, int nxp, T deltaT) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int walks = (nyp + kPpmWalk - 1) / kPpmWalk;
  const int g = blockIdx.y * kPpmYWarps + threadIdx.y;
  if (i >= nxp || g >= walks * nr) return;
  const int k = g / walks;
  const int j0 = (g - k * walks) * kPpmWalk;
  const int j1 = j0 + kPpmWalk < nyp ? j0 + kPpmWalk : nyp;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t plane = k * P;
  auto q2 = [&](int j) { return static_cast<size_t>(j) * nxp + i; };
  auto in = [&](int j) { return j >= 0 && j < nyp; };
  auto load = [&](int f) {
    PpmStep<T> v;
    if (f <= j1) {
      if (in(f + 4)) {
        v.q = src[plane + q2(f + 4)];
        v.m = a.maskC[plane + q2(f + 4)];
      }
      if (in(f)) {
        v.vel = a.vVel[plane + q2(f)];
        v.trans = a.vTrans[plane + q2(f)];
        v.rdF = a.recip_dyF[q2(f)];
        if constexpr (pqm<S>()) v.dF = a.dyF[q2(f)];
      }
      if constexpr (pqm<S>())
        if (in(f + 1)) v.rdC = a.recip_dyC[q2(f + 1)];
      if (f - 1 >= j0) {
        v.trc = a.tracer[plane + q2(f - 1)];
        v.rh = a.recip_hFacC[plane + q2(f - 1)];
        v.rA = a.recip_rA[q2(f - 1)];
        v.mIn = a.maskInC[q2(f - 1)];
      }
    }
    return v;
  };
  const int fs = j0 - ppm_lead<S>();
  PpmWalk<T, S, 1> w;
#pragma unroll
  for (int o = 0; o < 6; ++o) {
    const int jj = fs - 2 + o;
    w.q[o] = in(jj) ? src[plane + q2(jj)] : T(0);
    w.m[o] = in(jj) ? a.maskC[plane + q2(jj)] : T(0);
  }
  const T rdrF = a.recip_drF[k];
  PpmStep<T> cur = load(fs);
  T flm = T(0), trm = T(0);   // the flux and transport of face f - 1
  for (int f = fs; f <= j1; ++f) {
    const PpmStep<T> nxt = load(f + 1);
    const T src_c = w.q[1];   // the source of cell f - 1
    const T fl = w.step(f, nyp, cur, deltaT);
    if (f - 1 >= j0) {
      const T vol = deltaT * cur.rh * rdrF * cur.rA;
      dst[plane + q2(f - 1)] =
          src_c - vol * ((fl - flm) - cur.trc * (cur.trans - trm)) * cur.mIn;
    }
    flm = fl;
    trm = cur.trans;
    cur = nxt;
  }
}

// The R sweep, gTr = (localT - tracer) / deltaT, one thread a column.
template <typename T, int S>
__global__ void __launch_bounds__(NT) ppm_r_kernel(
    const AdvArgs<T> a, const T* __restrict__ src, T* __restrict__ dst,
    const T* __restrict__ add, int nr, int nyp, int nxp, T deltaT,
    T rkSign) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q2 = static_cast<size_t>(j) * nxp + i;
  auto lev = [&](int l) { return l < 0 ? 0 : (l > nr - 1 ? nr - 1 : l); };
  auto in = [&](int l) { return l >= 0 && l < nr; };
  auto load = [&](int f) {
    PpmStep<T> v;
    if (f <= nr) {
      // the source clamps to the column's ends (the ghost copies), maskC is
      // 0 beyond them
      v.q = src[lev(f + 4) * P + q2];
      if (in(f + 4)) v.m = a.maskC[(f + 4) * P + q2];
      if (in(f)) {
        // the surface's transport enters cell 0's update, not a flux
        if (f > 0) v.vel = a.wVel[f * P + q2];
        v.trans = a.rTrans[f * P + q2];
        v.rdF = a.recip_drF[f];
        if constexpr (pqm<S>()) v.dF = a.drF[f];
      }
      if constexpr (pqm<S>())
        if (f + 1 >= 0 && f + 1 <= nr) v.rdC = a.recip_drC[f + 1];
      if (f >= 1) {
        v.trc = a.tracer[(f - 1) * P + q2];
        v.rh = a.recip_hFacC[(f - 1) * P + q2];
        if (add) v.ad = add[(f - 1) * P + q2];
      }
    }
    return v;
  };
  const int fs = -ppm_lead<S>();
  PpmWalk<T, S, 2> w;
#pragma unroll
  for (int o = 0; o < 6; ++o) {
    const int l = fs - 2 + o;
    w.q[o] = src[lev(l) * P + q2];
    w.m[o] = in(l) ? a.maskC[l * P + q2] : T(0);
  }
  const T rA = a.recip_rA[q2], mIn = a.maskInC[q2];
  PpmStep<T> cur = load(fs);
  T flm = T(0), trm = T(0);   // the flux and transport of face f - 1
  for (int f = fs; f <= nr; ++f) {
    const PpmStep<T> nxt = load(f + 1);
    const T src_c = w.q[1];   // the source of cell f - 1
    const T fl = w.step(f, nr, cur, deltaT);
    if (f >= 1) {
      const int kc = f - 1;
      const T vol = deltaT * cur.rh * a.recip_drF[kc] * rA;
      const T localT =
          src_c - vol * ((fl - flm) - cur.trc * (cur.trans - trm)) * rkSign *
                      mIn;
      const T g = (localT - cur.trc) / deltaT;
      dst[kc * P + q2] = add ? g + cur.ad : g;
    }
    flm = fl;
    trm = cur.trans;
    cur = nxt;
  }
}

// Start sweep DIR (0 X, 1 Y, 2 R) of scheme S with start(kernel, grid,
// block, args...) (OnStream on the card).
template <typename T, int DIR, int S, typename Start>
void launch_ppm_s(const AdvArgs<T>& a, const T* s, T* d, const T* add,
                  int nr, int nyp, int nxp, double deltaT, double rkSign,
                  Start start) {
  if constexpr (DIR == 2) {
    start(ppm_r_kernel<T, S>, grid2d(nyp, nxp), dim3(BX, BY), a, s, d, add,
          nr, nyp, nxp, T(deltaT), T(rkSign));
  } else if constexpr (DIR == 1) {
    const int walks = (nyp + kPpmWalk - 1) / kPpmWalk;
    start(ppm_y_kernel<T, S>,
          dim3((nxp + BX - 1) / BX,
               (walks * nr + kPpmYWarps - 1) / kPpmYWarps),
          dim3(BX, kPpmYWarps), a, s, d, nr, nyp, nxp, T(deltaT));
  } else {
    start(ppm_x_kernel<T, S>,
          dim3((nxp + kPpmCells - 1) / kPpmCells,
               (nyp + kPpmRows - 1) / kPpmRows,
               (nr + kPpmLevels - 1) / kPpmLevels),
          dim3(BX, kPpmRows), a, s, d, nr, nyp, nxp, T(deltaT));
  }
}

// add as launch_multidim's
template <typename T, int DIR, typename Start>
int launch_ppm(const void* const* table, int n, const void* src, void* dst,
               const void* add, int nr, int nyp, int nxp, int scheme,
               double deltaT, double rkSign, Start start) {
  AdvArgs<T> a;
  // the walks index a level's plane with an int
  if (!adv_args(table, n, &a) || nr < 1 || nyp < 1 || nxp < 1 ||
      static_cast<long long>(nyp) * nxp > 0x7fffffffLL || src == nullptr ||
      dst == nullptr || (DIR != 2 && add != nullptr))
    return (int)cudaErrorInvalidValue;
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  const T* ad = static_cast<const T*>(add);
#define MITGCM_PPM_CASE(S)                                                    \
  case S:                                                                     \
    launch_ppm_s<T, DIR, S>(a, s, d, ad, nr, nyp, nxp, deltaT, rkSign,       \
                            start);                                           \
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
