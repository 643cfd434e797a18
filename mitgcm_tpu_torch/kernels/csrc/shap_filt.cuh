// Kernels SH-uv and SH-ts: one pass of the Shapiro filter's S2 function on
// the velocity pair or on a tracer, and their launches. Included by
// shap_filt.cu, whose entry points start them on the card, and by the host
// check of the tests, which runs them on the CPU.
//
// Replaces the fused passes that XLA made of each iteration of
// mitgcm_tpu/model/shap_filt.py:apply_uv (:150-221; index space,
// :183-205, or physical space through mom_vecinv.del2uv, :206-219) and
// apply_ts (:224-264), Cartesian grids only:
//   - a pass that fills (odd passes; SH-ts from the third) reads its input
//     through the cyclic wrap of the halo (the fill's gather,
//     ops/stencil.py:cyclic_fill_halo, folded into the read);
//   - the first SH-uv pass reads u maskW and v maskS;
//   - cells [1, nyp - 1) x [1, nxp - 1) take -1/8 of the pass's Laplacian,
//     the outermost ring keeps the value read (the `wr` mask, :172-178);
//   - the last pass writes u - tmpU fac (SH-ts: fld - tmp deltaT / tau).
// A neighbour outside the padded array reads 0, as the twins' shifts fill.
//
// Bound: bytes. An index-space SH-uv pass reads 4 3-D fields (tmpU, tmpV,
// maskW, maskS; the last also u and v) and writes 2, 24-32 B/cell in
// float32; an SH-ts pass 3 and 1, 16-20 B/cell; a few tens of flops.
// Design: one thread per padded cell (k, j, i), i fastest, that forms its
// neighbours' divergences, vorticities or fluxes from the input (the
// neighbours come from the caches). Each expression keeps the twins'
// operation order (model/shap_filt.py: _uv_pass_plain, _ts_pass_plain,
// apply_uv_plain, apply_ts_plain), so with --fmad=false the outputs are
// bit-equal on every padded cell.
#pragma once

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct ShapArgs {
  // [nr, nyp, nxp]: the pass's input pair and the fields that the last
  // pass filters (SH-ts: the tracer's input and the tracer, the second of
  // each null); the grid
  const T *tU, *tV, *u, *v;
  const T *maskW, *maskS, *hFacW, *hFacS, *recip_hFacW, *recip_hFacS,
      *recip_hFacC;
  // [nyp, nxp]
  const T *dxG, *dyG, *dxC, *dyC, *rA, *rAz, *rAw, *rAs, *recip_rA,
      *recip_rAz, *recip_dxC, *recip_dyC, *recip_dxG, *recip_dyG;
  // outputs: the pass's pair, or the filtered fields on the last pass
  // (SH-ts: the second null)
  T *outU, *outV;
};
constexpr int kShapNumPointers = 27;
// SH-uv: deltaTMom / Shap_uvtau, Shap_uvLength^2; SH-ts: deltaTTracer,
// Shap_Trtau, Shap_TrLength^2
constexpr int kShapUvParams = 2;
constexpr int kShapTsParams = 3;

// the pass: fill (read through the wrap), first (SH-uv: mask the input),
// last, physical, length (SH-uv: the sign of Shap_uvLength; SH-ts:
// Shap_TrLength > 0)
struct ShapFlags {
  int fill, first, last, physical, length;
};

// The padded cell of a pass's thread and its reads: a field's value at
// (jj, ii), 0 outside the array; the pass's input there, through the wrap
// on a pass that fills, masked on SH-uv's first pass.
template <typename T>
struct ShapCell {
  int nyp, nxp, oly, olx;
  size_t lev;
  ShapFlags f;
  __device__ bool in(int jj, int ii) const {
    return jj >= 0 && jj < nyp && ii >= 0 && ii < nxp;
  }
  __device__ T at3(const T* a, int jj, int ii) const {
    return in(jj, ii) ? a[lev + static_cast<size_t>(jj) * nxp + ii] : T(0);
  }
  __device__ T at2(const T* a, int jj, int ii) const {
    return in(jj, ii) ? a[static_cast<size_t>(jj) * nxp + ii] : T(0);
  }
  __device__ T input(const T* t, const T* m, int jj, int ii) const {
    if (!in(jj, ii)) return T(0);
    // the wrap (an integer modulo) only for halo cells: it leaves an
    // interior index as it is
    if (f.fill && (jj < oly || jj >= nyp - oly))
      jj = wrap(jj, oly, nyp - 2 * oly);
    if (f.fill && (ii < olx || ii >= nxp - olx))
      ii = wrap(ii, olx, nxp - 2 * olx);
    const size_t p = lev + static_cast<size_t>(jj) * nxp + ii;
    return f.first ? t[p] * m[p] : t[p];
  }
};

template <typename T>
__global__ void shap_uv_kernel(ShapArgs<T> a, int nyp, int nxp, int oly,
                               int olx, ShapFlags f, T fac, T L2) {
  GridCell g;
  if (!grid_cell_of(nyp, nxp, g)) return;
  const int j = g.j, i = g.i;
  const ShapCell<T> c{nyp, nxp, oly, olx, g.p - g.q, f};
  auto U = [&](int jj, int ii) { return c.input(a.tU, a.maskW, jj, ii); };
  auto V = [&](int jj, int ii) { return c.input(a.tV, a.maskS, jj, ii); };
  T nU, nV;
  if (j == 0 || i == 0 || j == nyp - 1 || i == nxp - 1) {
    nU = U(j, i);
    nV = V(j, i);
  } else if (!f.physical) {
    // index space (shap_filt_uv_s2.F, shap_filt_computvort.F)
    auto hdiv = [&](int jj, int ii) -> T {
      if (!c.in(jj, ii)) return T(0);
      return (U(jj, ii + 1) - U(jj, ii)) + (V(jj + 1, ii) - V(jj, ii));
    };
    auto vort = [&](int jj, int ii) -> T {
      if (!c.in(jj, ii)) return T(0);
      const T mZ = (c.at3(a.maskW, jj, ii) + c.at3(a.maskW, jj - 1, ii)) *
                   (c.at3(a.maskS, jj, ii) + c.at3(a.maskS, jj, ii - 1));
      return mZ < T(1) ? T(0)
                       : (V(jj, ii) - V(jj, ii - 1)) -
                             (U(jj, ii) - U(jj - 1, ii));
    };
    const T h = hdiv(j, i), z = vort(j, i);
    nU = T(-0.125) * ((h - hdiv(j, i - 1)) - (vort(j + 1, i) - z)) *
         a.maskW[g.p];
    nV = T(-0.125) * ((h - hdiv(j - 1, i)) + (vort(j, i + 1) - z)) *
         a.maskS[g.p];
  } else {
    // physical space: the Laplacian from the divergence and the vorticity
    // (mom_calc_hdiv.F, mom_calc_relvort3.F, mom_vi_del2uv.F), scaled by
    // rA and rAz when Shap_uvLength < 0
    auto hdiv = [&](int jj, int ii) -> T {
      if (!c.in(jj, ii)) return T(0);
      auto uT = [&](int j2, int i2) -> T {
        if (!c.in(j2, i2)) return T(0);
        return U(j2, i2) * c.at2(a.dyG, j2, i2) * c.at3(a.hFacW, j2, i2);
      };
      auto vT = [&](int j2, int i2) -> T {
        if (!c.in(j2, i2)) return T(0);
        return V(j2, i2) * c.at2(a.dxG, j2, i2) * c.at3(a.hFacS, j2, i2);
      };
      T d = ((uT(jj, ii + 1) - uT(jj, ii)) + (vT(jj + 1, ii) - vT(jj, ii))) *
            c.at2(a.recip_rA, jj, ii) * c.at3(a.recip_hFacC, jj, ii);
      if (f.length < 0) d = d * c.at2(a.rA, jj, ii);
      return d;
    };
    auto hv = [&](int jj, int ii) -> T {
      if (!c.in(jj, ii)) return T(0);
      auto vd = [&](int j2, int i2) -> T {
        return c.in(j2, i2) ? V(j2, i2) * c.at2(a.dyC, j2, i2) : T(0);
      };
      auto ud = [&](int j2, int i2) -> T {
        return c.in(j2, i2) ? U(j2, i2) * c.at2(a.dxC, j2, i2) : T(0);
      };
      T z = c.at2(a.recip_rAz, jj, ii) *
            ((vd(jj, ii) - vd(jj, ii - 1)) - (ud(jj, ii) - ud(jj - 1, ii)));
      if (f.length < 0) z = z * c.at2(a.rAz, jj, ii);
      // hFacZ (mom_calc_hfacz.F; model/mom_fluxform.py:calc_hfacz)
      const T mW = c.at3(a.maskW, jj, ii), mWs = c.at3(a.maskW, jj - 1, ii);
      const T mS = c.at3(a.maskS, jj, ii), mSw = c.at3(a.maskS, jj, ii - 1);
      const T openJ = min_nan(c.at3(a.hFacW, jj, ii),
                              c.at3(a.hFacW, jj - 1, ii)) * mW * mWs;
      const T openI = min_nan(c.at3(a.hFacS, jj, ii),
                              c.at3(a.hFacS, jj, ii - 1)) * mS * mSw;
      const T hz = min_nan(openI, openJ) * mW * mWs;
      return hz * z;
    };
    const size_t q = g.q;
    const T h = hdiv(j, i), z = hv(j, i);
    const T d2u = ((h - hdiv(j, i - 1)) * a.recip_dxC[q] -
                   a.recip_hFacW[g.p] * (hv(j + 1, i) - z) * a.recip_dyG[q]) *
                  a.maskW[g.p];
    const T d2v = ((h - hdiv(j - 1, i)) * a.recip_dyC[q] +
                   a.recip_hFacS[g.p] * (hv(j, i + 1) - z) * a.recip_dxG[q]) *
                  a.maskS[g.p];
    if (f.length < 0) {
      nU = T(-0.125) * d2u * a.maskW[g.p];
      nV = T(-0.125) * d2v * a.maskS[g.p];
    } else if (f.length == 0) {
      nU = T(-0.125) * d2u * a.rAw[q] * a.maskW[g.p];
      nV = T(-0.125) * d2v * a.rAs[q] * a.maskS[g.p];
    } else {
      nU = T(-0.125) * d2u * L2 * a.maskW[g.p];
      nV = T(-0.125) * d2v * L2 * a.maskS[g.p];
    }
  }
  if (f.last) {
    a.outU[g.p] = a.u[g.p] - nU * fac;
    a.outV[g.p] = a.v[g.p] - nV * fac;
  } else {
    a.outU[g.p] = nU;
    a.outV[g.p] = nV;
  }
}

template <typename T>
__global__ void shap_ts_kernel(ShapArgs<T> a, int nyp, int nxp, int oly,
                               int olx, ShapFlags f, T deltaT, T tau, T L2) {
  GridCell g;
  if (!grid_cell_of(nyp, nxp, g)) return;
  const int j = g.j, i = g.i;
  const ShapCell<T> c{nyp, nxp, oly, olx, g.p - g.q, f};
  auto t = [&](int jj, int ii) { return c.input(a.tU, nullptr, jj, ii); };
  T n;
  if (j == 0 || i == 0 || j == nyp - 1 || i == nxp - 1) {
    n = t(j, i);
  } else if (!f.physical) {
    auto fdx = [&](int jj, int ii) -> T {
      if (!c.in(jj, ii)) return T(0);
      return (t(jj, ii) - t(jj, ii - 1)) * c.at3(a.maskW, jj, ii);
    };
    auto fdy = [&](int jj, int ii) -> T {
      if (!c.in(jj, ii)) return T(0);
      return (t(jj, ii) - t(jj - 1, ii)) * c.at3(a.maskS, jj, ii);
    };
    const T grd = (fdx(j, i + 1) - fdx(j, i)) + (fdy(j + 1, i) - fdy(j, i));
    n = T(-0.125) * grd;
  } else {
    auto fdx = [&](int jj, int ii) -> T {
      if (!c.in(jj, ii)) return T(0);
      return (t(jj, ii) - t(jj, ii - 1)) * c.at3(a.hFacW, jj, ii) *
             c.at2(a.dyG, jj, ii) * c.at2(a.recip_dxC, jj, ii);
    };
    auto fdy = [&](int jj, int ii) -> T {
      if (!c.in(jj, ii)) return T(0);
      return (t(jj, ii) - t(jj - 1, ii)) * c.at3(a.hFacS, jj, ii) *
             c.at2(a.dxG, jj, ii) * c.at2(a.recip_dyC, jj, ii);
    };
    const T grd = (fdx(j, i + 1) - fdx(j, i)) + (fdy(j + 1, i) - fdy(j, i));
    n = T(-0.125) * grd * a.recip_hFacC[g.p];
    if (f.length) n = n * a.recip_rA[g.q] * L2;
  }
  a.outU[g.p] = f.last ? a.u[g.p] - n * deltaT / tau : n;
}

// SH-uv's (ts = 0) and SH-ts's (ts = 1) launch from their entry points'
// arguments: the tables', parameters' and flags' checks and the grid;
// start(kernel, grid, block, args...) starts it (OnStream on the card).
template <typename T, typename Start>
int launch_shap(int ts, const void* const* table, int n,
                const double* params, int np, int nr, int nyp, int nxp,
                int oly, int olx, ShapFlags f, Start start) {
  static_assert(sizeof(ShapArgs<T>) == kShapNumPointers * sizeof(void*),
                "ShapArgs must be a plain table of pointers");
  ShapArgs<T> a;
  const bool physical = f.physical != 0;
  if (!unpack(&a, table, n, kShapNumPointers) ||
      np != (ts ? kShapTsParams : kShapUvParams) || nr < 1 || nr > 65535 ||
      oly < 1 || olx < 1 || nyp <= 2 * oly || nxp <= 2 * olx ||
      f.fill < 0 || f.fill > 1 || f.first < 0 || f.first > 1 ||
      f.last < 0 || f.last > 1 || f.physical < 0 || f.physical > 1 ||
      f.length < -1 || f.length > 1 || (ts && (f.first || f.length < 0)) ||
      !(a.tU && a.u && a.maskW && a.maskS && a.outU) ||
      (!ts && !(a.tV && a.v && a.outV)))
    return (int)cudaErrorInvalidValue;
  // the metrics that a physical pass reads
  if (physical && !(a.hFacW && a.hFacS && a.recip_hFacC && a.dyG && a.dxG &&
                    a.recip_dxC && a.recip_dyC && a.recip_rA &&
                    (ts || (a.recip_hFacW && a.recip_hFacS && a.dxC &&
                            a.dyC && a.rA && a.rAz && a.rAw && a.rAs &&
                            a.recip_rAz && a.recip_dxG && a.recip_dyG))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = cell_grid(nr, nyp, nxp), block(kCellX, kCellY);
  if (ts)
    start(shap_ts_kernel<T>, grid, block, a, nyp, nxp, oly, olx, f,
          T(params[0]), T(params[1]), T(params[2]));
  else
    start(shap_uv_kernel<T>, grid, block, a, nyp, nxp, oly, olx, f,
          T(params[0]), T(params[1]));
  return (int)cudaGetLastError();
}

}  // namespace mitgcm
