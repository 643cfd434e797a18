// Kernel LA, seaice_advect_legacy: the sea ice's legacy advection of HEFF,
// AREA and HSNOW (SEAICEadvScheme 2, 3 or 4: advect.F's two-pass centred
// Heun scheme, with DIFF1's harmonic and biharmonic diffusion, diffus.F).
//
// Replaces: mitgcm_tpu/model/seaice.py:SeaIce._advect_legacy (:1449-1472)
// with _diffus (:1436-1447) and advdiff's legacy branch (:1485-1500, the
// diffKh diffusion of the old fields through _diffuse_field, :1350), which
// XLA fused into a few 2-D passes per field on the TPU.
//
// Three launches a step, one thread per padded cell, the three fields
// stacked [3, nyp, nxp]; each of the JAX code's halo fills is folded into
// the next launch's reads as the fill's gather index (common.cuh:wrap):
//   pass 1  the first Heun pass, upd1 = F - dt (div of the centred fluxes
//           of F) recip_rA maskInC on interior cells (F the old field);
//   pass 2  the second, from tmp = (upd1 filled + F) / 2, on interior
//           cells, and DIFF1's Laplacian of F there (0 on the halo);
//   pass 3  every padded cell: the filled second pass, DIFF1's harmonic
//           step masked by the ice mask, the biharmonic one (the Laplacian
//           of the filled Laplacian with the coefficient -DIFFA^2) masked
//           again, then where any diffKh > 0 dt times the harmonic
//           tendency of F (zero-filled shifts at the array's edges).
// DIFFA = min(dxF, dyF) is the SeaIce's, built once a grid.
//
// Bound: bytes. A pass reads the three fields (pass 2 and 3: two to four
// stacks) and 5-7 metric fields and writes one or two stacks, 40-80
// B/cell in float32 for ~30-60 flops; the neighbours hit L1/L2. Every
// expression keeps the JAX code's operation order, so built with
// --fmad=false every padded cell is bit-equal to the twin
// (model/seaice.py:_advdiff_legacy_plain).

#pragma once

#include <cstring>

#include "common.cuh"

namespace mitgcm {

template <typename T>
struct LegacyArgs {
  // [nyp, nxp]
  const T *uIce, *vIce, *dxG, *dyG, *recip_rA, *maskInC, *heffm, *recip_dxC,
      *recip_dyC, *cosFacU, *diffa, *maskW, *maskS;
  // [3, nyp, nxp]: the old fields, pass 1's and pass 2's interior values,
  // DIFF1's interior Laplacian, the output
  const T* fld;
  T *pass1, *pass2, *lap, *out;
};
constexpr int kLegacyPointers = 18;

struct LegacyParams {
  double dt, diff1, kh[3];
  int nyp, nxp, ol, any_kh;
};

template <typename T>
struct Plane {
  const T* f;
  int nyp, nxp, ol;
  bool wrapped;   // read through the cyclic fill's gather
  __device__ T operator()(int j, int i) const {
    if (wrapped) {
      j = wrap(j, ol, nyp - 2 * ol);
      i = wrap(i, ol, nxp - 2 * ol);
    } else if (i < 0 || i >= nxp || j < 0 || j >= nyp) {
      return T(0);
    }
    return f[static_cast<size_t>(j) * nxp + i];
  }
};

// a Heun pass at interior cell (j, i): F - dt ((afx(i+1) - afx(i)) +
// (afy(j+1) - afy(j))) recip_rA maskInC, afx = dyG u (tmp(i) + tmp(i-1)) / 2
// with tmp = (G + F) / 2 (seaice.py:1457-1465)
template <typename T>
__device__ T heun(const LegacyArgs<T>& a, const Plane<T>& G,
                  const Plane<T>& F, int j, int i, T dt) {
  const int nxp = G.nxp;
  auto tmp = [&](int jj, int ii) { return T(0.5) * (G(jj, ii) + F(jj, ii)); };
  auto afx = [&](int jj, int ii) {
    const size_t q = static_cast<size_t>(jj) * nxp + ii;
    return a.dyG[q] * a.uIce[q] * T(0.5) * (tmp(jj, ii) + tmp(jj, ii - 1));
  };
  auto afy = [&](int jj, int ii) {
    const size_t q = static_cast<size_t>(jj) * nxp + ii;
    return a.dxG[q] * a.vIce[q] * T(0.5) * (tmp(jj, ii) + tmp(jj - 1, ii));
  };
  const size_t p = static_cast<size_t>(j) * nxp + i;
  return F(j, i) - dt * ((afx(j, i + 1) - afx(j, i)) +
                         (afy(j + 1, i) - afy(j, i))) *
                       a.recip_rA[p] * a.maskInC[p];
}

// diffus.F at interior cell (j, i): the Laplacian of L with the coefficient
// c(q) = diffa or -diffa^2 (seaice.py:1436-1447)
template <typename T, bool Bilap>
__device__ T diffus(const LegacyArgs<T>& a, const Plane<T>& L, int j, int i) {
  const int nxp = L.nxp;
  auto c = [&](size_t q) {
    const T d = a.diffa[q];
    return Bilap ? -d * d : d;
  };
  auto dfx = [&](int jj, int ii) {
    const size_t q = static_cast<size_t>(jj) * nxp + ii;
    return a.dyG[q] * a.recip_dxC[q] * (L(jj, ii) - L(jj, ii - 1)) *
           a.cosFacU[q] * a.heffm[q] * a.heffm[q - 1] * T(0.5) *
           (c(q) + c(q - 1));
  };
  auto dfy = [&](int jj, int ii) {
    const size_t q = static_cast<size_t>(jj) * nxp + ii;
    return a.dxG[q] * a.recip_dyC[q] * (L(jj, ii) - L(jj - 1, ii)) *
           a.heffm[q] * a.heffm[q - nxp] * T(0.5) * (c(q) + c(q - nxp));
  };
  const size_t p = static_cast<size_t>(j) * nxp + i;
  return ((dfx(j, i + 1) - dfx(j, i)) + (dfy(j + 1, i) - dfy(j, i))) *
         a.recip_rA[p];
}

// seaice_diffusion.F at any padded cell (j, i), zero-filled shifts: the
// harmonic tendency of F with diffKh kh (seaice.py:1350-1357)
template <typename T>
__device__ T diffuse_field(const LegacyArgs<T>& a, const Plane<T>& F, int j,
                           int i, T kh) {
  const int nyp = F.nyp, nxp = F.nxp;
  auto zon = [&](int jj, int ii) -> T {
    if (ii >= nxp) return T(0);
    const size_t q = static_cast<size_t>(jj) * nxp + ii;
    return -kh * (a.dyG[q] * a.maskW[q]) * a.recip_dxC[q] *
           (F(jj, ii) - F(jj, ii - 1));
  };
  auto mer = [&](int jj, int ii) -> T {
    if (jj >= nyp) return T(0);
    const size_t q = static_cast<size_t>(jj) * nxp + ii;
    return -kh * (a.dxG[q] * a.maskS[q]) * a.recip_dyC[q] *
           (F(jj, ii) - F(jj - 1, ii));
  };
  const size_t p = static_cast<size_t>(j) * nxp + i;
  return (-a.heffm[p]) * a.recip_rA[p] *
         ((zon(j, i + 1) - zon(j, i)) + (mer(j + 1, i) - mer(j, i)));
}

template <typename T>
__global__ void seaice_advect_legacy_kernel(const LegacyArgs<T> a,
                                            const LegacyParams q, int pass) {
  const int nyp = q.nyp, nxp = q.nxp, ol = q.ol;
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t p = static_cast<size_t>(j) * nxp + i;
  const bool inside = j >= ol && j < nyp - ol && i >= ol && i < nxp - ol;
  const T dt = T(q.dt), diff1 = T(q.diff1);
  for (int f = 0; f < 3; ++f) {
    const Plane<T> F{a.fld + f * P, nyp, nxp, ol, false};
    if (pass == 1) {
      if (inside) a.pass1[f * P + p] = heun(a, F, F, j, i, dt);
    } else if (pass == 2) {
      if (!inside) continue;
      const Plane<T> G{a.pass1 + f * P, nyp, nxp, ol, true};
      a.pass2[f * P + p] = heun(a, G, F, j, i, dt);
      if (q.diff1 > 0.0) a.lap[f * P + p] = diffus<T, false>(a, F, j, i);
    } else {
      const Plane<T> G{a.pass2 + f * P, nyp, nxp, ol, true};
      T v = G(j, i);
      if (q.diff1 > 0.0) {
        const T hm = a.heffm[p];
        const T lap = inside ? a.lap[f * P + p] : T(0);
        v = (v + lap * diff1 * dt) * hm;
        const Plane<T> L{a.lap + f * P, nyp, nxp, ol, true};
        const T bilap = inside ? diffus<T, true>(a, L, j, i) : T(0);
        v = (v + bilap * diff1 * dt) * hm;
      }
      if (q.any_kh) v = v + dt * diffuse_field(a, F, j, i, T(q.kh[f]));
      a.out[f * P + p] = v;
    }
  }
}

template <typename T, typename Start>
int launch_seaice_advect_legacy(const void* const* table, int n,
                                const double* params, int nparams, int nyp,
                                int nxp, int ol, int pass, Start start) {
  static_assert(sizeof(LegacyArgs<T>) == kLegacyPointers * sizeof(void*),
                "LegacyArgs must be a plain table of pointers");
  if (n != kLegacyPointers || nparams != 6 || pass < 1 || pass > 3 ||
      ol < 1 || nyp <= 2 * ol || nxp <= 2 * ol)
    return (int)cudaErrorInvalidValue;
  LegacyArgs<T> a;
  std::memcpy(&a, table, sizeof(a));
  LegacyParams q{params[0], params[1], {params[2], params[3], params[4]},
                 nyp, nxp, ol, params[5] != 0.0};
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, 1);
  start(seaice_advect_legacy_kernel<T>, g, dim3(BX, BY), a, q, pass);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

