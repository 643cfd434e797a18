// Kernel H-IDEMIX: the internal-wave energy model IDEMIX (Olbers & Eden
// 2013, the CVMIX variant of ggl90_idemix.F) inside GGL90.
//
// Replaces: mitgcm_tpu/model/ggl90.py:GGL90.idemix (:209-355) in
// z-coordinates, which XLA ran as fused passes over [nr, nyp, nxp] arrays, a
// reduction over the levels and the lax.scan's of solve_tridiagonal
// (:590-612).
//
// Three launches per step:
//   idemix_prep  one thread per (j, i) column: the integrated buoyancy
//                frequency bN0 (summed k = 1..nr-1 in order, as the twin
//                does), the mode-1 speed cstar, then per level the group
//                velocities c0 and v0 (gofx2, hofx1; v0 under its CFL cap)
//                and the dissipation time scale tau_d (:224-257), into
//                three scratch fields.
//   idemix_hdiff one thread per cell: the four face fluxes of the
//                down-gradient diffusion of v0 E (tau_h-weighted, as the JAX
//                code's zero-filled shifts give them at the array's edges)
//                and E + dt gE below the surface (:253-285).
//   idemix_col   one thread per column: the vertical diffusivity delta from
//                the neighbouring c0 with its zero surface, bottom and
//                klowC-1 rows, the coefficients completed with the
//                neighbouring c0, the wind flux into level 1 and the tidal
//                flux into level klowC-1 (:287-350), the Thomas solve with
//                its zero-pivot rule, and gTKE = tau_d E'^2 (:352-355).
//
// Bound: bytes. idemix_prep reads Nsq and hFacC and writes 3 fields;
// idemix_hdiff reads 8 3-D fields (E, v0, maskC, hFacC, hFacW, hFacS, maskW,
// maskS; the neighbours hit L1/L2) and writes 1; idemix_col reads 6 and
// writes 2. The arithmetic (an asin, a pow, an exp, a log and three sqrt per
// cell in idemix_prep) stays well under the card's rate. Design: as kernel
// G9, a column's levels are coupled, so one thread walks one column with i
// fastest; idemix_col keeps the sweep's multipliers and right-hand side in
// per-thread arrays of kMaxNr levels (the wrapper refuses a larger nr). Each
// expression keeps the twin's operation order (model/ggl90.py:
// _idemix_prep_plain, _idemix_hdiff_plain, _idemix_col_plain), divisions are
// IEEE divisions as the twins' tensor-by-tensor ones, and asin, pow, exp,
// log and sqrt are the CUDA math library's, which PyTorch's elementwise
// kernels call; built with --fmad=false the outputs are bit-equal to the
// twins. Every cell of the padded arrays is computed, halos included.

#include <cstring>

#include "common.cuh"

namespace mitgcm {

namespace {

constexpr int kIdemixMaxNr = 64;   // model/ggl90.py:MAX_NR

// torch.minimum / maximum (a NaN in either gives NaN)
template <typename T>
__device__ __forceinline__ T imin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T imax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
struct PrepArgs {
  const T *Nsq, *hFacC;          // [nr, nyp, nxp]
  const T *fCori, *dxF, *dyF;    // [nyp, nxp]
  const T* drC;                  // [nr+1]
  T *c0, *v0, *tauD;             // [nr, nyp, nxp]
};
struct PrepParams {
  double twoOverPi, pijstar, gamma, mu0, cfl, powExp;
};

template <typename T>
struct HdiffArgs {
  // [nr, nyp, nxp]
  const T *E, *v0, *maskC, *hFacC, *hFacW, *hFacS, *maskW, *maskS;
  // [nyp, nxp]
  const T *dxG, *dyG, *recip_dxC, *recip_dyC, *recip_rA;
  // [nr+1]
  const T *drC, *recip_drC;
  T* Eout;
};
struct HdiffParams {
  double dt, tauH05;
};

template <typename T>
struct ColArgs {
  // [nr, nyp, nxp]
  const T *E, *c0, *tauD, *maskC, *hFacC, *recip_hFacC;
  // [nyp, nxp]: the surface (wind) and bottom (tidal) energy fluxes
  const T *Fs, *Fb;
  // [nr], [nr+1]
  const T *recip_drF, *recip_drC;
  const int* klowC;
  T *Enew, *gTKE;
};
struct ColParams {
  double dt, dtTauV;
};

// 1/hFacI of the interface above the cell at p (0 where closed); pm is the
// cell above (the cell itself at the surface, as the JAX code's hfac_km1)
template <typename T>
__device__ __forceinline__ T recip_hfacI(const T* hFacC, size_t p,
                                         size_t pm) {
  const T hI = imin(hFacC[pm], T(0.5)) + imin(hFacC[p], T(0.5));
  return hI != T(0) ? T(1) / hI : T(0);
}

template <typename T>
__global__ void idemix_prep_kernel(const PrepArgs<T> a, const PrepParams q,
                                   int nr, int nyp, int nxp) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int plane = nyp * nxp;
  if (col >= plane) return;
  const size_t P = static_cast<size_t>(plane);
  const T twoOverPi = T(q.twoOverPi);

  // bN0 = sum over k >= 1 of sqrt(N2+) drC hFacI, in level order
  T bN0 = T(0);
  for (int k = 1; k < nr; ++k) {
    const size_t p = k * P + col;
    const T hI = imin(a.hFacC[p - P], T(0.5)) + imin(a.hFacC[p], T(0.5));
    bN0 = bN0 + sqrt(imax(a.Nsq[p], T(0))) * a.drC[k] * hI;
  }
  const T fxb = fabs(a.fCori[col]);
  const T cstar = imax(bN0 / T(q.pijstar), T(1e-2));
  const T cstarG = cstar * T(q.gamma);
  const T cap = T(0.5) * imin(a.dxF[col], a.dyF[col]) * T(q.cfl);
  a.c0[col] = T(0);
  a.v0[col] = T(0);
  a.tauD[col] = T(0);
  for (int k = 1; k < nr; ++k) {
    const size_t p = k * P + col;
    const T fxa = sqrt(imax(a.Nsq[p], T(0))) / (T(1e-22) + fxb);
    // IDEMIX_gofx2 / IDEMIX_hofx1 (ggl90_idemix.F:549-566)
    const T xg = imax(fxa, T(3));
    const T cg = T(1) - twoOverPi * asin(T(1) / xg);
    const T gofx2 = twoOverPi / cg * T(0.9) * pow(xg, T(q.powExp)) *
                    (T(1) - exp(-xg / T(4.3)));
    const T xh = imax(fxa, T(1.01));
    const T hofx1 = twoOverPi / (T(1) - twoOverPi * asin(T(1) / xh)) *
                    (fxa - T(1)) / (fxa + T(1));
    T v0 = imax(cstarG * hofx1, T(0));
    if (q.cfl >= 0.0) v0 = imin(v0, cap);
    T fxc = imax(fxa, T(1));
    fxc = log(fxc + sqrt(fxc * fxc - T(1)));
    a.c0[p] = imax(cstarG * gofx2, T(0));
    a.v0[p] = v0;
    a.tauD[p] = imax(T(q.mu0) * fxb * fxc / (cstar * cstar), T(1e-4));
  }
}

template <typename T>
__global__ void idemix_hdiff_kernel(const HdiffArgs<T> a, const HdiffParams q,
                                    int nr, int nyp, int nxp) {
  const int i = blockIdx.x * BX + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nxp || j >= nyp) return;
  const size_t P = static_cast<size_t>(nyp) * nxp;
  const size_t q2 = static_cast<size_t>(j) * nxp + i;
  const size_t p = k * P + q2;
  if (k == 0) {
    a.Eout[p] = a.E[p];
    return;
  }
  const T tauH05 = T(q.tauH05), drC = a.drC[k];
  // v0 maskC and v0 E at (j, ii) of this level, 0 outside the array
  auto v0m = [&](int jj, int ii) -> T {
    if (ii < 0 || jj < 0) return T(0);
    const size_t s = k * P + static_cast<size_t>(jj) * nxp + ii;
    return a.v0[s] * a.maskC[s];
  };
  auto v0E = [&](int jj, int ii) -> T {
    if (ii < 0 || jj < 0) return T(0);
    const size_t s = k * P + static_cast<size_t>(jj) * nxp + ii;
    return a.v0[s] * a.E[s];
  };
  // the flux through the west face of cell (j, ii), 0 past the east edge
  auto dfx = [&](int ii) -> T {
    if (ii >= nxp) return T(0);
    const size_t s = k * P + static_cast<size_t>(j) * nxp + ii;
    const size_t s2 = static_cast<size_t>(j) * nxp + ii;
    const T fxaW = tauH05 * (v0m(j, ii - 1) + v0m(j, ii));
    return -fxaW * a.dyG[s2] * drC *
           (imin(a.hFacW[s - P], T(0.5)) + imin(a.hFacW[s], T(0.5))) *
           a.recip_dxC[s2] * (v0E(j, ii) - v0E(j, ii - 1)) * a.maskW[s];
  };
  // the flux through the south face of cell (jj, i), 0 past the north edge
  auto dfy = [&](int jj) -> T {
    if (jj >= nyp) return T(0);
    const size_t s = k * P + static_cast<size_t>(jj) * nxp + i;
    const size_t s2 = static_cast<size_t>(jj) * nxp + i;
    const T fxaS = tauH05 * (v0m(jj - 1, i) + v0m(jj, i));
    return -fxaS * a.dxG[s2] * drC *
           (imin(a.hFacS[s - P], T(0.5)) + imin(a.hFacS[s], T(0.5))) *
           a.recip_dyC[s2] * (v0E(jj, i) - v0E(jj - 1, i)) * a.maskS[s];
  };
  const T fx = dfx(i), fy = dfy(j);
  const T gE = -a.recip_drC[k] * a.recip_rA[q2] *
               recip_hfacI(a.hFacC, p, p - P) *
               ((dfx(i + 1) - fx) + (dfy(j + 1) - fy)) * a.maskC[p];
  a.Eout[p] = a.E[p] + T(q.dt) * gE;
}

template <typename T>
__global__ void idemix_col_kernel(const ColArgs<T> a, const ColParams q,
                                  int nr, int nyp, int nxp) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int plane = nyp * nxp;
  if (col >= plane) return;
  const size_t P = static_cast<size_t>(plane);
  const T dt = T(q.dt);
  const int klow = a.klowC[col];
  const int kB0 = klow - 1 > 0 ? klow - 1 : 0;
  T cp[kIdemixMaxNr], yp[kIdemixMaxNr];

  auto c0 = [&](int k) -> T { return a.c0[k * P + col]; };
  auto mC = [&](int k) -> T { return a.maskC[k * P + col]; };
  auto rhI = [&](int k) -> T {
    const size_t p = k * P + col;
    return recip_hfacI(a.hFacC, p, k > 0 ? p - P : p);
  };
  // delta_k = dt tau_v / drF_k / hFacC (c0_k + c0_k+1) / 2, 0 at the
  // surface, the last level and the bottom level
  auto delta = [&](int k) -> T {
    if (k == 0 || k == nr - 1 || k == kB0) return T(0);
    return T(q.dtTauV) * a.recip_drF[k] * a.recip_hFacC[k * P + col] *
           T(0.5) * (c0(k) + c0(k + 1));
  };

  T cpm1 = T(0), ypm1 = T(0);
  for (int k = 0; k < nr; ++k) {
    const size_t p = k * P + col;
    T ak = T(0), ck = T(0), bk = T(1), yk = a.E[p];
    if (k > 0) {
      const T rdrC = a.recip_drC[k], r = rhI(k);
      const T mkm1 = mC(k - 1);
      if (k > 1) ak = -delta(k - 1) * rdrC * r * mC(k);
      if (k != kB0) ck = -delta(k) * rdrC * r * mkm1;
      bk = T(1) + dt * a.tauD[p] * a.E[p] * mC(k) * mkm1 - (ak + ck) * c0(k);
      ak = ak * c0(k - 1 > 1 ? k - 1 : 1);
      ck = ck * c0(k + 1 < nr - 1 ? k + 1 : nr - 1);
    }
    if (k == 1) yk = yk + dt * a.Fs[col] * a.recip_drC[1] * rhI(1) * mC(1);
    if (k == kB0)
      yk = yk + -dt * a.Fb[col] * a.recip_drC[kB0] * rhI(kB0) * mC(kB0);
    const T den = bk - ak * cpm1;
    const T rec = den != T(0) ? T(1) / den : T(0);
    cpm1 = ck * rec;
    ypm1 = (yk - ak * ypm1) * rec;
    cp[k] = cpm1;
    yp[k] = ypm1;
  }
  T x = yp[nr - 1];
  for (int k = nr - 1; k >= 0; --k) {
    if (k < nr - 1) x = yp[k] - cp[k] * x;
    const size_t p = k * P + col;
    a.Enew[p] = x;
    a.gTKE[p] = k == 0 ? T(0) : a.tauD[p] * x * x;
  }
}

template <typename Args, typename Params>
bool unpack(const void* const* table, int n, const double* params, int np,
            Args* a, Params* q) {
  static_assert(sizeof(Args) % sizeof(void*) == 0,
                "the argument struct must be a plain table of pointers");
  static_assert(sizeof(Params) % sizeof(double) == 0,
                "the parameter struct must be a plain array of doubles");
  if (n != static_cast<int>(sizeof(Args) / sizeof(void*)) ||
      np != static_cast<int>(sizeof(Params) / sizeof(double)))
    return false;
  std::memcpy(a, table, sizeof(*a));
  std::memcpy(q, params, sizeof(*q));
  return true;
}

}  // namespace

template <typename T>
int launch_idemix_prep(const void* const* table, int n, const double* params,
                       int np, int nr, int nyp, int nxp, void* stream) {
  PrepArgs<T> a;
  PrepParams q;
  if (!unpack(table, n, params, np, &a, &q) || nr < 2 || nr > kIdemixMaxNr)
    return (int)cudaErrorInvalidValue;
  const int plane = nyp * nxp, threads = 128;
  idemix_prep_kernel<T><<<(plane + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(a, q, nr, nyp, nxp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_idemix_hdiff(const void* const* table, int n, const double* params,
                        int np, int nr, int nyp, int nxp, void* stream) {
  HdiffArgs<T> a;
  HdiffParams q;
  if (!unpack(table, n, params, np, &a, &q) || nr < 2)
    return (int)cudaErrorInvalidValue;
  const dim3 g((nxp + BX - 1) / BX, (nyp + BY - 1) / BY, nr);
  idemix_hdiff_kernel<T><<<g, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      a, q, nr, nyp, nxp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_idemix_col(const void* const* table, int n, const double* params,
                      int np, int nr, int nyp, int nxp, void* stream) {
  ColArgs<T> a;
  ColParams q;
  if (!unpack(table, n, params, np, &a, &q) || nr < 2 || nr > kIdemixMaxNr)
    return (int)cudaErrorInvalidValue;
  const int plane = nyp * nxp, threads = 128;
  idemix_col_kernel<T><<<(plane + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(a, q, nr, nyp, nxp);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_IDEMIX_ENTRY(NAME, SUF, T)                                    \
  extern "C" int mitgcm_##NAME##_##SUF(const void* const* table, int n,      \
                                       const double* params, int np, int nr, \
                                       int nyp, int nxp, void* stream) {     \
    return mitgcm::launch_##NAME<T>(table, n, params, np, nr, nyp, nxp,      \
                                    stream);                                 \
  }

MITGCM_IDEMIX_ENTRY(idemix_prep, f32, float)
MITGCM_IDEMIX_ENTRY(idemix_prep, f64, double)
MITGCM_IDEMIX_ENTRY(idemix_hdiff, f32, float)
MITGCM_IDEMIX_ENTRY(idemix_hdiff, f64, double)
MITGCM_IDEMIX_ENTRY(idemix_col, f32, float)
MITGCM_IDEMIX_ENTRY(idemix_col, f64, double)
