// Kernel M: direction-split multi-dimensional advection of one tracer with
// the schemes 1 (upwind), 20 (DST-2, Lax-Wendroff), 30 (DST-3), 33 (DST-3
// flux-limited) and 77 (the Superbee flux limiter), and the vertical
// schemes 1, 2 (centred), 3 (upwind-3rd), 4 (centred 4th), 20, 30, 33 and 77.
//
// Replaces: mitgcm_tpu/model/gad.py:multidim_advection (:1120-1154,
// Cartesian branch) with the fluxes of adv_flux_x / adv_flux_y (:839-908),
// _adv_flux_highorder (:783-836), _limiter (:85) and adv_flux_r
// (:911-1022), which XLA fused into one pass per direction over the padded
// [nr, nyp, nxp] arrays on the TPU.
//
// Three launches per tracer, one per sweep (gad_advect.cuh:adv_sweep), each
// one thread per cell of the whole padded array: gad_multidim_x, _y and _r.
// The kernel is a template on the direction and the scheme, so each
// scheme's code is compiled alone (no registers for the branches it does
// not take).
//
// Bound: bytes. Per sweep a cell reads its input field, the tracer, one
// transport and one velocity, recip_hFacC and a face mask (~7 fields,
// masks counted) and writes one, ~28-32 B/cell in float32 for ~80 flops;
// the neighbours of the stencil (i-2 .. i+2) hit L1/L2.
// Design: each thread computes both face fluxes of its cell itself, in the
// JAX code's operation order: sharing a flux between threads would need a
// second pass or shared memory, and the plain twin computes every flux
// once per face, so recomputing it gives the same bits. Like the JAX code
// (ops/stencil.py: zero-filled shifts), every cell of the padded array is
// computed and a neighbour outside the array reads 0, a face flux outside
// it is 0; so the Y sweep reads in the halo rows exactly the values of the
// X sweep that the JAX code reads there. The vertical neighbours are
// clamped at the column ends (km1 = max(1, k-1) ...), and the surface flux
// is 0. Built with --fmad=false the result is bit-equal to the plain twin
// (model/gad.py:_multidim_plain); the discrete choices (the limiter's
// clips, DST3-FL's overflow guard |Rj| 1e20 <= |R| and its sign, the clip
// of psi to [0, 1], C4's wall factor) are the twin's.

#include "gad_advect.cuh"

namespace mitgcm {

// the zonal flux at the west face of (k, j, i) (gad.py:adv_flux_x); 0 for a
// face outside the array
template <typename T, int S>
struct FluxX {
  __device__ T operator()(const AdvCell<T>& c, int k, int j, int i) const {
    if (i >= c.nxp) return T(0);
    const size_t p = c.i3(k, j, i);
    const T t = c.s(k, j, i), tm1 = c.s(k, j, i - 1);
    const T vdt = c.a.uVel[p] * c.deltaT * c.a.recip_dxC[c.i2(j, i)];
    if (S == kUpwind1 || S == kDst2)
      return flux_h<T, S>(c.a.uTrans[p], vdt, t, tm1, T(0), T(0), T(0));
    const T Rjp = (c.s(k, j, i + 1) - t) * c.mW(k, j, i + 1);
    const T Rj = (t - tm1) * c.mW(k, j, i);
    const T Rjm = (tm1 - c.s(k, j, i - 2)) * c.mW(k, j, i - 1);
    return flux_h<T, S>(c.a.uTrans[p], vdt, t, tm1, Rjp, Rj, Rjm);
  }
};

// the meridional flux at the south face (gad.py:adv_flux_y)
template <typename T, int S>
struct FluxY {
  __device__ T operator()(const AdvCell<T>& c, int k, int j, int i) const {
    if (j >= c.nyp) return T(0);
    const size_t p = c.i3(k, j, i);
    const T t = c.s(k, j, i), tm1 = c.s(k, j - 1, i);
    const T vdt = c.a.vVel[p] * c.deltaT * c.a.recip_dyC[c.i2(j, i)];
    if (S == kUpwind1 || S == kDst2)
      return flux_h<T, S>(c.a.vTrans[p], vdt, t, tm1, T(0), T(0), T(0));
    const T Rjp = (c.s(k, j + 1, i) - t) * c.mS(k, j + 1, i);
    const T Rj = (t - tm1) * c.mS(k, j, i);
    const T Rjm = (tm1 - c.s(k, j - 2, i)) * c.mS(k, j - 1, i);
    return flux_h<T, S>(c.a.vTrans[p], vdt, t, tm1, Rjp, Rj, Rjm);
  }
};

// the vertical flux at interface k, the top of cell k (gad.py:adv_flux_r):
// 0 at the surface and below the bottom; neighbours clamped to the column
template <typename T, int S>
struct FluxR {
  __device__ T operator()(const AdvCell<T>& c, int k, int j, int i) const {
    if (k == 0 || k >= c.nr) return T(0);
    const int nr = c.nr, km1 = k - 1, km2 = k > 1 ? k - 2 : 0;
    const int kp1 = k + 1 < nr ? k + 1 : nr - 1;
    const T* src = c.src;
    const T* maskC = c.a.maskC;
    const size_t p = c.i3(k, j, i);
    const T t = src[p], tkm1 = src[c.i3(km1, j, i)];
    const T mkm1 = maskC[c.i3(km1, j, i)];
    const T rT = c.a.rTrans[p], absT = fabs(rT);
    if (S == kCentered2) return mkm1 * rT * T(0.5) * (t + tkm1);
    const T wdt = c.a.wVel[p] * c.deltaT * c.a.recip_drC[k];
    if (S == kUpwind1 || S == kDst2) {
      // gad_dst2u1_adv_r.F: rkSign flips the upwind direction in r
      const T limit = S == kUpwind1 ? T(1) : fabs(wdt);
      return mkm1 * T(0.5) * (rT * (t + tkm1) + absT * limit * (t - tkm1));
    }
    const T tkm2 = src[c.i3(km2, j, i)], tkp1 = src[c.i3(kp1, j, i)];
    const T mkm2 = maskC[c.i3(km2, j, i)], mkp1 = maskC[c.i3(kp1, j, i)];
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
    const T mC = maskC[p];
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
};

template <typename T, int DIR, int S>
void launch_md(const AdvArgs<T>& a, const void* src, void* dst, int nr,
               int nyp, int nxp, double deltaT, double rkSign,
               cudaStream_t stream) {
  if (DIR == 0)
    launch_sweep<T, 0>(a, FluxX<T, S>{}, src, dst, nr, nyp, nxp, deltaT,
                       rkSign, stream);
  else if (DIR == 1)
    launch_sweep<T, 1>(a, FluxY<T, S>{}, src, dst, nr, nyp, nxp, deltaT,
                       rkSign, stream);
  else
    launch_sweep<T, 2>(a, FluxR<T, S>{}, src, dst, nr, nyp, nxp, deltaT,
                       rkSign, stream);
}

// the schemes M owns: 1, 20, 30, 33, 77 in X and Y, and 2, 3, 4 besides in R
template <typename T, int DIR>
int launch_multidim(const void* const* table, int n, const void* src,
                    void* dst, int nr, int nyp, int nxp, int scheme,
                    double deltaT, double rkSign, void* stream) {
  AdvArgs<T> a;
  if (!adv_args(table, n, &a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define MITGCM_MD_CASE(S)                                              \
  case S:                                                              \
    launch_md<T, DIR, S>(a, src, dst, nr, nyp, nxp, deltaT, rkSign, st); \
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

#define MITGCM_MD_ENTRY(NAME, DIR, SUF, T)                                     \
  extern "C" int mitgcm_gad_multidim_##NAME##_##SUF(                           \
      const void* const* table, int n, const void* src, void* dst, int nr,   \
      int nyp, int nxp, int scheme, double deltaT, double rkSign,             \
      void* stream) {                                                          \
    return mitgcm::launch_multidim<T, DIR>(table, n, src, dst, nr, nyp, nxp,  \
                                           scheme, deltaT, rkSign, stream);   \
  }

MITGCM_MD_ENTRY(x, 0, f32, float)
MITGCM_MD_ENTRY(x, 0, f64, double)
MITGCM_MD_ENTRY(y, 1, f32, float)
MITGCM_MD_ENTRY(y, 1, f64, double)
MITGCM_MD_ENTRY(r, 2, f32, float)
MITGCM_MD_ENTRY(r, 2, f64, double)
