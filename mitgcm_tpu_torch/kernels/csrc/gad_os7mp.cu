// Kernel O: direction-split multi-dimensional advection of one tracer with
// OS7MP, the one-step seventh-order monotonicity-preserving scheme 7.
//
// Replaces: mitgcm_tpu/model/gad.py:os7mp_psi (:103-178), os7mp_flux_x/y
// (:181-204) with os7mp_band (:207-218), and _os7mp_flux_r (:221-266),
// inside multidim_advection's X, Y and R passes (:1120-1154), which XLA
// fused into one pass per direction over the padded [nr, nyp, nxp] arrays
// on the TPU.
//
// Three launches per tracer, one per sweep (gad_advect.cuh:adv_sweep), each
// one thread per cell of the whole padded array: gad_os7mp_x, _y and _r.
//
// Bound: bytes. Per sweep a cell reads its input field, the tracer, one
// transport and one velocity, recip_hFacC, the face mask and its column
// factors and writes one field (~7-8 fields, ~30 B/cell in float32); the
// 8-point stencil of each face (i-4 .. i+3) hits L1/L2. About 90 flops and
// three divisions per face.
// Design: each thread computes the fluxes of its two faces itself, in the
// JAX code's operation order. JAX computes the flux of both upwind
// directions and selects by the sign of the transport; the kernel computes
// only the selected one, which has the same bits. The write band (x
// columns / y rows [4, n - 3)) multiplies the flux as the JAX code does.
// Neighbours outside the padded array read 0 (the zero-filled shifts), and
// the vertical levels clamp at the column ends with the mask factors
// float(k_hi - k_lo) of the clamped indices. The discrete choices
// (sign(d) / max(|d|, Eps) with 1 / Eps where d == 0, the median and the
// PhiMin / PhiMax clips) are the twin's (model/gad_ho.py:os7mp_psi), and
// built with --fmad=false the result is bit-equal to it.

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

// the horizontal flux at the west (DIR 0) or south (DIR 1) face of
// (k, j, i) (gad.py:os7mp_flux_x/y): 0 outside the array and off the band
template <typename T, int DIR>
struct Os7mpFluxH {
  __device__ T operator()(const AdvCell<T>& c, int k, int j, int i) const {
    const int n = DIR == 0 ? c.nxp : c.nyp;
    const int pos = DIR == 0 ? i : j;
    if (pos >= n) return T(0);
    const size_t p = c.i3(k, j, i);
    const size_t q2 = c.i2(j, i);
    const T trans = DIR == 0 ? c.a.uTrans[p] : c.a.vTrans[p];
    const T vel = DIR == 0 ? c.a.uVel[p] : c.a.vVel[p];
    const T rdC = DIR == 0 ? c.a.recip_dxC[q2] : c.a.recip_dyC[q2];
    const T cfl = fabs(vel * c.deltaT * rdC);
    auto Q = [&](int d) {
      return DIR == 0 ? c.s(k, j, i + d) : c.s(k, j + d, i);
    };
    auto M = [&](int d) {
      return DIR == 0 ? c.mW(k, j, i + d) : c.mS(k, j + d, i);
    };
    T f;
    if (trans > T(0)) {
      const T q[7] = {Q(2), Q(1), Q(0), Q(-1), Q(-2), Q(-3), Q(-4)};
      const T m[6] = {M(2), M(1), M(0), M(-1), M(-2), M(-3)};
      f = os7mp_psi(trans, cfl, q, m);
    } else if (trans < T(0)) {
      const T q[7] = {Q(-3), Q(-2), Q(-1), Q(0), Q(1), Q(2), Q(3)};
      const T m[6] = {M(-2), M(-1), M(0), M(1), M(2), M(3)};
      f = os7mp_psi(trans, cfl, q, m);
    } else {
      f = T(0);
    }
    const T band = (pos >= 4 && pos < n - 3) ? T(1) : T(0);
    return f * band;
  }
};

// the vertical flux at interface k (gad.py:_os7mp_flux_r), 0 at the surface
// and below the bottom
template <typename T>
struct Os7mpFluxR {
  __device__ T operator()(const AdvCell<T>& c, int k, int j, int i) const {
    if (k == 0 || k >= c.nr) return T(0);
    const int nr = c.nr;
    const size_t p = c.i3(k, j, i);
    const T rT = c.a.rTrans[p];
    const T cflK = fabs(c.a.wVel[p] * c.deltaT * c.a.recip_drC[k]);
    auto lev = [&](int off) {
      const int l = k + off;
      return l < 0 ? 0 : (l > nr - 1 ? nr - 1 : l);
    };
    auto Q = [&](int off) { return c.src[c.i3(lev(off), j, i)]; };
    // maskC at the clamped level of off times float(k_off - k_lo)
    auto M = [&](int off, int lo) {
      return c.a.maskC[c.i3(lev(off), j, i)] * T(lev(off) - lev(lo));
    };
    if (rT > T(0)) {
      // upwind from below, Qi = Q(k)
      const T q[7] = {Q(-3), Q(-2), Q(-1), Q(0), Q(1), Q(2), Q(3)};
      const T m[6] = {M(-2, -3), M(-1, -2), M(0, -1),
                      M(1, 0),   M(2, 1),   M(3, 2)};
      return os7mp_psi(rT, cflK, q, m);
    }
    if (rT < T(0)) {
      // upwind from above, Qi = Q(k-1)
      const T q[7] = {Q(2), Q(1), Q(0), Q(-1), Q(-2), Q(-3), Q(-4)};
      const T m[6] = {M(2, 1),   M(1, 0),   M(0, -1),
                      M(-1, -2), M(-2, -3), M(-3, -4)};
      return os7mp_psi(rT, cflK, q, m);
    }
    return T(0);
  }
};

template <typename T, int DIR>
int launch_os7mp(const void* const* table, int n, const void* src, void* dst,
                 int nr, int nyp, int nxp, int scheme, double deltaT,
                 double rkSign, void* stream) {
  AdvArgs<T> a;
  if (!adv_args(table, n, &a) || scheme != 7)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (DIR == 2)
    launch_sweep<T, 2>(a, Os7mpFluxR<T>{}, src, dst, nr, nyp, nxp, deltaT,
                       rkSign, st);
  else
    launch_sweep<T, DIR>(a, Os7mpFluxH<T, DIR>{}, src, dst, nr, nyp, nxp,
                         deltaT, rkSign, st);
  return (int)cudaGetLastError();
}

}  // namespace mitgcm

#define MITGCM_O_ENTRY(NAME, DIR, SUF, T)                                      \
  extern "C" int mitgcm_gad_os7mp_##NAME##_##SUF(                              \
      const void* const* table, int n, const void* src, void* dst, int nr,   \
      int nyp, int nxp, int scheme, double deltaT, double rkSign,             \
      void* stream) {                                                          \
    return mitgcm::launch_os7mp<T, DIR>(table, n, src, dst, nr, nyp, nxp,     \
                                        scheme, deltaT, rkSign, stream);      \
  }

MITGCM_O_ENTRY(x, 0, f32, float)
MITGCM_O_ENTRY(x, 0, f64, double)
MITGCM_O_ENTRY(y, 1, f32, float)
MITGCM_O_ENTRY(y, 1, f64, double)
MITGCM_O_ENTRY(r, 2, f32, float)
MITGCM_O_ENTRY(r, 2, f64, double)
