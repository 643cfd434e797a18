// Shared helpers of the sea ice's kernels (seaice_lsr.cu, seaice_evp.cu,
// seaice_freedrift.cu): zero-filled reads of a padded 2-D field, the four
// HEFFM product at a Z point, the shear strain rate, and the pointer-table
// copy of a launch's argument struct.
#pragma once

#include <cstring>

#include "gad_advect.cuh"

namespace mitgcm {

template <typename T>
struct Fld {   // a [nyp, nxp] field read with the JAX code's zero fill
  const T* f;
  int nyp, nxp;
  __device__ T operator()(int j, int i) const {
    return (i < 0 || i >= nxp || j < 0 || j >= nyp)
               ? T(0) : f[static_cast<size_t>(j) * nxp + i];
  }
};

__device__ __forceinline__ bool in2(int j, int i, int nyp, int nxp) {
  return i >= 0 && i < nxp && j >= 0 && j < nyp;
}

// hm * hm(i-1) * hm(j-1) * hm(j-1, i-1): the Z point's four C cells wet
template <typename T>
__device__ T hm4_at(const Fld<T>& hm, int j, int i) {
  return hm(j, i) * hm(j, i - 1) * hm(j - 1, i) * hm(j - 1, i - 1);
}

// the shear strain rate e12 at Z point (jj, ii) (seaice.py:strainrates on
// the Cartesian grid, free slip), 0 outside the array
template <typename T>
__device__ T e12_at(const Fld<T>& u, const Fld<T>& v, const Fld<T>& hm,
                    const T* recip_dyU, const T* recip_dxV, int jj, int ii) {
  if (!in2(jj, ii, u.nyp, u.nxp)) return T(0);
  const size_t r = static_cast<size_t>(jj) * u.nxp + ii;
  const T dudy = (u(jj, ii) - u(jj - 1, ii)) * recip_dyU[r];
  const T dvdx = (v(jj, ii) - v(jj, ii - 1)) * recip_dxV[r];
  return T(0.5) * (dudy + dvdx) * hm4_at(hm, jj, ii);
}

// the launch's argument struct from a table of n device pointers, if n is
// the struct's count
template <typename T, typename Args, int N>
bool table_of(const void* const* table, int n, Args* a) {
  static_assert(sizeof(Args) == N * sizeof(void*),
                "the argument struct must be a plain table of pointers");
  if (n != N) return false;
  std::memcpy(a, table, sizeof(*a));
  return true;
}

}  // namespace mitgcm
