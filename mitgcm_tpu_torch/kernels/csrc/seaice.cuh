// Shared helpers of the sea ice's kernels (seaice_lsr.cu, seaice_evp.cu,
// seaice_freedrift.cu): zero-filled reads of a padded 2-D field, the four
// HEFFM product at a Z point, and the pointer-table copy of a launch's
// argument struct.
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
