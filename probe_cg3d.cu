// Timing probe of kernel H-cg3d's two passes at the nh-convection box's
// 1024 x 1024 x 50 float32, on one NVIDIA GPU, and of a plain column walk
// with the same access pattern: how near the pattern lets a pass come to
// its bytes' bound, and what pass B's levels in flight and staging buy.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -I mitgcm_tpu_torch/kernels/csrc -o probe_cg3d probe_cg3d.cu
//   ./probe_cg3d
//
// Each line is a launch's device ms (the median of 5 runs of 20 launches
// between two CUDA events) with the share of its bound: the bytes of the
// fields it reads (interior) and writes (padded) over 3.35 TB/s. The
// fields hold arbitrary values; the times do not depend on them.
#include <algorithm>
#include <cstdio>
#include <vector>

#include "cg3d_tile.cuh"
using namespace mitgcm;

constexpr int NX = 1024, NY = 1024, NR = 50, OL = 2;
constexpr int NXP = NX + 2 * OL, NYP = NY + 2 * OL;
constexpr size_t N = static_cast<size_t>(NR) * NYP * NXP;

__global__ void fill(float* a, float v, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x)
    a[i] = v + 1e-3f * static_cast<float>(i % 97);
}

struct Fields {
  const float* in[8];
  float* out[3];
};

// A column walk of one thread a column over 32 x 8 blocks that reads NIN
// fields and writes NOUT a level, with G levels of loads in flight.
template <int NIN, int NOUT, int G>
__global__ void __launch_bounds__(NT) column_walk(Fields fl, float* sink) {
  const int i0 = blockIdx.x * BX + threadIdx.x;
  const int j0 = blockIdx.y * BY + threadIdx.y;
  if (i0 >= NX || j0 >= NY) return;
  const size_t plane = static_cast<size_t>(NYP) * NXP;
  const size_t p0 = static_cast<size_t>(j0 + OL) * NXP + i0 + OL;
  float cur[G][NIN], nxt[G][NIN];
  float acc = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int f = 0; f < NIN; ++f) cur[g][f] = fl.in[f][p0 + g * plane];
  for (int kb = 0; kb < NR; kb += G) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int f = 0; f < NIN; ++f)
        nxt[g][f] =
            kb + G + g < NR ? fl.in[f][p0 + (kb + G + g) * plane] : 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (kb + g >= NR) break;
      float v = 0.f;
#pragma unroll
      for (int f = 0; f < NIN; ++f) v += cur[g][f];
      acc += v;
#pragma unroll
      for (int o = 0; o < NOUT; ++o) fl.out[o][p0 + (kb + g) * plane] = v;
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int f = 0; f < NIN; ++f) cur[g][f] = nxt[g][f];
  }
  if (acc == 12345.f) *sink = acc;
}

template <typename F>
float launch_ms(F launch) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch();
  std::vector<float> ts;
  for (int r = 0; r < 5; ++r) {
    cudaEventRecord(a);
    for (int i = 0; i < 20; ++i) launch();
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    ts.push_back(ms / 20);
  }
  std::sort(ts.begin(), ts.end());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) printf("CUDA error: %s\n", cudaGetErrorString(err));
  return ts[ts.size() / 2];
}

int main() {
  std::vector<float*> f(15);
  for (int i = 0; i < 15; ++i) {
    cudaMalloc(&f[i], N * sizeof(float));
    fill<<<4096, 256>>>(f[i], 0.5f + 0.01f * i, N);
  }
  fill<<<4096, 256>>>(f[4], 1.0f, N);   // maskC
  float *scal, *partials, *pair, *sink;
  int* ctrl;
  unsigned* counter;
  cudaMalloc(&scal, 8 * sizeof(float));
  cudaMalloc(&partials, 2 * 4096 * sizeof(float));
  cudaMalloc(&pair, 2 * sizeof(float));
  cudaMalloc(&sink, sizeof(float));
  cudaMalloc(&ctrl, 2 * sizeof(int));
  cudaMalloc(&counter, sizeof(unsigned));
  cudaMemset(ctrl, 0, 2 * sizeof(int));   // never done: a tolerance of 0
  cudaMemset(counter, 0, sizeof(unsigned));
  std::vector<float> ones(8, 1.0f);
  ones[5] = 0.0f;
  cudaMemcpy(scal, ones.data(), 8 * sizeof(float), cudaMemcpyHostToDevice);
  const double field = 4.0 * NR * NY * NX, padded = 4.0 * N;
  const double boundA = (7 * field + 2 * padded) / 3.35e12 * 1e3;
  const double boundB = (8 * field + 3 * padded) / 3.35e12 * 1e3;
  const dim3 grid = grid2d(NY, NX), block(BX, BY);
  auto report = [](const char* name, float ms, double bound, auto kernel,
                   size_t smem) {
    cudaFuncAttributes at;
    cudaFuncGetAttributes(&at, kernel);
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NT, smem);
    printf("%-40s %.4f ms, %.2f of %.4f; %d registers, %d blocks an SM\n",
           name, ms, bound / ms, bound, at.numRegs, blocks);
  };
  // pass A
  auto passA = cg3d_s_stencil_dot_kernel<float>;
  report("pass A", launch_ms([&] {
           passA<<<grid, block>>>(f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                                  f[7], f[8], scal, scal + 1, scal + 2,
                                  partials, counter, ctrl, NR, NY, NX, OL,
                                  OL);
         }), boundA, passA, 0);
  // pass B: staged (2) or through q and r (0), levels in flight down / up
  auto passB = [&](const char* name, auto kernel, size_t smem) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    report(name, launch_ms([&] {
             kernel<<<grid, block, smem>>>(
                 f[9], f[10], f[7], f[8], f[4], f[11], f[12], f[13], f[14],
                 scal, scal + 1, scal + 3, scal + 4, partials, counter, pair,
                 ctrl, scal + 5, NR, NY, NX, OL, OL, 1 << 30, 1);
           }), boundB, kernel, smem);
  };
  const size_t staged = 2 * static_cast<size_t>(NR) * NT * sizeof(float);
  passB("pass B staged, 1 / 1 levels",
        cg3d_xr_precond_kernel<float, true, 1, 1>, staged);
  passB("pass B staged, 4 / 8 levels",
        cg3d_xr_precond_kernel<float, true, 4, 8>, staged);
  passB("pass B staged, 8 / 8 levels",
        cg3d_xr_precond_kernel<float, true, 8, 8>, staged);
  passB("pass B staged, 8 / 16 levels (the port's)",
        cg3d_xr_precond_kernel<float, true, 8, 16>, staged);
  passB("pass B through q and r, 8 / 16 levels",
        cg3d_xr_precond_kernel<float, false, 8, 16>, 0);
  // the plain column walk
  Fields fl{{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7]},
            {f[9], f[10], f[11]}};
  auto walk = [&](const char* name, auto kernel, double bound) {
    report(name, launch_ms([&] { kernel<<<grid, block>>>(fl, sink); }),
           bound, kernel, 0);
  };
  walk("walk 8 in, 3 out, 1 level", column_walk<8, 3, 1>, boundB);
  walk("walk 8 in, 3 out, 2 levels", column_walk<8, 3, 2>, boundB);
  walk("walk 8 in, 3 out, 4 levels", column_walk<8, 3, 4>, boundB);
  walk("walk 7 in, 2 out, 2 levels", column_walk<7, 2, 2>, boundA);
  return 0;
}
