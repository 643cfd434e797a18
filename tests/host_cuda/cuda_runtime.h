// A mock of the CUDA runtime for checking kernels on the host: the kernel
// sources compile with g++ against it, and host_launch runs a launch's
// blocks one after another on one std::thread per CUDA thread of a block,
// with a std::barrier for __syncthreads. A __shared__ variable becomes a
// static one, shared by the threads of the block that runs. Only what the
// port's kernels use is here.
#pragma once

#include <barrier>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* host_block_barrier = nullptr;

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
inline void __threadfence() {}
inline unsigned int atomicAdd(unsigned int* p, unsigned int v) {
  const unsigned int old = *p;
  *p += v;
  return old;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// Run body() as every thread of every block of a (grid, block) launch: one
// std::thread per thread of a block walks the blocks in order, and all of
// them finish a block before any starts the next (its __shared__ data is
// then the next block's). Every thread of a block must reach the same
// __syncthreads, as on the card.
template <typename Body>
void host_launch(dim3 grid, dim3 block, Body body) {
  gridDim = grid;
  blockDim = block;
  const unsigned nt = block.x * block.y * block.z;
  std::barrier<> bar(nt);
  host_block_barrier = &bar;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (unsigned tz = 0; tz < block.z; ++tz)
    for (unsigned ty = 0; ty < block.y; ++ty)
      for (unsigned tx = 0; tx < block.x; ++tx)
        threads.emplace_back([&body, &bar, grid, tx, ty, tz] {
          threadIdx = dim3(tx, ty, tz);
          for (unsigned bz = 0; bz < grid.z; ++bz)
            for (unsigned by = 0; by < grid.y; ++by)
              for (unsigned bx = 0; bx < grid.x; ++bx) {
                blockIdx = dim3(bx, by, bz);
                body();
                bar.arrive_and_wait();
              }
        });
  for (auto& th : threads) th.join();
}
