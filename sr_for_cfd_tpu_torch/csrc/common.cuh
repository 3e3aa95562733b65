// Shared helpers of the kernels in this directory.
#pragma once

#include <cuda_runtime.h>

#define SRCFD_THREADS 256  // threads per block of every kernel here
#define SRCFD_TX 32        // 2-D blocks: 32 threads along the contiguous axis
#define SRCFD_TY 8         //             8 along the strided one

// Fixed-order sum over the block's SRCFD_THREADS threads: a tree in shared
// memory, so the same inputs give the same bits on every run (the exit
// decisions of the solver loops are taken on these sums). Every thread of
// the block must call it; every thread gets the total.
__device__ __forceinline__ float srcfd_block_sum(float v, float* sh) {
  const int t = threadIdx.x + threadIdx.y * blockDim.x;
  sh[t] = v;
  __syncthreads();
  for (int s = SRCFD_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  const float total = sh[0];
  __syncthreads();  // sh may be written again right after the return
  return total;
}

// Fixed-order sum of x[0..n) by one 1-D block of SRCFD_THREADS threads:
// thread t adds x[t], x[t + SRCFD_THREADS], ... in turn, then
// srcfd_block_sum. The partials of a kernel's blocks are summed with it.
__device__ __forceinline__ float srcfd_fixed_sum(const float* x, int n, float* sh) {
  float acc = 0.0f;
  for (int k = threadIdx.x; k < n; k += SRCFD_THREADS) acc += x[k];
  return srcfd_block_sum(acc, sh);
}

// NS fixed-order sums of one value per thread at once: for each, the tree
// of srcfd_block_sum, so each total has its bits. sh holds NS *
// SRCFD_THREADS floats; every thread of the block must call it.
template <int NS>
__device__ __forceinline__ void srcfd_block_sums(float (&v)[NS], float* sh) {
  const int t = threadIdx.x + threadIdx.y * blockDim.x;
#pragma unroll
  for (int s = 0; s < NS; ++s) sh[s * SRCFD_THREADS + t] = v[s];
  __syncthreads();
  for (int w = SRCFD_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        sh[s * SRCFD_THREADS + t] += sh[s * SRCFD_THREADS + t + w];
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) v[s] = sh[s * SRCFD_THREADS];
  __syncthreads();
}

// 4-byte asynchronous copy global -> shared; `in` false zero-fills (no
// byte is read, src only has to be a valid address)
__device__ __forceinline__ void srcfd_cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

// 8-byte asynchronous copy global -> shared (both 8-byte aligned); `in`
// false zero-fills
__device__ __forceinline__ void srcfd_cp_async8(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 8 : 0));
}

// wait until at most N committed groups of this thread are still pending
template <int N>
__device__ __forceinline__ void srcfd_cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void srcfd_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void srcfd_cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Launch grid of SRCFD_TX x SRCFD_TY blocks covering a (rows, cols) array,
// cols contiguous.
static inline dim3 srcfd_grid(int rows, int cols) {
  return dim3((cols + SRCFD_TX - 1) / SRCFD_TX, (rows + SRCFD_TY - 1) / SRCFD_TY);
}
