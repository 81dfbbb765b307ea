// Tensor-core pieces of the ENet tail kernels (tail.cu): the warp-level
// TF32 product mma.sync.m16n8k8 with fp32 accumulation, taken once
// (TF32) or three times over the hi/lo split of both operands (3xTF32,
// about fp32's accuracy), and cp.async copies into shared memory.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4,
// q = lane % 4: A reg 0/1/2/3 = (row g, col q), (g+8, q), (g, q+4),
// (g+8, q+4) of the 16x8 k-step; B reg 0/1 = (k row q, col g),
// (q+4, g); C reg 0/1/2/3 = (g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssal {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (lo carries the next 11 bits of the mantissa).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of a warp's 16 x 8NT tile: acc += A (16x8) @ B (8 x 8NT),
// A given as this lane's four values (rows g, g+8 x cols q, q+4), B the
// k-step's 8 rows of a shared-memory weight [k][ws] from column n0.
// PASSES 1: TF32 products; 3: hi*hi + hi*lo + lo*hi (3xTF32).
template <int NT, int PASSES>
__device__ __forceinline__ void mma_kstep(float (&acc)[NT][4], float a0,
                                          float a1, float a2, float a3,
                                          const float* w, int ws, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint32_t ah[4], al[4];
  if (PASSES == 3) {
    split_tf32(a0, ah[0], al[0]);
    split_tf32(a1, ah[1], al[1]);
    split_tf32(a2, ah[2], al[2]);
    split_tf32(a3, ah[3], al[3]);
  } else {
    ah[0] = to_tf32(a0), ah[1] = to_tf32(a1);
    ah[2] = to_tf32(a2), ah[3] = to_tf32(a3);
  }
  const float* w0 = w + q * ws + n0 + g;
  const float* w1 = w0 + 4 * ws;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (PASSES == 3) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(w0[8 * j], bh0, bl0);
      split_tf32(w1[8 * j], bh1, bl1);
      mma_tf32(acc[j], al, bh0, bh1);
      mma_tf32(acc[j], ah, bl0, bl1);
      mma_tf32(acc[j], ah, bh0, bh1);
    } else {
      mma_tf32(acc[j], ah, to_tf32(w0[8 * j]), to_tf32(w1[8 * j]));
    }
  }
}

// Copy n floats (n % 4 == 0, both pointers 16-byte aligned) from global
// to shared memory with the block's threads, 16 bytes a cp.async.
__device__ __forceinline__ void cp_async_floats(float* dst, const float* src,
                                                int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + i));
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Wait for this thread's copies, then for every thread's.
__device__ __forceinline__ void cp_async_wait_sync() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

}  // namespace ssal
