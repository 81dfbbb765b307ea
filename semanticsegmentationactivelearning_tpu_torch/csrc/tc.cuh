// Tensor-core pieces of the ENet front, mid and tail kernels and ICNet's
// front and CFF2 + head kernels (front.cu, mid.cu, tail.cu,
// icnet_front.cu, icnet_head.cu): the
// warp-level TF32 product mma.sync.m16n8k8 with fp32 accumulation, taken
// once (TF32) or three times over the hi/lo split of both operands
// (3xTF32, about fp32's accuracy), cp.async copies into shared memory,
// the GEMM record of a layer's weights, the warp GEMM over records and
// an expand's 16-byte epilogue.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4,
// q = lane % 4: A reg 0/1/2/3 = (row g, col q), (g+8, q), (g, q+4),
// (g+8, q+4) of the 16x8 k-step; B reg 0/1 = (k row q, col g),
// (q+4, g); C reg 0/1/2/3 = (g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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

// One k-step of a warp's 16MT x 8NT tile: acc[m][j] += A_m (16x8) @ B_j
// (8 x 8) for the first `rows` of MT row tiles m and the first `cols` of
// NT column tiles j (both warp-uniform), A_m given as this lane's four
// values a[m] (rows g, g+8 x cols q, q+4), B the k-step's 8 rows of a
// weight [k][ws] from column n0, each B fragment read (and split) once
// for all row tiles. PASSES 1: TF32 products; 2: A in TF32 by the hi/lo
// split of B, hi*lo + hi*hi (the weights' rounding, the same at every
// position, cancels; A's varies by position); 3: hi*hi + hi*lo + lo*hi
// (3xTF32).
template <int MT, int NT, int PASSES>
__device__ __forceinline__ void mma_kstep_rows(float (&acc)[MT][NT][4],
                                               const float (&a)[MT][4],
                                               const float* w, int ws,
                                               int n0, int rows = MT,
                                               int cols = NT) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint32_t ah[MT][4], al[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m >= rows) break;
      if (PASSES == 3)
        split_tf32(a[m][i], ah[m][i], al[m][i]);
      else
        ah[m][i] = to_tf32(a[m][i]);
    }
  const float* w0 = w + q * ws + n0 + g;
  const float* w1 = w0 + 4 * ws;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= cols) break;
    if (PASSES >= 2) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(w0[8 * j], bh0, bl0);
      split_tf32(w1[8 * j], bh1, bl1);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= rows) break;
        if (PASSES == 3) mma_tf32(acc[m][j], al[m], bh0, bh1);
        mma_tf32(acc[m][j], ah[m], bl0, bl1);
        mma_tf32(acc[m][j], ah[m], bh0, bh1);
      }
    } else {
      const uint32_t b0 = to_tf32(w0[8 * j]), b1 = to_tf32(w1[8 * j]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= rows) break;
        mma_tf32(acc[m][j], ah[m], b0, b1);
      }
    }
  }
}

// mma_kstep_rows for one row tile, its A values a0..a3.
template <int NT, int PASSES>
__device__ __forceinline__ void mma_kstep(float (&acc)[NT][4], float a0,
                                          float a1, float a2, float a3,
                                          const float* w, int ws, int n0) {
  const float a[1][4] = {{a0, a1, a2, a3}};
  mma_kstep_rows<1, NT, PASSES>(
      *reinterpret_cast<float(*)[1][NT][4]>(&acc), a, w, ws, n0);
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

// Copy one float from global to shared memory, or write 0 there when
// !valid (a source size of 0 bytes); src must be a valid address.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// Wait for this thread's copies, then for every thread's.
__device__ __forceinline__ void cp_async_wait_sync() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Close this thread's group of the copies issued since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are pending, then for
// every thread.
template <int N>
__device__ __forceinline__ void cp_async_wait_group_sync() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  __syncthreads();
}

// A layer's GEMM record in a pack (the packers in ops/kernels build the
// same): the weight [taps][k][s] (k rows padded with zeros, columns
// padded to n, then to the stride s), then nv vectors of n floats.
struct Layer {
  int off, taps, k, n, s, nv;
  __host__ __device__ int wsize() const { return taps * k * s; }
  __host__ __device__ int size() const { return wsize() + nv * n; }
};

// The smallest s >= n (n % 8 == 0) with s % 32 in {8, 24}: the B
// fragment's reads (k row q, column g) then hit 32 different banks.
inline int bstride(int n) {
  int s = n;
  while (s % 32 != 8 && s % 32 != 24) s += 8;
  return s;
}

// -- the warp GEMM ---------------------------------------------------------

// For the items first, first+1, ... of a layer (each 16 rows of its M
// positions x 8NT of its N columns) that fall to this warp when items
// are dealt round-robin to the block's warps, continuing from `first`:
// acc = sum over taps t and k of A[p][t][k] * w[t][k][n], where
// src(p, t) points at row p's K values for tap t (p >= M: a zero row),
// then out(p, n, acc[p][n], acc[p][n+1]) for p < M, n even. Returns
// the number of items. VEC4 (K % 16 == 0, rows 16-byte aligned): a lane
// reads 4 consecutive values of a row at once, A[k + 4q .. k + 4q + 3]
// of each 16 (for rows in device memory); the first two feed k-step
// k/8's columns q and q+4, the last two k-step k/8 + 1's, so the record
// holds its rows in that order (ops/kernels/packing.py vec4_order).
template <int NT, int PASSES, int K, bool VEC4 = false, class Src,
          class Out>
__device__ __forceinline__ int gemm(int first, int M, int N, int taps,
                                    const float* w, int ws, Src src,
                                    Out out) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int ng = N / (8 * NT);
  const int items = (M + 15) / 16 * ng;
  int it = warp - first % nw;
  if (it < 0) it += nw;
  for (; it < items; it += nw) {
    const int p0 = it / ng * 16, n0 = it % ng * 8 * NT;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int t = 0; t < taps; ++t) {
      const float* r0 = src(p0 + g, t);
      const float* r1 = src(p0 + g + 8, t);
      const float* wt = w + t * K * ws;
      if (VEC4) {
#pragma unroll
        for (int k = 0; k < K; k += 16) {
          const float4 u = *reinterpret_cast<const float4*>(r0 + k + 4 * q);
          const float4 v = *reinterpret_cast<const float4*>(r1 + k + 4 * q);
          mma_kstep<NT, PASSES>(acc, u.x, v.x, u.y, v.y, wt + k * ws, ws, n0);
          mma_kstep<NT, PASSES>(acc, u.z, v.z, u.w, v.w, wt + (k + 8) * ws,
                                ws, n0);
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; k += 8)
          mma_kstep<NT, PASSES>(acc, r0[k + q], r1[k + q], r0[k + q + 4],
                                r1[k + q + 4], wt + k * ws, ws, n0);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + g + 8 * h;
        if (p < M)
          out(p, n0 + 8 * j + 2 * q, acc[j][2 * h], acc[j][2 * h + 1]);
      }
  }
  return items;
}

// A layer's weight, bias and second vector in shared memory at W.
struct Smem {
  const float *w, *b, *v;
  int ws;
};
__device__ __forceinline__ Smem smem_layer(const float* W, const Layer& L) {
  return {W, W + L.wsize(), W + L.wsize() + L.n, L.s};
}

// Stage `L` of the pack into W (after every thread is done with W).
__device__ __forceinline__ Smem stage_layer(float* W, const float* pack,
                                            const Layer& L) {
  __syncthreads();
  cp_async_floats(W, pack + L.off, L.size());
  cp_async_wait_sync();
  return smem_layer(W, L);
}

// An expand's epilogue over columns 8j .. 8j+7 of a warp's 16-row
// accumulators c (C fragment: rows g, g+8 x columns 2q, 2q+1). After a
// shuffle with the lane beside it an even lane holds row g's columns
// 4(q / 2) .. +3 of the eight and an odd lane row g+8's, so that a lane
// loads its residual and stores its output 16 bytes at a time. Returns
// them + the bias E.b[ch ..] + res through the PReLU of alpha E.v[ch ..],
// ch the first one's channel. Every lane of the warp calls it.
__device__ __forceinline__ float4 expand_epilogue(const float (&c)[4],
                                                  const Smem& E, int ch,
                                                  float4 res) {
  const bool odd = threadIdx.x & 1;
  // an even lane keeps row g and takes its odd partner's row-g pair; the
  // odd lane keeps row g+8 and takes the even one's
  const float s0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
  const float s1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
  float4 v = odd ? make_float4(s0, s1, c[2], c[3])
                 : make_float4(c[0], c[1], s0, s1);
  v.x = prelu(v.x + E.b[ch] + res.x, E.v[ch]);
  v.y = prelu(v.y + E.b[ch + 1] + res.y, E.v[ch + 1]);
  v.z = prelu(v.z + E.b[ch + 2] + res.z, E.v[ch + 2]);
  v.w = prelu(v.w + E.b[ch + 3] + res.w, E.v[ch + 3]);
  return v;
}

}  // namespace ssal
