// The score kernels' shared pieces: EntropyAcc for ICNet's head kernels
// (icnet_head.cu), block_partial for every score kernel (tail.cu,
// icnet_head.cu) and cmax. block_partial() sums the block's confidences
// in a fixed order (no atomics), so that a score is bit-repeatable from
// run to run.
#pragma once

#include "common.cuh"

namespace ssal {

__host__ __device__ constexpr int cmax(int a, int b) {
  return a > b ? a : b;
}

// A pixel's softmax entropy confidence 1 + (S/Z - log Z)/log C, online
// over its classes: Z = sum e^(l-m), S = sum e^(l-m)(l-m), m the running
// maximum, both sums rescaled when m grows. start() takes the pixel's
// first logit, add() each later one; conf() takes 1/log C. Each add()
// takes one exp, __expf (ex2.approx: a few ulp, flushed below 2^-126,
// where a term is lost against Z >= 1), before its branch: e^-|d| is the
// new term's weight when the maximum stays and the old sums' when it
// grows.
struct EntropyAcc {
  float m, z, s;
  __device__ __forceinline__ void start(float logit) {
    m = logit, z = 1.f, s = 0.f;
  }
  __device__ __forceinline__ void add(float logit) {
    const float d = logit - m;
    const float e = __expf(-fabsf(d));
    if (d > 0.f) {
      s = e * (s - d * z);
      z = e * z + 1.f;
      m = logit;
    } else {
      z += e;
      s += e * d;
    }
  }
  __device__ __forceinline__ float conf(float inv_log_c) const {
    return 1.f + (s / z - logf(z)) * inv_log_c;
  }
};

// *out = the sum of every thread's v, in thread order. slots holds
// blockDim.x floats that no thread reads any more.
__device__ __forceinline__ void block_partial(float v, float* slots,
                                              float* out) {
  slots[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int i = 0; i < blockDim.x; ++i) sum += slots[i];
    *out = sum;
  }
}

}  // namespace ssal
