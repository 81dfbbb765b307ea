// The ENet decoder's last device functions and the score's reduction:
// final_stage() for the deconv score kernel (decoder.cu) with its
// EntropyAccExact, EntropyAcc for ICNet's head kernels (icnet_head.cu),
// block_partial for every score kernel (decoder.cu, tail.cu,
// icnet_head.cu).
//
// final_stage() runs the Final 3x3/s2 transposed conv for a tile's
// SIDE x SIDE half-res positions (2SIDE x 2SIDE pixels) and ends each
// pixel either in a first-max argmax or in its entropy confidence
// 1 - H(softmax)/log C, online over the classes. block_partial() sums
// the block's confidences in a fixed order (no atomics), so that a
// score is bit-repeatable from run to run.
#pragma once

#include "common.cuh"

namespace ssal {

constexpr int SIDE = 16;         // half-res positions per tile side
constexpr int S5_THREADS = 256;  // block size of the deconv score kernel
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

// EntropyAcc's sums for final_stage(), branch first: expf (full
// precision) of m - logit when the maximum grows, of logit - m when it
// stays. add() takes one logit (first for the pixel's first class).
struct EntropyAccExact {
  float m = 0.f, z = 0.f, s = 0.f;
  __device__ __forceinline__ void add(float logit, bool first) {
    if (first) {
      m = logit;
      z = 1.f;
    } else if (logit > m) {
      const float d = m - logit;  // < 0: rescale the sums to the new max
      const float e = expf(d);
      s = e * (s + d * z);
      z = e * z + 1.f;
      m = logit;
    } else {
      const float d = logit - m;
      const float e = expf(d);
      z += e;
      s += e * d;
    }
  }
  __device__ __forceinline__ float conf(float inv_log_c) const {
    return 1.f + (s / z - logf(z)) * inv_log_c;
  }
};

// The Final transposed conv over the SIDE x SIDE half-res positions at
// (hy0, hx0), from X5 (16 channels over at least {hy0-1, hx0-1, SIDE+1,
// SIDE+1}, zero outside the half-res grid). Work items are phase-major,
// so that a warp shares its taps' weights; with S5_THREADS = SIDE^2 a
// thread takes one half-res position and its four output phases. Pixels
// outside the H x W image are skipped. Predict (kScore false) writes
// the first-max label to labels_n [H][W]; score returns the sum of this
// thread's pixel confidences, one class at a time (EntropyAccExact).
template <bool kScore>
__device__ __forceinline__ float final_stage(const Buf X5,
                                             const float* __restrict__ fw,
                                             int C, int hy0, int hx0, int H,
                                             int W, int8_t* labels_n) {
  const float inv_log_c = kScore ? 1.f / logf((float)C) : 0.f;
  float acc = 0.f;
  for (int t = threadIdx.x; t < 4 * SIDE * SIDE; t += blockDim.x) {
    const int ph = t / (SIDE * SIDE), k = t % (SIDE * SIDE);
    const int a = ph >> 1, b = ph & 1;
    const int hy = hy0 + k / SIDE, hx = hx0 + k % SIDE;
    const int R = 2 * hy + a, Cc = 2 * hx + b;
    if (R >= H || Cc >= W) continue;
    // taps: rows (kh, dy) = a ? (1, 0) : {(2, 0), (0, -1)}; same for cols
    float v[2][2][16];
#pragma unroll
    for (int tr = 0; tr < 2; ++tr)
#pragma unroll
      for (int tc = 0; tc < 2; ++tc) {
        const bool used = (tr == 0 || a == 0) && (tc == 0 || b == 0);
        const float* s = X5.at(hy - tr, hx - tc);
#pragma unroll
        for (int ic = 0; ic < 16; ++ic) v[tr][tc][ic] = used ? s[ic] : 0.f;
      }
    int best_c = 0;
    float m = 0.f;
    EntropyAccExact ent;
    for (int cls = 0; cls < C; ++cls) {
      float logit = 0.f;
#pragma unroll
      for (int tr = 0; tr < 2; ++tr)
#pragma unroll
        for (int tc = 0; tc < 2; ++tc) {
          const int kh = a ? 1 : (tr ? 0 : 2);
          const int kw = b ? 1 : (tc ? 0 : 2);
          const float* w = fw + (kh * 3 + kw) * 16 * C + cls;
#pragma unroll
          for (int ic = 0; ic < 16; ++ic)
            logit += v[tr][tc][ic] * __ldg(w + ic * C);
        }
      if (kScore) {
        ent.add(logit, cls == 0);
      } else if (cls == 0 || logit > m) {
        m = logit;
        best_c = cls;
      }
    }
    if (kScore)
      acc += ent.conf(inv_log_c);
    else
      labels_n[(size_t)R * W + Cc] = (int8_t)best_c;
  }
  return acc;
}

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
