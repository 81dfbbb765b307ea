// The ENet decoder's last stages as device functions, shared by the
// tail kernels (tail.cu: predict and entropy score) and the decoder and
// deconv score kernels (decoder.cu), so that every route runs the same
// stage-5, Final and entropy code; ICNet's head kernels (icnet_head.cu)
// take its EntropyAcc and block_partial.
//
// stage5() runs Bottleneck5_0 (1x1 projection, 3x3/s2 transposed conv,
// expand; residual = 1x1 conv unpooled by the B1_0 mask) and
// Bottleneck5_1 for one tile of TQ x TQ quarter-res positions.
// final_stage() runs the Final 3x3/s2 transposed conv for the tile's
// 2TQ x 2TQ half-res positions (4TQ x 4TQ pixels) and ends each pixel
// either in a first-max argmax or in its entropy confidence
// 1 - H(softmax)/log C, online over the classes. block_partial() sums
// the block's confidences in a fixed order (no atomics), so that a
// score is bit-repeatable from run to run.
#pragma once

#include "common.cuh"

namespace ssal {

constexpr int TQ = 8;            // quarter-res tile side of stage 5
constexpr int SIDE = 2 * TQ;     // half-res positions per tile side
constexpr int S5_THREADS = 256;  // block size of every stage-5 kernel
// stage-5 buffer sizes in floats (rectangle positions x channel stride)
constexpr int S5_Q2N = (TQ + 3) * (TQ + 3);              // B5_0 proj
constexpr int S5_H0N = (2 * TQ + 3) * (2 * TQ + 3);      // B5_0 out
constexpr int S5_H1N = (2 * TQ + 1) * (2 * TQ + 1);      // B5_1 out
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int S5_AF = cmax(cmax(S5_Q2N * 17, S5_H0N * 5), S5_THREADS);
constexpr int S5_BF = cmax(S5_H0N * 9, S5_H1N * 5);
constexpr int S5_XF = S5_H0N * 17;

struct UpParams {
  Affine proj, deconv, exp;
  const float* res_w;  // [cin][cout], the residual 1x1 conv (no BN)
  const float* res_alpha;
};

inline UpParams take_up(Cursor& c, int cin, int f, int fo, int cout) {
  UpParams p;
  p.proj = take_affine(c, cin * f, f, true);
  p.deconv = take_affine(c, 9 * f * fo, fo, true);
  p.exp = take_affine(c, fo * cout, cout, false);
  p.res_w = c.take(cin * cout);
  p.res_alpha = c.take(cout);
  return p;
}

inline int up_pack_size(int cin, int f, int fo, int cout) {
  return cin * f + 2 * f + 9 * f * fo + 2 * fo + fo * cout + cout +
         cin * cout + cout;
}

struct Stage5Params {
  UpParams b50;          // 64 -> 16 -> 8 -> 16
  BottleneckParams b51;  // 16, projection 4
  const float* final_w;  // [3][3][16][C]
};

inline Stage5Params take_stage5(Cursor& c, int num_classes) {
  Stage5Params p;
  p.b50 = take_up(c, 64, 16, 8, 16);
  p.b51 = take_bottleneck(c, 16, 4);
  p.final_w = c.take(9 * 16 * num_classes);
  return p;
}

inline int stage5_pack_size(int num_classes) {
  return up_pack_size(64, 16, 8, 16) + bottleneck_pack_size(16, 4) +
         9 * 16 * num_classes;
}

// Bottleneck5_0 + Bottleneck5_1 for the quarter-res tile at (qr0, qc0).
// X4 holds the stage-4 features (64 channels) over at least the rect
// {qr0-2, qc0-2, TQ+3, TQ+3}, zero outside the Hq x Wq grid; mn is the
// image's B1_0 mask [Hq][Wq][64] (one-hot at channel p*16 + c). A and B
// are scratch of S5_AF and S5_BF floats; X5p (S5_XF floats) receives
// the B5_1 output over {2qr0-1, 2qc0-1, 2TQ+1, 2TQ+1}, zero outside the
// half-res grid. Ends with a barrier.
__device__ __forceinline__ void stage5(const Buf X4,
                                       const float* __restrict__ mn,
                                       const Stage5Params P, float* A,
                                       float* B, float* X5p, int qr0,
                                       int qc0, int Hq, int Wq) {
  const int Hh = 2 * Hq, Wh = 2 * Wq;
  const Rect q2 = {qr0 - 2, qc0 - 2, TQ + 3, TQ + 3};
  const Rect h0 = {2 * qr0 - 2, 2 * qc0 - 2, 2 * TQ + 3, 2 * TQ + 3};
  const Rect h1 = {2 * qr0 - 1, 2 * qc0 - 1, 2 * TQ + 1, 2 * TQ + 1};
  const Buf X5 = {X5p, h0, 17};

  // --- Bottleneck5_0 ----------------------------------------------------
  const Buf P5 = {A, q2, 17};
  conv_stage<64, 16, 1, 1>(X4, P5, q2, 1, P.b50.proj, Hq, Wq);
  // residual: the 1x1 conv 64 -> 16 unpooled by mask1, into X5
  for (int t = threadIdx.x; t < h0.size() * 16; t += blockDim.x) {
    const int oc = t % 16, p = t / 16;
    const int r = h0.row(p), c = h0.col(p);
    float v = 0.f;
    if (inside(r, c, Hh, Wh)) {
      const int qr = r >> 1, qc = c >> 1;
      const int ph = 2 * (r & 1) + (c & 1);
      if (__ldg(mn + ((size_t)qr * Wq + qc) * 64 + ph * 16 + oc) != 0.f) {
        const float* xs = X4.at(qr, qc);
#pragma unroll 8
        for (int ic = 0; ic < 64; ++ic)
          v += xs[ic] * __ldg(P.b50.res_w + ic * 16 + oc);
      }
    }
    X5.at(r, c)[oc] = v;
  }
  __syncthreads();
  const Buf D5 = {B, h0, 9};
  deconv_stage<16, 8>(P5, D5, h0, P.b50.deconv, Hh, Wh);
  __syncthreads();
  expand_residual<8, 16>(D5, X5, h0, P.b50.exp, P.b50.res_alpha, Hh, Wh);
  __syncthreads();

  // --- Bottleneck5_1 ----------------------------------------------------
  const Buf T5 = {A, h0, 5};
  const Buf U5 = {B, h1, 5};
  conv_stage<16, 4, 1, 1>(X5, T5, h0, 1, P.b51.proj, Hh, Wh);
  __syncthreads();
  conv_stage<4, 4, 3, 3>(T5, U5, h1, 1, P.b51.conv, Hh, Wh);
  __syncthreads();
  expand_residual<4, 16>(U5, X5, h1, P.b51.exp, P.b51.res_alpha, Hh, Wh);
  __syncthreads();
}

// A pixel's softmax entropy confidence 1 + (S/Z - log Z)/log C, online
// over its classes: Z = sum e^(l-m), S = sum e^(l-m)(l-m), m the running
// maximum, both sums rescaled when m grows. add() takes one logit (first
// for the pixel's first class); conf() takes 1/log C.
struct EntropyAcc {
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
// thread's pixel confidences, one class at a time (EntropyAcc).
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
    EntropyAcc ent;
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
