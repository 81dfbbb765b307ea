// Shared pieces of the kernels: ENet's (front.cu, mid.cu, tail.cu,
// decoder.cu) and ICNet's (icnet_front.cu, icnet_head.cu).
//
// Every kernel works on NHWC float32 activations and a flat float32
// parameter pack whose layout the Python packers in ops/kernels/*.py
// build in the same order (BatchNorm folded into the conv weights:
// w * s per output channel plus a shift t). Weights are HWIO
// ([kh][kw][in][out]), the JAX package's layout.
//
// Inside a block, the stages of a fused chain run one after another on
// shared-memory buffers. Each buffer covers a rectangle of one
// resolution's grid (global coordinates) and stores a position's
// channels at an odd stride, so that threads reading neighbouring
// positions hit different banks. A stage computes every (position,
// output channel) pair of its destination rectangle with a
// block-stride loop; output channel is the fastest index, so a warp
// reads consecutive weights and writes consecutive outputs. Positions
// outside the image are written as zero after every stage: that is the
// SAME zero padding every convolution sees at the image edge.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssal {

// A rectangle of one resolution's grid, in global coordinates.
struct Rect {
  int r0, c0, h, w;
  __device__ __forceinline__ int size() const { return h * w; }
  __device__ __forceinline__ int row(int p) const { return r0 + p / w; }
  __device__ __forceinline__ int col(int p) const { return c0 + p % w; }
  __device__ __forceinline__ int idx(int r, int c) const {
    return (r - r0) * w + (c - c0);
  }
};

// A shared-memory buffer over a rectangle, channel stride cs.
struct Buf {
  float* p;
  Rect r;
  int cs;
  __device__ __forceinline__ float* at(int gr, int gc) const {
    return p + r.idx(gr, gc) * cs;
  }
};

__device__ __forceinline__ bool inside(int r, int c, int gh, int gw) {
  return r >= 0 && r < gh && c >= 0 && c < gw;
}

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : a * v;
}

// Cursor over a parameter pack (used on the host to slice it).
struct Cursor {
  const float* p;
  const float* take(int n) {
    const float* r = p;
    p += n;
    return r;
  }
};

// Folded conv + BatchNorm + PReLU parameters of one stage.
struct Affine {
  const float* w;      // [kh][kw][in][out]
  const float* b;      // [out]
  const float* alpha;  // [out]
};

inline Affine take_affine(Cursor& c, int wn, int bn, bool has_alpha) {
  Affine a;
  a.w = c.take(wn);
  a.b = c.take(bn);
  a.alpha = has_alpha ? c.take(bn) : nullptr;
  return a;
}

// A plain 64/128-channel bottleneck: 1x1 project, 3x3 conv, 1x1
// expand; res_alpha is the PReLU after the residual add.
struct BottleneckParams {
  Affine proj, conv, exp;
  const float* res_alpha;
};

inline BottleneckParams take_bottleneck(Cursor& c, int ch, int f) {
  BottleneckParams p;
  p.proj = take_affine(c, ch * f, f, true);
  p.conv = take_affine(c, 9 * f * f, f, true);
  p.exp = take_affine(c, f * ch, ch, false);
  p.res_alpha = c.take(ch);
  return p;
}

inline int bottleneck_pack_size(int ch, int f) {
  return ch * f + 2 * f + 9 * f * f + 2 * f + f * ch + 2 * ch;
}

// dst[q][oc] = prelu(b + sum_{kh,kw,ic} src[q + ((kh-KH/2)*dil,
// (kw-KW/2)*dil)][ic] * w[kh][kw][ic][oc]) over the rectangle `out`;
// zero outside the gh x gw grid.
template <int IC, int OC, int KH, int KW>
__device__ void conv_stage(const Buf src, const Buf dst, const Rect out,
                           int dil, const Affine a, int gh, int gw) {
  const int n = out.size() * OC;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int oc = t % OC;
    const int p = t / OC;
    const int r = out.row(p), c = out.col(p);
    float v = 0.f;
    if (inside(r, c, gh, gw)) {
      float acc = __ldg(a.b + oc);
#pragma unroll
      for (int kh = 0; kh < KH; ++kh) {
#pragma unroll
        for (int kw = 0; kw < KW; ++kw) {
          const float* x =
              src.at(r + (kh - KH / 2) * dil, c + (kw - KW / 2) * dil);
          const float* w = a.w + ((kh * KW + kw) * IC) * OC + oc;
#pragma unroll 8
          for (int ic = 0; ic < IC; ++ic) acc += x[ic] * __ldg(w + ic * OC);
        }
      }
      v = prelu(acc, __ldg(a.alpha + oc));
    }
    dst.at(r, c)[oc] = v;
  }
}

// x[q][oc] = prelu(b + sum_ic src[q][ic] * w[ic][oc] + x[q][oc],
// res_alpha) in place over `out`: the 1x1 expand, residual add and
// PReLU that end every bottleneck. Zero outside the grid.
template <int IC, int OC>
__device__ void expand_residual(const Buf src, const Buf x, const Rect out,
                                const Affine a, const float* res_alpha,
                                int gh, int gw) {
  const int n = out.size() * OC;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int oc = t % OC;
    const int p = t / OC;
    const int r = out.row(p), c = out.col(p);
    float* xo = x.at(r, c) + oc;
    if (!inside(r, c, gh, gw)) {
      *xo = 0.f;
      continue;
    }
    const float* s = src.at(r, c);
    float acc = __ldg(a.b + oc);
#pragma unroll 8
    for (int ic = 0; ic < IC; ++ic) acc += s[ic] * __ldg(a.w + ic * OC + oc);
    *xo = prelu(acc + *xo, __ldg(res_alpha + oc));
  }
}

// The 3x3/stride-2 transposed conv (lax.conv_transpose SAME) from the
// coarse buffer `src` to the fine buffer `dst` over the fine rectangle
// `out`, as four polyphases of the JAX kernel k[kh][kw][ic][oc]:
//   out[2i  ][.] <- k[2][.] x[i] + k[0][.] x[i-1]
//   out[2i+1][.] <- k[1][.] x[i]
// and the same along columns; then folded BN + PReLU. The fine grid is
// gh x gw; zero outside it.
template <int IC, int OC>
__device__ void deconv_stage(const Buf src, const Buf dst, const Rect out,
                             const Affine a, int gh, int gw) {
  const int n = out.size() * OC;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int oc = t % OC;
    const int p = t / OC;
    const int r = out.row(p), c = out.col(p);
    float v = 0.f;
    if (inside(r, c, gh, gw)) {
      const int i = r >> 1, j = c >> 1;
      const int nr = (r & 1) ? 1 : 2, nc = (c & 1) ? 1 : 2;
      float acc = __ldg(a.b + oc);
      for (int tr = 0; tr < nr; ++tr) {
        const int kh = (r & 1) ? 1 : (tr ? 0 : 2);
        for (int tc = 0; tc < nc; ++tc) {
          const int kw = (c & 1) ? 1 : (tc ? 0 : 2);
          const float* x = src.at(i - tr, j - tc);
          const float* w = a.w + ((kh * 3 + kw) * IC) * OC + oc;
#pragma unroll 8
          for (int ic = 0; ic < IC; ++ic) acc += x[ic] * __ldg(w + ic * OC);
        }
      }
      v = prelu(acc, __ldg(a.alpha + oc));
    }
    dst.at(r, c)[oc] = v;
  }
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace ssal
