// ENet mid section: stage-1 features -> stage-3 features and the B2_0
// pool switches.
//
// Replaces fused_mid_stage23_w (ops/pallas_kernels.py:2184, bodies
// _mid_w_b20_kernel :2089 and _mid_w_blocks_kernel :2139) and its v1
// fused_mid_stage23 (:1808): one contract, no width limit beyond
// W % 8 == 0. Outputs y [N,H/8,W/8,128] f32 and sw2 int8 [N,H/8,W/8,64]
// (window position 0..3 of each first maximum).
//
// What bounds it on an H100: fp32 FMAs on the CUDA cores, about 9.8 G
// multiply-adds per 1024x2048 image (290 us at the 67 TFLOP/s fp32
// peak); the 128-channel activations move 17 MB per image per block.
//
// Design: the TPU kernel keeps a whole image in VMEM; its receptive
// field (+-73 eighth positions, dilations up to 16) cannot be tiled into
// the 227 KB of shared memory a block may use. So every block is its
// own launch and the activations between blocks go through global
// memory, where at batch 1-2 they stay in the 50 MB L2:
//   - B2_0: one launch, 8x8 eighth-res tile with a halo of 1: the
//     2x2/s2 projection reads x1 directly, 3x3, expand, pool with
//     first-max switches and zero channel pad;
//   - each of the 16 stage-2/3 bottlenecks: two launches, the 1x1
//     projection 128->32 (+BN, PReLU) into a 32-channel buffer, then the
//     dilated 3x3 or the 5x1 followed by 1x5 (+BN, PReLU), the 1x1
//     expand, the residual and the PReLU on 8x8 tiles. At dilation 16
//     a fused projection would recompute the tile 9 times over, so it
//     round-trips the 4 MB (per image) buffer instead.
// 33 launches in all. fp32 storage and accumulation; wgmma and bf16 are
// later work.
#include "common.cuh"

namespace ssal {
namespace {

constexpr int TE = 8;  // eighth-res output tile side
constexpr int THREADS = 256;
constexpr int CS = 33;  // channel stride of the 32-channel buffers

struct Down20Params {
  Affine proj;  // [2*2*64][32]
  Affine conv;  // [3][3][32][32]
  Affine exp;   // [32][128]
  const float* res_alpha;
};

// One value of a [.., H8, W8, 32] buffer, zero outside the grid.
__device__ __forceinline__ float at32(const float* P, int r, int c, int ic,
                                      int H8, int W8) {
  return inside(r, c, H8, W8) ? __ldg(P + ((size_t)r * W8 + c) * 32 + ic)
                              : 0.f;
}

__global__ void __launch_bounds__(THREADS)
    b20_kernel(const float* __restrict__ x1, const Down20Params P,
               float* __restrict__ y, int8_t* __restrict__ sw2, int H8,
               int W8) {
  __shared__ float sP[(TE + 2) * (TE + 2) * CS];
  __shared__ float sC[TE * TE * CS];
  const int n = blockIdx.z;
  const int Hq = 2 * H8, Wq = 2 * W8;
  const int E0 = blockIdx.y * TE, F0 = blockIdx.x * TE;
  const Rect r1 = {E0 - 1, F0 - 1, TE + 2, TE + 2};
  const Rect r0 = {E0, F0, TE, TE};
  const Buf bP = {sP, r1, CS};
  const Buf bC = {sC, r0, CS};
  const float* xn = x1 + (size_t)n * Hq * Wq * 64;

  // 2x2/s2 projection 64 -> 32 over the halo-1 region, zero outside
  for (int t = threadIdx.x; t < r1.size() * 32; t += blockDim.x) {
    const int oc = t % 32, p = t / 32;
    const int r = r1.row(p), c = r1.col(p);
    float v = 0.f;
    if (inside(r, c, H8, W8)) {
      float acc = __ldg(P.proj.b + oc);
      for (int ph = 0; ph < 4; ++ph) {
        const float* xs =
            xn + ((size_t)(2 * r + (ph >> 1)) * Wq + 2 * c + (ph & 1)) * 64;
        const float* w = P.proj.w + ph * 64 * 32 + oc;
#pragma unroll 8
        for (int ic = 0; ic < 64; ++ic) acc += __ldg(xs + ic) * __ldg(w + ic * 32);
      }
      v = prelu(acc, __ldg(P.proj.alpha + oc));
    }
    bP.at(r, c)[oc] = v;
  }
  __syncthreads();
  conv_stage<32, 32, 3, 3>(bP, bC, r0, 1, P.conv, H8, W8);
  __syncthreads();

  // expand 32 -> 128 + pooled residual (channels < 64) + PReLU
  for (int t = threadIdx.x; t < r0.size() * 128; t += blockDim.x) {
    const int oc = t % 128, p = t / 128;
    const int r = r0.row(p), c = r0.col(p);
    if (!inside(r, c, H8, W8)) continue;
    const float* s = bC.at(r, c);
    float acc = __ldg(P.exp.b + oc);
#pragma unroll 8
    for (int ic = 0; ic < 32; ++ic) acc += s[ic] * __ldg(P.exp.w + ic * 128 + oc);
    const size_t o = ((size_t)n * H8 + r) * W8 + c;
    if (oc < 64) {
      float m = 0.f;
      int sw = 0;
      for (int ph = 0; ph < 4; ++ph) {
        const float v = __ldg(
            xn + ((size_t)(2 * r + (ph >> 1)) * Wq + 2 * c + (ph & 1)) * 64 + oc);
        if (ph == 0 || v > m) {
          m = v;
          sw = ph;
        }
      }
      acc += m;
      sw2[o * 64 + oc] = (int8_t)sw;
    }
    y[o * 128 + oc] = prelu(acc, __ldg(P.res_alpha + oc));
  }
}

// P = prelu(x @ w + b): the 1x1 projection 128 -> 32 of one bottleneck.
__global__ void __launch_bounds__(THREADS)
    proj_kernel(const float* __restrict__ x, const Affine a,
                float* __restrict__ P, int npix) {
  const size_t n = (size_t)npix * 32;
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const int oc = t % 32;
    const size_t pix = t / 32;
    const float* xs = x + pix * 128;
    float acc = __ldg(a.b + oc);
#pragma unroll 8
    for (int ic = 0; ic < 128; ++ic) acc += __ldg(xs + ic) * __ldg(a.w + ic * 32 + oc);
    P[t] = prelu(acc, __ldg(a.alpha + oc));
  }
}

struct BlockConvParams {
  const float* col;  // asymmetric only: 5x1 kernel [5][32][32], no BN
  Affine conv;       // dilated [3][3][32][32] or the 1x5 [5][32][32]
  Affine exp;        // [32][128]
  const float* res_alpha;
};

// The spatial conv (dilated 3x3, or 5x1 then 1x5), expand, residual
// and PReLU of one stage-2/3 bottleneck on an 8x8 tile.
template <bool ASYM>
__global__ void __launch_bounds__(THREADS)
    conv_kernel(const float* __restrict__ x, const float* __restrict__ P,
                const BlockConvParams B, float* __restrict__ y, int H8,
                int W8, int dil) {
  __shared__ float sA[ASYM ? TE * (TE + 4) * CS : 1];
  __shared__ float sC[TE * TE * CS];
  const int n = blockIdx.z;
  const int E0 = blockIdx.y * TE, F0 = blockIdx.x * TE;
  const Rect r0 = {E0, F0, TE, TE};
  const Buf bC = {sC, r0, CS};
  const float* Pn = P + (size_t)n * H8 * W8 * 32;

  if (ASYM) {
    // 5x1 (no bias, no BN) over the tile widened by 2 columns each
    // side; zero outside the grid, the 1x5's SAME padding
    const Rect ra = {E0, F0 - 2, TE, TE + 4};
    const Buf bA = {sA, ra, CS};
    for (int t = threadIdx.x; t < ra.size() * 32; t += blockDim.x) {
      const int oc = t % 32, p = t / 32;
      const int r = ra.row(p), c = ra.col(p);
      float acc = 0.f;
      if (inside(r, c, H8, W8)) {
        for (int kh = 0; kh < 5; ++kh) {
          const float* w = B.col + kh * 32 * 32 + oc;
#pragma unroll 8
          for (int ic = 0; ic < 32; ++ic)
            acc += at32(Pn, r + kh - 2, c, ic, H8, W8) * __ldg(w + ic * 32);
        }
      }
      bA.at(r, c)[oc] = acc;
    }
    __syncthreads();
    conv_stage<32, 32, 1, 5>(bA, bC, r0, 1, B.conv, H8, W8);
  } else {
    for (int t = threadIdx.x; t < r0.size() * 32; t += blockDim.x) {
      const int oc = t % 32, p = t / 32;
      const int r = r0.row(p), c = r0.col(p);
      float v = 0.f;
      if (inside(r, c, H8, W8)) {
        float acc = __ldg(B.conv.b + oc);
        for (int kh = 0; kh < 3; ++kh) {
          for (int kw = 0; kw < 3; ++kw) {
            const int rr = r + (kh - 1) * dil, cc = c + (kw - 1) * dil;
            if (!inside(rr, cc, H8, W8)) continue;
            const float* ps = Pn + ((size_t)rr * W8 + cc) * 32;
            const float* w = B.conv.w + (kh * 3 + kw) * 32 * 32 + oc;
#pragma unroll 8
            for (int ic = 0; ic < 32; ++ic) acc += __ldg(ps + ic) * __ldg(w + ic * 32);
          }
        }
        v = prelu(acc, __ldg(B.conv.alpha + oc));
      }
      bC.at(r, c)[oc] = v;
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < r0.size() * 128; t += blockDim.x) {
    const int oc = t % 128, p = t / 128;
    const int r = r0.row(p), c = r0.col(p);
    if (!inside(r, c, H8, W8)) continue;
    const float* s = bC.at(r, c);
    const size_t o = (((size_t)n * H8 + r) * W8 + c) * 128 + oc;
    float acc = __ldg(B.exp.b + oc) + __ldg(x + o);
#pragma unroll 8
    for (int ic = 0; ic < 32; ++ic) acc += s[ic] * __ldg(B.exp.w + ic * 128 + oc);
    y[o] = prelu(acc, __ldg(B.res_alpha + oc));
  }
}

dim3 tile_grid(int n, int h8, int w8) {
  return dim3((w8 + TE - 1) / TE, (h8 + TE - 1) / TE, n);
}

}  // namespace
}  // namespace ssal

using namespace ssal;

extern "C" int ssal_mid_b20_pack_size() {
  return (4 * 64 * 32 + 64) + (9 * 32 * 32 + 64) + (32 * 128 + 128) + 128;
}

extern "C" int ssal_mid_proj_pack_size() { return 128 * 32 + 64; }

extern "C" int ssal_mid_conv_pack_size(int asym) {
  return (asym ? 2 * 5 * 32 * 32 : 9 * 32 * 32) + 64 + (32 * 128 + 128) + 128;
}

// x1 [N,Hq,Wq,64] -> y [N,Hq/2,Wq/2,128], sw2 int8 [N,Hq/2,Wq/2,64].
extern "C" int ssal_mid_b20(const float* x1, const float* pack, float* y,
                            int8_t* sw2, int n, int h8, int w8,
                            void* stream) {
  Cursor cur{pack};
  Down20Params P;
  P.proj = take_affine(cur, 4 * 64 * 32, 32, true);
  P.conv = take_affine(cur, 9 * 32 * 32, 32, true);
  P.exp = take_affine(cur, 32 * 128, 128, false);
  P.res_alpha = cur.take(128);
  b20_kernel<<<tile_grid(n, h8, w8), THREADS, 0, (cudaStream_t)stream>>>(
      x1, P, y, sw2, h8, w8);
  return (int)cudaGetLastError();
}

// x [npix,128] -> P [npix,32]
extern "C" int ssal_mid_proj(const float* x, const float* pack, float* P,
                             int npix, void* stream) {
  Cursor cur{pack};
  const Affine a = take_affine(cur, 128 * 32, 32, true);
  const int blocks = (int)(((size_t)npix * 32 + THREADS - 1) / THREADS);
  proj_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(x, a, P, npix);
  return (int)cudaGetLastError();
}

// x [N,H8,W8,128], P [N,H8,W8,32] -> y [N,H8,W8,128]
extern "C" int ssal_mid_conv(const float* x, const float* P,
                             const float* pack, float* y, int n, int h8,
                             int w8, int dilation, int asym, void* stream) {
  Cursor cur{pack};
  BlockConvParams B;
  B.col = asym ? cur.take(5 * 32 * 32) : nullptr;
  B.conv = take_affine(cur, (asym ? 5 : 9) * 32 * 32, 32, true);
  B.exp = take_affine(cur, 32 * 128, 128, false);
  B.res_alpha = cur.take(128);
  const dim3 grid = tile_grid(n, h8, w8);
  if (asym)
    conv_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        x, P, B, y, h8, w8, dilation);
  else
    conv_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        x, P, B, y, h8, w8, dilation);
  return (int)cudaGetLastError();
}
