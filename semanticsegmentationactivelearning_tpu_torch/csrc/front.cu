// ENet front: image -> stage-1 features and the B1_0 pool-switch mask.
//
// Replaces fused_front_stage1_w (ops/pallas_kernels.py:1474, body
// _front_w_kernel :1302) and its v1 fused_front_stage1 (:1030): one
// contract, one kernel, no width limit beyond W % 8 == 0.
//
// Computes Initial (3x3/s2 conv 3->13 || 2x2 max pool, BN, PReLU) ->
// Bottleneck1_0 (2x2/s2 projection 16->8, 3x3, 1x1 expand to 64, max
// pool with first-max switches, zero channel pad) -> Bottleneck1_1..1_4.
// Outputs x1 [N,H/4,W/4,64] and mask1 [N,H/4,W/4,64], the one-hot of
// each switch at channel p*16 + c with p = 2*row + col of the window.
// The half-resolution Initial output and B1_0's internals never reach
// global memory.
//
// What bounds it on an H100: fp32 FMAs on the CUDA cores. Per image at
// 1024x2048 it does about 2.7 G multiply-adds before halo recompute
// (80 us at the 67 TFLOP/s fp32 peak) against 6.3 MB read and 67 MB
// written (about 22 us at 3.35 TB/s).
//
// Design: one block per (image, 8x8 tile of quarter-res positions).
// The tile needs a halo of 5 quarter positions (B1_0's 3x3 and four
// 3x3 bottlenecks), i.e. a 73x73 image patch, which is staged in
// shared memory with zeros outside the image. Every stage runs on
// shared-memory buffers over the 18x18 halo region and shrinks its
// valid rectangle by its own halo; every conv input is re-zeroed
// outside the image after its PReLU, which is the SAME padding the
// model's convs see. The halo costs about 2.7x recompute in stage 1;
// a larger tile would need more than the 227 KB of shared memory a
// block may use (189 KB here). fp32 storage and accumulation;
// tensor cores (wgmma) and bf16 are later work.
#include "common.cuh"

namespace ssal {
namespace {

constexpr int TQ = 8;              // quarter-res output tile side
constexpr int HALO = 5;            // B1_0's 3x3 + four 3x3 bottlenecks
constexpr int RQ = TQ + 2 * HALO;  // region side in quarter positions
constexpr int RI = 4 * RQ + 1;     // staged image rows/cols
constexpr int XS = 65;             // channel stride of X (64 used)
constexpr int TS = 17;             // channel stride of T, U (<= 16 used)
constexpr int THREADS = 256;
constexpr size_t SMEM_FLOATS =
    (size_t)RQ * RQ * XS + 2 * (size_t)RQ * RQ * TS + (size_t)RI * RI * 3;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * 4 + TQ * TQ * 16;

struct FrontParams {
  const float* ini_w;  // [3][3][3][13], BN scale folded
  const float* ini_s;  // [16] BN scale (the pool channels 13..15 use it)
  const float* ini_t;  // [16] BN shift
  const float* ini_a;  // [16] PReLU
  Affine p10;          // B1_0 2x2/s2 projection [2*2*16][8]
  Affine c10;          // B1_0 3x3 [3][3][8][8]
  Affine e10;          // B1_0 expand [8][64]
  const float* r10;    // [64] residual PReLU
  BottleneckParams b[4];
};

__global__ void __launch_bounds__(THREADS)
    front_kernel(const float* __restrict__ image, const FrontParams P,
                 float* __restrict__ x1, float* __restrict__ mask1, int H,
                 int W) {
  extern __shared__ float smem[];
  const int n = blockIdx.z;
  const int Hq = H / 4, Wq = W / 4;
  const int R0 = blockIdx.y * TQ, C0 = blockIdx.x * TQ;
  const Rect reg = {R0 - HALO, C0 - HALO, RQ, RQ};
  const Buf X = {smem, reg, XS};
  const Buf T = {X.p + RQ * RQ * XS, reg, TS};
  const Buf U = {T.p + RQ * RQ * TS, reg, TS};
  float* img = U.p + RQ * RQ * TS;
  uint8_t* sw = reinterpret_cast<uint8_t*>(img + RI * RI * 3);

  // 1. the image patch under the region, zero outside the image
  const float* im = image + (size_t)n * H * W * 3;
  const int iy0 = 4 * reg.r0, ix0 = 4 * reg.c0;
  for (int t = threadIdx.x; t < RI * RI * 3; t += blockDim.x) {
    const int ch = t % 3, p = t / 3;
    const int y = iy0 + p / RI, x = ix0 + p % RI;
    img[t] = (y >= 0 && y < H && x >= 0 && x < W)
                 ? __ldg(im + ((size_t)y * W + x) * 3 + ch)
                 : 0.f;
  }
  __syncthreads();

  // 2. Initial at the four half-res positions (phase ph = 2a + b) of
  //    every quarter position q: X[q][ph*16 + c]. The stride-2 SAME
  //    conv pads (0, 1): half row y reads image rows 2y..2y+2.
  for (int t = threadIdx.x; t < RQ * RQ * 64; t += blockDim.x) {
    const int c = t % 16, ph = (t / 16) % 4, p = t / 64;
    const int hy = 2 * (p / RQ) + (ph >> 1), hx = 2 * (p % RQ) + (ph & 1);
    const float* src = img + ((2 * hy) * RI + 2 * hx) * 3;
    float v;
    if (c < 13) {
      v = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci)
            v += src[(dy * RI + dx) * 3 + ci] *
                 __ldg(P.ini_w + ((dy * 3 + dx) * 3 + ci) * 13 + c);
    } else {
      const int ci = c - 13;
      const float m = fmaxf(fmaxf(src[ci], src[3 + ci]),
                            fmaxf(src[RI * 3 + ci], src[RI * 3 + 3 + ci]));
      v = m * __ldg(P.ini_s + c);
    }
    X.p[p * XS + ph * 16 + c] = prelu(v + __ldg(P.ini_t + c),
                                      __ldg(P.ini_a + c));
  }
  __syncthreads();

  // 3. B1_0's 2x2/s2 projection (a 1x1 over the 4 phases x 16 channels)
  //    into T, and its residual: the pool over the phases with
  //    first-max switches, zero-padded to 64 channels in place in X.
  for (int p = threadIdx.x; p < RQ * RQ; p += blockDim.x) {
    const int r = reg.row(p), c = reg.col(p);
    float* xq = X.p + p * XS;
    float iv[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) iv[k] = xq[k];
    const bool in = inside(r, c, Hq, Wq);
#pragma unroll
    for (int oc = 0; oc < 8; ++oc) {
      float acc = __ldg(P.p10.b + oc);
#pragma unroll
      for (int k = 0; k < 64; ++k) acc += iv[k] * __ldg(P.p10.w + k * 8 + oc);
      T.p[p * TS + oc] = in ? prelu(acc, __ldg(P.p10.alpha + oc)) : 0.f;
    }
    const int lr = r - R0, lc = c - C0;
    const bool tile = lr >= 0 && lr < TQ && lc >= 0 && lc < TQ;
#pragma unroll
    for (int ch = 0; ch < 16; ++ch) {
      float m = iv[ch];
      int s = 0;
#pragma unroll
      for (int ph = 1; ph < 4; ++ph) {
        if (iv[ph * 16 + ch] > m) {
          m = iv[ph * 16 + ch];
          s = ph;
        }
      }
      xq[ch] = m;
      if (tile) sw[(lr * TQ + lc) * 16 + ch] = (uint8_t)s;
    }
#pragma unroll
    for (int ch = 16; ch < 64; ++ch) xq[ch] = 0.f;
  }
  __syncthreads();

  // 4. B1_0's 3x3 and expand + residual, valid on halo 4
  const Rect r4 = {R0 - 4, C0 - 4, TQ + 8, TQ + 8};
  conv_stage<8, 8, 3, 3>(T, U, r4, 1, P.c10, Hq, Wq);
  __syncthreads();
  expand_residual<8, 64>(U, X, r4, P.e10, P.r10, Hq, Wq);
  __syncthreads();

  // 5. Bottleneck1_1..1_4: each shrinks the valid halo by one
  for (int k = 0; k < 4; ++k) {
    const int h = 4 - k;
    const Rect rin = {R0 - h, C0 - h, TQ + 2 * h, TQ + 2 * h};
    const Rect rout = {R0 - h + 1, C0 - h + 1, TQ + 2 * h - 2, TQ + 2 * h - 2};
    conv_stage<64, 16, 1, 1>(X, T, rin, 1, P.b[k].proj, Hq, Wq);
    __syncthreads();
    conv_stage<16, 16, 3, 3>(T, U, rout, 1, P.b[k].conv, Hq, Wq);
    __syncthreads();
    expand_residual<16, 64>(U, X, rout, P.b[k].exp, P.b[k].res_alpha, Hq,
                            Wq);
    __syncthreads();
  }

  // 6. the tile's x1 and mask1
  for (int t = threadIdx.x; t < TQ * TQ * 64; t += blockDim.x) {
    const int ch = t % 64, p = t / 64;
    const int r = R0 + p / TQ, c = C0 + p % TQ;
    if (r < Hq && c < Wq) {
      const size_t o = (((size_t)n * Hq + r) * Wq + c) * 64 + ch;
      x1[o] = X.at(r, c)[ch];
      mask1[o] = sw[p * 16 + (ch & 15)] == (ch >> 4) ? 1.f : 0.f;
    }
  }
}

}  // namespace
}  // namespace ssal

using namespace ssal;

extern "C" int ssal_front_pack_size() {
  return 351 + 3 * 16 + (512 + 2 * 8) + (576 + 2 * 8) + (512 + 64) + 64 +
         4 * bottleneck_pack_size(64, 16);
}

// image [N,H,W,3] f32 -> x1, mask1 [N,H/4,W/4,64] f32; H, W % 8 == 0.
// Returns the cudaError_t of the launch.
extern "C" int ssal_front(const float* image, const float* pack, float* x1,
                          float* mask1, int n, int h, int w, void* stream) {
  Cursor cur{pack};
  FrontParams P;
  P.ini_w = cur.take(351);
  P.ini_s = cur.take(16);
  P.ini_t = cur.take(16);
  P.ini_a = cur.take(16);
  P.p10 = take_affine(cur, 4 * 16 * 8, 8, true);
  P.c10 = take_affine(cur, 9 * 8 * 8, 8, true);
  P.e10 = take_affine(cur, 8 * 64, 64, false);
  P.r10 = cur.take(64);
  for (int k = 0; k < 4; ++k) P.b[k] = take_bottleneck(cur, 64, 16);
  cudaFuncSetAttribute(front_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  const dim3 grid((w / 4 + TQ - 1) / TQ, (h / 4 + TQ - 1) / TQ, n);
  front_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      image, P, x1, mask1, h, w);
  return (int)cudaGetLastError();
}
