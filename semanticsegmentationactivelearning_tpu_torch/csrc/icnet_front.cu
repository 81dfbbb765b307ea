// ICNet front: image -> Branch1's f1 and either the half-resolution image
// (front) or the pooled stem features (front + stem).
//
// One template, icnet_front_kernel<kStem>, so that the two routes share
// their image staging, Branch1 and downsample code, as
// _make_icnet_front_ops (ops/pallas_kernels.py:3016) keeps them
// together on the TPU:
// - kStem false replaces fused_icnet_front (ops/pallas_kernels.py:3189,
//   body _icnet_front_kernel :3167): image [N,H,W,3] -> f1 [N,H/8,W/8,64]
//   and x_half [N,H/2,W/2,3];
// - kStem true replaces fused_icnet_front_stem (:3346, body
//   _icnet_front_stem_kernel :3289): image -> f1 and stem1 [N,H/8,W/8,64],
//   the SharedStem's conv1_1 (s2) -> conv1_2 -> conv1_3 -> 3x3/s2 max
//   pool on the half-res image, which never reaches global memory.
// Branch1 is three 3x3/s2 conv-BN-ReLU layers (3->32->32->64). Every
// stride-2 SAME conv pads (0, 1) (pallas_kernels.py:2913). The 2x
// downsample is jax.image.resize's antialiased bilinear: taps (1, 3, 3,
// 1)/8 on image rows and columns 2i-1..2i+2, renormalized to (3, 3, 1)/7
// at the first and last half row and column (:2921-2926). Half-res rows
// outside the image are zero for conv1_1's SAME padding, which is not
// the resize's own edge rule. The max pool's padded row and column at
// the high edge hold 0, which is max-neutral only because the values are
// post-ReLU.
//
// What bounds it on an H100: fp32 FMAs on the CUDA cores. Per 1024x2048
// image, Branch1 does 2.27 G multiply-adds and the stem 3.74 G before
// halo recompute (1.4 ms at batch 8 and the 67 TFLOP/s fp32 peak) against
// 25 MB read and 4 MB written per image; the front alone 2.27 G.
//
// Design: one block per (image, TR x TC tile of 1/8-res outputs) with the
// image window under it staged in shared memory, zero outside the image.
// f1 row r reads image rows 8r..8r+14 and stem1 row m reads 8m-9..8m+22
// (the pool, conv1_3 and conv1_2 +-1, conv1_1 s2 and the downsample's
// four taps), so a 4x8 tile stages a 56x88 window. Each stage is
// conv_tile (common.cuh) over shared-memory buffers that shrink by the
// next stage's halo: Branch1's conv1 at half resolution (19x35x32), then
// its conv2 (9x17x32) and conv3 (4x8x64); the stem reuses those buffers
// for the half-res window (27x43x3), conv1_1 (13x21x32), conv1_2
// (11x19x32) and conv1_3 (9x17x64). 175 KB of shared memory, one block
// per SM. fp32 storage and accumulation; tensor cores are later work.
#include "common.cuh"

namespace ssal {
namespace {

constexpr int TR = 4, TC = 8;  // 1/8-res output tile
constexpr int THREADS = 512;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// buffer sides (rows x cols) and sizes in floats (odd channel strides)
constexpr int IMG_H = 8 * TR + 24, IMG_W = 8 * TC + 24;  // image 8R0-9..
constexpr int B1_H = 4 * TR + 3, B1_W = 4 * TC + 3;      // Branch1_1
constexpr int B2_H = 2 * TR + 1, B2_W = 2 * TC + 1;      // Branch1_2
constexpr int XH_H = 4 * TR + 11, XH_W = 4 * TC + 11;    // half-res image
constexpr int S1_H = 2 * TR + 5, S1_W = 2 * TC + 5;      // conv1_1
constexpr int S2_H = 2 * TR + 3, S2_W = 2 * TC + 3;      // conv1_2
constexpr int S3_H = 2 * TR + 1, S3_W = 2 * TC + 1;      // conv1_3
constexpr int IMG_F = IMG_H * IMG_W * 3;
constexpr int B1_F = B1_H * B1_W * 33;
constexpr int S1_F = S1_H * S1_W * 33;
constexpr int S2_F = S2_H * S2_W * 33;
constexpr int S3_F = S3_H * S3_W * 65;
// region A: Branch1_1, then conv1_2 at A[0], conv1_3 after it and
// conv1_1 at A's end (conv1_3 overwrites conv1_1 once conv1_2 is done)
constexpr int A_F = cmax(B1_F, cmax(S2_F + S3_F, S2_F + S1_F));
// region B: Branch1_2, then the half-res window; D: the f1 tile
constexpr int B_F = cmax(B2_H * B2_W * 33, XH_H * XH_W * 3);
constexpr int D_F = TR * TC * 65;
constexpr size_t SMEM_BYTES = (size_t)(IMG_F + A_F + B_F + D_F) * 4;
static_assert(SMEM_BYTES <= 232448, "227 KB of shared memory a block");

struct ConvW {
  const float* w;  // [3][3][in][out], BN scale folded
  const float* b;  // [out], BN shift
};

struct FrontParams {
  ConvW b1, b2, b3;  // Branch1_1..1_3
  ConvW s1, s2, s3;  // SharedStem conv1_1..1_3 (the stem route only)
};

constexpr int kConvSizes[6][2] = {{3, 32}, {32, 32}, {32, 64},
                                  {3, 32}, {32, 32}, {32, 64}};

// The antialiased 2x downsample's taps on image indices 2i-1..2i+2 of
// half index i on an axis of n2 half positions.
__device__ __forceinline__ void tent(int i, int n2, float wt[4]) {
  if (i == 0) {
    wt[0] = 0.f, wt[1] = 3.f / 7.f, wt[2] = 3.f / 7.f, wt[3] = 1.f / 7.f;
  } else if (i == n2 - 1) {
    wt[0] = 1.f / 7.f, wt[1] = 3.f / 7.f, wt[2] = 3.f / 7.f, wt[3] = 0.f;
  } else {
    wt[0] = 0.125f, wt[1] = 0.375f, wt[2] = 0.375f, wt[3] = 0.125f;
  }
}

// Half-res pixel (i, j), channel ch, from the staged image; zero outside
// the H2 x W2 grid.
__device__ __forceinline__ float half_px(const Buf img, int i, int j, int ch,
                                         int H2, int W2) {
  if (!inside(i, j, H2, W2)) return 0.f;
  float wr[4], wc[4];
  tent(i, H2, wr);
  tent(j, W2, wc);
  float v = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float* row = img.at(2 * i - 1 + a, 2 * j - 1) + ch;
    float rv = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) rv += wc[b] * row[3 * b];
    v += wr[a] * rv;
  }
  return v;
}

template <bool kStem>
__global__ void __launch_bounds__(THREADS)
    icnet_front_kernel(const float* __restrict__ image, const FrontParams P,
                       float* __restrict__ f1, float* __restrict__ out2,
                       int H, int W) {
  extern __shared__ float smem[];
  const int n = blockIdx.z;
  const int R0 = blockIdx.y * TR, C0 = blockIdx.x * TC;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4, H8 = H / 8,
            W8 = W / 8;
  const Buf IMG = {smem, {8 * R0 - 9, 8 * C0 - 9, IMG_H, IMG_W}, 3};
  float* const A = smem + IMG_F;
  float* const B = A + A_F;
  float* const D = B + B_F;

  // 1. the image window, zero outside the image
  const float* im = image + (size_t)n * H * W * 3;
  for (int t = threadIdx.x; t < IMG_F; t += blockDim.x) {
    const int p = t / 3;
    const int y = IMG.r.row(p), x = IMG.r.col(p);
    IMG.p[t] = inside(y, x, H, W) ? __ldg(im + ((size_t)y * W + x) * 3 + t % 3)
                                  : 0.f;
  }
  __syncthreads();

  // 2. Branch1: three 3x3/s2 conv-BN-ReLU, pad (0, 1)
  const Buf B1 = {A, {4 * R0, 4 * C0, B1_H, B1_W}, 33};
  conv_tile<3, 32, 3, 2, 1, 0, 2, true>(IMG, B1, B1.r, P.b1.w, P.b1.b, H2,
                                        W2);
  __syncthreads();
  const Buf B2 = {B, {2 * R0, 2 * C0, B2_H, B2_W}, 33};
  conv_tile<32, 32, 3, 2, 1, 0, 1, true>(B1, B2, B2.r, P.b2.w, P.b2.b, H4,
                                         W4);
  __syncthreads();
  const Buf F1 = {D, {R0, C0, TR, TC}, 65};
  conv_tile<32, 64, 3, 2, 1, 0, 1, true>(B2, F1, F1.r, P.b3.w, P.b3.b, H8,
                                         W8);
  __syncthreads();
  float* const f1n = f1 + (size_t)n * H8 * W8 * 64;
  for (int t = threadIdx.x; t < TR * TC * 64; t += blockDim.x) {
    const int p = t / 64;
    const int r = F1.r.row(p), c = F1.r.col(p);
    if (r < H8 && c < W8)
      f1n[((size_t)r * W8 + c) * 64 + t % 64] = F1.at(r, c)[t % 64];
  }

  if (!kStem) {
    // 3. the tile's half-res image rows and columns
    float* const xh = out2 + (size_t)n * H2 * W2 * 3;
    for (int t = threadIdx.x; t < 16 * TR * TC * 3; t += blockDim.x) {
      const int p = t / 3;
      const int i = 4 * R0 + p / (4 * TC), j = 4 * C0 + p % (4 * TC);
      if (i < H2 && j < W2)
        xh[((size_t)i * W2 + j) * 3 + t % 3] = half_px(IMG, i, j, t % 3, H2,
                                                       W2);
    }
    return;
  }

  // 3. the stem: half-res window (B2 is consumed), conv1_1 s2, conv1_2,
  //    conv1_3, each zero outside its grid
  const Buf XH = {B, {4 * R0 - 4, 4 * C0 - 4, XH_H, XH_W}, 3};
  for (int t = threadIdx.x; t < XH_H * XH_W * 3; t += blockDim.x) {
    const int p = t / 3;
    XH.p[t] = half_px(IMG, XH.r.row(p), XH.r.col(p), t % 3, H2, W2);
  }
  __syncthreads();
  const Buf S1 = {A + A_F - S1_F, {2 * R0 - 2, 2 * C0 - 2, S1_H, S1_W}, 33};
  conv_tile<3, 32, 3, 2, 1, 0, 1, true>(XH, S1, S1.r, P.s1.w, P.s1.b, H4,
                                        W4);
  __syncthreads();
  const Buf S2 = {A, {2 * R0 - 1, 2 * C0 - 1, S2_H, S2_W}, 33};
  conv_tile<32, 32, 3, 1, 1, 1, 2, true>(S1, S2, S2.r, P.s2.w, P.s2.b, H4,
                                         W4);
  __syncthreads();
  const Buf S3 = {A + S2_F, {2 * R0, 2 * C0, S3_H, S3_W}, 65};
  conv_tile<32, 64, 3, 1, 1, 1, 3, true>(S2, S3, S3.r, P.s3.w, P.s3.b, H4,
                                         W4);
  __syncthreads();

  // 4. max pool 3x3/s2 over quarter rows/cols 2m..2m+2 -> stem1
  float* const st = out2 + (size_t)n * H8 * W8 * 64;
  for (int t = threadIdx.x; t < TR * TC * 64; t += blockDim.x) {
    const int ch = t % 64, p = t / 64;
    const int m = R0 + p / TC, q = C0 + p % TC;
    if (m >= H8 || q >= W8) continue;
    float v = S3.at(2 * m, 2 * q)[ch];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        v = fmaxf(v, S3.at(2 * m + dy, 2 * q + dx)[ch]);
    st[((size_t)m * W8 + q) * 64 + ch] = v;
  }
}

FrontParams take_front(const float* pack) {
  Cursor cur{pack};
  ConvW* convs[6];
  FrontParams P;
  convs[0] = &P.b1, convs[1] = &P.b2, convs[2] = &P.b3;
  convs[3] = &P.s1, convs[4] = &P.s2, convs[5] = &P.s3;
  for (int k = 0; k < 6; ++k) {
    convs[k]->w = cur.take(9 * kConvSizes[k][0] * kConvSizes[k][1]);
    convs[k]->b = cur.take(kConvSizes[k][1]);
  }
  return P;
}

template <bool kStem>
int launch_front(const float* image, const float* pack, float* f1,
                 float* out2, int n, int h, int w, void* stream) {
  const FrontParams P = take_front(pack);
  cudaFuncSetAttribute(icnet_front_kernel<kStem>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  const dim3 grid((w / 8 + TC - 1) / TC, (h / 8 + TR - 1) / TR, n);
  icnet_front_kernel<kStem><<<grid, THREADS, SMEM_BYTES,
                              (cudaStream_t)stream>>>(image, P, f1, out2, h,
                                                      w);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ssal

using namespace ssal;

// Branch1_1..1_3 then conv1_1..1_3, each [3][3][in][out] then [out].
extern "C" int ssal_icnet_front_pack_size() {
  int size = 0;
  for (int k = 0; k < 6; ++k)
    size += 9 * kConvSizes[k][0] * kConvSizes[k][1] + kConvSizes[k][1];
  return size;
}

// image [N,H,W,3] -> f1 [N,H/8,W/8,64], x_half [N,H/2,W/2,3];
// H, W % 32 == 0.
extern "C" int ssal_icnet_front(const float* image, const float* pack,
                                float* f1, float* x_half, int n, int h,
                                int w, void* stream) {
  return launch_front<false>(image, pack, f1, x_half, n, h, w, stream);
}

// image [N,H,W,3] -> f1, stem1 [N,H/8,W/8,64]; H, W % 32 == 0.
extern "C" int ssal_icnet_front_stem(const float* image, const float* pack,
                                     float* f1, float* stem1, int n, int h,
                                     int w, void* stream) {
  return launch_front<true>(image, pack, f1, stem1, n, h, w, stream);
}
