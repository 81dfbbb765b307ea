// ICNet's heads: the classifier + 8x upsample head ending in the
// per-image mean entropy confidence (score) or in per-pixel labels
// (predict), from fused8 (head8_kernel) or from CFF2's inputs
// (cff2_head_kernel).
//
// head8_kernel replaces fused_head8_entropy_score and fused_head8_predict
// (ops/pallas_kernels.py:198 and :267, body _head8_kernel :112): fused8
// [N,H8,W8,128] f32, the classifier wcls [128,C] and bcls [C].
// cff2_head_kernel replaces fused_cff2_head8_entropy_score and
// fused_cff2_head8_predict (:3604 and :3677, body _cff2_head8_kernel
// :3468): fused16 [N,H8/2,W8/2,128] (CFF1's output) and f1 [N,H8,W8,64];
// CFF2 (2x bilinear upsample of fused16 with edge clamp, dilation-2 3x3
// 128->128 conv-BN with zero padding, 1x1 64->128 conv-BN of f1, sum,
// ReLU) runs in the kernel, so fused8 never reaches global memory.
//
// Both end in one head device function, head8(): the 1x1 classifier
// moved in front of the resizes (exact, since the tent weights sum to
// 1), then for every full-resolution pixel (8r+t, 8c+u) the composed
// 2x-then-4x bilinear upsample, the fixed tent weights kHead8W[t] x
// kHead8W[u] over 1/8-res rows and columns (r-1, r, r+1) x (c-1, c,
// c+1) (_HEAD8_W, pallas_kernels.py:106), each clamped to the grid,
// which reproduces both resizes' edge clamp; then either the softmax
// entropy confidence online over the classes (decoder.cuh EntropyAcc)
// or a running first-max argmax over the classes in order (strict >,
// jnp.argmax's lowest-index tie rule, pallas_kernels.py:166-171). The
// upsample is separable: a thread takes one pixel row 8r+t and one
// 1/8-res column c, blends the three logit rows by t for columns c-1,
// c, c+1 (9 multiply-adds a class), then the three columns by u for
// its 8 pixels (24), about 4 a pixel and class instead of 9. Note the
// two edge rules of the CFF2 kernel: the conv pads with zeros, the head
// clamps to fused8's own boundary row.
//
// Score: each block writes one partial sum of pixel confidences 1 -
// H/log C, [N, blocks], summed in a fixed order (decoder.cuh
// block_partial, no atomics), so that a score is bit-repeatable; the
// wrapper divides the row sums by the pixel count, as the JAX wrappers
// do. Predict: a thread stores its 8 labels as one 8-byte piece of
// labels [N, 8*H8, 8*W8] at (8r+t, 8c); a ragged tile stores only its
// in-grid pieces.
//
// What bounds the CFF2 kernel on an H100: its products. Per 1024x2048
// image at 19 classes the dilated conv is 4.83 G multiply-adds, the 1x1
// 0.27 G, the head about 0.7 G (multiply-adds and exps): ~10.8 GFLOP,
// 0.175 ms at batch 8 and the 495 TFLOP/s of one TF32 pass (0.129 ms
// for batch 2 in 3xTF32, 165 TFLOP/s), against 12.6 MB of input an
// image. The fp32 design it replaces ran the conv as FMAs on the CUDA
// cores (11% of the fp32 peak) and streamed the 590 KB conv weights
// through L2 once per work item, 8.8 MB a block.
//
// Design: CFF2 is one implicit GEMM on the tensor cores (tc.cuh
// mma.sync m16n8k8; 3xTF32 for labels, one TF32 pass for scores,
// ops/kernels/icnet_head.py PRECISION; the classifier 3xTF32 on both):
// for each position p of the head's rectangle (a 16x8 tile and a
// one-position halo, 18x10 = 180 rows, 1.41x the tile), acc[p] = [the
// nine dilated taps of the upsampled fused16 (9 x 128) | f1 (64)] @
// [kc ; kh], K = 1216, N = 128, + (bc + bh), ReLU: the low conv and the
// high 1x1 share one accumulator, as they are summed before the ReLU.
// The weights are one GEMM record (bank-safe stride 136) that streams
// through a 3-stage cp.async ring in chunks of 32 k rows, so each chunk
// is read once a block and serves every row of it (0.66 MB a block).
// Each of 12 warps holds 32 rows x 64 channels in registers for the
// whole K loop. Its A fragments are blended from fused16 (staged under
// the tile) as they are read, four reads a value: a staged 2x upsample
// would not fit beside the ring at this tile. The classifier is a
// second GEMM (N = C padded to 8s, padded classes never stored) on the
// ReLU'd fused8, which replaces the buffers in shared memory, with each
// out-of-grid position of the rectangle reading its clamped neighbour;
// then head8(). fp32 storage and accumulation everywhere. 189 KB of
// shared memory, one block of 384 threads an SM.
//
// What bounds head8_kernel on an H100: the head, one exp and about a
// dozen other operations a pixel and class (319 M pixel-classes at batch
// 8, 1024x2048, 19 classes), against 134 MB of fused8 (0.040 ms). The
// fp32 design it replaces spent most of its time in the classifier's
// loads (two a multiply-add: a staged x[k] and an __ldg of wcls) and
// staged fused8 4 bytes a load over an 8x8 tile's rectangle (1.56x the
// tile). Design: a 16x8 tile (1.41x), fused8 over its rectangle staged
// by 16-byte cp.async copies at a bank-safe channel stride, each
// out-of-grid position holding its clamped neighbour; wcls staged once a
// block at the classifier record's stride; the classifier on the tensor
// cores through classify(), the CFF2 kernel's own, its logits written
// over the staged fused8; then head8(). Two blocks of 512 threads an SM
// at 19 classes (107 KB each): tools/probe_head8.py measured this tile
// fastest on score and within 20% of the fastest on predict, of 16x8
// with 256 threads, 8x8, 8x16 and 16x16 with 512 or 1024 (PERF.md);
// 16x16 would take at most 104 classes.
#include "decoder.cuh"
#include "tc.cuh"

namespace ssal {
namespace {

constexpr int MAX_CLASSES = 128;

// _HEAD8_W: output phase t of the composed upsample draws on 1/8-res
// rows (i-1, i, i+1) with these weights (x32)
__constant__ float kHead8W[8][3] = {
    {14.f / 32, 18.f / 32, 0.f},      {10.f / 32, 22.f / 32, 0.f},
    {7.f / 32, 24.f / 32, 1.f / 32},  {5.f / 32, 24.f / 32, 3.f / 32},
    {3.f / 32, 24.f / 32, 5.f / 32},  {1.f / 32, 24.f / 32, 7.f / 32},
    {0.f, 22.f / 32, 10.f / 32},      {0.f, 18.f / 32, 14.f / 32}};

// The head over the tile {R0, C0, TR, TC} of image n: CL holds the
// classifier logits (C a position) over the rectangle {R0-1, C0-1,
// TR+2, TC+2}, each out-of-grid position holding its clamped
// neighbour's. Score: returns this thread's sum of pixel confidences.
// Predict: stores each item's 8 labels to labels and returns 0. An item
// is (pixel row 8r+t, 1/8-res column c); a warp takes the TC columns of
// a few row phases, so its logit reads hit TC addresses.
template <bool kPredict, int TR, int TC>
__device__ float head8(const float* CL, int C, int n, int R0, int C0,
                       int H8, int W8, signed char* __restrict__ labels) {
  constexpr int RW = TC + 2;
  const float inv_log_c = 1.f / logf((float)C);
  float acc = 0.f;
  for (int it = threadIdx.x; it < TR * 8 * TC; it += blockDim.x) {
    const int pc = it % TC, t = it / TC % 8, pr = it / (8 * TC);
    const int r = R0 + pr, c = C0 + pc;
    if (r >= H8 || c >= W8) continue;
    const float w0 = kHead8W[t][0], w1 = kHead8W[t][1], w2 = kHead8W[t][2];
    // CL position (r-1, c-1), relative to the rectangle's origin
    const float* x = CL + (pr * RW + pc) * C;
    // row-blended logit of class cls at column c-1+b
    const auto col = [&](int b, int cls) {
      const float* y = x + b * C + cls;
      return w0 * y[0] + w1 * y[RW * C] + w2 * y[2 * RW * C];
    };
    // the logit of pixel phase u from the three row-blended columns
    const auto px = [&](int u, float v0, float v1, float v2) {
      return kHead8W[u][0] * v0 + kHead8W[u][1] * v1 + kHead8W[u][2] * v2;
    };
    // the first class starts each pixel's argmax or entropy, the others
    // follow
    float v0 = col(0, 0), v1 = col(1, 0), v2 = col(2, 0);
    if constexpr (kPredict) {
      float best[8];
      int lab[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) best[u] = px(u, v0, v1, v2), lab[u] = 0;
      for (int cls = 1; cls < C; ++cls) {
        v0 = col(0, cls), v1 = col(1, cls), v2 = col(2, cls);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float l = px(u, v0, v1, v2);
          if (l > best[u]) best[u] = l, lab[u] = cls;
        }
      }
      unsigned long long piece = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        piece |= (unsigned long long)(unsigned char)lab[u] << (8 * u);
      *reinterpret_cast<unsigned long long*>(
          labels + ((size_t)n * 8 * H8 + 8 * r + t) * 8 * W8 + 8 * c) = piece;
    } else {
      EntropyAcc ent[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) ent[u].start(px(u, v0, v1, v2));
      for (int cls = 1; cls < C; ++cls) {
        v0 = col(0, cls), v1 = col(1, cls), v2 = col(2, cls);
#pragma unroll
        for (int u = 0; u < 8; ++u) ent[u].add(px(u, v0, v1, v2));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += ent[u].conf(inv_log_c);
    }
  }
  return acc;
}

// The block's score partial, at its (image, tile) slot of [N, blocks].
__device__ __forceinline__ void store_partial(float v, float* slots,
                                              float* partials, int n) {
  block_partial(v, slots,
                partials + ((size_t)n * gridDim.y + blockIdx.y) * gridDim.x +
                    blockIdx.x);
}

constexpr int AS = 132;  // channel stride of fused8 (and fused16): = 4
                         // mod 32, so that A fragment reads hit 32 banks

// -- the classifier ------------------------------------------------------------

// The classifier's products run in 3xTF32 on both routes (1.7% of the
// CFF2 kernel's): its weights rounded to TF32 shift every pixel's logits
// alike, which a mean over the pixels does not average away (in one
// pass they took the error of a score at the classifier x5 from 5.9e-5
// to 9.8e-5 of the 1e-4 gate; PERF.md).
constexpr int kClassifierPasses = 3;
constexpr int CLS_NTW = 4;  // n-tiles (of 8 classes) a warp at most

// CL[p * C + cls] = bcls[cls] + sum_k row(p)[k] w[k][cls] for the M
// positions p of a head's rectangle and the classes cls < C, on the
// tensor cores (mma.sync in kClassifierPasses) with fp32 sums. w is the
// classifier record [128][ws], its classes zero-padded to whole n-tiles
// (ws = bstride of that), in shared or global memory; row(p) points at
// a position's 128 channels. An m-tile of 16 positions (the last one
// repeated past M) takes ceil(n-tiles / CLS_NTW) warps, each up to
// CLS_NTW n-tiles of it; the m-tiles go in rounds, as many as the
// block's warps hold, and every warp of a round reads its rows before
// any warp of it writes. So CL may overlay the rows where position p's
// logits lie at or before row p's channels (rows of stride >= C from CL,
// as in head8_kernel). Ends with a barrier.
template <class Row>
__device__ void classify(Row row, int M, const float* w, int ws,
                         const float* bcls, int C, float* CL) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int nt = (C + 7) / 8;
  const int wpm = (nt + CLS_NTW - 1) / CLS_NTW;  // warps an m-tile
  const int part = warp % wpm;
  const int ntw = min(CLS_NTW, nt - part * CLS_NTW);
  const int n0 = part * CLS_NTW * 8;
  const int per_round = nw / wpm, mtiles = (M + 15) / 16;
  for (int base = 0; base < mtiles; base += per_round) {
    const int mt = base + warp / wpm;
    const bool active = warp / wpm < per_round && mt < mtiles;
    float acc[1][CLS_NTW][4];
#pragma unroll
    for (int j = 0; j < CLS_NTW; ++j)
      acc[0][j][0] = acc[0][j][1] = acc[0][j][2] = acc[0][j][3] = 0.f;
    if (active) {
      const float* r0 = row(min(16 * mt + g, M - 1));
      const float* r1 = row(min(16 * mt + g + 8, M - 1));
#pragma unroll 4
      for (int k = 0; k < 128; k += 8) {
        const float a[1][4] = {
            {r0[k + q], r1[k + q], r0[k + q + 4], r1[k + q + 4]}};
        mma_kstep_rows<1, CLS_NTW, kClassifierPasses>(acc, a, w + k * ws, ws,
                                                      n0, 1, ntw);
      }
    }
    __syncthreads();  // every row of the round is read
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < CLS_NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * mt + g + 8 * h, cls = n0 + 8 * j + 2 * q;
        if (j >= ntw || p >= M) continue;
        if (cls < C) CL[p * C + cls] = acc[0][j][2 * h] + bcls[cls];
        if (cls + 1 < C)
          CL[p * C + cls + 1] = acc[0][j][2 * h + 1] + bcls[cls + 1];
      }
  }
  __syncthreads();
}

// -- head8_kernel ------------------------------------------------------------

// The tile: HR x HC 1/8-res positions, HEAD8_THREADS threads, at least
// HEAD8_BLOCKS blocks an SM (tools/probe_head8.py --tile measures other
// shapes); its head rectangle has a one-position halo.
constexpr int HR = 16, HC = 8, HEAD8_THREADS = 512, HEAD8_BLOCKS = 2;
constexpr int HRW = HC + 2, HM = (HR + 2) * HRW;
constexpr int HF8 = HM * AS;  // fused8 over the rectangle, then CL over it

// fused8 [HM][AS] (then the logits [HM][C] over it) and the classifier
// record [128][ws] (then the score's reduction slots)
inline size_t head8_smem_bytes(int ws) {
  return (size_t)(HF8 + 128 * ws) * 4;
}

// Score writes partials, predict labels; the other pointer is unused.
// ws: the staged classifier's stride, bstride(C padded to 8s).
template <bool kPredict>
__global__ void __launch_bounds__(HEAD8_THREADS, HEAD8_BLOCKS)
    head8_kernel(const float* __restrict__ f8, const float* __restrict__ wcls,
                 const float* __restrict__ bcls, float* __restrict__ partials,
                 signed char* __restrict__ labels, int H8, int W8, int C,
                 int ws) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.z;
  const int R0 = blockIdx.y * HR, C0 = blockIdx.x * HC;
  float* const F8 = smem;
  float* const W = smem + HF8;
  const float* fn = f8 + (size_t)n * H8 * W8 * 128;
  for (int i = threadIdx.x; i < HM * 32; i += blockDim.x) {
    const int p = i / 32, k = i % 32 * 4;
    const int r = clampi(R0 - 1 + p / HRW, 0, H8 - 1);
    const int c = clampi(C0 - 1 + p % HRW, 0, W8 - 1);
    cp_async16(F8 + p * AS + k, fn + ((size_t)r * W8 + c) * 128 + k);
  }
  for (int i = threadIdx.x; i < 128 * ws; i += blockDim.x) {
    const int k = i / ws, cls = i % ws;
    W[i] = cls < C ? __ldg(wcls + k * C + cls) : 0.f;
  }
  cp_async_wait_sync();
  classify([&](int p) -> const float* { return F8 + p * AS; }, HM, W, ws,
           bcls, C, F8);
  const float v = head8<kPredict, HR, HC>(F8, C, n, R0, C0, H8, W8, labels);
  if constexpr (!kPredict) store_partial(v, W, partials, n);
}

// -- cff2_head_kernel ----------------------------------------------------------

constexpr int F1S = 68;   // channel stride of f1 (= 4 mod 32, as AS)
constexpr int KMAIN = 9 * 128 + 64;  // [dilated taps | f1] rows of the record
constexpr int WS = 136;   // the record's row stride (bstride(128))
constexpr int KC = 32;    // k rows a ring chunk
constexpr int STAGES = 3;
constexpr int CHUNK_F = KC * WS;
constexpr int NCHUNKS = KMAIN / KC;  // 36 for the taps, 2 for f1
constexpr int TAP_CHUNKS = 128 / KC;
static_assert(KMAIN % KC == 0 && 64 % KC == 0, "whole chunks");

// The tile: TR x TC 1/8-res positions, its head rectangle with a
// one-position halo (M rows of the GEMM); a warp takes MT row tiles of
// 16 x 64 channels (NT = 8 n-tiles). tools/probe_cff2.py measured 8x8
// tiles with the upsample staged in shared memory slower: 6-10% (score)
// and 13-23% (predict) in 8 warps of 32 rows, 23-26% and 39-47% in 14
// warps of 16 (PERF.md).
constexpr int TR = 16, TC = 8, MT = 2, NT = 8;
constexpr int RH = TR + 2, RW = TC + 2, M = RH * RW;
constexpr int NG = 128 / (8 * NT);
constexpr int CFF2_THREADS = 32 * ((M + 16 * MT - 1) / (16 * MT)) * NG;
static_assert(CFF2_THREADS == 384, "12 warps of 32 rows x 64 channels");
// fused16 under the tile (clamped): rows R0/2-2 .. R0/2+TR/2+1
constexpr int YH = TR / 2 + 4, YW = TC / 2 + 4;
constexpr int Y_F = YH * YW * AS;
constexpr int F1_F = M * F1S;
constexpr int RING_F = STAGES * CHUNK_F;
// after the GEMM: fused8 over the rect, the logits, the slots
constexpr int F8_F = M * AS;
constexpr int SLOTS = F8_F + M * MAX_CLASSES;
constexpr size_t CFF2_SMEM =
    (size_t)cmax(Y_F + F1_F + RING_F, SLOTS + CFF2_THREADS) * 4;
static_assert(CFF2_SMEM <= 232448, "227 KB of shared memory a block");

enum { OUT_SCORE, OUT_PREDICT, OUT_FUSED8 };

// kOut: the head's partials (score) or labels (predict), or fused8 for
// the tile's positions (the GEMM alone); out is partials or fused8.
// PASSES: CFF2's products in 1 (TF32), 2 (TF32, the weights as hi + lo)
// or 3 (3xTF32) passes. cls_ws: the
// classifier record's stride (its n is C padded to 8s).
template <int kOut, int PASSES>
__global__ void __launch_bounds__(CFF2_THREADS, 1)
    cff2_head_kernel(const float* __restrict__ f16,
                     const float* __restrict__ f1,
                     const float* __restrict__ pack, int cls_ws,
                     float* __restrict__ out,
                     signed char* __restrict__ labels, int H8, int W8,
                     int C) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.z;
  const int R0 = blockIdx.y * TR, C0 = blockIdx.x * TC;
  const int H16 = H8 / 2, W16 = W8 / 2;
  float* const Y = smem;
  float* const F1 = Y + Y_F;
  float* const ring = F1 + F1_F;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int warp = threadIdx.x >> 5;

  // 1. copies: fused16 under the tile (clamped reads), f1 over the rect
  //    (zero outside the grid) and the record's first chunk (group 0),
  //    its second chunk (group 1)
  const int yr0 = R0 / 2 - 2, yc0 = C0 / 2 - 2;
  const float* fn = f16 + (size_t)n * H16 * W16 * 128;
  for (int i = threadIdx.x; i < YH * YW * 32; i += blockDim.x) {
    const int p = i / 32, k = i % 32 * 4;
    const int r = clampi(yr0 + p / YW, 0, H16 - 1);
    const int c = clampi(yc0 + p % YW, 0, W16 - 1);
    cp_async16(Y + p * AS + k, fn + ((size_t)r * W16 + c) * 128 + k);
  }
  const float* f1n = f1 + (size_t)n * H8 * W8 * 64;
  for (int i = threadIdx.x; i < M * 16; i += blockDim.x) {
    const int p = i / 16, k = i % 16 * 4;
    const int r = R0 - 1 + p / RW, c = C0 - 1 + p % RW;
    float* d = F1 + p * F1S + k;
    if (inside(r, c, H8, W8))
      cp_async16(d, f1n + ((size_t)r * W8 + c) * 64 + k);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_floats(ring, pack, CHUNK_F);
  cp_async_commit();
  cp_async_floats(ring + CHUNK_F, pack + CHUNK_F, CHUNK_F);
  cp_async_commit();

  // 2. the GEMM: this warp's rows (rect positions, the last repeated
  //    past M) and 64 channels from n0, over the record's chunks. An A
  //    value of a dilated tap is the 2x upsample of fused16 at the tap's
  //    1/8-res position (r, c), blended as it is read: row 2i -> .25
  //    y[i-1] + .75 y[i], row 2i+1 -> .75 y[i] + .25 y[i+1], the same on
  //    columns, with the edge clamp of fused16's staged reads; zero
  //    outside the grid (the dilated conv's SAME padding).
  const int n0 = warp % NG * 8 * NT;
  const int p0 = warp / NG * 16 * MT;
  int pi[MT][2], pj[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = min(p0 + 16 * m + g + 8 * h, M - 1);
      pi[m][h] = p / RW, pj[m][h] = p % RW;
    }
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  for (int ch = 0; ch < NCHUNKS; ++ch) {
    cp_async_wait_group_sync<STAGES - 2>();  // chunk ch is in; ch-1 done
    if (ch + STAGES - 1 < NCHUNKS)
      cp_async_floats(ring + (ch + STAGES - 1) % STAGES * CHUNK_F,
                      pack + (size_t)(ch + STAGES - 1) * CHUNK_F, CHUNK_F);
    cp_async_commit();
    const float* w = ring + ch % STAGES * CHUNK_F;
    const int tap = ch / TAP_CHUNKS, kb = ch % TAP_CHUNKS * KC;
    // each row's source for this chunk: fused16 at the top-left of its
    // four taps and their weights, or its f1 row (weight 1)
    const float* src[MT][2];
    float wt[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (tap == 9) {
          src[m][h] = F1 + (pi[m][h] * RW + pj[m][h]) * F1S + kb;
          continue;
        }
        const int r = R0 - 3 + pi[m][h] + 2 * (tap / 3);
        const int c = C0 - 3 + pj[m][h] + 2 * (tap % 3);
        const int i = (r >> 1) - 1 + (r & 1), j = (c >> 1) - 1 + (c & 1);
        const float in = inside(r, c, H8, W8) ? 1.f : 0.f;
        const float wr = (r & 1) ? 0.75f : 0.25f;
        const float wc = (c & 1) ? 0.75f : 0.25f;
        wt[m][h][0] = in * wr * wc, wt[m][h][1] = in * wr * (1.f - wc);
        wt[m][h][2] = in * (1.f - wr) * wc;
        wt[m][h][3] = in * (1.f - wr) * (1.f - wc);
        src[m][h] = Y + ((i - yr0) * YW + (j - yc0)) * AS + kb;
      }
    const auto aval = [&](int m, int h, int k) {
      const float* s = src[m][h] + k;
      if (tap == 9) return s[0];
      return wt[m][h][0] * s[0] + wt[m][h][1] * s[AS] +
             wt[m][h][2] * s[YW * AS] + wt[m][h][3] * s[YW * AS + AS];
    };
#pragma unroll
    for (int ks = 0; ks < KC; ks += 8) {
      float a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        a[m][0] = aval(m, 0, ks + q), a[m][1] = aval(m, 1, ks + q);
        a[m][2] = aval(m, 0, ks + q + 4), a[m][3] = aval(m, 1, ks + q + 4);
      }
      mma_kstep_rows<MT, NT, PASSES>(acc, a, w + ks * WS, WS, n0);
    }
  }
  cp_async_wait_group_sync<0>();  // every warp is done with the buffers

  // 3. + (bc + bh), ReLU: fused8 over the rect, in place of the buffers
  //    (or, for the GEMM alone, the tile's positions to out)
  const float* bias = pack + KMAIN * WS;
  float* const F8 = smem;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 16 * m + g + 8 * h;
      if (p >= M) continue;
      const int r = R0 - 1 + p / RW, c = C0 - 1 + p % RW;
      const bool own = r >= R0 && r < R0 + TR && c >= C0 && c < C0 + TC &&
                       r < H8 && c < W8;
      if (kOut == OUT_FUSED8 && !own) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int ch = n0 + 8 * j + 2 * q;
        const float2 v = make_float2(fmaxf(acc[m][j][2 * h] + bias[ch], 0.f),
                                     fmaxf(acc[m][j][2 * h + 1] + bias[ch + 1],
                                           0.f));
        if (kOut == OUT_FUSED8)
          *reinterpret_cast<float2*>(
              out + (((size_t)n * H8 + r) * W8 + c) * 128 + ch) = v;
        else
          *reinterpret_cast<float2*>(F8 + p * AS + ch) = v;
      }
    }
  if constexpr (kOut == OUT_FUSED8) return;
  __syncthreads();

  // 4. the classifier over the rect, each out-of-grid position reading
  //    its clamped neighbour's fused8, then the head
  float* const CL = smem + F8_F;
  const float* wcls = pack + KMAIN * WS + 128;
  const float* bcls = wcls + 128 * cls_ws;
  classify(
      [&](int p) -> const float* {
        const int r = clampi(R0 - 1 + p / RW, 0, H8 - 1);
        const int c = clampi(C0 - 1 + p % RW, 0, W8 - 1);
        return F8 + ((r - R0 + 1) * RW + c - C0 + 1) * AS;
      },
      M, wcls, cls_ws, bcls, C, CL);
  const float v =
      head8<kOut == OUT_PREDICT, TR, TC>(CL, C, n, R0, C0, H8, W8, labels);
  if constexpr (kOut == OUT_SCORE) store_partial(v, smem + SLOTS, out, n);
}

// mma passes of CFF2's products on each route (ops/kernels/icnet_head.py
// PRECISION): on the score route the weights as hi + lo (tc.cuh PASSES
// 2), as the ENet tail's Final: in one pass their rounding shifts every
// position's fused8 alike, which an image's mean does not average out
// (1.29e-4 an image at chip_smoke.py --seed 3, classifier x5; 1.2e-7 in
// two passes in tools/cpu_emu.py)
constexpr int kPredictPasses = 3, kScorePasses = 2;

}  // namespace
}  // namespace ssal

using namespace ssal;

extern "C" int ssal_head8_partials(int h8, int w8) {
  return ((h8 + HR - 1) / HR) * ((w8 + HC - 1) / HC);
}

namespace {

template <bool kPredict>
int launch_head8(const float* f8, const float* wcls, const float* bcls,
                 float* partials, signed char* labels, int n, int h8, int w8,
                 int num_classes, void* stream) {
  const int ws = bstride((num_classes + 7) / 8 * 8);
  const size_t smem = head8_smem_bytes(ws);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(head8_kernel<kPredict>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((w8 + HC - 1) / HC, (h8 + HR - 1) / HR, n);
  head8_kernel<kPredict><<<grid, HEAD8_THREADS, smem,
                           (cudaStream_t)stream>>>(
      f8, wcls, bcls, partials, labels, h8, w8, num_classes, ws);
  return (int)cudaGetLastError();
}

template <int kOut, int PASSES>
int launch_cff2(const float* f16, const float* f1, const float* pack,
                float* out, signed char* labels, int n, int h8, int w8,
                int num_classes, void* stream) {
  const auto k = cff2_head_kernel<kOut, PASSES>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)CFF2_SMEM);
  const dim3 grid((w8 + TC - 1) / TC, (h8 + TR - 1) / TR, n);
  k<<<grid, CFF2_THREADS, CFF2_SMEM, (cudaStream_t)stream>>>(
      f16, f1, pack, bstride((num_classes + 7) / 8 * 8), out, labels, h8, w8,
      num_classes);
  return (int)cudaGetLastError();
}

}  // namespace

// fused8 [N,H8,W8,128], wcls [128,C], bcls [C] -> partials [N,
// ssal_head8_partials(h8, w8)]; C <= 128.
extern "C" int ssal_head8_score(const float* f8, const float* wcls,
                                const float* bcls, float* partials, int n,
                                int h8, int w8, int num_classes,
                                void* stream) {
  return launch_head8<false>(f8, wcls, bcls, partials, nullptr, n, h8, w8,
                             num_classes, stream);
}

// The same inputs -> labels int8 [N, 8*H8, 8*W8]; C <= 127.
extern "C" int ssal_head8_predict(const float* f8, const float* wcls,
                                  const float* bcls, signed char* labels,
                                  int n, int h8, int w8, int num_classes,
                                  void* stream) {
  return launch_head8<true>(f8, wcls, bcls, nullptr, labels, n, h8, w8,
                            num_classes, stream);
}

// Two GEMM records (tc.cuh Layer): [kc (tap-major, 9 x 128 rows) ; kh
// (64 rows)] [1216][136] with the vector bc + bh, then the classifier
// [128][bstride(Cp)] with bcls padded to Cp, Cp = C rounded up to 8s.
extern "C" int ssal_cff2_head_pack_size(int num_classes) {
  const int cp = (num_classes + 7) / 8 * 8;
  return KMAIN * WS + 128 + 128 * bstride(cp) + cp;
}

// Score partials of the CFF2 + head kernel per image.
extern "C" int ssal_cff2_head_partials(int h8, int w8) {
  return ((h8 + TR - 1) / TR) * ((w8 + TC - 1) / TC);
}

// fused16 [N,H8/2,W8/2,128], f1 [N,H8,W8,64] -> partials [N,
// ssal_cff2_head_partials(h8, w8)]; H8, W8 even, C <= 128.
extern "C" int ssal_cff2_head_score(const float* f16, const float* f1,
                                    const float* pack, float* partials, int n,
                                    int h8, int w8, int num_classes,
                                    void* stream) {
  return launch_cff2<OUT_SCORE, kScorePasses>(f16, f1, pack, partials,
                                              nullptr, n, h8, w8,
                                              num_classes, stream);
}

// The same inputs -> labels int8 [N, 8*H8, 8*W8]; C <= 127.
extern "C" int ssal_cff2_head_predict(const float* f16, const float* f1,
                                      const float* pack, signed char* labels,
                                      int n, int h8, int w8, int num_classes,
                                      void* stream) {
  return launch_cff2<OUT_PREDICT, kPredictPasses>(f16, f1, pack, nullptr,
                                                  labels, n, h8, w8,
                                                  num_classes, stream);
}

// The GEMM alone: the same inputs -> fused8 [N,H8,W8,128], at the score
// route's precision (score != 0) or the predict route's.
extern "C" int ssal_cff2_fused8(const float* f16, const float* f1,
                                const float* pack, float* fused8, int n,
                                int h8, int w8, int num_classes, int score,
                                void* stream) {
  return score ? launch_cff2<OUT_FUSED8, kScorePasses>(
                     f16, f1, pack, fused8, nullptr, n, h8, w8, num_classes,
                     stream)
               : launch_cff2<OUT_FUSED8, kPredictPasses>(
                     f16, f1, pack, fused8, nullptr, n, h8, w8, num_classes,
                     stream);
}
