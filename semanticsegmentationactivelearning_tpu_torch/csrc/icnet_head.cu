// ICNet's heads: the classifier + 8x upsample head ending in the
// per-image mean entropy confidence (score) or in per-pixel labels
// (predict), from fused8 (head8_kernel) or from CFF2's inputs
// (cff2_head_kernel). One template parameter, kPredict, picks the end.
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
// jnp.argmax's lowest-index tie rule, pallas_kernels.py:166-171). Note
// the two edge rules of the CFF2 kernel: the conv pads with zeros, the
// head clamps to fused8's own boundary row.
//
// Score: each block writes one partial sum of pixel confidences 1 -
// H/log C, [N, blocks], summed in a fixed order (decoder.cuh
// block_partial, no atomics), so that a score is bit-repeatable; the
// wrapper divides the row sums by the pixel count, as the JAX wrappers
// do. Predict: the block's 64 x 64 int8 labels are staged in shared
// memory and stored as 8-byte row pieces straight to labels [N, 8*H8,
// 8*W8] at (8r+t, 8c+u) (no lane-tile unpack as on the TPU); a ragged
// tile stores only its in-grid positions, each a whole 8-byte piece.
//
// What bounds them on an H100: fp32 FMAs on the CUDA cores, and for the
// head alone its reads. Per 1024x2048 image at 19 classes: the dilated
// conv 4.83 G multiply-adds, the 1x1 0.27 G, the head about 0.7 G
// (multiply-adds and exps; the argmax has compares in place of the
// exps), ~11 GFLOP an image (~1.35 ms at batch 8 and the 67 TFLOP/s fp32
// peak); the head alone reads 16.8 MB of fused8 an image, and predict
// writes 2.1 MB of labels.
//
// Design: one block per (image, 8x8 tile of 1/8-res positions). The head
// kernel stages the tile's fused8 with a one-position halo and computes
// the classifier logits over it (62 KB at 19 classes). The CFF2
// kernel stages fused16 under the tile (clamped reads), upsamples it to
// a 14x14 window of 1/8-res positions (zero outside the grid), runs the
// dilated conv over the 10x10 positions the head needs (conv_tile,
// common.cuh, 7 positions x 8 channels a thread), adds the f1 branch,
// applies ReLU and the classifier: 153 KB of shared memory, one block
// per SM. fp32 storage and accumulation.
#include "decoder.cuh"

namespace ssal {
namespace {

constexpr int HT = 8;  // 1/8-res tile side of both kernels
constexpr int HS = HT + 2;  // with the head's one-position halo
constexpr int THREADS = 256;
constexpr int MAX_CLASSES = 128;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// the block's last shared floats: score's reduction slots or predict's
// 64 x 64 int8 labels
constexpr int TAIL_F = cmax(THREADS, 64 * 64 / 4);

// _HEAD8_W: output phase t of the composed upsample draws on 1/8-res
// rows (i-1, i, i+1) with these weights (x32)
__constant__ float kHead8W[8][3] = {
    {14.f / 32, 18.f / 32, 0.f},      {10.f / 32, 22.f / 32, 0.f},
    {7.f / 32, 24.f / 32, 1.f / 32},  {5.f / 32, 24.f / 32, 3.f / 32},
    {3.f / 32, 24.f / 32, 5.f / 32},  {1.f / 32, 24.f / 32, 7.f / 32},
    {0.f, 22.f / 32, 10.f / 32},      {0.f, 18.f / 32, 14.f / 32}};

// The head over the tile's own positions {R0, C0, HT, HT}: CL holds the
// classifier logits (C per position) over {R0-1, C0-1, HS, HS}, each
// out-of-grid position holding its clamped neighbour's. Score: returns
// this thread's sum of pixel confidences. Predict: writes each pixel's
// label to lab[(8*(r-R0) + t) * 64 + 8*(c-C0) + u] and returns 0. A warp
// takes the 32 pixels of one position and half its row phases, so every
// logit read is a broadcast.
template <bool kPredict>
__device__ float head8(const float* CL, int C, int R0, int C0, int H8,
                       int W8, signed char* lab) {
  const float inv_log_c = 1.f / logf((float)C);
  float acc = 0.f;
  for (int it = threadIdx.x; it < HT * HT * 64; it += blockDim.x) {
    const int ph = it % 64, p = it / 64;
    const int t = ph >> 3, u = ph & 7;
    const int r = R0 + p / HT, c = C0 + p % HT;
    if (r >= H8 || c >= W8) continue;
    float wt[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) wt[a][b] = kHead8W[t][a] * kHead8W[u][b];
    // CL position (r-1, c-1), relative to the rectangle's origin
    const float* q = CL + ((r - R0) * HS + (c - C0)) * C;
    auto logit = [&](int cls) {
      float l = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) l += wt[a][b] * q[(a * HS + b) * C + cls];
      return l;
    };
    if constexpr (kPredict) {
      float best = logit(0);
      int label = 0;
      for (int cls = 1; cls < C; ++cls) {
        const float l = logit(cls);
        if (l > best) best = l, label = cls;
      }
      lab[(8 * (r - R0) + t) * 64 + 8 * (c - C0) + u] = (signed char)label;
    } else {
      EntropyAcc ent;
      for (int cls = 0; cls < C; ++cls) ent.add(logit(cls), cls == 0);
      acc += ent.conf(inv_log_c);
    }
  }
  return acc;
}

// The tile's staged labels (head8<true>) -> labels [N, 8*H8, 8*W8]: one
// 8-byte piece per (pixel row, 1/8-res column), so a ragged tile stores
// only whole in-grid pieces; a warp stores four 64-byte row runs.
__device__ void store_labels(const signed char* lab,
                             signed char* __restrict__ labels, int n, int R0,
                             int C0, int H8, int W8) {
  for (int it = threadIdx.x; it < 64 * HT; it += blockDim.x) {
    const int i = it / HT, pc = it % HT;  // tile pixel row, 1/8-res column
    const int row = 8 * R0 + i, c = C0 + pc;
    if (R0 + i / 8 >= H8 || c >= W8) continue;
    const size_t off = ((size_t)n * 8 * H8 + row) * 8 * W8 + 8 * c;
    *reinterpret_cast<unsigned long long*>(labels + off) =
        *reinterpret_cast<const unsigned long long*>(lab + i * 64 + 8 * pc);
  }
}

// The kernels' common end over the tile {R0, C0} of image n, CL holding
// the classifier logits: the partial confidence sum of the block or its
// labels; tail is TAIL_F shared floats.
template <bool kPredict>
__device__ void head8_end(const float* CL, float* tail, int C, int n, int R0,
                          int C0, int H8, int W8, float* partials,
                          signed char* labels) {
  signed char* lab = reinterpret_cast<signed char*>(tail);
  const float v = head8<kPredict>(CL, C, R0, C0, H8, W8, lab);
  if constexpr (kPredict) {
    __syncthreads();
    store_labels(lab, labels, n, R0, C0, H8, W8);
  } else {
    block_partial(v, tail,
                  partials + ((size_t)n * gridDim.y + blockIdx.y) * gridDim.x +
                      blockIdx.x);
  }
}

// CL[p][cls] = bcls + sum_k X[clamp(p)][k] wcls[k][cls] over the head's
// rectangle {R0-1, C0-1, HS, HS}, p clamped to the H8 x W8 grid. X is a
// 128-channel buffer holding every in-grid position of that rectangle.
__device__ void classify(const Buf X, float* CL, const float* __restrict__ wcls,
                         const float* __restrict__ bcls, int C, int R0,
                         int C0, int H8, int W8) {
  for (int it = threadIdx.x; it < HS * HS * C; it += blockDim.x) {
    const int cls = it % C, p = it / C;
    const int r = clampi(R0 - 1 + p / HS, 0, H8 - 1);
    const int c = clampi(C0 - 1 + p % HS, 0, W8 - 1);
    const float* x = X.at(r, c);
    float v = __ldg(bcls + cls);
#pragma unroll 8
    for (int k = 0; k < 128; ++k) v += x[k] * __ldg(wcls + k * C + cls);
    CL[it] = v;
  }
}

constexpr int H8_F = HS * HS * 129;  // fused8 over the head's rectangle
// + the classifier logits (C a position; HS * HS is even, so the tail
// stays 8-byte aligned) and the tail
inline size_t head_smem_bytes(int num_classes) {
  return (size_t)(H8_F + HS * HS * num_classes + TAIL_F) * 4;
}

// Score writes partials, predict labels; the other pointer is unused.
template <bool kPredict>
__global__ void __launch_bounds__(THREADS)
    head8_kernel(const float* __restrict__ f8, const float* __restrict__ wcls,
                 const float* __restrict__ bcls, float* __restrict__ partials,
                 signed char* __restrict__ labels, int H8, int W8, int C) {
  extern __shared__ float smem[];
  const int n = blockIdx.z;
  const int R0 = blockIdx.y * HT, C0 = blockIdx.x * HT;
  const Buf X = {smem, {R0 - 1, C0 - 1, HS, HS}, 129};
  float* const CL = smem + H8_F;
  const float* fn = f8 + (size_t)n * H8 * W8 * 128;
  for (int t = threadIdx.x; t < HS * HS * 128; t += blockDim.x) {
    const int p = t / 128;
    const int r = X.r.row(p), c = X.r.col(p);
    if (inside(r, c, H8, W8))
      X.at(r, c)[t % 128] = __ldg(fn + ((size_t)r * W8 + c) * 128 + t % 128);
  }
  __syncthreads();
  classify(X, CL, wcls, bcls, C, R0, C0, H8, W8);
  __syncthreads();
  head8_end<kPredict>(CL, CL + HS * HS * C, C, n, R0, C0, H8, W8, partials,
                      labels);
}

// The CFF2 kernel's buffers: fused16 under the tile (clamped), its 2x
// upsample over {R0-3, C0-3, HT+6, HT+6}, and fused8 over the head's
// rectangle (aliasing fused16's buffer once the upsample is done); the
// classifier logits and the tail alias the upsample's.
constexpr int F16_S = HT / 2 + 4;
constexpr int LU_S = HT + 6;
constexpr int F_F = cmax(F16_S * F16_S, HS * HS) * 129;
constexpr int LU_F = LU_S * LU_S * 129;
constexpr size_t CFF2_SMEM_BYTES = (size_t)(F_F + LU_F) * 4;
static_assert(CFF2_SMEM_BYTES <= 232448, "227 KB of shared memory a block");
static_assert(HS * HS * MAX_CLASSES + TAIL_F <= LU_F,
              "logits and the tail fit in the upsample's buffer");
static_assert((F_F + LU_F - TAIL_F) % 2 == 0, "the tail is 8-byte aligned");

struct Cff2Params {
  const float* kc;    // [3][3][128][128] low conv, BN folded
  const float* bc;    // [128]
  const float* kh;    // [64][128] high 1x1, BN folded
  const float* bh;    // [128]
  const float* wcls;  // [128][C]
  const float* bcls;  // [C]
};

template <bool kPredict>
__global__ void __launch_bounds__(THREADS)
    cff2_head_kernel(const float* __restrict__ f16,
                     const float* __restrict__ f1, const Cff2Params P,
                     float* __restrict__ partials,
                     signed char* __restrict__ labels, int H8, int W8,
                     int C) {
  extern __shared__ float smem[];
  const int n = blockIdx.z;
  const int R0 = blockIdx.y * HT, C0 = blockIdx.x * HT;
  const int H16 = H8 / 2, W16 = W8 / 2;
  float* const LUp = smem + F_F;

  // 1. fused16 rows/cols R0/2-2 .. R0/2+HT/2+1, read clamped to the grid
  const Buf Y = {smem, {R0 / 2 - 2, C0 / 2 - 2, F16_S, F16_S}, 129};
  const float* fn = f16 + (size_t)n * H16 * W16 * 128;
  for (int t = threadIdx.x; t < F16_S * F16_S * 128; t += blockDim.x) {
    const int p = t / 128;
    const int r = clampi(Y.r.row(p), 0, H16 - 1);
    const int c = clampi(Y.r.col(p), 0, W16 - 1);
    Y.p[p * 129 + t % 128] = __ldg(fn + ((size_t)r * W16 + c) * 128 + t % 128);
  }
  __syncthreads();

  // 2. the 2x upsample: row 2i -> .25 y[i-1] + .75 y[i], row 2i+1 ->
  //    .75 y[i] + .25 y[i+1], the same on columns; zero outside the grid
  //    (the dilated conv's SAME padding)
  const Buf LU = {LUp, {R0 - 3, C0 - 3, LU_S, LU_S}, 129};
  for (int t = threadIdx.x; t < LU_S * LU_S * 128; t += blockDim.x) {
    const int ch = t % 128, p = t / 128;
    const int r = LU.r.row(p), c = LU.r.col(p);
    float v = 0.f;
    if (inside(r, c, H8, W8)) {
      const int i = (r >> 1) - 1 + (r & 1), j = (c >> 1) - 1 + (c & 1);
      const float wr0 = (r & 1) ? 0.75f : 0.25f, wc0 = (c & 1) ? 0.75f : 0.25f;
      const float* y0 = Y.at(i, j) + ch;
      const float* y1 = Y.at(i + 1, j) + ch;
      const float cl = wr0 * y0[0] + (1.f - wr0) * y1[0];
      const float cr = wr0 * y0[129] + (1.f - wr0) * y1[129];
      v = wc0 * cl + (1.f - wc0) * cr;
    }
    LU.p[p * 129 + ch] = v;
  }
  __syncthreads();

  // 3. the dilation-2 3x3 conv (BN folded, bias bc) over the head's
  //    rectangle, into fused16's buffer
  const Buf F8 = {smem, {R0 - 1, C0 - 1, HS, HS}, 129};
  conv_tile<128, 128, 3, 1, 2, 2, 7, false>(LU, F8, F8.r, P.kc, P.bc, H8, W8);
  __syncthreads();

  // 4. + the f1 1x1 branch (BN folded), ReLU
  const float* f1n = f1 + (size_t)n * H8 * W8 * 64;
  for (int t = threadIdx.x; t < HS * HS * 128; t += blockDim.x) {
    const int ch = t % 128, p = t / 128;
    const int r = F8.r.row(p), c = F8.r.col(p);
    if (!inside(r, c, H8, W8)) continue;
    const float* x = f1n + ((size_t)r * W8 + c) * 64;
    float v = F8.p[p * 129 + ch] + __ldg(P.bh + ch);
#pragma unroll 8
    for (int k = 0; k < 64; ++k) v += __ldg(x + k) * __ldg(P.kh + k * 128 + ch);
    F8.p[p * 129 + ch] = fmaxf(v, 0.f);
  }
  __syncthreads();

  // 5. the classifier over the head's rectangle (clamped), then the head
  float* const CL = LUp;
  classify(F8, CL, P.wcls, P.bcls, C, R0, C0, H8, W8);
  __syncthreads();
  head8_end<kPredict>(CL, LUp + LU_F - TAIL_F, C, n, R0, C0, H8, W8,
                      partials, labels);
}

}  // namespace
}  // namespace ssal

using namespace ssal;

extern "C" int ssal_head8_partials(int h8, int w8) {
  return ((h8 + HT - 1) / HT) * ((w8 + HT - 1) / HT);
}

namespace {

template <bool kPredict>
int launch_head8(const float* f8, const float* wcls, const float* bcls,
                 float* partials, signed char* labels, int n, int h8, int w8,
                 int num_classes, void* stream) {
  const size_t smem = head_smem_bytes(num_classes);
  cudaFuncSetAttribute(head8_kernel<kPredict>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((w8 + HT - 1) / HT, (h8 + HT - 1) / HT, n);
  head8_kernel<kPredict><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      f8, wcls, bcls, partials, labels, h8, w8, num_classes);
  return (int)cudaGetLastError();
}

template <bool kPredict>
int launch_cff2_head(const float* f16, const float* f1, const float* pack,
                     float* partials, signed char* labels, int n, int h8,
                     int w8, int num_classes, void* stream) {
  Cursor cur{pack};
  Cff2Params P;
  P.kc = cur.take(9 * 128 * 128);
  P.bc = cur.take(128);
  P.kh = cur.take(64 * 128);
  P.bh = cur.take(128);
  P.wcls = cur.take(128 * num_classes);
  P.bcls = cur.take(num_classes);
  cudaFuncSetAttribute(cff2_head_kernel<kPredict>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)CFF2_SMEM_BYTES);
  const dim3 grid((w8 + HT - 1) / HT, (h8 + HT - 1) / HT, n);
  cff2_head_kernel<kPredict><<<grid, THREADS, CFF2_SMEM_BYTES,
                               (cudaStream_t)stream>>>(
      f16, f1, P, partials, labels, h8, w8, num_classes);
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

// kc [3][3][128][128], bc [128], kh [64][128], bh [128], wcls [128][C],
// bcls [C].
extern "C" int ssal_cff2_head_pack_size(int num_classes) {
  return 9 * 128 * 128 + 128 + 64 * 128 + 128 + 129 * num_classes;
}

// fused16 [N,H8/2,W8/2,128], f1 [N,H8,W8,64] -> partials [N,
// ssal_head8_partials(h8, w8)]; H8, W8 even, C <= 128.
extern "C" int ssal_cff2_head_score(const float* f16, const float* f1,
                                    const float* pack, float* partials, int n,
                                    int h8, int w8, int num_classes,
                                    void* stream) {
  return launch_cff2_head<false>(f16, f1, pack, partials, nullptr, n, h8, w8,
                                 num_classes, stream);
}

// The same inputs -> labels int8 [N, 8*H8, 8*W8]; C <= 127.
extern "C" int ssal_cff2_head_predict(const float* f16, const float* f1,
                                      const float* pack, signed char* labels,
                                      int n, int h8, int w8, int num_classes,
                                      void* stream) {
  return launch_cff2_head<true>(f16, f1, pack, nullptr, labels, n, h8, w8,
                                num_classes, stream);
}
