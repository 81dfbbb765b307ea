// ENet tail: stage-3 features + both pool switches -> labels (predict)
// or the per-image mean entropy confidence (score), in two kernels.
//
// Replaces fused_tail_predict (ops/pallas_kernels.py:2810) and
// fused_tail_entropy_score (:2720), both the body _tail_kernel :2495
// (pack pack_enet_tail :2383).
//
// tail4_kernel computes stage 4: Bottleneck4_0 (1x1 projection, 3x3/s2
// transposed conv, expand; residual = 1x1 conv unpooled by sw2) ->
// Bottleneck4_1, 4_2, and writes x4 [N,H/4,W/4,64] f32, the one
// intermediate the tail hands through device memory. tail5_kernel reads
// x4 and computes Bottleneck5_0 (the same, unpooled by mask1) ->
// Bottleneck5_1 -> the Final 3x3/s2 transposed conv, then per pixel
// either the argmax that keeps the first maximum (the lowest class
// index, as jnp.argmax does) or the confidence 1 - H(softmax)/log C.
// Inputs: y [N,H/8,W/8,128] f32, sw2 int8 [N,H/8,W/8,64] (0..3), mask1
// [N,H/4,W/4,64] f32 one-hot at channel p*16 + c. Output: int8 labels
// [N,H,W], or one partial sum of confidences per tail5 block [N, blocks]
// that the wrapper reduces to the per-image mean. The half-resolution
// activations live in shared memory and the class logits in registers;
// only x4 and the labels or the partials reach global memory.
//
// What bounds it on an H100: the multiply-adds, about 1.83 G (stage 4),
// 0.63 G (stage 5) and 1.43 G (the Final at 19 classes) per 1024x2048
// image, 0.23 ms for batch 2 at the 67 TFLOP/s fp32 peak, against 27 MB
// read, 2 MB written and x4's 33.6 MB each way per image.
//
// Design. Every 1x1 conv, 3x3 conv, transposed-conv phase and the Final
// is a GEMM of [positions x K] by [K x N] on the tensor cores:
// mma.sync.m16n8k8 TF32 (tc.cuh), once or as 3xTF32 (hi/lo split of
// both operands, PASSES 3), fp32 accumulation: 3xTF32 for labels, one
// pass for scores (kPredictPasses, kScorePasses) but the Final's
// weights as hi + lo (kFinalScorePasses). A warp takes 16
// positions (a rectangle's positions in row-major order, or one phase of
// a transposed conv) by 8-32 output channels; its A fragments are read
// from the activation buffers in shared memory (channel stride = 4 mod
// 32, conflict-free), its B fragments from the layer's folded weights,
// which cp.async stages into shared memory once per block (stride 8 or
// 24 mod 32, conflict-free). A transposed conv runs as four phase GEMMs
// with their exact taps (1, 2, 2 or 4 of the 3x3), as the pack lays
// them out. tail4: one block of 16 warps per 16x16 quarter-res tile,
// with a 2-position halo for the two 3x3 convs (1.28x the least work of
// B4_1/B4_2), 227 KB of shared memory; the eighth-res projection and
// residual are computed once per position of the tile's 11x11 / 10x10
// eighth-res rectangle. tail5: one block of 8 warps per 16x16 half-res
// tile (32x32 pixels), 109 KB at 19 classes (two blocks per SM). The
// Final's classes are padded to 8 per n-tile; padded classes never
// enter the argmax or the entropy, whose per-lane partial results are
// merged across the 4 lanes of a row in a fixed order. The score sums
// each block's confidences in a fixed order (no atomics), so it is
// bit-repeatable. Positions outside the image are zero after every
// stage: the SAME padding of each conv and the x[-1] = 0 edge of the
// transposed convs.
//
// deconv_score_kernel replaces fused_deconv_entropy_score (:344, body
// _score_kernel :40): the Final + entropy mean from the pre-Final
// features [N,H/2,W/2,16] f32 and the Final's GEMM record alone
// (tail.py pack_final, the bits of the tail pack's FIN). It runs
// tail5_kernel's Final (final_phases) on the score route on a tile of
// DECONV_ROWS x 16 half-res positions staged by cp.async with the row
// above and the column to the left; the record is staged once a block.
// What bounds it: the features' 67 MB at batch 8, 512x1024 (0.020 ms at
// 3.35 TB/s; the Final's 2.9 G multiply-adds over its exact taps take
// 0.012 ms at the TF32 peak), then the entropy's exp and ~15
// instructions a pixel and class on the CUDA cores.
#include "decoder.cuh"
#include "tc.cuh"

namespace ssal {
namespace {

// -- the pack ------------------------------------------------------------
// One GEMM record per layer (tc.cuh Layer), in this order (ops/kernels/
// tail.py pack_tail builds the same): vectors bias and PReLU alpha, or
// bias and the residual PReLU alpha of an expand; none for a residual
// conv and the Final.
enum {
  P40, R40, D40, E40,  // Bottleneck4_0: proj, residual, deconv, expand
  P41, C41, E41, P42, C42, E42,
  P50, R50, D50, E50,  // Bottleneck5_0
  P51, C51, E51,       // Bottleneck5_1 (the 3x3 conv as K = 9 taps x 4)
  FIN,                 // the Final, per phase
  NLAYERS
};
constexpr int T5_FIRST = P50;

// n-tiles of the Final per chunk of classes, and its padded class count
int final_ntf(int c) { return c <= 8 ? 1 : c <= 16 ? 2 : c <= 24 ? 3 : 4; }
int final_cp(int c) {
  const int ntf = final_ntf(c), nt = (c + 7) / 8;
  return 8 * ntf * ((nt + ntf - 1) / ntf);
}

struct Layout {
  Layer l[NLAYERS];
  int size;
};

Layout tail_layout(int c) {
  // taps, k, n, nv
  const int spec[NLAYERS][4] = {
      {1, 128, 32, 2}, {1, 128, 64, 0}, {9, 32, 16, 2}, {1, 16, 64, 2},
      {1, 64, 16, 2},  {9, 16, 16, 2},  {1, 16, 64, 2}, {1, 64, 16, 2},
      {9, 16, 16, 2},  {1, 16, 64, 2},  {1, 64, 16, 2}, {1, 64, 16, 0},
      {9, 16, 8, 2},   {1, 8, 16, 2},   {1, 16, 8, 2},  {1, 40, 8, 2},
      {1, 8, 16, 2},   {9, 16, final_cp(c), 0}};
  Layout L;
  int off = 0;
  for (int i = 0; i < NLAYERS; ++i) {
    L.l[i] = {off, spec[i][0], spec[i][1], spec[i][2], bstride(spec[i][2]),
              spec[i][3]};
    off += L.l[i].size();
  }
  L.size = off;
  return L;
}

// first tap of each output phase (2a + b) in a transposed conv's record:
// phase (a, b) has (a ? 1 : 2) x (b ? 1 : 2) taps, row-major over
// (tr, tc); tap (tr, tc) reads the coarse position (i - tr, j - tc)
__device__ __constant__ int kPhaseTap[4] = {0, 4, 6, 8};

// -- stage 4 -------------------------------------------------------------

constexpr int T4 = 16;             // quarter-res output tile side
constexpr int T4_THREADS = 512;
constexpr int ES = T4 / 2 + 3;     // eighth-res rectangle side (11)
constexpr int RS = T4 + 4;         // quarter-res rectangle R0 side (20)
constexpr int EN = ES * ES, R0N = RS * RS, R1N = (T4 + 2) * (T4 + 2);
constexpr int YS = 132, PS = 36, XS = 68, S16 = 20;  // channel strides
constexpr int A4F = cmax(EN * YS, (R0N + R1N) * S16);
constexpr int P4F = EN * PS;
constexpr int X4F = R0N * XS;
constexpr int W4F = 128 * 72;      // the largest stage-4 record (R40)
constexpr int ZF = 128;
constexpr size_t T4_SMEM = (size_t)(A4F + P4F + X4F + W4F + ZF) * 4;
static_assert(T4_SMEM <= 232448, "227 KB of shared memory a block");

struct Tail4Params {
  const float* pack;
  Layer l[T5_FIRST];
};

// One block per (image, 16x16 tile of quarter-res positions at
// (qr0, qc0)). Rectangles (global coordinates): E, eighth res, rows
// qr0/2-2 .. qr0/2+8 (the deconv's inputs); R0 = quarter rows qr0-2 ..
// qr0+17 (B4_0's output, B4_1's input), R1 = qr0-1 .. qr0+16 (B4_1's
// output), R2 = the tile (B4_2's output); the same for columns.
template <int PASSES>
__global__ void __launch_bounds__(T4_THREADS, 1)
    tail4_kernel(const float* __restrict__ y, const int8_t* __restrict__ sw2,
                 const Tail4Params P, float* __restrict__ x4, int H8,
                 int W8) {
  extern __shared__ __align__(16) float smem[];
  float* const A = smem;       // y tile [EN][YS]; later D/T [R0N][S16], U
  float* const Pb = A + A4F;   // B4_0 projection [EN][PS]
  float* const X = Pb + P4F;   // stage-4 activations over R0 [R0N][XS]
  float* const W = X + X4F;    // the current layer's record
  float* const Z = W + W4F;    // a zero row
  const int n = blockIdx.z;
  const int Hq = 2 * H8, Wq = 2 * W8;
  const int qr0 = blockIdx.y * T4, qc0 = blockIdx.x * T4;
  const int er0 = qr0 / 2 - 2, ec0 = qc0 / 2 - 2;
  const float* yn = y + (size_t)n * H8 * W8 * 128;
  const int8_t* swn = sw2 + (size_t)n * H8 * W8 * 64;

  // y over E (zero outside the image), the projection's record
  for (int i = threadIdx.x; i < EN * 32; i += blockDim.x) {
    const int p = i >> 5, c4 = (i & 31) * 4;
    const int er = er0 + p / ES, ec = ec0 + p % ES;
    float* d = A + p * YS + c4;
    if (inside(er, ec, H8, W8))
      cp_async16(d, yn + ((size_t)er * W8 + ec) * 128 + c4);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < ZF; i += blockDim.x) Z[i] = 0.f;

  // --- Bottleneck4_0 ---------------------------------------------------
  // projection 128 -> 32 over E
  Smem L = stage_layer(W, P.pack, P.l[P40]);
  gemm<2, PASSES, 128>(
      0, EN, 32, 1, L.w, L.ws,
      [&](int p, int) { return p < EN ? A + p * YS : Z; },
      [&](int p, int c, float v0, float v1) {
        const bool in = inside(er0 + p / ES, ec0 + p % ES, H8, W8);
        float* o = Pb + p * PS + c;
        o[0] = in ? prelu(v0 + L.b[c], L.v[c]) : 0.f;
        o[1] = in ? prelu(v1 + L.b[c + 1], L.v[c + 1]) : 0.f;
      });
  // residual: the 1x1 conv 128 -> 64 over E's inner 10x10, unpooled by
  // sw2 into X over R0 (each eighth position's four quarter positions)
  L = stage_layer(W, P.pack, P.l[R40]);
  gemm<2, PASSES, 128>(
      0, 100, 64, 1, L.w, L.ws,
      [&](int p, int) {
        return p < 100 ? A + ((p / 10 + 1) * ES + p % 10 + 1) * YS : Z;
      },
      [&](int p, int c, float v0, float v1) {
        const int u = p / 10, v = p % 10;
        const int er = er0 + 1 + u, ec = ec0 + 1 + v;
        const bool in = inside(er, ec, H8, W8);
        int s0 = -1, s1 = -1;
        if (in) {
          const int8_t* s = swn + ((size_t)er * W8 + ec) * 64 + c;
          s0 = s[0], s1 = s[1];
        }
#pragma unroll
        for (int ph = 0; ph < 4; ++ph) {
          float* o =
              X + ((2 * u + (ph >> 1)) * RS + 2 * v + (ph & 1)) * XS + c;
          o[0] = s0 == ph ? v0 : 0.f;
          o[1] = s1 == ph ? v1 : 0.f;
        }
      });
  // the transposed conv 32 -> 16 from E to R0, one GEMM per phase
  L = stage_layer(W, P.pack, P.l[D40]);
  float* const D = A;
  for (int ph = 0, first = 0; ph < 4; ++ph) {
    const int a = ph >> 1, b = ph & 1, nc = b ? 1 : 2;
    first += gemm<2, PASSES, 32>(
        first, 100, 16, (a ? 1 : 2) * nc, L.w + kPhaseTap[ph] * 32 * L.ws,
        L.ws,
        [&](int p, int t) {
          return p < 100 ? Pb + ((p / 10 + 1 - t / nc) * ES + p % 10 + 1 -
                                 t % nc) * PS
                         : Z;
        },
        [&](int p, int c, float v0, float v1) {
          const int r = 2 * (p / 10) + a, cc = 2 * (p % 10) + b;
          const bool in = inside(qr0 - 2 + r, qc0 - 2 + cc, Hq, Wq);
          float* o = D + (r * RS + cc) * S16 + c;
          o[0] = in ? prelu(v0 + L.b[c], L.v[c]) : 0.f;
          o[1] = in ? prelu(v1 + L.b[c + 1], L.v[c + 1]) : 0.f;
        });
  }
  // expand 16 -> 64, + residual, PReLU, over R0
  L = stage_layer(W, P.pack, P.l[E40]);
  gemm<4, PASSES, 16>(
      0, R0N, 64, 1, L.w, L.ws,
      [&](int p, int) { return p < R0N ? D + p * S16 : Z; },
      [&](int p, int c, float v0, float v1) {
        const bool in = inside(qr0 - 2 + p / RS, qc0 - 2 + p % RS, Hq, Wq);
        float* o = X + p * XS + c;
        o[0] = in ? prelu(v0 + L.b[c] + o[0], L.v[c]) : 0.f;
        o[1] = in ? prelu(v1 + L.b[c + 1] + o[1], L.v[c + 1]) : 0.f;
      });

  // --- Bottleneck4_1 (R0 -> R1), 4_2 (R1 -> R2) -------------------------
  float* const T = A;              // projection over R0's indexing
  float* const U = A + R0N * S16;  // 3x3 conv output over the out rect
  for (int k = 0; k < 2; ++k) {
    const int oi = k, si = RS - 2 * k;          // input rect in R0
    const int oo = k + 1, so = RS - 2 * k - 2;  // output rect in R0
    L = stage_layer(W, P.pack, P.l[P41 + 3 * k]);
    gemm<2, PASSES, 64>(
        0, si * si, 16, 1, L.w, L.ws,
        [&](int p, int) {
          return p < si * si ? X + ((p / si + oi) * RS + p % si + oi) * XS : Z;
        },
        [&](int p, int c, float v0, float v1) {
          const int r = p / si + oi, cc = p % si + oi;
          const bool in = inside(qr0 - 2 + r, qc0 - 2 + cc, Hq, Wq);
          float* o = T + (r * RS + cc) * S16 + c;
          o[0] = in ? prelu(v0 + L.b[c], L.v[c]) : 0.f;
          o[1] = in ? prelu(v1 + L.b[c + 1], L.v[c + 1]) : 0.f;
        });
    L = stage_layer(W, P.pack, P.l[C41 + 3 * k]);
    gemm<2, PASSES, 16>(
        0, so * so, 16, 9, L.w, L.ws,
        [&](int p, int t) {
          return p < so * so ? T + ((p / so + oo + t / 3 - 1) * RS + p % so +
                                    oo + t % 3 - 1) * S16
                             : Z;
        },
        [&](int p, int c, float v0, float v1) {
          const bool in = inside(qr0 - 2 + p / so + oo, qc0 - 2 + p % so + oo,
                                 Hq, Wq);
          float* o = U + p * S16 + c;
          o[0] = in ? prelu(v0 + L.b[c], L.v[c]) : 0.f;
          o[1] = in ? prelu(v1 + L.b[c + 1], L.v[c + 1]) : 0.f;
        });
    L = stage_layer(W, P.pack, P.l[E41 + 3 * k]);
    gemm<4, PASSES, 16>(
        0, so * so, 64, 1, L.w, L.ws,
        [&](int p, int) { return p < so * so ? U + p * S16 : Z; },
        [&](int p, int c, float v0, float v1) {
          const int r = p / so + oo, cc = p % so + oo;
          const bool in = inside(qr0 - 2 + r, qc0 - 2 + cc, Hq, Wq);
          float* o = X + (r * RS + cc) * XS + c;
          o[0] = in ? prelu(v0 + L.b[c] + o[0], L.v[c]) : 0.f;
          o[1] = in ? prelu(v1 + L.b[c + 1] + o[1], L.v[c + 1]) : 0.f;
        });
  }
  __syncthreads();

  // x4 over the tile (R2), inside the image
  float* x4n = x4 + (size_t)n * Hq * Wq * 64;
  for (int i = threadIdx.x; i < T4 * T4 * 16; i += blockDim.x) {
    const int p = i >> 4, c4 = (i & 15) * 4;
    const int r = qr0 + p / T4, c = qc0 + p % T4;
    if (r < Hq && c < Wq)
      *reinterpret_cast<float4*>(x4n + ((size_t)r * Wq + c) * 64 + c4) =
          *reinterpret_cast<const float4*>(
              X + ((p / T4 + 2) * RS + p % T4 + 2) * XS + c4);
  }
}

// -- stage 5 and the Final -------------------------------------------------

constexpr int T5 = 16;            // half-res output tile side
constexpr int T5_THREADS = 256;
constexpr int QS = T5 / 2 + 3;    // quarter-res rectangle side (11)
constexpr int HS = T5 + 4;        // half-res rectangle H0 side (20)
constexpr int H1S = T5 + 1;       // H1 side (17)
constexpr int QN = QS * QS, H0N = HS * HS, H1N = H1S * H1S;
constexpr int S8 = 12, S4 = 4;    // channel strides of 8 and 4 channels
constexpr int A5F = cmax(cmax(QN * XS, H0N * S8),
                         cmax(H0N * S4 + H1N * S4, T5_THREADS));
constexpr int P5F = QN * S16;
constexpr int X5F = H0N * S16;
constexpr int Z5F = 64;
constexpr int T5_FIXED = A5F + P5F + X5F + Z5F;  // floats before W5

struct Tail5Params {
  const float* pack;  // the stage-5 records, from P50 on
  Layer l[NLAYERS - T5_FIRST];  // offsets relative to P50's
  int size;
};

// A pixel's online softmax entropy sums over some of its classes
// (EntropyAcc's, starting empty), and the merge of two of them.
struct Ent {
  float m = 0.f, z = 0.f, s = 0.f;
  __device__ __forceinline__ void add(float l) {
    if (z == 0.f) {
      m = l, z = 1.f, s = 0.f;
    } else if (l > m) {
      const float d = m - l, e = expf(d);
      s = e * (s + d * z);
      z = e * z + 1.f;
      m = l;
    } else {
      const float d = l - m, e = expf(d);
      z += e;
      s += e * d;
    }
  }
  __device__ __forceinline__ void merge(float om, float oz, float os) {
    if (oz == 0.f) return;
    if (z == 0.f) {
      m = om, z = oz, s = os;
      return;
    }
    const float mm = fmaxf(m, om);
    const float d1 = m - mm, d2 = om - mm;
    const float e1 = expf(d1), e2 = expf(d2);
    s = e1 * (s + d1 * z) + e2 * (os + d2 * oz);
    z = e1 * z + e2 * oz;
    m = mm;
  }
};

// The Final 3x3/s2 transposed conv over a tile of TR x T5 half-res
// positions at (r0, c0), and per pixel its confidence 1 - H(softmax)/
// log C (kScore) or its first-max label. Per output phase (a, b) one
// GEMM of [positions x 16*taps] by [16*taps x 8*NTF classes] a chunk of
// classes, over the phase's exact taps (L, the FIN record, n classes
// padded); an item is one tile row of one phase. X1 holds the 16
// channels at stride S16 of the rectangle from (r0 - 1, c0 - 1), P
// positions a row, zero outside the half-res grid (the x[-1] = 0
// edge). Pixels outside the H x Wd image are skipped. Score: returns
// this thread's sum of its pixels' confidences (block_partial adds the
// block's); predict: writes the labels into lab [2TR][2T5].
//
// The score route's Final takes its weights as hi + lo (tc.cuh PASSES
// 2): in one TF32 pass the weights' rounding shifts every pixel's logits
// alike, which the image's mean does not average out, and a saturated
// Final (its kernel x1000) moved an image's score by 3.3e-4 (PERF.md);
// the features' rounding differs by position and averages out.
constexpr int kFinalScorePasses = 2;

template <bool kScore, int PASSES, int NTF, int TR, int P>
__device__ __forceinline__ float final_phases(const float* X1,
                                              const Smem& L, int n, int C,
                                              int r0, int c0, int H, int Wd,
                                              int8_t* lab) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float inv_log_c = kScore ? 1.f / logf((float)C) : 0.f;
  float total = 0.f;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int chunks = n / (8 * NTF);
  for (int it = warp; it < 4 * TR; it += nw) {
    const int ph = it / TR, u = it % TR;
    const int a = ph >> 1, b = ph & 1, nc = b ? 1 : 2, taps = (a ? 1 : 2) * nc;
    const float* wph = L.w + kPhaseTap[ph] * 16 * L.ws;
    Ent ent[2];
    float best[2] = {0.f, 0.f};
    int bidx[2] = {-1, -1};
    for (int ch = 0; ch < chunks; ++ch) {
      const int n0 = ch * 8 * NTF;
      float acc[NTF][4];
#pragma unroll
      for (int j = 0; j < NTF; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int t = 0; t < taps; ++t) {
        // the tap's source: row u - t/nc and column g - t%nc of the tile
        const float* r0p = X1 + ((u + 1 - t / nc) * P + g + 1 - t % nc) * S16;
        const float* r1p = r0p + 8 * S16;
        const float* wt = wph + t * 16 * L.ws;
#pragma unroll
        for (int k = 0; k < 16; k += 8)
          mma_kstep<NTF, PASSES>(acc, r0p[k + q], r1p[k + q], r0p[k + q + 4],
                                 r1p[k + q + 4], wt + k * L.ws, L.ws, n0);
      }
#pragma unroll
      for (int j = 0; j < NTF; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cls = n0 + 8 * j + 2 * q + e;
            const float l = acc[j][2 * h + e];
            if (cls >= C) continue;
            if (kScore)
              ent[h].add(l);
            else if (bidx[h] < 0 || l > best[h])
              best[h] = l, bidx[h] = cls;
          }
    }
    // merge the 4 lanes of each row, then lane q == 0 owns the pixel
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        if (kScore) {
          const float om = __shfl_xor_sync(0xffffffffu, ent[h].m, sh);
          const float oz = __shfl_xor_sync(0xffffffffu, ent[h].z, sh);
          const float os = __shfl_xor_sync(0xffffffffu, ent[h].s, sh);
          // the lower lane's sums first, so both lanes agree bit for bit
          if (q & sh) {
            Ent lo;
            lo.m = om, lo.z = oz, lo.s = os;
            lo.merge(ent[h].m, ent[h].z, ent[h].s);
            ent[h] = lo;
          } else {
            ent[h].merge(om, oz, os);
          }
        } else {
          const float ob = __shfl_xor_sync(0xffffffffu, best[h], sh);
          const int oi = __shfl_xor_sync(0xffffffffu, bidx[h], sh);
          if (oi >= 0 && (bidx[h] < 0 || ob > best[h] ||
                          (ob == best[h] && oi < bidx[h])))
            best[h] = ob, bidx[h] = oi;
        }
      }
      const int v = g + 8 * h;
      const int R = 2 * (r0 + u) + a, Cc = 2 * (c0 + v) + b;
      if (q == 0 && R < H && Cc < Wd) {
        if (kScore)
          total += 1.f + (ent[h].s / ent[h].z - logf(ent[h].z)) * inv_log_c;
        else
          lab[(2 * u + a) * (2 * T5) + 2 * v + b] = (int8_t)bidx[h];
      }
    }
  }
  return total;
}

// One block per (image, 16x16 tile of half-res positions at (hr0,
// hc0)), i.e. 32x32 pixels. Rectangles: Q, quarter res, rows
// hr0/2-2 .. hr0/2+8 (x4 for the projection and, inner 10x10, the
// residual); H0 = half rows hr0-2 .. hr0+17 (B5_0's output); H1 =
// hr0-1 .. hr0+15 (B5_1's output, the Final's input).
template <bool kScore, int PASSES, int NTF>
__global__ void __launch_bounds__(T5_THREADS, 2)
    tail5_kernel(const float* __restrict__ x4, const float* __restrict__ mask1,
                 const Tail5Params P, int8_t* __restrict__ labels,
                 float* __restrict__ partials, int Hq, int Wq, int C) {
  extern __shared__ __align__(16) float smem[];
  float* const A = smem;       // x4 tile [QN][XS]; later D5, T5/U5, labels
  float* const Pb = A + A5F;   // B5_0 projection [QN][S16]
  float* const X = Pb + P5F;   // stage-5 activations over H0 [H0N][S16]
  float* const Z = X + X5F;    // a zero row
  float* const W = Z + Z5F;    // every stage-5 record
  const int n = blockIdx.z;
  const int Hh = 2 * Hq, Wh = 2 * Wq, H = 2 * Hh, Wd = 2 * Wh;
  const int hr0 = blockIdx.y * T5, hc0 = blockIdx.x * T5;
  const int qr0 = hr0 / 2 - 2, qc0 = hc0 / 2 - 2;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float* xn = x4 + (size_t)n * Hq * Wq * 64;
  const float* mn = mask1 + (size_t)n * Hq * Wq * 64;

  for (int i = threadIdx.x; i < QN * 16; i += blockDim.x) {
    const int p = i >> 4, c4 = (i & 15) * 4;
    const int r = qr0 + p / QS, c = qc0 + p % QS;
    float* d = A + p * XS + c4;
    if (inside(r, c, Hq, Wq))
      cp_async16(d, xn + ((size_t)r * Wq + c) * 64 + c4);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_floats(W, P.pack, P.size);
  for (int i = threadIdx.x; i < Z5F; i += blockDim.x) Z[i] = 0.f;
  cp_async_wait_sync();
  const auto layer = [&](int i) {
    return smem_layer(W + P.l[i - T5_FIRST].off, P.l[i - T5_FIRST]);
  };

  // --- Bottleneck5_0 -----------------------------------------------------
  // projection 64 -> 16 over Q; residual 1x1 64 -> 16 over Q's inner
  // 10x10, unpooled by mask1 into X over H0
  const Smem Lp = layer(P50), Lr = layer(R50);
  int first = gemm<2, PASSES, 64>(
      0, QN, 16, 1, Lp.w, Lp.ws,
      [&](int p, int) { return p < QN ? A + p * XS : Z; },
      [&](int p, int c, float v0, float v1) {
        const bool in = inside(qr0 + p / QS, qc0 + p % QS, Hq, Wq);
        float* o = Pb + p * S16 + c;
        o[0] = in ? prelu(v0 + Lp.b[c], Lp.v[c]) : 0.f;
        o[1] = in ? prelu(v1 + Lp.b[c + 1], Lp.v[c + 1]) : 0.f;
      });
  gemm<2, PASSES, 64>(
      first, 100, 16, 1, Lr.w, Lr.ws,
      [&](int p, int) {
        return p < 100 ? A + ((p / 10 + 1) * QS + p % 10 + 1) * XS : Z;
      },
      [&](int p, int c, float v0, float v1) {
        const int u = p / 10, v = p % 10;
        const int r = qr0 + 1 + u, cc = qc0 + 1 + v;
        const bool in = inside(r, cc, Hq, Wq);
        const float* m = mn + ((size_t)r * Wq + cc) * 64 + c;
#pragma unroll
        for (int ph = 0; ph < 4; ++ph) {
          float* o =
              X + ((2 * u + (ph >> 1)) * HS + 2 * v + (ph & 1)) * S16 + c;
          o[0] = in && __ldg(m + 16 * ph) != 0.f ? v0 : 0.f;
          o[1] = in && __ldg(m + 16 * ph + 1) != 0.f ? v1 : 0.f;
        }
      });
  __syncthreads();
  // the transposed conv 16 -> 8 from Q to H0, one GEMM per phase
  float* const D = A;
  {
    const Smem L = layer(D50);
    first = 0;
    for (int ph = 0; ph < 4; ++ph) {
      const int a = ph >> 1, b = ph & 1, nc = b ? 1 : 2;
      first += gemm<1, PASSES, 16>(
          first, 100, 8, (a ? 1 : 2) * nc, L.w + kPhaseTap[ph] * 16 * L.ws,
          L.ws,
          [&](int p, int t) {
            return p < 100 ? Pb + ((p / 10 + 1 - t / nc) * QS + p % 10 + 1 -
                                   t % nc) * S16
                           : Z;
          },
          [&](int p, int c, float v0, float v1) {
            const int r = 2 * (p / 10) + a, cc = 2 * (p % 10) + b;
            const bool in = inside(hr0 - 2 + r, hc0 - 2 + cc, Hh, Wh);
            float* o = D + (r * HS + cc) * S8 + c;
            o[0] = in ? prelu(v0 + L.b[c], L.v[c]) : 0.f;
            o[1] = in ? prelu(v1 + L.b[c + 1], L.v[c + 1]) : 0.f;
          });
    }
  }
  __syncthreads();
  // expand 8 -> 16, + residual, PReLU, over H0
  {
    const Smem L = layer(E50);
    gemm<2, PASSES, 8>(
        0, H0N, 16, 1, L.w, L.ws,
        [&](int p, int) { return p < H0N ? D + p * S8 : Z; },
        [&](int p, int c, float v0, float v1) {
          const bool in = inside(hr0 - 2 + p / HS, hc0 - 2 + p % HS, Hh, Wh);
          float* o = X + p * S16 + c;
          o[0] = in ? prelu(v0 + L.b[c] + o[0], L.v[c]) : 0.f;
          o[1] = in ? prelu(v1 + L.b[c + 1] + o[1], L.v[c + 1]) : 0.f;
        });
  }
  __syncthreads();

  // --- Bottleneck5_1 -----------------------------------------------------
  float* const T = A;              // projection over H0 [H0N][S4]
  float* const U = A + H0N * S4;   // 3x3 conv over H1 [H1N][S4]
  {
    const Smem L = layer(P51);  // 16 -> 4, N padded to 8
    gemm<1, PASSES, 16>(
        0, H0N, 8, 1, L.w, L.ws,
        [&](int p, int) { return p < H0N ? X + p * S16 : Z; },
        [&](int p, int c, float v0, float v1) {
          if (c >= 4) return;
          const bool in = inside(hr0 - 2 + p / HS, hc0 - 2 + p % HS, Hh, Wh);
          float* o = T + p * S4 + c;
          o[0] = in ? prelu(v0 + L.b[c], L.v[c]) : 0.f;
          o[1] = in ? prelu(v1 + L.b[c + 1], L.v[c + 1]) : 0.f;
        });
  }
  __syncthreads();
  {
    // the 3x3 conv 4 -> 4 over H1 as K = 40: k = tap * 4 + channel, so
    // that a k-step takes taps 2s (columns 0-3) and 2s+1 (4-7)
    const Smem L = layer(C51);
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const auto tap_row = [&](int p, int t) -> const float* {
      if (p >= H1N || t >= 9) return Z;
      return T + ((p / H1S + t / 3) * HS + p % H1S + t % 3) * S4;
    };
    for (int it = warp; it < (H1N + 15) / 16; it += nw) {
      const int p0 = it * 16;
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int s = 0; s < 5; ++s)
        mma_kstep<1, PASSES>(acc, tap_row(p0 + g, 2 * s)[q],
                             tap_row(p0 + g + 8, 2 * s)[q],
                             tap_row(p0 + g, 2 * s + 1)[q],
                             tap_row(p0 + g + 8, 2 * s + 1)[q],
                             L.w + 8 * s * L.ws, L.ws, 0);
      const int c = 2 * q;
      if (c < 4) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + g + 8 * h;
          if (p >= H1N) continue;
          const bool in =
              inside(hr0 - 1 + p / H1S, hc0 - 1 + p % H1S, Hh, Wh);
          float* o = U + p * S4 + c;
          o[0] = in ? prelu(acc[0][2 * h] + L.b[c], L.v[c]) : 0.f;
          o[1] = in ? prelu(acc[0][2 * h + 1] + L.b[c + 1], L.v[c + 1]) : 0.f;
        }
      }
    }
  }
  __syncthreads();
  {
    // expand 4 -> 16 (K padded to 8 with zero columns), + residual,
    // PReLU, over H1
    const Smem L = layer(E51);
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    for (int it = warp; it < (H1N + 15) / 16; it += nw) {
      const int p0 = it * 16;
      const float* r0 = p0 + g < H1N ? U + (p0 + g) * S4 : Z;
      const float* r1 = p0 + g + 8 < H1N ? U + (p0 + g + 8) * S4 : Z;
      float acc[2][4] = {};
      mma_kstep<2, PASSES>(acc, r0[q], r1[q], 0.f, 0.f, L.w, L.ws, 0);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + g + 8 * h, c = 8 * j + 2 * q;
          if (p >= H1N) continue;
          const int r = p / H1S + 1, cc = p % H1S + 1;
          const bool in = inside(hr0 - 2 + r, hc0 - 2 + cc, Hh, Wh);
          float* o = X + (r * HS + cc) * S16 + c;
          o[0] = in ? prelu(acc[j][2 * h] + L.b[c] + o[0], L.v[c]) : 0.f;
          o[1] = in ? prelu(acc[j][2 * h + 1] + L.b[c + 1] + o[1],
                            L.v[c + 1]) : 0.f;
        }
    }
  }
  __syncthreads();

  // --- Final ------------------------------------------------------------
  int8_t* const lab = reinterpret_cast<int8_t*>(A);  // [2*T5][2*T5]
  const float total =
      final_phases<kScore, kScore ? kFinalScorePasses : PASSES, NTF, T5, HS>(
      X + (HS + 1) * S16, layer(FIN), P.l[FIN - T5_FIRST].n, C, hr0, hc0, H,
      Wd, lab);
  if (kScore) {
    block_partial(total, A,
                  partials + ((size_t)n * gridDim.y + blockIdx.y) * gridDim.x +
                      blockIdx.x);
  } else {
    __syncthreads();
    // the tile's labels in 8-byte row pieces (W % 8 == 0: a piece is
    // wholly inside the image or wholly outside)
    int8_t* ln = labels + (size_t)n * H * Wd;
    for (int k = threadIdx.x; k < 2 * T5 * (2 * T5 / 8); k += blockDim.x) {
      const int row = k / (2 * T5 / 8), c8 = k % (2 * T5 / 8) * 8;
      const int R = 2 * hr0 + row, Cc = 2 * hc0 + c8;
      if (R < H && Cc < Wd)
        *reinterpret_cast<uint2*>(ln + (size_t)R * Wd + Cc) =
            *reinterpret_cast<const uint2*>(lab + row * 2 * T5 + c8);
    }
  }
}

// -- the deconv score kernel ------------------------------------------------

// A block's tile: DECONV_ROWS x T5 half-res positions, one block a
// tile, at least DECONV_BLOCKS blocks an SM (tools/probe_tail.py
// --deconv-tile rebuilds this line). 16x16 with 4 blocks an SM (at most
// 64 registers, 38 KB each at 19 classes) measured fastest against
// 16x16 and 32x16 with 3 (PERF.md).
constexpr int DECONV_ROWS = 16, DECONV_BLOCKS = 4;
constexpr int DX = (DECONV_ROWS + 1) * (T5 + 1);  // staged positions
constexpr int DECONV_FIXED = DX * S16 + T5_THREADS;  // floats before W

// Block t takes tile t (image, tile row, tile column) and writes
// partials[t] ([N, tiles an image]). It stages the FIN record (L, its
// offset 0) and the features over its rectangle from (r0 - 1, c0 - 1),
// zero outside the half-res grid.
template <int PASSES, int NTF>
__global__ void __launch_bounds__(T5_THREADS, DECONV_BLOCKS)
    deconv_score_kernel(const float* __restrict__ x,
                        const float* __restrict__ fin, const Layer L,
                        float* __restrict__ partials, int H2, int W2,
                        int C) {
  extern __shared__ __align__(16) float smem[];
  float* const X = smem;                   // features [DX][S16]
  float* const slots = X + DX * S16;       // block_partial's
  float* const W = slots + T5_THREADS;     // the FIN record
  const int tx = (W2 + T5 - 1) / T5;
  const int ty = (H2 + DECONV_ROWS - 1) / DECONV_ROWS;
  const int t = blockIdx.x, n = t / (ty * tx);
  const int r0 = t / tx % ty * DECONV_ROWS, c0 = t % tx * T5;
  const float* xn = x + (size_t)n * H2 * W2 * 16;
  cp_async_floats(W, fin, L.wsize());
  for (int i = threadIdx.x; i < DX * 4; i += blockDim.x) {
    const int p = i >> 2, c4 = (i & 3) * 4;
    const int r = r0 - 1 + p / (T5 + 1), c = c0 - 1 + p % (T5 + 1);
    float* d = X + p * S16 + c4;
    if (inside(r, c, H2, W2))
      cp_async16(d, xn + ((size_t)r * W2 + c) * 16 + c4);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_wait_sync();
  const float v = final_phases<true, PASSES, NTF, DECONV_ROWS, T5 + 1>(
      X, smem_layer(W, L), L.n, C, r0, c0, 2 * H2, 2 * W2, nullptr);
  block_partial(v, slots, partials + t);
}

// -- launches --------------------------------------------------------------

size_t tail5_smem(const Layout& L) {
  return (size_t)(T5_FIXED + L.size - L.l[T5_FIRST].off) * 4;
}

// mma passes of each route: one TF32 pass moves a few decided labels of
// a 1024x2048 batch but keeps scores within 2e-5 of fp32's (PERF.md);
// the score route's Final: kFinalScorePasses
constexpr int kPredictPasses = 3, kScorePasses = 1;

int launch_stage4(const float* y, const int8_t* sw2, const float* pack,
                  float* x4, int n, int h8, int w8, bool score,
                  cudaStream_t stream) {
  const Layout L = tail_layout(1);
  Tail4Params P;
  P.pack = pack;
  for (int i = 0; i < T5_FIRST; ++i) P.l[i] = L.l[i];
  const dim3 grid((2 * w8 + T4 - 1) / T4, (2 * h8 + T4 - 1) / T4, n);
  const auto k = score ? tail4_kernel<kScorePasses>
                       : tail4_kernel<kPredictPasses>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)T4_SMEM);
  k<<<grid, T4_THREADS, T4_SMEM, stream>>>(y, sw2, P, x4, h8, w8);
  return (int)cudaGetLastError();
}

// tail5_kernel for c classes (final_ntf(c) n-tiles a chunk)
template <bool kScore, int PASSES>
auto tail5_for(int c) {
  switch (final_ntf(c)) {
    case 1: return tail5_kernel<kScore, PASSES, 1>;
    case 2: return tail5_kernel<kScore, PASSES, 2>;
    case 3: return tail5_kernel<kScore, PASSES, 3>;
    default: return tail5_kernel<kScore, PASSES, 4>;
  }
}

template <bool kScore>
int launch_stage5(const float* x4, const float* mask1, const float* pack,
                  int8_t* labels, float* partials, int n, int h8, int w8,
                  int c, cudaStream_t stream) {
  const Layout L = tail_layout(c);
  Tail5Params P;
  const int base = L.l[T5_FIRST].off;
  P.pack = pack + base;
  for (int i = T5_FIRST; i < NLAYERS; ++i) {
    P.l[i - T5_FIRST] = L.l[i];
    P.l[i - T5_FIRST].off -= base;
  }
  P.size = L.size - base;
  const size_t smem = tail5_smem(L);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const dim3 grid((4 * w8 + T5 - 1) / T5, (4 * h8 + T5 - 1) / T5, n);
  const auto k =
      tail5_for<kScore, kScore ? kScorePasses : kPredictPasses>(c);
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  k<<<grid, T5_THREADS, smem, stream>>>(x4, mask1, P, labels, partials,
                                        2 * h8, 2 * w8, c);
  return (int)cudaGetLastError();
}

// deconv_score_kernel for c classes, the Final as the score route takes
// it (kFinalScorePasses)
auto deconv_for(int c) {
  switch (final_ntf(c)) {
    case 1: return deconv_score_kernel<kFinalScorePasses, 1>;
    case 2: return deconv_score_kernel<kFinalScorePasses, 2>;
    case 3: return deconv_score_kernel<kFinalScorePasses, 3>;
    default: return deconv_score_kernel<kFinalScorePasses, 4>;
  }
}

int launch_deconv(const float* x, const float* fin, float* partials, int n,
                  int h2, int w2, int c, cudaStream_t stream) {
  const Layer L = tail_layout(c).l[FIN];
  const size_t smem = (size_t)(DECONV_FIXED + L.wsize()) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const auto k = deconv_for(c);
  // the bytes each instance may take so far, by device: the attribute is
  // set once an instance, device and larger size, not on every launch
  static int allowed[16][4];
  int dev = 0;
  cudaGetDevice(&dev);
  int* const a = dev < 16 ? &allowed[dev][final_ntf(c) - 1] : nullptr;
  if (!a || (int)smem > *a) {
    const int status = (int)cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (status) return status;
    if (a) *a = (int)smem;
  }
  const int tiles = n * ((h2 + DECONV_ROWS - 1) / DECONV_ROWS) *
                    ((w2 + T5 - 1) / T5);
  k<<<tiles, T5_THREADS, smem, stream>>>(x, fin, L, partials, h2, w2, c);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ssal

using namespace ssal;

extern "C" int ssal_tail_pack_size(int num_classes) {
  return tail_layout(num_classes).size;
}

// Partial sums of ssal_tail_decode_score per image.
extern "C" int ssal_tail_partials(int h8, int w8) {
  return ((4 * h8 + T5 - 1) / T5) * ((4 * w8 + T5 - 1) / T5);
}

// y [N,H8,W8,128], sw2 int8 [N,H8,W8,64] -> x4 [N,2H8,2W8,64] (stage 4).
// score: at the score route's precision, else the predict route's.
extern "C" int ssal_tail_stage4(const float* y, const int8_t* sw2,
                                const float* pack, float* x4, int n, int h8,
                                int w8, int score, void* stream) {
  return launch_stage4(y, sw2, pack, x4, n, h8, w8, score != 0,
                       (cudaStream_t)stream);
}

// x4 [N,2H8,2W8,64], mask1 [N,2H8,2W8,64] -> labels int8 [N,8H8,8W8];
// num_classes <= 127.
extern "C" int ssal_tail_decode_predict(const float* x4, const float* mask1,
                                        const float* pack, int8_t* labels,
                                        int n, int h8, int w8,
                                        int num_classes, void* stream) {
  return launch_stage5<false>(x4, mask1, pack, labels, nullptr, n, h8, w8,
                              num_classes, (cudaStream_t)stream);
}

// The same inputs -> partials [N, ssal_tail_partials(h8, w8)]: sums of
// the pixels' entropy confidences, one per block.
extern "C" int ssal_tail_decode_score(const float* x4, const float* mask1,
                                      const float* pack, float* partials,
                                      int n, int h8, int w8,
                                      int num_classes, void* stream) {
  return launch_stage5<true>(x4, mask1, pack, nullptr, partials, n, h8, w8,
                             num_classes, (cudaStream_t)stream);
}

// Partial sums of ssal_deconv_score per image: one per tile.
extern "C" int ssal_deconv_partials(int h2, int w2) {
  return ((h2 + DECONV_ROWS - 1) / DECONV_ROWS) * ((w2 + T5 - 1) / T5);
}

// features [N,H2,W2,16], the Final's record (tail.py pack_final for
// num_classes) -> partials [N, ssal_deconv_partials(h2, w2)]: sums of the
// pixels' entropy confidences, one per tile.
extern "C" int ssal_deconv_score(const float* x, const float* final_record,
                                 float* partials, int n, int h2, int w2,
                                 int num_classes, void* stream) {
  return launch_deconv(x, final_record, partials, n, h2, w2, num_classes,
                       (cudaStream_t)stream);
}
