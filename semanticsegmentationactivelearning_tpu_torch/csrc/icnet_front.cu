// ICNet front: image -> Branch1's f1 and either the half-resolution image
// (front) or the pooled stem features (front + stem).
//
// Replaces fused_icnet_front (ops/pallas_kernels.py:3189, body
// _icnet_front_kernel :3167): image [N,H,W,3] -> f1 [N,H/8,W/8,64] and
// x_half [N,H/2,W/2,3]; and fused_icnet_front_stem (:3346, body
// _icnet_front_stem_kernel :3289): image -> f1 and stem1
// [N,H/8,W/8,64], the SharedStem's conv1_1 (s2) -> conv1_2 -> conv1_3 ->
// 3x3/s2 max pool on the half-res image. Branch1 is three 3x3/s2
// conv-BN-ReLU layers (3->32->32->64). Every stride-2 SAME conv pads
// (0, 1) (pallas_kernels.py:2913). The 2x downsample is
// jax.image.resize's antialiased bilinear: taps (1, 3, 3, 1)/8 on image
// rows and columns 2i-1..2i+2, renormalized to (3, 3, 1)/7 at the first
// and last half row and column (:2921-2926). Half-res rows outside the
// image are zero for conv1_1's SAME padding, which is not the resize's
// own edge rule. The max pool's padded row and column at the high edge
// hold 0, which is max-neutral only because the values are post-ReLU.
//
// What bounds it on an H100: its products. Per 1024x2048 image Branch1
// does 2.27 G multiply-adds and the stem 3.74 G (90% of them in the four
// K = 288 convs), 12.0 GFLOP: 0.194 ms at batch 8 in one TF32 pass
// (495 TFLOP/s), 0.146 ms at batch 2 in 3xTF32, against 25 MB read and
// 4 MB written per image (0.06 ms at batch 8 and 3.35 TB/s).
//
// Design. Every conv is a GEMM on the tensor cores (tc.cuh mma.sync
// m16n8k8, fp32 accumulation), once (TF32) or as 3xTF32 (kScorePasses,
// kPredictPasses; ops/kernels/icnet_front.py PRECISION), from BN-folded
// GEMM records (ops/kernels/icnet_front.py pack_icnet_front): the K = 27
// convs (Branch1_1, conv1_1) as one tap of K padded to 32, each lane
// reading its A values at (dy, dx, c) offsets into the staged 3-channel
// pixels; the K = 288 convs as implicit GEMMs of 9 taps x 32 channels.
// Each warp holds the accumulators of its row tiles (16 positions) for
// one group of columns, so that a B fragment read serves all of its row
// tiles, while the records' taps stream through a 4-slot cp.async ring
// (one tap, 32 k rows, a slot), across a kernel's layers without a
// drain. The downsample and the pool stay fp32 on the CUDA cores. Blocks
// of 16 warps, one an SM (164-196 KB of shared memory); each layer
// writes its output rectangle, zero outside its grid (the SAME padding),
// into a shared-memory buffer that the next layer reads, the last one to
// global memory. Channel strides of 38 (read at stride 2) and 36 (at
// stride 1) keep the A reads of a warp on 32 banks; the record strides
// 40 and 72 its B reads.
//
// Three kernels:
//   - branch1_kernel<kHalf>: a 4x8 eighth-res tile: the image window
//     (cp.async, zero-filled), Branch1_1 over the 19x35 half-res
//     rectangle under it, Branch1_2 over 9x17 quarter positions, Branch1_3
//     -> f1; kHalf also writes the tile's x_half (the front's second
//     output): the front is this one launch;
//   - stem12_kernel: a 16x32 quarter-res tile: the image window, the
//     half-res window, conv1_1 over 18x34, conv1_2 -> c12 [N, H/4, W/4,
//     32] in device memory;
//   - stem3_kernel: an 8x8 eighth-res tile: c12 over 19x19, conv1_3 over
//     17x17, the pool -> stem1.
// The front + stem is the three launches. The stem's halo of 5 quarter
// positions (conv1_1 s2 -> conv1_2 -> conv1_3 -> pool) is cut after
// conv1_2, where it costs most: c12 goes through device memory (134 MB
// written and 1.4x that read at batch 8), and the stem recomputes 1.09x
// its least work instead of 1.24x in one launch a tile. tools/probe_icnet_front.py
// measured that split fastest on the H100 on both routes, ahead of the
// stem in one 8x8 launch and of Branch1 and the stem in one 4x8 launch a
// tile (PERF.md).
#include "common.cuh"
#include "tc.cuh"

namespace ssal {
namespace {

constexpr int THREADS = 512;          // 16 warps
constexpr int KR = 32;                // a record's k rows a tap
constexpr int WS32 = 40, WS64 = 72;   // record strides (bstride(32), (64))
constexpr int STAGES = 4;             // the ring's slots, one tap each
constexpr int SLOT_F = KR * WS64;
constexpr int RING_F = STAGES * SLOT_F;
// Channel strides of the 32-channel buffers: a warp's A reads (8
// positions x 4 channels) then hit 32 banks, read at stride 2 (2 x 38 = 12
// mod 32) or 1 (36 = 4 mod 32); conv1_3's 64 channels at 68 (4 mod 32):
// at 64 a warp's float2 epilogue stores would pile onto 8 banks.
constexpr int CS2 = 38;
constexpr int CS1 = 36;
constexpr int CS13 = 68;
__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int cmax(int a, int b) {
  return a > b ? a : b;
}

// -- the pack ------------------------------------------------------------------
// One GEMM record (tc.cuh Layer) per conv, BN folded: Branch1_1, 1_2,
// 1_3, then conv1_1, 1_2, 1_3. A K = 27 conv: [32][40] (k = 9 dy + 3 dx
// + c, rows 27..31 zero) + its bias [32]; a K = 288 conv: [9 taps][32][s]
// (s = 40 for 32 outputs, 72 for 64) + its bias.
constexpr int REC27_F = KR * WS32 + 32;
constexpr int REC32_F = 9 * KR * WS32 + 32;
constexpr int REC64_F = 9 * KR * WS64 + 64;
constexpr int BRANCH_F = REC27_F + REC32_F + REC64_F;
constexpr int PACK_F = 2 * BRANCH_F;
constexpr int B11 = 0, B12 = REC27_F, B13 = B12 + REC32_F;
constexpr int S11 = BRANCH_F, S12 = S11 + REC27_F, S13 = S12 + REC32_F;
static_assert(REC27_F % 4 == 0 && REC32_F % 4 == 0 && REC64_F % 4 == 0,
              "records on 16-byte boundaries");

// -- the image and the downsample --------------------------------------------

// Image rows y0 .. y0+rows-1, columns x0 .. x0+cols-1 of `im` (H x W x 3)
// into S (row stride 3 cols), zero outside the image; one cp.async group.
__device__ void stage_image(float* S, const float* im, int y0, int x0,
                            int rows, int cols, int H, int W) {
  const int rs = 3 * cols;
  for (int i = threadIdx.x; i < rows * rs; i += blockDim.x) {
    const int r = i / rs, f = i - r * rs;
    const int y = y0 + r, x = x0 + f / 3;
    const bool in = inside(y, x, H, W);
    cp_async4(S + i, in ? im + ((size_t)y * W + x) * 3 + f % 3 : im, in);
  }
  cp_async_commit();
}

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

// Half-res pixel (i, j), channel ch, from a staged image window whose
// top-left pixel is image (sy0, sx0) (row stride rs); zero outside the
// H2 x W2 grid.
__device__ __forceinline__ float half_px(const float* S, int rs, int sy0,
                                         int sx0, int i, int j, int ch,
                                         int H2, int W2) {
  if (!inside(i, j, H2, W2)) return 0.f;
  float wr[4], wc[4];
  tent(i, H2, wr);
  tent(j, W2, wc);
  const float* base = S + (2 * i - 1 - sy0) * rs + (2 * j - 1 - sx0) * 3 + ch;
  float v = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float* row = base + a * rs;
    float rv = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) rv += wc[b] * row[3 * b];
    v += wr[a] * rv;
  }
  return v;
}

// XH[(li * cols + lj) * 3 + ch] = half_px(i0 + li, j0 + lj, ch).
__device__ void downsample(float* XH, int i0, int j0, int rows, int cols,
                           const float* S, int rs, int sy0, int sx0, int H2,
                           int W2) {
  for (int t = threadIdx.x; t < rows * cols * 3; t += blockDim.x) {
    const int p = t / 3;
    XH[t] = half_px(S, rs, sy0, sx0, i0 + p / cols, j0 + p % cols, t % 3, H2,
                    W2);
  }
}

// -- the GEMMs -------------------------------------------------------------------
//
// A layer's M positions are cut into row tiles of 16 and its N columns into
// groups of 8NT; each warp takes one column group (warp % NG) and the row
// tiles warp / NG + i * (16 / NG), i < J (at most J; `rows` of them exist),
// keeping their accumulators, so that each B fragment read serves all of
// the warp's row tiles and each A fragment all of its NT column tiles.

// The row tiles a warp owns: their count and, per tile i, rows g and g+8's
// positions (clamped to M - 1: their products are never stored).
template <int J, int NG>
struct Rows {
  int n0, rows, p0[J], p[J][2];
  __device__ __forceinline__ Rows(int M, int nt8) {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
    const int step = (THREADS / 32) / NG, rtiles = (M + 15) / 16;
    n0 = warp % NG * nt8;
    rows = 0;
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int rt = warp / NG + i * step;
      if (rt < rtiles) rows = i + 1;
      p0[i] = rt * 16;
      p[i][0] = min(p0[i] + g, M - 1);
      p[i][1] = min(p0[i] + g + 8, M - 1);
    }
  }
};

// out(p, n, v0, v1) for columns n, n+1 of the rows p < M of the warp's
// row tiles.
template <int J, int NT, int NG, class Out>
__device__ __forceinline__ void store_rows(const Rows<J, NG>& R,
                                           const float (&acc)[J][NT][4],
                                           int M, Out out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < J; ++i) {
    if (i >= R.rows) break;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = R.p0[i] + g + 8 * h;
        if (p < M)
          out(p, R.n0 + 8 * j + 2 * q, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  }
}

// Row tiles for M positions in warps of 16 / NG (the J of Rows).
__host__ __device__ constexpr int row_tiles(int M, int NG) {
  return ((M + 15) / 16 + 16 / NG - 1) / (16 / NG);
}

// A 3x3/s2 conv of 3 channels (K = 27, padded to 32) -> 32 as one GEMM
// over the M positions of a rectangle of width bw: position p reads the
// pixels S[(2 (p / bw) + oy + dy) rs + (2 (p % bw) + ox + dx) 3 + c] at
// k = 9 dy + 3 dx + c, the record W's row order (in shared memory); all
// 32 columns a warp (NT = 4).
template <int M, int PASSES, class Out>
__device__ void conv27(const float* S, int rs, int oy, int ox, int bw,
                       const float* W, Out out) {
  constexpr int J = row_tiles(M, 1);
  const int q = threadIdx.x & 3;
  const Rows<J, 1> R(M, 32);
  int ko[4][2];  // the offsets of k = 8s + q and 8s + q + 4
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 8 * s + q + 4 * h;
      ko[s][h] = k < 27 ? (k / 9) * rs + k % 9 : 0;  // rows 27..31: zero
    }
  const float* base[J][2];
  float acc[J][4][4];
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = R.p[i][h];
      base[i][h] = S + (2 * (p / bw) + oy) * rs + (2 * (p % bw) + ox) * 3;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  if (!R.rows) return;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    float a[J][4];
#pragma unroll
    for (int i = 0; i < J; ++i) {
      a[i][0] = base[i][0][ko[s][0]], a[i][1] = base[i][1][ko[s][0]];
      a[i][2] = base[i][0][ko[s][1]], a[i][3] = base[i][1][ko[s][1]];
    }
    mma_kstep_rows<J, 4, PASSES>(acc, a, W + 8 * s * WS32, WS32, 0, R.rows);
  }
  store_rows(R, acc, M, out);
}

// The ring: a kernel's K = 288 layers stream their records' taps (32 k
// rows each) through STAGES slots in one sequence, global tap g in slot g
// % STAGES, one cp.async group a tap, STAGES - 1 taps ahead of the one in
// use, across layer boundaries. ring_start issues taps 0 .. STAGES-2 of
// the first layer's record (stride ws).
__device__ void ring_start(float* ring, const float* rec, int ws) {
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    cp_async_floats(ring + t * SLOT_F, rec + t * KR * ws, KR * ws);
    cp_async_commit();
  }
}

// A 3x3 conv 32 -> N (K = 9 taps x 32) as an implicit GEMM over the M
// positions of a rectangle of width bw: position p's tap t reads the 32
// channels at X + ((s (p / bw) + t / 3) xw + s (p % bw) + t % 3) cs, for
// stride s. Its taps are global taps g0 .. g0+8 of the ring; `next` (if
// not null, stride next_ws) is the following layer's record, whose first
// taps this layer issues. out(p, n, v0, v1) for p < M at the end, with no
// barrier: the caller syncs before the output is read.
template <int N, int NT, int M, int PASSES, class Out>
__device__ void conv288(float* ring, int g0, const float* rec,
                        const float* next, int next_ws, const float* X,
                        int xw, int cs, int s, int bw, Out out) {
  constexpr int WS = N == 32 ? WS32 : WS64;
  constexpr int NG = N / (8 * NT), J = row_tiles(M, NG);
  static_assert(16 % NG == 0, "a warp's row tiles share their columns");
  const int q = threadIdx.x & 3;
  const Rows<J, NG> R(M, 8 * NT);
  int off[J][2];
  float acc[J][NT][4];
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = R.p[i][h];
      off[i][h] = (s * (p / bw) * xw + s * (p % bw)) * cs;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  for (int t = 0; t < 9; ++t) {
    cp_async_wait_group_sync<STAGES - 2>();  // tap t is in; t-1 done
    const int ahead = t + STAGES - 1;
    float* slot = ring + (g0 + ahead) % STAGES * SLOT_F;
    if (ahead < 9)
      cp_async_floats(slot, rec + ahead * KR * WS, KR * WS);
    else if (next)
      cp_async_floats(slot, next + (ahead - 9) * KR * next_ws, KR * next_ws);
    cp_async_commit();
    if (!R.rows) continue;
    const float* w = ring + (g0 + t) % STAGES * SLOT_F;
    const int toff = ((t / 3) * xw + t % 3) * cs;
#pragma unroll
    for (int k = 0; k < KR; k += 8) {
      float a[J][4];
#pragma unroll
      for (int i = 0; i < J; ++i) {
        const float* a0 = X + off[i][0] + toff + k + q;
        const float* a1 = X + off[i][1] + toff + k + q;
        a[i][0] = a0[0], a[i][1] = a1[0], a[i][2] = a0[4], a[i][3] = a1[4];
      }
      mma_kstep_rows<J, NT, PASSES>(acc, a, w + k * WS, WS, R.n0, R.rows);
    }
  }
  store_rows(R, acc, M, out);
}

// The epilogue of a conv into a shared-memory buffer over the rectangle
// {r0, c0, *, bw} of a gh x gw grid at channel stride cs: bias + ReLU,
// zero outside the grid. The bias lies in global or shared memory.
__device__ __forceinline__ void put(float* buf, int cs, int r0, int c0, int bw,
                                    int gh, int gw, const float* bias, int p,
                                    int n, float v0, float v1) {
  const bool in = inside(r0 + p / bw, c0 + p % bw, gh, gw);
  *reinterpret_cast<float2*>(buf + p * cs + n) =
      in ? make_float2(fmaxf(v0 + bias[n], 0.f),
                       fmaxf(v1 + bias[n + 1], 0.f))
         : make_float2(0.f, 0.f);
}

// The same into an [*, gh, gw, ch] tensor of global memory (`dst` at the
// image), in-grid positions only.
__device__ __forceinline__ void put_global(float* dst, int ch, int r0, int c0,
                                           int bw, int gh, int gw,
                                           const float* bias, int p, int n,
                                           float v0, float v1) {
  const int r = r0 + p / bw, c = c0 + p % bw;
  if (r < gh && c < gw)
    *reinterpret_cast<float2*>(dst + ((size_t)r * gw + c) * ch + n) =
        make_float2(fmaxf(v0 + bias[n], 0.f),
                    fmaxf(v1 + bias[n + 1], 0.f));
}

// -- Branch1 ---------------------------------------------------------------------

namespace b1k {  // branch1_kernel's tile and buffers
constexpr int TR = 4, TC = 8;                                 // eighth-res
constexpr int IH = 8 * TR + 8, IW = 8 * TC + 8, RS = 3 * IW;  // from 8R0-1
constexpr int BW1 = 4 * TC + 3, M1 = (4 * TR + 3) * BW1;  // from 4R0, 4C0
constexpr int BW2 = 2 * TC + 1, M2 = (2 * TR + 1) * BW2;  // from 2R0, 2C0
constexpr int IMG_F = IH * RS;
constexpr int B1_F = up4(M1 * CS2), B2_F = up4(M2 * CS2);
constexpr int S_F = cmax(IMG_F, B2_F);
constexpr int SMEM_F = S_F + B1_F + REC27_F + RING_F;
}  // namespace b1k

// One block per (image, 4x8 eighth-res tile {R0, C0}): the image window
// from image row 8R0-1, column 8C0-1 (S), Branch1_1 -> B1 (the half-res
// rectangle from (4R0, 4C0)), with kHalf the tile's x_half from S, then
// Branch1_2 -> B2 (quarter-res from (2R0, 2C0), over S), Branch1_3 -> f1;
// Branch1_3's taps follow Branch1_2's in the ring.
template <bool kHalf, int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
    branch1_kernel(const float* __restrict__ image,
                   const float* __restrict__ pack, float* __restrict__ f1,
                   float* __restrict__ x_half, int H, int W) {
  using namespace b1k;
  extern __shared__ __align__(16) float smem[];
  float* const S = smem;  // the image window, then Branch1_2's output
  float* const B1 = S + S_F;
  float* const W11 = B1 + B1_F;
  float* const ring = W11 + REC27_F;
  const int n = blockIdx.z;
  const int R0 = blockIdx.y * TR, C0 = blockIdx.x * TC;
  const int H2 = H / 2, W2 = W / 2;
  const float* rec2 = pack + B12;
  const float* rec3 = pack + B13;
  cp_async_floats(W11, pack + B11, REC27_F);
  stage_image(S, image + (size_t)n * H * W * 3, 8 * R0 - 1, 8 * C0 - 1, IH,
              IW, H, W);
  ring_start(ring, rec2, WS32);
  cp_async_wait_group_sync<STAGES - 1>();  // the image and W11
  conv27<M1, PASSES>(S, RS, 1, 1, BW1, W11,
                     [&](int p, int c, float v0, float v1) {
                       put(B1, CS2, 4 * R0, 4 * C0, BW1, H2, W2,
                           W11 + KR * WS32, p, c, v0, v1);
                     });
  if (kHalf) {  // the tile's half rows 4R0 .. 4R0+4TR-1
    float* const xh = x_half + (size_t)n * H2 * W2 * 3;
    for (int t = threadIdx.x; t < 16 * TR * TC * 3; t += blockDim.x) {
      const int p = t / 3;
      const int i = 4 * R0 + p / (4 * TC), j = 4 * C0 + p % (4 * TC);
      if (i < H2 && j < W2)
        xh[((size_t)i * W2 + j) * 3 + t % 3] =
            half_px(S, RS, 8 * R0 - 1, 8 * C0 - 1, i, j, t % 3, H2, W2);
    }
  }
  __syncthreads();
  float* const B2 = S;
  conv288<32, 2, M2, PASSES>(
      ring, 0, rec2, rec3, WS64, B1, BW1, CS2, 2, BW2,
      [&](int p, int c, float v0, float v1) {
        put(B2, CS2, 2 * R0, 2 * C0, BW2, H / 4, W / 4, rec2 + 9 * KR * WS32,
            p, c, v0, v1);
      });
  __syncthreads();
  float* const f1n = f1 + (size_t)n * (H / 8) * (W / 8) * 64;
  conv288<64, 1, TR * TC, PASSES>(
      ring, 9, rec3, nullptr, 0, B2, BW2, CS2, 2, TC,
      [&](int p, int c, float v0, float v1) {
        put_global(f1n, 64, R0, C0, TC, H / 8, W / 8, rec3 + 9 * KR * WS64, p,
                   c, v0, v1);
      });
}

// -- the stem --------------------------------------------------------------------

namespace s12 {  // stem12_kernel's quarter-res tile and buffers
constexpr int QR = 16, QC = 32;
constexpr int IH = 4 * QR + 12, IW = 4 * QC + 12, RS = 3 * IW;  // 4Y0-5 ..
constexpr int XR = 2 * QR + 5, XC = 2 * QC + 5;  // half-res, from 2Y0-2
constexpr int CH = QR + 2, CW = QC + 2;          // conv1_1, from Y0-1
constexpr int IMG_F = IH * RS, XH_F = up4(XR * XC * 3);
constexpr int C11_F = up4(CH * CW * CS1);
constexpr int A_F = cmax(IMG_F, C11_F);
constexpr int SMEM_F = A_F + XH_F + REC27_F + RING_F;
}  // namespace s12

// One block per (image, 16x32 quarter-res tile {Y0, X0}): the image
// window from image row 4Y0-5 (A), the half-res window from (2Y0-2,
// 2X0-2) (XH), conv1_1 -> C11 (from (Y0-1, X0-1), over A), conv1_2 ->
// c12 [N, H/4, W/4, 32] in global memory.
template <int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
    stem12_kernel(const float* __restrict__ image,
                  const float* __restrict__ pack, float* __restrict__ c12,
                  float*, int H, int W) {
  using namespace s12;
  extern __shared__ __align__(16) float smem[];
  float* const A = smem;  // the image window, then conv1_1's output
  float* const XH = A + A_F;
  float* const W11 = XH + XH_F;
  float* const ring = W11 + REC27_F;
  const int n = blockIdx.z;
  const int Y0 = blockIdx.y * QR, X0 = blockIdx.x * QC;
  const int H4 = H / 4, W4 = W / 4;
  const float* rec = pack + S12;
  cp_async_floats(W11, pack + S11, REC27_F);
  stage_image(A, image + (size_t)n * H * W * 3, 4 * Y0 - 5, 4 * X0 - 5, IH,
              IW, H, W);
  ring_start(ring, rec, WS32);
  cp_async_wait_group_sync<STAGES - 1>();  // the image and W11
  downsample(XH, 2 * Y0 - 2, 2 * X0 - 2, XR, XC, A, RS, 4 * Y0 - 5,
             4 * X0 - 5, H / 2, W / 2);
  __syncthreads();
  float* const C11 = A;
  conv27<CH * CW, PASSES>(XH, 3 * XC, 0, 0, CW, W11,
                          [&](int p, int c, float v0, float v1) {
                            put(C11, CS1, Y0 - 1, X0 - 1, CW, H4, W4,
                                W11 + KR * WS32, p, c, v0, v1);
                          });
  __syncthreads();
  float* const out = c12 + (size_t)n * H4 * W4 * 32;
  conv288<32, 4, QR * QC, PASSES>(
      ring, 0, rec, nullptr, 0, C11, CW, CS1, 1, QC,
      [&](int p, int c, float v0, float v1) {
        put_global(out, 32, Y0, X0, QC, H4, W4, rec + 9 * KR * WS32, p, c,
                   v0, v1);
      });
}

namespace s3 {  // stem3_kernel's tile and buffers
constexpr int TR = 8, TC = 8;                    // eighth-res
constexpr int QH = 2 * TR + 3, QW = 2 * TC + 3;  // c12, from 2R0-1
constexpr int BW = 2 * TC + 1, M = (2 * TR + 1) * BW;  // from 2R0
constexpr int C12_F = up4(QH * QW * CS1), C13_F = up4(M * CS13);
constexpr int SMEM_F = C12_F + C13_F + RING_F;
}  // namespace s3

// One block per (image, 8x8 eighth-res tile {R0, C0}): c12 over the
// quarter rectangle from (2R0-1, 2C0-1), zero outside the grid (C12),
// conv1_3 -> C13 (from (2R0, 2C0)), then the 3x3/s2 max pool over C13's
// quarter rows and columns 2m .. 2m+2 -> stem1.
template <int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
    stem3_kernel(const float* __restrict__ c12,
                 const float* __restrict__ pack, float* __restrict__ stem1,
                 float*, int H, int W) {
  using namespace s3;
  extern __shared__ __align__(16) float smem[];
  float* const C12 = smem;
  float* const C13 = C12 + C12_F;
  float* const ring = C13 + C13_F;
  const int n = blockIdx.z;
  const int R0 = blockIdx.y * TR, C0 = blockIdx.x * TC;
  const int H4 = H / 4, W4 = W / 4, H8 = H / 8, W8 = W / 8;
  const float* rec = pack + S13;
  const float* cn = c12 + (size_t)n * H4 * W4 * 32;
  for (int i = threadIdx.x; i < QH * QW * 8; i += blockDim.x) {
    const int p = i / 8, k = i % 8 * 4;
    const int r = 2 * R0 - 1 + p / QW, c = 2 * C0 - 1 + p % QW;
    float* d = C12 + p * CS1 + k;
    if (inside(r, c, H4, W4))
      cp_async16(d, cn + ((size_t)r * W4 + c) * 32 + k);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
  ring_start(ring, rec, WS64);
  cp_async_wait_group_sync<STAGES - 1>();  // c12
  conv288<64, 4, M, PASSES>(
      ring, 0, rec, nullptr, 0, C12, QW, CS1, 1, BW,
      [&](int p, int c, float v0, float v1) {
        put(C13, CS13, 2 * R0, 2 * C0, BW, H4, W4, rec + 9 * KR * WS64, p, c,
            v0, v1);
      });
  __syncthreads();
  // the pool; C13 is zero outside the grid, max-neutral after the ReLU
  float* const st = stem1 + (size_t)n * H8 * W8 * 64;
  for (int t = threadIdx.x; t < TR * TC * 16; t += blockDim.x) {
    const int c4 = t % 16 * 4, p = t / 16;
    const int lr = p / TC, lc = p % TC;
    if (R0 + lr >= H8 || C0 + lc >= W8) continue;
    const float* x = C13 + (2 * lr * BW + 2 * lc) * CS13 + c4;
    float4 v = *reinterpret_cast<const float4*>(x);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 u =
            *reinterpret_cast<const float4*>(x + (dy * BW + dx) * CS13);
        v.x = fmaxf(v.x, u.x), v.y = fmaxf(v.y, u.y);
        v.z = fmaxf(v.z, u.z), v.w = fmaxf(v.w, u.w);
      }
    *reinterpret_cast<float4*>(st + ((size_t)(R0 + lr) * W8 + C0 + lc) * 64 +
                               c4) = v;
  }
}

// -- launches -------------------------------------------------------------------

// mma passes of each route (ops/kernels/icnet_front.py PRECISION)
constexpr int kPredictPasses = 3, kScorePasses = 1;

// The launches of the C entry ssal_icnet_front_part (ops/kernels/
// icnet_front.py PARTS).
enum { BRANCH1, FRONT, STEM12, STEM3 };

// Launch kernel k (in, pack, out, out2, h, w) with smem_f floats of
// shared memory.
template <class K>
int launch(K k, int smem_f, dim3 grid, cudaStream_t stream,
           const float* in, const float* pack, float* out, float* out2,
           int h, int w) {
  const size_t smem = (size_t)smem_f * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int status = (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (status) return status;
  k<<<grid, THREADS, smem, stream>>>(in, pack, out, out2, h, w);
  return (int)cudaGetLastError();
}

dim3 tiles(int n, int rows, int cols, int tr, int tc) {
  return dim3((cols + tc - 1) / tc, (rows + tr - 1) / tr, n);
}

template <int PASSES>
int launch_part(int part, const float* in, const float* pack, float* out,
                float* out2, int n, int h, int w, cudaStream_t s) {
  const int h8 = h / 8, w8 = w / 8;
  switch (part) {
    case BRANCH1:
      return launch(branch1_kernel<false, PASSES>, b1k::SMEM_F,
                    tiles(n, h8, w8, b1k::TR, b1k::TC), s, in, pack, out,
                    out2, h, w);
    case FRONT:
      return launch(branch1_kernel<true, PASSES>, b1k::SMEM_F,
                    tiles(n, h8, w8, b1k::TR, b1k::TC), s, in, pack, out,
                    out2, h, w);
    case STEM12:
      return launch(stem12_kernel<PASSES>, s12::SMEM_F,
                    tiles(n, h / 4, w / 4, s12::QR, s12::QC), s, in, pack,
                    out, out2, h, w);
    case STEM3:
      return launch(stem3_kernel<PASSES>, s3::SMEM_F,
                    tiles(n, h8, w8, s3::TR, s3::TC), s, in, pack, out, out2,
                    h, w);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ssal

using namespace ssal;

// Six GEMM records: Branch1_1..1_3, then conv1_1..1_3.
extern "C" int ssal_icnet_front_pack_size() { return PACK_F; }

// One launch of the ICNet front, at the score route's precision (score !=
// 0) or the predict route's, on an image of h x w (h, w % 32 == 0):
//   part 0 (branch1): image -> f1 [N,h/8,w/8,64];
//   1 (front): image -> f1, out2 = x_half [N,h/2,w/2,3];
//   2 (stem12): image -> c12 [N,h/4,w/4,32] (conv1_2's output);
//   3 (stem3): in = c12 -> stem1 [N,h/8,w/8,64].
extern "C" int ssal_icnet_front_part(int part, const float* in,
                                     const float* pack, float* out,
                                     float* out2, int n, int h, int w,
                                     int score, void* stream) {
  const auto s = (cudaStream_t)stream;
  return score ? launch_part<kScorePasses>(part, in, pack, out, out2, n, h,
                                           w, s)
               : launch_part<kPredictPasses>(part, in, pack, out, out2, n, h,
                                             w, s);
}
