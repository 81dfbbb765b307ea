// ENet mid section: stage-1 features -> stage-3 features and the B2_0
// pool switches.
//
// Replaces fused_mid_stage23_w (ops/pallas_kernels.py:2184, bodies
// _mid_w_b20_kernel :2089 and _mid_w_blocks_kernel :2139) and its v1
// fused_mid_stage23 (:1808): one contract, no width limit beyond
// W % 8 == 0. Outputs y [N,H/8,W/8,128] f32 and sw2 int8 [N,H/8,W/8,64]
// (window position 0..3 of each first maximum).
//
// What bounds it on an H100. Per eighth-res position the 16 bottlenecks
// take 282,624 multiply-adds and B2_0 21,504: 39.9 GFLOP at batch 2,
// 1024x2048, 0.081 ms at the TF32 peak, 0.242 ms in 3xTF32. The
// receptive field (+-73 eighth positions, dilations up to 16) cannot be
// tiled into the 227 KB of shared memory a block may use, so every
// bottleneck is its own launch and the 128-channel activations go
// through device memory between launches: at batch 2 each launch reads x
// (33.5 MB) and writes y (33.5 MB), more than the 50 MB L2 holds, about
// 1.07 GB and 0.32 ms a call at 3.35 TB/s for 16 launches. Once the
// products are on the tensor cores those bytes, not the operations, set
// the floor; a separate projection adds its 8.4 MB round trip and one
// launch.
//
// Design. Every product is a GEMM on the tensor cores: mma.sync m16n8k8
// TF32 (tc.cuh), once or as 3xTF32 (kPredictPasses, kScorePasses), fp32
// accumulation, the layer's weights staged into shared memory with
// cp.async as GEMM records (tc.cuh Layer; ops/kernels/mid.py pack_mid).
// A block of 16 warps takes a 16x16 tile of eighth-res positions:
//   - b20_kernel, B2_0: the 2x2/s2 projection (K = 4 taps x 64, A read
//     from x1) over the tile plus a halo of 1, the 3x3 (K = 9 x 32), the
//     expand with the pooled residual and the first-max switches;
//   - block_kernel, one stage-2/3 bottleneck: the 1x1 projection (K =
//     128) over the tile plus the conv's halo into shared memory (FUSE,
//     where the halo is small: the asymmetric blocks and small
//     dilations), or P read tap by tap from proj_kernel's 32-channel
//     buffer into a double buffer (large dilations, where the fused
//     recompute would cost more than P's round trip); then the dilated
//     3x3 as one implicit GEMM (K = 9 taps x 32, taps outside the grid
//     read zeros), or the 5x1 (no bias or BN) and the 1x5 as two K = 5 x
//     32 GEMMs; then the 1x1 expand (K = 32, N = 128) whose epilogue adds
//     the bias and the residual x and applies the PReLU, a lane holding 4
//     consecutive channels of one position (a shuffle with the lane
//     beside it) so that x is read and y stored 16 bytes a lane;
//   - proj_kernel: the unfused 1x1 projection, 128 positions a block.
// Activation buffers in shared memory have a channel stride of 36 (4 mod
// 32) and the weights a stride of 40 or 136 (8 mod 32): the A and B
// fragment reads hit 32 different banks. Positions outside the grid are
// zero in every buffer a conv reads: the SAME padding at any dilation.
#include "common.cuh"
#include "tc.cuh"

namespace ssal {
namespace {

constexpr int T = 16;           // eighth-res output tile side
constexpr int THREADS = 512;    // 16 warps: one tile row each
constexpr int CS = 36;          // channel stride of the 32-channel buffers
constexpr int TN = T * T;
constexpr int MAX_FUSED_HALO = 4;  // the largest halo a fused block holds

// -- the pack ---------------------------------------------------------------
// One GEMM record per layer, in this order (ops/kernels/mid.py
// mid_layout): B2_0: PROJ (the 2x2/s2 conv as 4 taps x 64), CONV, EXP; a
// dilated block: PROJ, CONV, EXP; an asymmetric one: PROJ, COL (the 5x1,
// no bias or BN), ROW (the 1x5), EXP. Vectors: the folded bias and the
// PReLU alpha (EXP: the bias and the residual PReLU's alpha); none for
// COL.
enum Kind { B20 = 0, DIL = 1, ASYM = 2 };
constexpr int MAX_LAYERS = 4;

struct MidLayout {
  Layer l[MAX_LAYERS];
  int n, size;
};

MidLayout mid_layout(int kind) {
  // taps, k, n, nv
  static const int spec[3][MAX_LAYERS][4] = {
      {{4, 64, 32, 2}, {9, 32, 32, 2}, {1, 32, 128, 2}, {0, 0, 0, 0}},
      {{1, 128, 32, 2}, {9, 32, 32, 2}, {1, 32, 128, 2}, {0, 0, 0, 0}},
      {{1, 128, 32, 2}, {5, 32, 32, 0}, {5, 32, 32, 2}, {1, 32, 128, 2}}};
  MidLayout L;
  L.n = kind == ASYM ? 4 : 3;
  int off = 0;
  for (int i = 0; i < L.n; ++i) {
    const int* s = spec[kind][i];
    L.l[i] = {off, s[0], s[1], s[2], bstride(s[2]), s[3]};
    off += L.l[i].size();
  }
  L.size = off;
  return L;
}

// Record sizes in floats (weight stride 40 for 32 columns, 136 for 128)
constexpr int PROJ_F = 128 * 40 + 2 * 32, B20_PROJ_F = 4 * 64 * 40 + 2 * 32;
constexpr int CONV_F = 9 * 32 * 40 + 2 * 32, ASYM_F = 2 * 5 * 32 * 40 + 2 * 32;
constexpr int EXP_F = 32 * 136 + 2 * 128;
// Shared-memory floats of a stage-2/3 block: the spatial records (CONV,
// or COL + ROW), the PROJ then EXP record, a zero row, the spatial
// conv's output over the tile.
constexpr int WSF = ASYM_F, WEF = PROJ_F;
constexpr int ZF = 128;
constexpr int CF = TN * CS;
constexpr int FIXED_F = WSF + WEF + ZF + CF;
static_assert(CONV_F <= WSF && EXP_F <= WEF, "records fit their buffers");

int rect_side(int halo) { return T + 2 * halo; }

// Consecutive records copied as one piece.
struct Span {
  int off, size;
};

struct BlockParams {
  const float* pack;
  Layer l[MAX_LAYERS];
  Span spatial;  // CONV, or COL + ROW
};

// y over the tile at (r0, c0): prelu(C @ E.w + E.b + res, E.v), C the
// spatial conv's output [TN][CS] in shared memory. Warp m takes tile row
// m, 32 output channels at a time; after a shuffle with the lane beside
// it each lane holds 4 consecutive channels of one position (tc.cuh
// expand_epilogue), so that res(r, c, ch) (the residual's float4 at
// position (r, c), channels ch .. ch+3) and the store move 16 bytes a
// lane. A group's residuals are
// loaded while the group before it is multiplied.
template <int PASSES, class Res>
__device__ __forceinline__ void expand_store(const float* C, const Smem& E,
                                             int r0, int c0, int H8, int W8,
                                             Res res, float* __restrict__ yn) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const bool odd = q & 1;
  for (int m = warp; m < T; m += nw) {
    const float* a0 = C + (m * T + g) * CS;
    const float* a1 = a0 + 8 * CS;
    const int r = r0 + m, c = c0 + g + 8 * odd;  // this lane's position
    const bool in = r < H8 && c < W8;
    float* const yp = yn + ((size_t)r * W8 + c) * 128 + 4 * (q >> 1);
    float4 cur[4], nxt[4];
    auto load = [&](int n0, float4 (&x)[4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = in ? res(r, c, n0 + 8 * j + 4 * (q >> 1))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    load(0, cur);
#pragma unroll
    for (int n0 = 0; n0 < 128; n0 += 32) {
      if (n0 + 32 < 128) load(n0 + 32, nxt);
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int k = 0; k < 32; k += 8)
        mma_kstep<4, PASSES>(acc, a0[k + q], a1[k + q], a0[k + q + 4],
                             a1[k + q + 4], E.w + k * E.ws, E.ws, n0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v =
            expand_epilogue(acc[j], E, n0 + 8 * j + 4 * (q >> 1), cur[j]);
        if (in) *reinterpret_cast<float4*>(yp + n0 + 8 * j) = v;
        cur[j] = nxt[j];
      }
    }
  }
}

// The folded 1x1 projection 128 -> 32 + PReLU over the rectangle of side
// rs at (rr0, rc0) into P [rs*rs][CS], A read from x; zero outside the
// grid.
template <int PASSES>
__device__ __forceinline__ void project(const float* __restrict__ xn,
                                        const Smem& L, const float* Z,
                                        float* P, int rr0, int rc0, int rs,
                                        int H8, int W8) {
  gemm<4, PASSES, 128, true>(
      0, rs * rs, 32, 1, L.w, L.ws,
      [&](int p, int) {
        const int r = rr0 + p / rs, c = rc0 + p % rs;
        return p < rs * rs && inside(r, c, H8, W8)
                   ? xn + ((size_t)r * W8 + c) * 128
                   : Z;
      },
      [&](int p, int c, float v0, float v1) {
        const bool in = inside(rr0 + p / rs, rc0 + p % rs, H8, W8);
        float* o = P + p * CS + c;
        o[0] = in ? prelu(v0 + L.b[c], L.v[c]) : 0.f;
        o[1] = in ? prelu(v1 + L.b[c + 1], L.v[c + 1]) : 0.f;
      });
}

// -- B2_0 -----------------------------------------------------------------

constexpr int B20_RS = T + 2;
constexpr size_t B20_SMEM =
    (size_t)(CONV_F + B20_PROJ_F + ZF + CF + B20_RS * B20_RS * CS) * 4;
static_assert(B20_SMEM <= 232448, "227 KB of shared memory a block");

template <int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
    b20_kernel(const float* __restrict__ x1, const BlockParams B,
               float* __restrict__ y, int8_t* __restrict__ sw2, int H8,
               int W8) {
  extern __shared__ __align__(16) float smem[];
  float* const WS = smem;             // CONV
  float* const WE = WS + CONV_F;      // PROJ, then EXP
  float* const Z = WE + B20_PROJ_F;
  float* const C = Z + ZF;            // the 3x3's output over the tile
  float* const P = C + CF;            // the projection over the tile + 1
  const int n = blockIdx.z;
  const int Hq = 2 * H8, Wq = 2 * W8;
  const int r0 = blockIdx.y * T, c0 = blockIdx.x * T;
  const float* xn = x1 + (size_t)n * Hq * Wq * 64;

  // PROJ, then CONV while the projection runs
  cp_async_floats(WE, B.pack + B.l[0].off, B.l[0].size());
  cp_async_commit();
  cp_async_floats(WS, B.pack + B.spatial.off, B.spatial.size);
  cp_async_commit();
  for (int i = threadIdx.x; i < ZF; i += blockDim.x) Z[i] = 0.f;
  cp_async_wait_group_sync<1>();

  // 2x2/s2 projection 64 -> 32 over the tile + 1: tap t reads the
  // stage-1 position (2r + t/2, 2c + t%2)
  Smem L = smem_layer(WE, B.l[0]);
  gemm<4, PASSES, 64, true>(
      0, B20_RS * B20_RS, 32, 4, L.w, L.ws,
      [&](int p, int t) {
        const int r = r0 - 1 + p / B20_RS, c = c0 - 1 + p % B20_RS;
        return p < B20_RS * B20_RS && inside(r, c, H8, W8)
                   ? xn + ((size_t)(2 * r + (t >> 1)) * Wq + 2 * c + (t & 1)) *
                              64
                   : Z;
      },
      [&](int p, int c, float v0, float v1) {
        const bool in =
            inside(r0 - 1 + p / B20_RS, c0 - 1 + p % B20_RS, H8, W8);
        float* o = P + p * CS + c;
        o[0] = in ? prelu(v0 + L.b[c], L.v[c]) : 0.f;
        o[1] = in ? prelu(v1 + L.b[c + 1], L.v[c + 1]) : 0.f;
      });
  __syncthreads();
  cp_async_floats(WE, B.pack + B.l[2].off, B.l[2].size());  // EXP
  cp_async_commit();
  cp_async_wait_group_sync<1>();  // CONV

  // 3x3 32 -> 32 over the tile
  L = smem_layer(WS, B.l[1]);
  gemm<4, PASSES, 32>(
      0, TN, 32, 9, L.w, L.ws,
      [&](int p, int t) {
        return P + ((p / T + t / 3) * B20_RS + p % T + t % 3) * CS;
      },
      [&](int p, int c, float v0, float v1) {
        float* o = C + p * CS + c;
        o[0] = prelu(v0 + L.b[c], L.v[c]);
        o[1] = prelu(v1 + L.b[c + 1], L.v[c + 1]);
      });
  cp_async_wait_sync();

  // expand 32 -> 128 + the pooled x1 (channels < 64, with the first-max
  // switches; zero above) + PReLU
  int8_t* swn = sw2 + (size_t)n * H8 * W8 * 64;
  expand_store<PASSES>(
      C, smem_layer(WE, B.l[2]), r0, c0, H8, W8,
      [&](int r, int c, int ch) {
        float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ch >= 64) return m;
        char4 s = make_char4(0, 0, 0, 0);
#pragma unroll
        for (int ph = 0; ph < 4; ++ph) {
          const float4 v = *reinterpret_cast<const float4*>(
              xn + ((size_t)(2 * r + (ph >> 1)) * Wq + 2 * c + (ph & 1)) *
                       64 + ch);
          if (ph == 0 || v.x > m.x) m.x = v.x, s.x = ph;
          if (ph == 0 || v.y > m.y) m.y = v.y, s.y = ph;
          if (ph == 0 || v.z > m.z) m.z = v.z, s.z = ph;
          if (ph == 0 || v.w > m.w) m.w = v.w, s.w = ph;
        }
        *reinterpret_cast<char4*>(swn + ((size_t)r * W8 + c) * 64 + ch) = s;
        return m;
      },
      y + (size_t)n * H8 * W8 * 128);
}

// -- the unfused projection -----------------------------------------------

constexpr int PROJ_THREADS = 256;
constexpr int PROJ_M = 128;  // positions a block
constexpr size_t PROJ_SMEM = (size_t)(PROJ_F + ZF) * 4;

// P = prelu(x @ w + b): the 1x1 projection 128 -> 32 of one bottleneck,
// x [npix, 128] -> P [npix, 32].
template <int PASSES>
__global__ void __launch_bounds__(PROJ_THREADS)
    proj_kernel(const float* __restrict__ x, const BlockParams B,
                float* __restrict__ P, int npix) {
  extern __shared__ __align__(16) float smem[];
  float* const W = smem;
  float* const Z = W + PROJ_F;
  cp_async_floats(W, B.pack + B.l[0].off, B.l[0].size());
  for (int i = threadIdx.x; i < ZF; i += blockDim.x) Z[i] = 0.f;
  cp_async_wait_sync();
  const size_t base = (size_t)blockIdx.x * PROJ_M;
  const int M = min(PROJ_M, npix - (int)blockIdx.x * PROJ_M);
  const Smem L = smem_layer(W, B.l[0]);
  gemm<4, PASSES, 128, true>(
      0, M, 32, 1, L.w, L.ws,
      [&](int p, int) { return p < M ? x + (base + p) * 128 : Z; },
      [&](int p, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(P + (base + p) * 32 + c) = make_float2(
            prelu(v0 + L.b[c], L.v[c]), prelu(v1 + L.b[c + 1], L.v[c + 1]));
      });
}

// -- one stage-2/3 bottleneck ---------------------------------------------

int block_smem_floats(bool asym, bool fuse, int dil) {
  if (asym)
    return FIXED_F + rect_side(2) * rect_side(2) * CS + T * (T + 4) * CS;
  if (fuse) return FIXED_F + rect_side(dil) * rect_side(dil) * CS;
  return FIXED_F + 2 * TN * CS;
}

// One block per (image, 16x16 tile at (r0, c0)): x [N,H8,W8,128] (and,
// unfused, P [N,H8,W8,32]) -> y. Rectangles: the projection over the
// tile + h (h = dil, or 2 for the asymmetric 5x1 and 1x5); ASYM's 5x1
// output over the tile's rows and its columns +- 2.
template <bool ASYM, bool FUSE, int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
    block_kernel(const float* __restrict__ x, const float* __restrict__ Pg,
                 const BlockParams B, float* __restrict__ y, int H8, int W8,
                 int dil) {
  static_assert(FUSE || !ASYM, "the asymmetric blocks are always fused");
  extern __shared__ __align__(16) float smem[];
  float* const WS = smem;        // CONV, or COL + ROW
  float* const WE = WS + WSF;    // PROJ, then EXP
  float* const Z = WE + WEF;
  float* const C = Z + ZF;       // the spatial conv's output over the tile
  float* const V = C + CF;       // FUSE: the projection; else two tap tiles
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * T, c0 = blockIdx.x * T;
  const size_t img = (size_t)n * H8 * W8;
  const float* xn = x + img * 128;
  const Layer& EXP = B.l[ASYM ? 3 : 2];

  // PROJ (fused; else EXP), then the spatial records while the
  // projection runs
  if (FUSE) cp_async_floats(WE, B.pack + B.l[0].off, B.l[0].size());
  else cp_async_floats(WE, B.pack + EXP.off, EXP.size());
  cp_async_commit();
  cp_async_floats(WS, B.pack + B.spatial.off, B.spatial.size);
  cp_async_commit();
  for (int i = threadIdx.x; i < ZF; i += blockDim.x) Z[i] = 0.f;

  if (FUSE) {
    const int h = ASYM ? 2 : dil, rs = T + 2 * h;
    cp_async_wait_group_sync<1>();
    project<PASSES>(xn, smem_layer(WE, B.l[0]), Z, V, r0 - h, c0 - h, rs, H8,
                    W8);
    __syncthreads();
    cp_async_floats(WE, B.pack + EXP.off, EXP.size());
    cp_async_commit();
    cp_async_wait_group_sync<1>();  // the spatial records
    if (ASYM) {
      // 5x1 (no bias, no BN) over rows r0.., columns c0-2.. (T x T+4),
      // zero outside the grid: the 1x5's SAME padding
      float* const A = V + rs * rs * CS;
      constexpr int AW = T + 4;
      Smem L = smem_layer(WS, B.l[1]);
      gemm<4, PASSES, 32>(
          0, T * AW, 32, 5, L.w, L.ws,
          [&](int p, int t) { return V + ((p / AW + t) * rs + p % AW) * CS; },
          [&](int p, int c, float v0, float v1) {
            const bool in = inside(r0 + p / AW, c0 - 2 + p % AW, H8, W8);
            float* o = A + p * CS + c;
            o[0] = in ? v0 : 0.f;
            o[1] = in ? v1 : 0.f;
          });
      __syncthreads();
      L = smem_layer(WS + B.l[2].off - B.l[1].off, B.l[2]);
      gemm<4, PASSES, 32>(
          0, TN, 32, 5, L.w, L.ws,
          [&](int p, int t) { return A + ((p / T) * AW + p % T + t) * CS; },
          [&](int p, int c, float v0, float v1) {
            float* o = C + p * CS + c;
            o[0] = prelu(v0 + L.b[c], L.v[c]);
            o[1] = prelu(v1 + L.b[c + 1], L.v[c + 1]);
          });
    } else {
      const Smem L = smem_layer(WS, B.l[1]);
      gemm<4, PASSES, 32>(
          0, TN, 32, 9, L.w, L.ws,
          [&](int p, int t) {
            return V + ((p / T + h + (t / 3 - 1) * dil) * rs + p % T + h +
                        (t % 3 - 1) * dil) * CS;
          },
          [&](int p, int c, float v0, float v1) {
            float* o = C + p * CS + c;
            o[0] = prelu(v0 + L.b[c], L.v[c]);
            o[1] = prelu(v1 + L.b[c + 1], L.v[c + 1]);
          });
    }
    cp_async_wait_sync();
  } else {
    // the dilated 3x3 tap by tap: tap t's shifted tile of P is copied
    // into V[t % 2] while tap t-1's is multiplied; warp w keeps tile
    // row w's 16 x 32 sums in registers across the taps
    const float* Pn = Pg + img * 32;
    auto load_tap = [&](int t) {
      float* dst = V + (t & 1) * TN * CS;
      const int dr = (t / 3 - 1) * dil, dc = (t % 3 - 1) * dil;
      for (int i = threadIdx.x; i < TN * 8; i += blockDim.x) {
        const int p = i >> 3, c4 = (i & 7) * 4;
        const int r = r0 + p / T + dr, c = c0 + p % T + dc;
        float* d = dst + p * CS + c4;
        if (inside(r, c, H8, W8))
          cp_async16(d, Pn + ((size_t)r * W8 + c) * 32 + c4);
        else
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      cp_async_commit();
    };
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const Smem L = smem_layer(WS, B.l[1]);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    load_tap(0);
    for (int t = 0; t < 9; ++t) {
      if (t + 1 < 9) {
        load_tap(t + 1);
        cp_async_wait_group_sync<1>();
      } else {
        cp_async_wait_group_sync<0>();
      }
      const float* a0 = V + (t & 1) * TN * CS + (warp * T + g) * CS;
      const float* a1 = a0 + 8 * CS;
      const float* wt = L.w + t * 32 * L.ws;
#pragma unroll
      for (int k = 0; k < 32; k += 8)
        mma_kstep<4, PASSES>(acc, a0[k + q], a1[k + q], a0[k + q + 4],
                             a1[k + q + 4], wt + k * L.ws, L.ws, 0);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = warp * T + g + 8 * hh, c = 8 * j + 2 * q;
        float* o = C + p * CS + c;
        o[0] = prelu(acc[j][2 * hh] + L.b[c], L.v[c]);
        o[1] = prelu(acc[j][2 * hh + 1] + L.b[c + 1], L.v[c + 1]);
      }
    __syncthreads();
  }

  // expand 32 -> 128 + x + PReLU
  expand_store<PASSES>(
      C, smem_layer(WE, EXP), r0, c0, H8, W8,
      [&](int r, int c, int ch) {
        return *reinterpret_cast<const float4*>(
            xn + ((size_t)r * W8 + c) * 128 + ch);
      },
      y + img * 128);
}

// -- launches -------------------------------------------------------------

// mma passes of each route (ops/kernels/mid.py PRECISION)
constexpr int kPredictPasses = 3, kScorePasses = 1;

BlockParams block_params(const float* pack, int kind) {
  const MidLayout L = mid_layout(kind);
  BlockParams B;
  B.pack = pack;
  for (int i = 0; i < L.n; ++i) B.l[i] = L.l[i];
  const Layer& last = L.l[L.n - 2];  // the last spatial record
  B.spatial = {L.l[1].off, last.off + last.size() - L.l[1].off};
  return B;
}

dim3 tile_grid(int n, int h8, int w8) {
  return dim3((w8 + T - 1) / T, (h8 + T - 1) / T, n);
}

// Let kernel k take `smem` bytes of dynamic shared memory.
template <class K>
int allow_smem(K k, size_t smem) {
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
}  // namespace ssal

using namespace ssal;

// kind 0: B2_0, 1: a dilated block, 2: an asymmetric one.
extern "C" int ssal_mid_pack_size(int kind) { return mid_layout(kind).size; }

// x1 [N,2h8,2w8,64] -> y [N,h8,w8,128], sw2 int8 [N,h8,w8,64].
extern "C" int ssal_mid_b20(const float* x1, const float* pack, float* y,
                            int8_t* sw2, int n, int h8, int w8, int score,
                            void* stream) {
  const BlockParams B = block_params(pack, B20);
  const auto k = score ? b20_kernel<kScorePasses> : b20_kernel<kPredictPasses>;
  const cudaStream_t s = (cudaStream_t)stream;
  const int status = allow_smem(k, B20_SMEM);
  if (status) return status;
  k<<<tile_grid(n, h8, w8), THREADS, B20_SMEM, s>>>(x1, B, y, sw2, h8, w8);
  return (int)cudaGetLastError();
}

// x [npix,128] -> P [npix,32], the projection of a stage-2/3 block
// (its pack: kind 1 or 2).
extern "C" int ssal_mid_proj(const float* x, const float* pack, float* P,
                             int npix, int score, void* stream) {
  const BlockParams B = block_params(pack, DIL);
  const auto k =
      score ? proj_kernel<kScorePasses> : proj_kernel<kPredictPasses>;
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (npix + PROJ_M - 1) / PROJ_M;
  k<<<blocks, PROJ_THREADS, PROJ_SMEM, s>>>(x, B, P, npix);
  return (int)cudaGetLastError();
}

// x [N,h8,w8,128] -> y [N,h8,w8,128], one stage-2/3 bottleneck. P null:
// the projection fused (asymmetric, or dilation <= MAX_FUSED_HALO);
// else P [N,h8,w8,32] from ssal_mid_proj (dilated blocks only).
extern "C" int ssal_mid_block(const float* x, const float* P,
                              const float* pack, float* y, int n, int h8,
                              int w8, int dilation, int asym, int score,
                              void* stream) {
  const bool fuse = P == nullptr;
  if ((asym && (!fuse || dilation != 1)) ||
      (fuse && !asym && dilation > MAX_FUSED_HALO) || dilation < 1)
    return (int)cudaErrorInvalidValue;
  const BlockParams B = block_params(pack, asym ? ASYM : DIL);
  const size_t smem = (size_t)block_smem_floats(asym, fuse, dilation) * 4;
  const dim3 grid = tile_grid(n, h8, w8);
  const cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto k) {
    const int status = allow_smem(k, smem);
    if (status) return status;
    k<<<grid, THREADS, smem, s>>>(x, P, B, y, h8, w8, dilation);
    return (int)cudaGetLastError();
  };
  if (asym)
    return score ? go(block_kernel<true, true, kScorePasses>)
                 : go(block_kernel<true, true, kPredictPasses>);
  if (fuse)
    return score ? go(block_kernel<false, true, kScorePasses>)
                 : go(block_kernel<false, true, kPredictPasses>);
  return score ? go(block_kernel<false, false, kScorePasses>)
               : go(block_kernel<false, false, kPredictPasses>);
}
