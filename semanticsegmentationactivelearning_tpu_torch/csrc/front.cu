// ENet front: image -> stage-1 features and the B1_0 pool-switch mask.
//
// Replaces fused_front_stage1_w (ops/pallas_kernels.py:1474, body
// _front_w_kernel :1302) and its v1 fused_front_stage1 (:1030, body
// _front_kernel :905): one contract, no width limit beyond W % 8 == 0.
// Computes Initial (3x3/s2 conv 3->13 || 2x2 max pool, BN, PReLU) ->
// Bottleneck1_0 (2x2/s2 projection 16->8, 3x3, 1x1 expand to 64, max
// pool with first-max switches, zero channel pad) -> Bottleneck1_1..1_4.
// Outputs x1 [N,H/4,W/4,64] and mask1 [N,H/4,W/4,64], the one-hot of
// each switch at channel p*16 + c with p = 2*row + col of the window.
// The half-resolution Initial output and B1_0's internals never reach
// global memory. Amended contract (as the tail's x4 and the mid's
// activations): the quarter-res 64-channel activations between the
// stage-1 bottlenecks may pass through device memory, because five
// fused 3x3 convs need a halo of 5 that the 227 KB of shared memory a
// block may use cannot hold at a tile large enough to keep the
// recompute small.
//
// What bounds it on an H100. Per quarter-res position Initial takes
// 1,404 multiply-adds, B1_0 1,600 and B1_1..1_4 4,352 each: 10.7 GFLOP
// at batch 2, 1024x2048 (262,144 quarter positions, as at batch 8,
// 512x1024), 0.065 ms at the 3xTF32 rate, 0.022 ms in one TF32 pass.
// The contract's bytes: the fp32 image read (25.2 MB an image at
// 1024x2048), x1 and mask1 written (33.6 MB each an image), 184.5 MB
// and 0.055 ms at 3.35 TB/s at batch 2. Each of the four stage-1
// launches adds x's 67 MB read and written.
//
// Design. Every product of B1_0 and B1_1..1_4 is a GEMM on the tensor
// cores: mma.sync m16n8k8 TF32 (tc.cuh), once or as 3xTF32
// (kPredictPasses, kScorePasses), fp32 accumulation, weights staged into
// shared memory with cp.async as GEMM records (tc.cuh Layer;
// ops/kernels/front.py pack_front). Initial and the pool stay exact fp32
// on both routes, so the switches are decided in fp32. Blocks of 16
// warps take a 16x16 tile of quarter-res positions:
//   - b10_kernel: the 73x73x3 image patch under the tile plus B1_0's
//     halo of 1 (cp.async), Initial at the four half-res phases of each
//     of the 18x18 positions on the CUDA cores (X0, channel ph*16 + c),
//     B1_0's 2x2/s2 projection as one K = 4 x 16 GEMM over X0, its 3x3
//     as an implicit GEMM (K = 9 x 8) over the tile, the expand (K = 8,
//     N = 64) with the pooled residual, the switches and mask1;
//   - stage1_kernel: one stage-1 bottleneck on the tile, x over the
//     tile plus a halo of 1 staged into shared memory: the 1x1
//     projection (K = 64, N = 16) over that region, the 3x3 (K = 9 x 16)
//     over the tile, and the expand (K = 16, N = 64) from the 3x3's
//     accumulators in registers, whose epilogue adds the bias and the
//     residual and applies the PReLU (tc.cuh expand_epilogue), 16 bytes
//     a lane into y. Four launches, one per bottleneck: fusing 2 or 4 of
//     them into a launch over a halo of 2 or 4 was measured slower on the
//     H100 (tools/probe_front.py, PERF.md), its recompute costing more
//     than the bytes that fewer launches save.
// What bounds the design: a block of 16 warps with 139-161 KB of shared
// memory holds an SM alone and runs its phases in turn (the staging
// copies, Initial, each GEMM, the stores) with no other block to
// overlap them.
// Activation buffers in shared memory have channel strides of 68, 20
// and 12 (4, 20 and 12 mod 32) and the weights strides of 8, 24 and 72
// (8 mod 32 each way): the A and B fragment reads hit 32 different
// banks. Positions outside the grid are zero in every buffer a conv
// reads: the SAME padding.
#include "common.cuh"
#include "tc.cuh"

namespace ssal {
namespace {

constexpr int T = 16;         // quarter-res output tile side
constexpr int THREADS = 512;  // 16 warps
constexpr int XS = 68;        // channel stride of the 64-channel buffers
constexpr int PS = 20;        // of a bottleneck's 16-channel projection
constexpr int P0S = 12;       // of B1_0's 8-channel projection
constexpr int ZF = 64;        // a zero row

// -- the pack ---------------------------------------------------------------
// Initial: the folded 3x3 weights [27][16] (13 used), then the BN scale,
// the BN shift and the PReLU alpha [16] each. Then one GEMM record per
// layer (ops/kernels/front.py front_layout): B1_0's PROJ (the 2x2/s2
// conv as one tap of 4 x 16), CONV, EXP, then each of B1_1..1_4's
// PROJ, CONV, EXP. Vectors: the folded bias and the PReLU alpha (EXP:
// the bias and the residual PReLU's alpha). EXP's k rows are in
// acc_order: the 3x3's accumulators are its A fragments.
constexpr int INI_F = 27 * 16 + 3 * 16;
constexpr int B10_PROJ = INI_F;                     // 1 tap, k 64, n 8
constexpr int B10_CONV = B10_PROJ + 64 * 8 + 2 * 8;  // 9 taps, k 8, n 8
constexpr int B10_EXP = B10_CONV + 9 * 8 * 8 + 2 * 8;  // k 8, n 64
constexpr int B10_END = B10_EXP + 8 * 72 + 2 * 64;
// a stage-1 bottleneck's records: PROJ (k 64, n 16), CONV (9 taps, k
// 16, n 16), EXP (k 16, n 64)
constexpr int PROJ_F = 64 * 24 + 2 * 16, CONV_F = 9 * 16 * 24 + 2 * 16;
constexpr int EXP_F = 16 * 72 + 2 * 64, BLOCK_F = PROJ_F + CONV_F + EXP_F;
constexpr int PACK_F = B10_END + 4 * BLOCK_F;
static_assert(B10_END % 4 == 0 && BLOCK_F % 4 == 0 && PROJ_F % 4 == 0,
              "records on 16-byte boundaries");

// The record at W (its bias and alpha after the weight [taps][k][s]).
__device__ __forceinline__ Smem rec(const float* W, int taps, int k, int n,
                                    int s) {
  return smem_layer(W, Layer{0, taps, k, n, s, 2});
}

// -- the 3x3 and the expand ----------------------------------------------

// For each 16 positions of the rectangle of side `so` (row-major) dealt
// to this warp: the 3x3 F -> F (+ bias, PReLU) from P, the projection
// over the rectangle of side so + 2 around it (channel stride ps), then
// the 1x1 expand F -> 64 whose A fragments are the 3x3's accumulators
// (C frag (g, 2q), (g, 2q+1), (g+8, ...) read as A frag (g, q), (g,
// q+4), ...: EXP's k rows in acc_order), + its bias + res(p, ch) and its
// PReLU -> out(p, ch, v). After a shuffle with the lane beside it each
// lane holds 4 consecutive channels ch .. ch+3 of one position p, so
// res and out move 16 bytes a lane (tc.cuh expand_epilogue). A twin of
// mid.cu's expand_store rather than that function made generic: there
// the 3x3's output comes back from shared memory, here the expand's A
// fragments are the 3x3's accumulators, so the two share the epilogue
// and not the loop.
template <int F, int PASSES, class Res, class Out>
__device__ __forceinline__ void conv3_expand(const float* P, int ps, int so,
                                             const Smem& C, const Smem& E,
                                             const float* Z, Res res,
                                             Out out) {
  constexpr int NT = F / 8;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const bool odd = q & 1;
  const int si = so + 2, M = so * so;
  for (int p0 = 16 * warp; p0 < M; p0 += 16 * nw) {
    const int pa = p0 + g, pb = pa + 8;
    const float* ra = P + ((pa / so) * si + pa % so) * ps;
    const float* rb = P + ((pb / so) * si + pb % so) * ps;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int off = ((t / 3) * si + t % 3) * ps;
      const float* a0 = pa < M ? ra + off : Z;
      const float* a1 = pb < M ? rb + off : Z;
      const float* wt = C.w + t * F * C.ws;
#pragma unroll
      for (int k = 0; k < F; k += 8)
        mma_kstep<NT, PASSES>(acc, a0[k + q], a1[k + q], a0[k + q + 4],
                              a1[k + q + 4], wt + k * C.ws, C.ws, 0);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * q;
      acc[j][0] = prelu(acc[j][0] + C.b[c], C.v[c]);
      acc[j][1] = prelu(acc[j][1] + C.b[c + 1], C.v[c + 1]);
      acc[j][2] = prelu(acc[j][2] + C.b[c], C.v[c]);
      acc[j][3] = prelu(acc[j][3] + C.b[c + 1], C.v[c + 1]);
    }
    const int p = odd ? pb : pa;  // this lane's position after the shuffle
#pragma unroll
    for (int n0 = 0; n0 < 64; n0 += 32) {
      float e[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j][0] = e[j][1] = e[j][2] = e[j][3] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_kstep<4, PASSES>(e, acc[j][0], acc[j][2], acc[j][1], acc[j][3],
                             E.w + 8 * j * E.ws, E.ws, n0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = n0 + 8 * j + 4 * (q >> 1);
        const float4 x = p < M ? res(p, ch) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 v = expand_epilogue(e[j], E, ch, x);
        if (p < M) out(p, ch, v);
      }
    }
  }
}

// -- Initial + B1_0 --------------------------------------------------------

constexpr int RA = T + 2;       // B1_0's region side (halo 1)
constexpr int RI = 4 * RA + 1;  // image patch side
constexpr int IS = 220;         // patch row stride (3 * 73 = 219 used)
// shared memory: X0, the patch (later B1_0's projection), weights, Z
constexpr int B10_SMEM_F = RA * RA * XS + RI * IS + B10_END + ZF;
constexpr size_t B10_SMEM = (size_t)B10_SMEM_F * 4;
static_assert(RA * RA * P0S <= RI * IS, "the projection fits the patch");
static_assert(B10_SMEM <= 232448, "227 KB of shared memory a block");

template <int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
    b10_kernel(const float* __restrict__ image, const float* __restrict__ pack,
               float* __restrict__ x, float* __restrict__ mask1, int H,
               int W) {
  extern __shared__ __align__(16) float smem[];
  float* const X0 = smem;             // Initial over the region
  float* const U = X0 + RA * RA * XS;  // the patch, then the projection
  float* const Wt = U + RI * IS;       // Initial + B1_0's records
  float* const Z = Wt + B10_END;
  const int n = blockIdx.z;
  const int Hq = H / 4, Wq = W / 4;
  const int R0 = blockIdx.y * T, C0 = blockIdx.x * T;

  // 1. the weights and the image patch under the region (image rows
  //    4(R0-1) .. 4(R0+17)), zero outside the image; 16-byte copies
  //    where a piece lies inside the image
  cp_async_floats(Wt, pack, B10_END);
  const float* im = image + (size_t)n * H * W * 3;
  const int iy0 = 4 * (R0 - 1), ix0 = 4 * (C0 - 1);
  for (int i = threadIdx.x; i < RI * (IS / 4); i += blockDim.x) {
    const int r = i / (IS / 4), f = 4 * (i % (IS / 4));
    const int y = iy0 + r;
    float* d = U + r * IS + f;
    const int xa = ix0 + f / 3, xb = ix0 + (f + 3) / 3;
    if (y >= 0 && y < H && xa >= 0 && xb < W && f + 3 < 3 * RI) {
      cp_async16(d, im + ((size_t)y * W + xa) * 3 + f % 3);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int xe = ix0 + (f + e) / 3;
        d[e] = (f + e < 3 * RI && y >= 0 && y < H && xe >= 0 && xe < W)
                   ? __ldg(im + ((size_t)y * W + xe) * 3 + (f + e) % 3)
                   : 0.f;
      }
    }
  }
  for (int i = threadIdx.x; i < ZF; i += blockDim.x) Z[i] = 0.f;
  cp_async_wait_sync();

  // 2. Initial at the four half-res positions (phase ph = 2a + b) of
  //    every quarter position p of the region: X0[p][ph*16 + c]. The
  //    stride-2 SAME conv pads (0, 1): half row y reads image rows
  //    2y..2y+2. Exact fp32 FMAs on both routes; a thread takes one
  //    (p, ph) and its 16 channels, so that the weights are read 16
  //    bytes at a time, the same address across the warp.
  {
    const float* iw = Wt;  // [27][16], channels 13..15 zero
    const float* is = iw + 27 * 16;
    const float* it = is + 16;
    const float* ia = it + 16;
    for (int t = threadIdx.x; t < RA * RA * 4; t += blockDim.x) {
      const int ph = t & 3, p = t >> 2;
      const int hy = 2 * (p / RA) + (ph >> 1), hx = 2 * (p % RA) + (ph & 1);
      const float* src = U + 2 * hy * IS + 6 * hx;
      float acc[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[c] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const float v = src[dy * IS + k];
          const float4* w4 =
              reinterpret_cast<const float4*>(iw + (dy * 9 + k) * 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 w = w4[j];
            acc[4 * j] += v * w.x;
            acc[4 * j + 1] += v * w.y;
            acc[4 * j + 2] += v * w.z;
            acc[4 * j + 3] += v * w.w;
          }
        }
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
        acc[13 + ci] = fmaxf(fmaxf(src[ci], src[3 + ci]),
                             fmaxf(src[IS + ci], src[IS + 3 + ci])) *
                       is[13 + ci];
      float* xo = X0 + p * XS + ph * 16;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(xo + 4 * j) = make_float4(
            prelu(acc[4 * j] + it[4 * j], ia[4 * j]),
            prelu(acc[4 * j + 1] + it[4 * j + 1], ia[4 * j + 1]),
            prelu(acc[4 * j + 2] + it[4 * j + 2], ia[4 * j + 2]),
            prelu(acc[4 * j + 3] + it[4 * j + 3], ia[4 * j + 3]));
    }
  }
  __syncthreads();

  // 3. B1_0's 2x2/s2 projection 16 -> 8 over the region: one tap of K =
  //    4 phases x 16 channels over X0, into U; zero outside the grid
  float* const P = U;
  const Smem L = rec(Wt + B10_PROJ, 1, 64, 8, 8);
  gemm<1, PASSES, 64>(
      0, RA * RA, 8, 1, L.w, L.ws,
      [&](int p, int) { return p < RA * RA ? X0 + p * XS : Z; },
      [&](int p, int c, float v0, float v1) {
        const bool in = inside(R0 - 1 + p / RA, C0 - 1 + p % RA, Hq, Wq);
        float* o = P + p * P0S + c;
        o[0] = in ? prelu(v0 + L.b[c], L.v[c]) : 0.f;
        o[1] = in ? prelu(v1 + L.b[c + 1], L.v[c + 1]) : 0.f;
      });
  __syncthreads();

  // 4. B1_0's 3x3 and expand over the tile, + the pooled X0 (channels <
  //    16, with the first-max switches and mask1; zero above) + PReLU
  float* const xn = x + (size_t)n * Hq * Wq * 64;
  float* const mn = mask1 + (size_t)n * Hq * Wq * 64;
  conv3_expand<8, PASSES>(
      P, P0S, T, rec(Wt + B10_CONV, 9, 8, 8, 8),
      rec(Wt + B10_EXP, 1, 8, 64, 72), Z,
      [&](int p, int ch) {
        float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ch >= 16) return m;
        const float* xq = X0 + ((p / T + 1) * RA + p % T + 1) * XS + ch;
        int4 s = make_int4(0, 0, 0, 0);
        m = *reinterpret_cast<const float4*>(xq);
#pragma unroll
        for (int ph = 1; ph < 4; ++ph) {
          const float4 v = *reinterpret_cast<const float4*>(xq + 16 * ph);
          if (v.x > m.x) m.x = v.x, s.x = ph;
          if (v.y > m.y) m.y = v.y, s.y = ph;
          if (v.z > m.z) m.z = v.z, s.z = ph;
          if (v.w > m.w) m.w = v.w, s.w = ph;
        }
        const int r = R0 + p / T, c = C0 + p % T;
        if (r < Hq && c < Wq) {
          float* mo = mn + ((size_t)r * Wq + c) * 64 + ch;
#pragma unroll
          for (int ph = 0; ph < 4; ++ph)
            *reinterpret_cast<float4*>(mo + 16 * ph) =
                make_float4(s.x == ph, s.y == ph, s.z == ph, s.w == ph);
        }
        return m;
      },
      [&](int p, int ch, float4 v) {
        const int r = R0 + p / T, c = C0 + p % T;
        if (r < Hq && c < Wq)
          *reinterpret_cast<float4*>(xn + ((size_t)r * Wq + c) * 64 + ch) = v;
      });
}

// -- B1_1..1_4 -------------------------------------------------------------

constexpr int RS = T + 2;  // the projection's region side (halo 1)
constexpr size_t STAGE1_SMEM =
    (size_t)(RS * RS * (XS + PS) + BLOCK_F + ZF) * 4;
static_assert(STAGE1_SMEM <= 232448, "227 KB of shared memory a block");

// One block per (image, 16x16 tile at (R0, C0)): x [N,Hq,Wq,64] -> y,
// the stage-1 bottleneck whose records start at `recs`. x over the tile
// plus a halo of 1 is staged in X; PROJ is copied first, so that the
// projection starts while CONV and EXP are still on their way.
template <int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
    stage1_kernel(const float* __restrict__ x, const float* __restrict__ recs,
                  float* __restrict__ y, int Hq, int Wq) {
  extern __shared__ __align__(16) float smem[];
  float* const X = smem;              // x over the region
  float* const P = X + RS * RS * XS;  // the projection
  float* const Wp = P + RS * RS * PS; // PROJ, CONV, EXP
  float* const Wc = Wp + PROJ_F;      // CONV, EXP
  float* const Z = Wp + BLOCK_F;
  const int n = blockIdx.z;
  const int R0 = blockIdx.y * T, C0 = blockIdx.x * T;
  const size_t img = (size_t)n * Hq * Wq;
  const float* xn = x + img * 64;

  // x over the region (zero outside the grid) and PROJ, then CONV + EXP
  for (int i = threadIdx.x; i < RS * RS * 16; i += blockDim.x) {
    const int p = i >> 4, c4 = (i & 15) * 4;
    const int r = R0 - 1 + p / RS, c = C0 - 1 + p % RS;
    float* d = X + p * XS + c4;
    if (inside(r, c, Hq, Wq))
      cp_async16(d, xn + ((size_t)r * Wq + c) * 64 + c4);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_floats(Wp, recs, PROJ_F);
  cp_async_commit();
  cp_async_floats(Wc, recs + PROJ_F, CONV_F + EXP_F);
  cp_async_commit();
  for (int i = threadIdx.x; i < ZF; i += blockDim.x) Z[i] = 0.f;
  cp_async_wait_group_sync<1>();

  // 1x1 projection 64 -> 16 + PReLU over the region, zero outside the grid
  const Smem L = rec(Wp, 1, 64, 16, 24);
  gemm<2, PASSES, 64>(
      0, RS * RS, 16, 1, L.w, L.ws,
      [&](int p, int) { return p < RS * RS ? X + p * XS : Z; },
      [&](int p, int c, float v0, float v1) {
        const bool in = inside(R0 - 1 + p / RS, C0 - 1 + p % RS, Hq, Wq);
        *reinterpret_cast<float2*>(P + p * PS + c) =
            in ? make_float2(prelu(v0 + L.b[c], L.v[c]),
                             prelu(v1 + L.b[c + 1], L.v[c + 1]))
               : make_float2(0.f, 0.f);
      });
  cp_async_wait_sync();  // CONV + EXP, and the projection done

  // 3x3 16 -> 16 and expand 16 -> 64 + the residual + PReLU over the
  // tile, into y
  float* const yn = y + img * 64;
  conv3_expand<16, PASSES>(
      P, PS, T, rec(Wc, 9, 16, 16, 24), rec(Wc + CONV_F, 1, 16, 64, 72), Z,
      [&](int p, int ch) {
        return *reinterpret_cast<const float4*>(
            X + ((1 + p / T) * RS + 1 + p % T) * XS + ch);
      },
      [&](int p, int ch, float4 v) {
        const int r = R0 + p / T, c = C0 + p % T;
        if (r < Hq && c < Wq)
          *reinterpret_cast<float4*>(yn + ((size_t)r * Wq + c) * 64 + ch) = v;
      });
}

// -- launches -------------------------------------------------------------

// mma passes of each route (ops/kernels/front.py PRECISION)
constexpr int kPredictPasses = 3, kScorePasses = 1;

dim3 tile_grid(int n, int hq, int wq) {
  return dim3((wq + T - 1) / T, (hq + T - 1) / T, n);
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

extern "C" int ssal_front_pack_size() { return PACK_F; }

// image [N,h,w,3] f32 -> x [N,h/4,w/4,64] (B1_0's output), mask1
// [N,h/4,w/4,64] f32; h, w % 8 == 0.
extern "C" int ssal_front_b10(const float* image, const float* pack,
                              float* x, float* mask1, int n, int h, int w,
                              int score, void* stream) {
  const auto k = score ? b10_kernel<kScorePasses> : b10_kernel<kPredictPasses>;
  const int status = allow_smem(k, B10_SMEM);
  if (status) return status;
  k<<<tile_grid(n, h / 4, w / 4), THREADS, B10_SMEM, (cudaStream_t)stream>>>(
      image, pack, x, mask1, h, w);
  return (int)cudaGetLastError();
}

// x [N,hq,wq,64] -> y: Bottleneck1_{index+1}, index 0 .. 3.
extern "C" int ssal_front_block(const float* x, const float* pack, float* y,
                                int n, int hq, int wq, int index, int score,
                                void* stream) {
  if (index < 0 || index >= 4) return (int)cudaErrorInvalidValue;
  const auto k =
      score ? stage1_kernel<kScorePasses> : stage1_kernel<kPredictPasses>;
  const int status = allow_smem(k, STAGE1_SMEM);
  if (status) return status;
  k<<<tile_grid(n, hq, wq), THREADS, STAGE1_SMEM, (cudaStream_t)stream>>>(
      x, pack + B10_END + index * BLOCK_F, y, hq, wq);
  return (int)cudaGetLastError();
}
