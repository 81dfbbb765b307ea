// The matmul-stream rig: what rate a stream of [R,128] x [128,N]
// products reaches on the card, independent or as a dependent chain, in
// bf16 on the tensor cores and in fp32 on the CUDA cores
// (tools/probe_matmul_floor.py and tools/probe_front_packing.py of the
// port drive it).
//
// Replaces the Pallas rigs of tools/probe_mosaic_floor.py:103 and
// tools/probe_front_packing.py:134, one contract at two output widths:
// for each of T tiles, a [rows, 128] input and one [128, N] weight,
//   indep  (N = 128) the sum of m products input @ w, fp32;
//   chain  (N = 128) cur <- round(cur @ w), m times;
//   prelu  (N = 128) cur <- round(prelu(cur @ w, 0.25)), m times;
//   nside  (N = 16)  cur <- round(tile(cur @ w)), m times, where tile
//          repeats the 16 output columns 8 times back to 128;
// -> f32 [T], the sum of the final fp32 sum (indep) or of the final cur.
// round() is to bf16 on the bf16 route (bf16 inputs, fp32 accumulation,
// as the TPU rigs computed) and nothing on the fp32 route. Products are
// row-wise, so a row's chain never leaves the warp (bf16) or block
// (fp32) that owns it.
//
// What bounds it on an H100: the issued multiply-adds, 2*rows*128*N*m*T
// FLOP a call: 989 TFLOP/s dense bf16, 67 TFLOP/s fp32.
//
// Design. bf16: the warp-level tensor-core instruction
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate; not wgmma or TMA); a warp
// owns 32 rows (two 16-row m-tiles) and keeps its chain in registers:
// the fp32 accumulator fragment of a product is, pair-rounded to bf16,
// the A fragment of the next (n-tiles 2kk and 2kk+1 are k-step kk; for
// nside n-tiles 0 and 1 are every k-step). The [128,N] weight is staged
// once per block in shared memory, transposed and padded so that each B
// fragment register is one conflict-free 32-bit read. fp32: 256 threads,
// each an 8-row x 8-column register tile (columns strided by N/8), the
// weight and the block's current input (transposed) in shared memory;
// a product's outputs go to a second buffer, which becomes the input.
// Each block writes one partial sum, reduced in a fixed order; the
// wrapper sums a tile's partials.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssal {
namespace {

enum Mode { INDEP = 0, CHAIN = 1, PRELU = 2, NSIDE = 3 };
constexpr int K = 128;  // every product's contraction depth

__device__ __forceinline__ float act(float v, int mode) {
  return mode == PRELU ? fmaxf(v, 0.f) + 0.25f * fminf(v, 0.f) : v;
}

// The sum of every thread's v, in every thread (blockDim.x a power of 2).
__device__ float block_sum(float v, float* slots) {
  slots[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) slots[threadIdx.x] += slots[threadIdx.x + s];
    __syncthreads();
  }
  return slots[0];
}

// -- bf16 on the tensor cores -------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MT = 2;                          // 16-row m-tiles a warp
constexpr int MMA_ROWS = MMA_WARPS * MT * 16;  // rows a block
constexpr int WT_STRIDE = K + 8;  // bf16 a staged weight column

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float sum_bf16(uint32_t u) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  return f.x + f.y;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), g = lane / 4, q = lane
// % 4: A reg 0/1/2/3 = rows (g, g+8, g, g+8) x columns 2q, 2q+1 (+8 for
// regs 2, 3) of the 16x16 k-step; B reg 0/1 = k rows 2q, 2q+1 (+8 for
// reg 1) of column g; C = rows (g, g, g+8, g+8) x columns (2q, 2q+1).
template <int N, int MODE>
__global__ void __launch_bounds__(MMA_WARPS * 32)
    mma_stream_kernel(const __nv_bfloat16* __restrict__ a,
                      const __nv_bfloat16* __restrict__ w,
                      float* __restrict__ partials, int rows, int m) {
  constexpr int NT = N / 8;
  __shared__ __align__(16) __nv_bfloat16 wt[N * WT_STRIDE];
  __shared__ float slots[MMA_WARPS * 32];
  for (int i = threadIdx.x; i < K * N; i += blockDim.x)
    wt[(i % N) * WT_STRIDE + i / N] = w[i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const size_t row0 = (size_t)blockIdx.y * rows +
                      (size_t)blockIdx.x * MMA_ROWS + warp * MT * 16;
  uint32_t af[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const __nv_bfloat16* r = a + (row0 + mt * 16 + g) * K + kk * 16 + 2 * q;
      af[mt][kk][0] = ld32(r);
      af[mt][kk][1] = ld32(r + 8 * K);
      af[mt][kk][2] = ld32(r + 8);
      af[mt][kk][3] = ld32(r + 8 * K + 8);
    }
  float c[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) c[mt][j][0] = c[mt][j][1] = c[mt][j][2] = c[mt][j][3] = 0.f;

  for (int p = 0; p < m; ++p) {
    if (MODE != INDEP) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          c[mt][j][0] = c[mt][j][1] = c[mt][j][2] = c[mt][j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* b = wt + (j * 8 + g) * WT_STRIDE + kk * 16 + 2 * q;
        const uint32_t b0 = ld32(b), b1 = ld32(b + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(c[mt][j], af[mt][kk], b0, b1);
      }
    }
    if (MODE != INDEP) {  // the accumulators, rounded, are the next input
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int j0 = MODE == NSIDE ? 0 : 2 * kk;
          af[mt][kk][0] = pack_bf16(act(c[mt][j0][0], MODE), act(c[mt][j0][1], MODE));
          af[mt][kk][1] = pack_bf16(act(c[mt][j0][2], MODE), act(c[mt][j0][3], MODE));
          af[mt][kk][2] = pack_bf16(act(c[mt][j0 + 1][0], MODE), act(c[mt][j0 + 1][1], MODE));
          af[mt][kk][3] = pack_bf16(act(c[mt][j0 + 1][2], MODE), act(c[mt][j0 + 1][3], MODE));
        }
    }
  }

  float s = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (MODE == INDEP) {
#pragma unroll
      for (int j = 0; j < NT; ++j) s += (c[mt][j][0] + c[mt][j][1]) + (c[mt][j][2] + c[mt][j][3]);
    } else {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        s += (sum_bf16(af[mt][kk][0]) + sum_bf16(af[mt][kk][1])) +
             (sum_bf16(af[mt][kk][2]) + sum_bf16(af[mt][kk][3]));
    }
  }
  s = block_sum(s, slots);
  if (threadIdx.x == 0) partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// -- fp32 on the CUDA cores ----------------------------------------------

constexpr int FMA_THREADS = 256;
constexpr int RT = 8;  // rows of a thread's register tile (and columns)

template <int N>
struct FmaTile {
  static constexpr int TX = N / 8;                 // threads across columns
  static constexpr int RB = FMA_THREADS / TX * RT;  // rows a block
  static constexpr int CS = RB + 4;  // floats a transposed input column
  static constexpr size_t SMEM = (size_t)(K * N + 2 * N * CS) * 4;
};
static_assert(FmaTile<128>::SMEM <= 232448 && FmaTile<16>::SMEM <= 232448,
              "227 KB of shared memory a block");

// In shared memory: W [K][N], then two transposed inputs [N][CS] (the
// input column k of a row-tiled nside input is column k % N). The first
// nside product reads its 128 distinct columns from global memory.
template <int N, int MODE>
__global__ void __launch_bounds__(FMA_THREADS)
    fma_stream_kernel(const float* __restrict__ a, const float* __restrict__ w,
                      float* __restrict__ partials, int rows, int m) {
  using T = FmaTile<N>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float slots[FMA_THREADS];
  float* W = smem;
  float* cur = W + K * N;
  float* nxt = cur + N * T::CS;
  const float* ab =
      a + ((size_t)blockIdx.y * rows + (size_t)blockIdx.x * T::RB) * K;
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  for (int i = threadIdx.x; i < K * N; i += blockDim.x) W[i] = w[i];
  if (N == K)
    for (int i = threadIdx.x; i < T::RB * K; i += blockDim.x)
      cur[(i % K) * T::CS + i / K] = ab[i];
  __syncthreads();

  float acc[RT][RT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;
  for (int p = 0; p < m; ++p) {
    if (MODE != INDEP) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;
    }
    const bool global_input = N != K && p == 0;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float x[RT], wv[RT];
      if (global_input) {
#pragma unroll
        for (int i = 0; i < RT; ++i) x[i] = __ldg(ab + (size_t)(RT * ty + i) * K + k);
      } else {
        const float4* xp =
            reinterpret_cast<const float4*>(cur + (k % N) * T::CS + RT * ty);
        const float4 x0 = xp[0], x1 = xp[1];
        x[0] = x0.x, x[1] = x0.y, x[2] = x0.z, x[3] = x0.w;
        x[4] = x1.x, x[5] = x1.y, x[6] = x1.z, x[7] = x1.w;
      }
#pragma unroll
      for (int j = 0; j < RT; ++j) wv[j] = W[k * N + tx + T::TX * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i][j] += x[i] * wv[j];
    }
    if (MODE != INDEP) {
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        float* o = nxt + (tx + T::TX * j) * T::CS + RT * ty;
        reinterpret_cast<float4*>(o)[0] =
            make_float4(act(acc[0][j], MODE), act(acc[1][j], MODE),
                        act(acc[2][j], MODE), act(acc[3][j], MODE));
        reinterpret_cast<float4*>(o)[1] =
            make_float4(act(acc[4][j], MODE), act(acc[5][j], MODE),
                        act(acc[6][j], MODE), act(acc[7][j], MODE));
      }
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    // every thread has read cur (and, for a chain, written nxt): the
    // next product may start; for indep it also keeps the compiler from
    // hoisting the loop-invariant product out of the loop
    __syncthreads();
  }

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j)
      s += MODE == INDEP ? acc[i][j] : act(acc[i][j], MODE);
  if (MODE == NSIDE) s *= K / N;  // the final input repeats its columns
  s = block_sum(s, slots);
  if (threadIdx.x == 0) partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

template <int N, int MODE>
int launch(bool bf16, const void* a, const void* w, float* partials, int tiles,
           int rows, int m, cudaStream_t stream) {
  if (bf16) {
    const dim3 grid(rows / MMA_ROWS, tiles);
    mma_stream_kernel<N, MODE><<<grid, MMA_WARPS * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(w), partials, rows, m);
  } else {
    using T = FmaTile<N>;
    cudaFuncSetAttribute(fma_stream_kernel<N, MODE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)T::SMEM);
    const dim3 grid(rows / T::RB, tiles);
    fma_stream_kernel<N, MODE><<<grid, FMA_THREADS, T::SMEM, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(w), partials,
        rows, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ssal

using namespace ssal;

// Rows of a tile one block takes: a tile's rows must be a multiple, and
// the partials are [tiles, rows / this].
extern "C" int ssal_probe_matmul_block_rows(int n_cols, int bf16) {
  return bf16 ? MMA_ROWS : (n_cols == K ? FmaTile<K>::RB : FmaTile<16>::RB);
}

// a [tiles, rows, 128] and w [128, n_cols], both bf16 or both f32 ->
// partials [tiles, rows / block_rows] f32 (sum over the second axis for
// the rig's output); mode 0..2 (indep, chain, prelu) with n_cols 128,
// mode 3 (nside) with n_cols 16; m >= 1. Returns -1 for another
// combination.
extern "C" int ssal_probe_matmul(const void* a, const void* w, float* partials,
                                 int tiles, int rows, int n_cols, int m,
                                 int mode, int bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_cols == K && mode == INDEP)
    return launch<K, INDEP>(bf16, a, w, partials, tiles, rows, m, s);
  if (n_cols == K && mode == CHAIN)
    return launch<K, CHAIN>(bf16, a, w, partials, tiles, rows, m, s);
  if (n_cols == K && mode == PRELU)
    return launch<K, PRELU>(bf16, a, w, partials, tiles, rows, m, s);
  if (n_cols == 16 && mode == NSIDE)
    return launch<16, NSIDE>(bf16, a, w, partials, tiles, rows, m, s);
  return -1;
}
