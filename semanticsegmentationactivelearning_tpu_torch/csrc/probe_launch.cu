// The launch rig: the grid and tile streams of the tail kernel with a
// trivial body, so that what one call costs beyond its arithmetic can
// be read off (tools/probe_launch_overhead.py of the port drives it).
//
// Replaces the Pallas rig of tools/probe_pallas_overhead.py:81: grid
// (N, H8/te); nine tile streams, y (128 channels), sw (64) and m1 (256)
// each at row-tile offsets -1, 0, +1 clipped to the grid; a body that
// sums the centre y tile into [N, H8/te]; optionally 41 constant
// operands shaped (1,256), (256,256) and (4,128,256) in turn. On the TPU
// every operand was copied into VMEM whether the body used it or not;
// on the card a read happens only if the code issues it, so every block
// reads all nine tiles and every constant, and their sum goes to a
// second output, reads [N, H8/te], which the plain version also
// computes. fp32, the dtype of the port's tail streams.
//
// What bounds it on an H100: the reads. At the rig's defaults (batch 16,
// H8 128, W8 256, te 16) the three streams hold 940 MB, each block reads
// three row tiles of each (2.8 GB a call) and the 10.5 MB of constants
// (1.3 GB over 128 blocks, mostly from L2); 940 MB once is 0.28 ms at
// 3.35 TB/s.
//
// Design: one block of 1024 threads per (tile, image), 16-byte loads,
// four in flight a thread; each sum is reduced over the block in shared
// memory in a fixed order (no atomics).
#include <cuda_runtime.h>

namespace ssal {
namespace {

constexpr int LAUNCH_THREADS = 1024;
constexpr int MAX_CONSTS = 64;

struct Consts {
  const float* p[MAX_CONSTS];
  int n[MAX_CONSTS];
  int count;
};

// This thread's part of the sum of p[0..n).
__device__ float sum_part(const float* __restrict__ p, int n) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const int n4 = n >> 2, step = blockDim.x;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int i = threadIdx.x;
  for (; i + 3 * step < n4; i += 4 * step) {
    const float4 a = __ldg(q + i), b = __ldg(q + i + step);
    const float4 c = __ldg(q + i + 2 * step), d = __ldg(q + i + 3 * step);
    s0 += (a.x + a.y) + (a.z + a.w);
    s1 += (b.x + b.y) + (b.z + b.w);
    s2 += (c.x + c.y) + (c.z + c.w);
    s3 += (d.x + d.y) + (d.z + d.w);
  }
  for (; i < n4; i += step) {
    const float4 a = __ldg(q + i);
    s0 += (a.x + a.y) + (a.z + a.w);
  }
  for (int k = 4 * n4 + threadIdx.x; k < n; k += step) s1 += __ldg(p + k);
  return (s0 + s1) + (s2 + s3);
}

// The sum of every thread's v, in thread 0 (blockDim.x a power of 2).
__device__ float block_sum(float v, float* slots) {
  slots[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) slots[threadIdx.x] += slots[threadIdx.x + s];
    __syncthreads();
  }
  return slots[0];
}

__global__ void __launch_bounds__(LAUNCH_THREADS)
    probe_launch_kernel(const float* __restrict__ y,
                        const float* __restrict__ sw,
                        const float* __restrict__ m1, const Consts consts,
                        float* __restrict__ centre, float* __restrict__ reads,
                        int h8, int w8, int te) {
  __shared__ float slots[2][LAUNCH_THREADS];
  const int j = blockIdx.x, n = blockIdx.y, tiles = gridDim.x;
  const float* streams[3] = {y, sw, m1};
  const int channels[3] = {128, 64, 256};
  float own = 0.f, all = 0.f;
  for (int off = -1; off <= 1; ++off) {
    const int jt = min(max(j + off, 0), tiles - 1);
    for (int s = 0; s < 3; ++s) {
      const size_t base = ((size_t)n * h8 + (size_t)jt * te) * w8 * channels[s];
      const float v = sum_part(streams[s] + base, te * w8 * channels[s]);
      all += v;
      if (s == 0 && off == 0) own = v;
    }
  }
  for (int i = 0; i < consts.count; ++i) all += sum_part(consts.p[i], consts.n[i]);
  const float c = block_sum(own, slots[0]);
  const float r = block_sum(all, slots[1]);
  if (threadIdx.x == 0) {
    centre[(size_t)n * tiles + j] = c;
    reads[(size_t)n * tiles + j] = r;
  }
}

}  // namespace
}  // namespace ssal

using namespace ssal;

extern "C" int ssal_probe_launch_max_consts() { return MAX_CONSTS; }

// y [N,H8,W8,128], sw [N,H8,W8,64], m1 [N,H8,W8,256] f32, nconst
// constant operands (device pointers and float counts, host arrays) ->
// centre, reads [N, H8/te]; H8 a multiple of te, nconst <= MAX_CONSTS,
// every operand 16-byte aligned.
extern "C" int ssal_probe_launch(const float* y, const float* sw,
                                 const float* m1,
                                 const float* const* const_ptrs,
                                 const int* const_sizes, int nconst,
                                 float* centre, float* reads, int n, int h8,
                                 int w8, int te, void* stream) {
  Consts consts;
  consts.count = nconst;
  for (int i = 0; i < nconst; ++i) {
    consts.p[i] = const_ptrs[i];
    consts.n[i] = const_sizes[i];
  }
  const dim3 grid(h8 / te, n);
  probe_launch_kernel<<<grid, LAUNCH_THREADS, 0, (cudaStream_t)stream>>>(
      y, sw, m1, consts, centre, reads, h8, w8, te);
  return (int)cudaGetLastError();
}
