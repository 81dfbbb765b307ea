// ENet decoder scoring: the per-image mean entropy confidence from
// stage-4 features (decoder_score_kernel) or from the pre-Final
// features (deconv_score_kernel).
//
// decoder_score_kernel replaces fused_decoder_entropy_score
// (ops/pallas_kernels.py:687, body _decoder_kernel :582, pack
// pack_enet_decoder :453): Bottleneck5_0 (unpooled by the B1_0 mask) +
// Bottleneck5_1 + the Final 3x3/s2 transposed conv + softmax entropy.
// Inputs: f4 [N,H/4,W/4,64] f32 and mask1 [N,H/4,W/4,64] f32 one-hot at
// channel p*16 + c (the wrapper expands switches into it).
//
// deconv_score_kernel replaces fused_deconv_entropy_score (:344, body
// _score_kernel :40): the Final transposed conv as four polyphases
// (pallas_kernels.py:15-19, x[-1] = 0 at the top and left edges) +
// softmax entropy. Inputs: features [N,H/2,W/2,16] f32 and the Final
// kernel [3,3,16,C] f32 (JAX layout).
//
// Both write one partial sum of pixel confidences 1 - H/log C per
// block, [N, blocks]; the wrapper takes partials.sum(1) / (H*W), as the
// JAX wrappers do with their per-tile sums. The sums are taken in a
// fixed order (decoder.cuh block_partial), so a score is bit-repeatable.
//
// What bounds them on an H100: fp32 FMAs on the CUDA cores. Per
// 1024x2048 image and 19 classes the decoder does about 2.0 G
// multiply-adds before halo recompute (61 us at the 67 TFLOP/s fp32
// peak) against 67 MB read (20 us at 3.35 TB/s); the deconv does 1.4 G,
// nearly all of the decoder's Final stage (43 us), against 34 MB
// (10 us). The Final stage multiplies all four tap slots of every phase
// (2.25 are used on average), like the tail kernel.
//
// Design: the decoder kernel takes one block per (image, 8x8 tile of
// quarter-res positions), i.e. 32x32 output pixels, loads the stage-4
// features of the tile and a halo of 2 above/left and 1 below/right
// into shared memory (zero outside the image) and runs decoder.cuh's
// stage5() and final_stage<true>(), the tail kernel's own code: 77 KB
// of shared memory. The deconv kernel takes one block per 16x16 tile of
// half-res positions plus one row and column of halo above and left
// (17 KB); each of its 256 threads takes one half-res position and its
// four output phases through the same final_stage<true>(). fp32
// storage and accumulation.
#include "decoder.cuh"

namespace ssal {
namespace {

constexpr int X4N = S5_Q2N * 65;  // stage-4 features, odd channel stride
constexpr size_t DEC_SMEM_BYTES =
    (size_t)(X4N + S5_AF + S5_BF + S5_XF) * 4;

__global__ void __launch_bounds__(S5_THREADS)
    decoder_score_kernel(const float* __restrict__ f4,
                         const float* __restrict__ mask1,
                         const Stage5Params P, float* __restrict__ partials,
                         int Hq, int Wq, int C) {
  extern __shared__ float smem[];
  const int n = blockIdx.z;
  const int qr0 = blockIdx.y * TQ, qc0 = blockIdx.x * TQ;
  const Rect q2 = {qr0 - 2, qc0 - 2, TQ + 3, TQ + 3};
  float* const X4p = smem;
  float* const A = X4p + X4N;
  float* const B = A + S5_AF;
  float* const X5p = B + S5_BF;
  const Buf X4 = {X4p, q2, 65};
  const float* fn = f4 + (size_t)n * Hq * Wq * 64;
  for (int t = threadIdx.x; t < q2.size() * 64; t += blockDim.x) {
    const int ic = t % 64, p = t / 64;
    const int r = q2.row(p), c = q2.col(p);
    X4.at(r, c)[ic] =
        inside(r, c, Hq, Wq) ? __ldg(fn + ((size_t)r * Wq + c) * 64 + ic)
                             : 0.f;
  }
  __syncthreads();
  stage5(X4, mask1 + (size_t)n * Hq * Wq * 64, P, A, B, X5p, qr0, qc0, Hq,
         Wq);
  const Buf X5 = {X5p, {2 * qr0 - 2, 2 * qc0 - 2, 2 * TQ + 3, 2 * TQ + 3},
                  17};
  const float v = final_stage<true>(X5, P.final_w, C, 2 * qr0, 2 * qc0,
                                    4 * Hq, 4 * Wq, nullptr);
  block_partial(v, A,
                partials + ((size_t)n * gridDim.y + blockIdx.y) * gridDim.x +
                    blockIdx.x);
}

__global__ void __launch_bounds__(S5_THREADS)
    deconv_score_kernel(const float* __restrict__ x,
                        const float* __restrict__ fw,
                        float* __restrict__ partials, int H2, int W2,
                        int C) {
  __shared__ float xs[(SIDE + 1) * (SIDE + 1) * 17];
  __shared__ float slots[S5_THREADS];
  const int n = blockIdx.z;
  const int hy0 = blockIdx.y * SIDE, hx0 = blockIdx.x * SIDE;
  const Rect rect = {hy0 - 1, hx0 - 1, SIDE + 1, SIDE + 1};
  const Buf X = {xs, rect, 17};
  const float* xn = x + (size_t)n * H2 * W2 * 16;
  for (int t = threadIdx.x; t < rect.size() * 16; t += blockDim.x) {
    const int ic = t % 16, p = t / 16;
    const int r = rect.row(p), c = rect.col(p);
    X.at(r, c)[ic] =
        inside(r, c, H2, W2) ? __ldg(xn + ((size_t)r * W2 + c) * 16 + ic)
                             : 0.f;
  }
  __syncthreads();
  const float v =
      final_stage<true>(X, fw, C, hy0, hx0, 2 * H2, 2 * W2, nullptr);
  block_partial(v, slots,
                partials + ((size_t)n * gridDim.y + blockIdx.y) * gridDim.x +
                    blockIdx.x);
}

}  // namespace
}  // namespace ssal

using namespace ssal;

extern "C" int ssal_decoder_pack_size(int num_classes) {
  return stage5_pack_size(num_classes);
}

extern "C" int ssal_decoder_partials(int hq, int wq) {
  return ((hq + TQ - 1) / TQ) * ((wq + TQ - 1) / TQ);
}

// f4 [N,Hq,Wq,64], mask1 [N,Hq,Wq,64] -> partials [N,
// ssal_decoder_partials(hq, wq)].
extern "C" int ssal_decoder_score(const float* f4, const float* mask1,
                                  const float* pack, float* partials, int n,
                                  int hq, int wq, int num_classes,
                                  void* stream) {
  Cursor cur{pack};
  const Stage5Params P = take_stage5(cur, num_classes);
  cudaFuncSetAttribute(decoder_score_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)DEC_SMEM_BYTES);
  const dim3 grid((wq + TQ - 1) / TQ, (hq + TQ - 1) / TQ, n);
  decoder_score_kernel<<<grid, S5_THREADS, DEC_SMEM_BYTES,
                         (cudaStream_t)stream>>>(f4, mask1, P, partials, hq,
                                                 wq, num_classes);
  return (int)cudaGetLastError();
}

extern "C" int ssal_deconv_partials(int h2, int w2) {
  return ((h2 + SIDE - 1) / SIDE) * ((w2 + SIDE - 1) / SIDE);
}

// features [N,H2,W2,16], final_w [3,3,16,C] -> partials [N,
// ssal_deconv_partials(h2, w2)].
extern "C" int ssal_deconv_score(const float* x, const float* final_w,
                                 float* partials, int n, int h2, int w2,
                                 int num_classes, void* stream) {
  const dim3 grid((w2 + SIDE - 1) / SIDE, (h2 + SIDE - 1) / SIDE, n);
  deconv_score_kernel<<<grid, S5_THREADS, 0, (cudaStream_t)stream>>>(
      x, final_w, partials, h2, w2, num_classes);
  return (int)cudaGetLastError();
}
