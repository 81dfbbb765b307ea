// ENet decoder scoring from the pre-Final features: the per-image mean
// entropy confidence (deconv_score_kernel). The decoder score from
// stage-4 features (fused_decoder_entropy_score, ops/pallas_kernels.py
// :687) runs on the tail's tail5_kernel (tail.cu, ssal_tail_decode_score).
//
// deconv_score_kernel replaces fused_deconv_entropy_score (:344, body
// _score_kernel :40): the Final transposed conv as four polyphases
// (pallas_kernels.py:15-19, x[-1] = 0 at the top and left edges) +
// softmax entropy. Inputs: features [N,H/2,W/2,16] f32 and the Final
// kernel [3,3,16,C] f32 (JAX layout). It writes one partial sum of
// pixel confidences 1 - H/log C per block, [N, blocks]; the wrapper
// takes partials.sum(1) / (H*W), as the JAX wrapper does with its
// per-tile sums. The sums are taken in a fixed order (decoder.cuh
// block_partial), so a score is bit-repeatable.
//
// What bounds it on an H100: fp32 FMAs on the CUDA cores, about 1.4 G
// multiply-adds per 1024x2048 image at 19 classes (43 us at the 67
// TFLOP/s fp32 peak) against 34 MB (10 us). The Final stage multiplies
// all four tap slots of every phase (2.25 are used on average).
//
// Design: one block per 16x16 tile of half-res positions plus one row
// and column of halo above and left (17 KB); each of its 256 threads
// takes one half-res position and its four output phases through
// decoder.cuh's final_stage<true>(). fp32 storage and accumulation.
#include "decoder.cuh"

namespace ssal {
namespace {

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
