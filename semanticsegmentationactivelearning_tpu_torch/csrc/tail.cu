// ENet tail: stage-3 features + both pool switches -> labels (predict)
// or the per-image mean entropy confidence (score).
//
// Replaces fused_tail_predict (ops/pallas_kernels.py:2810) and
// fused_tail_entropy_score (:2720), both the body _tail_kernel :2495
// (pack pack_enet_tail :2383).
//
// Computes Bottleneck4_0 (1x1 projection, 3x3/s2 transposed conv,
// expand; residual = 1x1 conv unpooled by sw2) -> Bottleneck4_1, 4_2 ->
// Bottleneck5_0 (the same, unpooled by mask1) -> Bottleneck5_1 -> the
// Final 3x3/s2 transposed conv, then per pixel either the argmax that
// keeps the first maximum (the lowest class index, as jnp.argmax does)
// or the confidence 1 - H(softmax)/log C. Inputs: y [N,H/8,W/8,128]
// f32, sw2 int8 [N,H/8,W/8,64] (0..3), mask1 [N,H/4,W/4,64] f32 one-hot
// at channel p*16 + c. Output: int8 labels [N,H,W], or one partial sum
// of confidences per block [N, blocks] that the wrapper reduces to the
// per-image mean. The quarter- and half-resolution activations live in
// shared memory and each pixel's class logits in registers; only the
// labels or the partials reach global memory.
//
// What bounds it on an H100: fp32 FMAs on the CUDA cores, about 3.8 G
// multiply-adds per 1024x2048 image before halo recompute (110 us at
// the 67 TFLOP/s fp32 peak), against 27 MB read and 2 MB written.
//
// Design: one block per (image, 4x4 tile of eighth-res positions),
// i.e. 32x32 output pixels. Working backwards from the tile, the stages
// need a halo of 3 eighth positions above/left and 2 below/right:
// eighth 9x9 (B4_0 projection), quarter 15x15 -> 13x13 -> 11x11
// (B4_0..4_2), half 19x19 -> 17x17 (B5_0, B5_1). Each stage computes
// exactly its rectangle and zeroes what lies outside the image, which
// is also the transposed convs' x[-1] = 0 edge. The buffers take 109 KB
// of shared memory, two blocks per SM. The unpooled residuals are
// computed only where the switch selects the position. Stage 5 and the
// Final stage are decoder.cuh's, shared with the decoder and deconv
// score kernels; the last stage (argmax or entropy) is a template
// parameter, so predict and score run one body. The score reduces
// without atomics (decoder.cuh block_partial), so it is bit-repeatable.
// fp32 storage and accumulation; wgmma and bf16 are later work.
#include "decoder.cuh"

namespace ssal {
namespace {

constexpr int TE = TQ / 2;  // eighth-res tile side
constexpr int THREADS = S5_THREADS;
// buffer sizes in floats (rectangle positions x odd channel stride)
constexpr int Q0N = (2 * TE + 7) * (2 * TE + 7);  // quarter, B4_0 out
constexpr int Q1N = (2 * TE + 5) * (2 * TE + 5);
constexpr int REN = (TE + 5) * (TE + 5);          // eighth, B4_0 proj
constexpr int X4F = Q0N * 65;
constexpr int AF = cmax(Q0N * 17, S5_AF);
constexpr int BF = cmax(cmax(REN * 33, Q1N * 17), S5_BF);
constexpr int X5F = S5_XF;
constexpr size_t SMEM_BYTES = (size_t)(X4F + AF + BF + X5F) * 4;

struct TailParams {
  UpParams b40;             // 128 -> 32 -> 16 -> 64
  BottleneckParams b4[2];   // 64, projection 16
  Stage5Params s5;          // B5_0, B5_1, Final
};

// kScore false: labels [N][H][W]; true: partials [N][gridDim.y *
// gridDim.x], one per block.
template <bool kScore>
__global__ void __launch_bounds__(THREADS)
    tail_kernel(const float* __restrict__ y, const int8_t* __restrict__ sw2,
                const float* __restrict__ mask1, const TailParams P,
                int8_t* __restrict__ labels, float* __restrict__ partials,
                int H8, int W8, int C) {
  extern __shared__ float smem[];
  const int n = blockIdx.z;
  const int Hq = 2 * H8, Wq = 2 * W8;
  const int H = 8 * H8, W = 8 * W8;
  const int E0 = blockIdx.y * TE, F0 = blockIdx.x * TE;
  const Rect re = {E0 - 3, F0 - 3, TE + 5, TE + 5};
  const Rect q0 = {2 * E0 - 4, 2 * F0 - 4, 2 * TE + 7, 2 * TE + 7};
  const Rect q1 = {2 * E0 - 3, 2 * F0 - 3, 2 * TE + 5, 2 * TE + 5};
  const Rect q2 = {2 * E0 - 2, 2 * F0 - 2, 2 * TE + 3, 2 * TE + 3};
  float* const X4p = smem;
  float* const Ap = X4p + X4F;
  float* const Bp = Ap + AF;
  float* const X5p = Bp + BF;
  const Buf X4 = {X4p, q0, 65};
  const float* yn = y + (size_t)n * H8 * W8 * 128;
  const int8_t* swn = sw2 + (size_t)n * H8 * W8 * 64;
  const float* mn = mask1 + (size_t)n * Hq * Wq * 64;

  // --- Bottleneck4_0 -------------------------------------------------
  // projection 128 -> 32 at eighth res, zero outside
  const Buf Pe = {Bp, re, 33};
  for (int t = threadIdx.x; t < re.size() * 32; t += blockDim.x) {
    const int oc = t % 32, p = t / 32;
    const int r = re.row(p), c = re.col(p);
    float v = 0.f;
    if (inside(r, c, H8, W8)) {
      const float* xs = yn + ((size_t)r * W8 + c) * 128;
      float acc = __ldg(P.b40.proj.b + oc);
#pragma unroll 8
      for (int ic = 0; ic < 128; ++ic)
        acc += __ldg(xs + ic) * __ldg(P.b40.proj.w + ic * 32 + oc);
      v = prelu(acc, __ldg(P.b40.proj.alpha + oc));
    }
    Pe.at(r, c)[oc] = v;
  }
  // residual: the 1x1 conv 128 -> 64 unpooled by sw2, into X4
  for (int t = threadIdx.x; t < q0.size() * 64; t += blockDim.x) {
    const int oc = t % 64, p = t / 64;
    const int r = q0.row(p), c = q0.col(p);
    float v = 0.f;
    if (inside(r, c, Hq, Wq)) {
      const size_t e = (size_t)(r >> 1) * W8 + (c >> 1);
      if (swn[e * 64 + oc] == 2 * (r & 1) + (c & 1)) {
        const float* xs = yn + e * 128;
#pragma unroll 8
        for (int ic = 0; ic < 128; ++ic)
          v += __ldg(xs + ic) * __ldg(P.b40.res_w + ic * 64 + oc);
      }
    }
    X4.at(r, c)[oc] = v;
  }
  __syncthreads();
  const Buf D4 = {Ap, q0, 17};
  deconv_stage<32, 16>(Pe, D4, q0, P.b40.deconv, Hq, Wq);
  __syncthreads();
  expand_residual<16, 64>(D4, X4, q0, P.b40.exp, P.b40.res_alpha, Hq, Wq);
  __syncthreads();

  // --- Bottleneck4_1, 4_2 ---------------------------------------------
  const Buf T4 = {Ap, q0, 17};
  const Buf U4 = {Bp, q1, 17};
  const Rect ins[2] = {q0, q1};
  const Rect outs[2] = {q1, q2};
  for (int k = 0; k < 2; ++k) {
    conv_stage<64, 16, 1, 1>(X4, T4, ins[k], 1, P.b4[k].proj, Hq, Wq);
    __syncthreads();
    conv_stage<16, 16, 3, 3>(T4, U4, outs[k], 1, P.b4[k].conv, Hq, Wq);
    __syncthreads();
    expand_residual<16, 64>(U4, X4, outs[k], P.b4[k].exp,
                            P.b4[k].res_alpha, Hq, Wq);
    __syncthreads();
  }

  // --- Bottleneck5_0, 5_1 (X4 covers q0, which holds q2) ----------------
  stage5(X4, mn, P.s5, Ap, Bp, X5p, 2 * E0, 2 * F0, Hq, Wq);

  // --- Final transposed conv + argmax or entropy -----------------------
  const Buf X5 = {X5p, {4 * E0 - 2, 4 * F0 - 2, 4 * TE + 3, 4 * TE + 3}, 17};
  const float v = final_stage<kScore>(
      X5, P.s5.final_w, C, 4 * E0, 4 * F0, H, W,
      kScore ? nullptr : labels + (size_t)n * H * W);
  if (kScore)
    block_partial(v, Ap,
                  partials + ((size_t)n * gridDim.y + blockIdx.y) * gridDim.x +
                      blockIdx.x);
}

TailParams take_tail(const float* pack, int num_classes) {
  Cursor cur{pack};
  TailParams P;
  P.b40 = take_up(cur, 128, 32, 16, 64);
  for (int k = 0; k < 2; ++k) P.b4[k] = take_bottleneck(cur, 64, 16);
  P.s5 = take_stage5(cur, num_classes);
  return P;
}

template <bool kScore>
int launch_tail(const float* y, const int8_t* sw2, const float* mask1,
                const float* pack, int8_t* labels, float* partials, int n,
                int h8, int w8, int num_classes, void* stream) {
  const TailParams P = take_tail(pack, num_classes);
  cudaFuncSetAttribute(tail_kernel<kScore>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  const dim3 grid((w8 + TE - 1) / TE, (h8 + TE - 1) / TE, n);
  tail_kernel<kScore><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      y, sw2, mask1, P, labels, partials, h8, w8, num_classes);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ssal

using namespace ssal;

extern "C" int ssal_tail_pack_size(int num_classes) {
  return up_pack_size(128, 32, 16, 64) + 2 * bottleneck_pack_size(64, 16) +
         stage5_pack_size(num_classes);
}

// y [N,H8,W8,128], sw2 int8 [N,H8,W8,64], mask1 [N,2H8,2W8,64]
// -> labels int8 [N,8H8,8W8]; num_classes <= 127.
extern "C" int ssal_tail_predict(const float* y, const int8_t* sw2,
                                 const float* mask1, const float* pack,
                                 int8_t* labels, int n, int h8, int w8,
                                 int num_classes, void* stream) {
  return launch_tail<false>(y, sw2, mask1, pack, labels, nullptr, n, h8, w8,
                            num_classes, stream);
}

// Partial sums of ssal_tail_score per image.
extern "C" int ssal_tail_partials(int h8, int w8) {
  return ((h8 + TE - 1) / TE) * ((w8 + TE - 1) / TE);
}

// The same inputs -> partials [N, ssal_tail_partials(h8, w8)]: sums of
// the pixels' entropy confidences, one per block.
extern "C" int ssal_tail_score(const float* y, const int8_t* sw2,
                               const float* mask1, const float* pack,
                               float* partials, int n, int h8, int w8,
                               int num_classes, void* stream) {
  return launch_tail<true>(y, sw2, mask1, pack, nullptr, partials, n, h8, w8,
                           num_classes, stream);
}
