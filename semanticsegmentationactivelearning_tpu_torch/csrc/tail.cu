// ENet predict tail: stage-3 features + both pool switches -> labels.
//
// Replaces fused_tail_predict (ops/pallas_kernels.py:2810, body
// _tail_kernel :2495 in mode "predict", pack pack_enet_tail :2383).
//
// Computes Bottleneck4_0 (1x1 projection, 3x3/s2 transposed conv,
// expand; residual = 1x1 conv unpooled by sw2) -> Bottleneck4_1, 4_2 ->
// Bottleneck5_0 (the same, unpooled by mask1) -> Bottleneck5_1 -> the
// Final 3x3/s2 transposed conv -> per-pixel argmax keeping the first
// maximum (the lowest class index, as jnp.argmax does). Inputs: y
// [N,H/8,W/8,128] f32, sw2 int8 [N,H/8,W/8,64] (0..3), mask1
// [N,H/4,W/4,64] f32 one-hot at channel p*16 + c. Output: int8 labels
// [N,H,W]. The quarter- and half-resolution activations live in shared
// memory and each pixel's class logits in registers; only the label
// reaches global memory.
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
// computed only where the switch selects the position. fp32 storage
// and accumulation; wgmma and bf16 are later work.
#include "common.cuh"

namespace ssal {
namespace {

constexpr int TE = 4;  // eighth-res tile side
constexpr int THREADS = 256;
// buffer sizes in floats (rectangle positions x odd channel stride)
constexpr int Q0N = (2 * TE + 7) * (2 * TE + 7);  // quarter, B4_0 out
constexpr int Q1N = (2 * TE + 5) * (2 * TE + 5);
constexpr int H0N = (4 * TE + 3) * (4 * TE + 3);  // half, B5_0 out
constexpr int H1N = (4 * TE + 1) * (4 * TE + 1);
constexpr int REN = (TE + 5) * (TE + 5);          // eighth, B4_0 proj
constexpr int X4F = Q0N * 65;
constexpr int AF = Q0N * 17;
constexpr int BF_ = REN * 33 > Q1N * 17 ? REN * 33 : Q1N * 17;
constexpr int BF = BF_ > H0N * 9 ? BF_ : H0N * 9;
constexpr int X5F = H0N * 17;
constexpr size_t SMEM_BYTES = (size_t)(X4F + AF + BF + X5F) * 4;

struct UpParams {
  Affine proj, deconv, exp;
  const float* res_w;  // [cin][cout], the residual 1x1 conv (no BN)
  const float* res_alpha;
};

struct TailParams {
  UpParams b40;             // 128 -> 32 -> 16 -> 64
  BottleneckParams b4[2];   // 64, projection 16
  UpParams b50;             // 64 -> 16 -> 8 -> 16
  BottleneckParams b51;     // 16, projection 4
  const float* final_w;     // [3][3][16][C]
};

UpParams take_up(Cursor& c, int cin, int f, int fo, int cout) {
  UpParams p;
  p.proj = take_affine(c, cin * f, f, true);
  p.deconv = take_affine(c, 9 * f * fo, fo, true);
  p.exp = take_affine(c, fo * cout, cout, false);
  p.res_w = c.take(cin * cout);
  p.res_alpha = c.take(cout);
  return p;
}

int up_pack_size(int cin, int f, int fo, int cout) {
  return cin * f + 2 * f + 9 * f * fo + 2 * fo + fo * cout + cout +
         cin * cout + cout;
}

__global__ void __launch_bounds__(THREADS)
    tail_kernel(const float* __restrict__ y, const int8_t* __restrict__ sw2,
                const float* __restrict__ mask1, const TailParams P,
                int8_t* __restrict__ labels, int H8, int W8, int C) {
  extern __shared__ float smem[];
  const int n = blockIdx.z;
  const int Hq = 2 * H8, Wq = 2 * W8, Hh = 4 * H8, Wh = 4 * W8;
  const int H = 8 * H8, W = 8 * W8;
  const int E0 = blockIdx.y * TE, F0 = blockIdx.x * TE;
  const Rect re = {E0 - 3, F0 - 3, TE + 5, TE + 5};
  const Rect q0 = {2 * E0 - 4, 2 * F0 - 4, 2 * TE + 7, 2 * TE + 7};
  const Rect q1 = {2 * E0 - 3, 2 * F0 - 3, 2 * TE + 5, 2 * TE + 5};
  const Rect q2 = {2 * E0 - 2, 2 * F0 - 2, 2 * TE + 3, 2 * TE + 3};
  const Rect h0 = {4 * E0 - 2, 4 * F0 - 2, 4 * TE + 3, 4 * TE + 3};
  const Rect h1 = {4 * E0 - 1, 4 * F0 - 1, 4 * TE + 1, 4 * TE + 1};
  float* const X4p = smem;
  float* const Ap = X4p + X4F;
  float* const Bp = Ap + AF;
  float* const X5p = Bp + BF;
  const Buf X4 = {X4p, q0, 65};
  const Buf X5 = {X5p, h0, 17};
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

  // --- Bottleneck5_0 ----------------------------------------------------
  const Buf P5 = {Ap, q2, 17};
  conv_stage<64, 16, 1, 1>(X4, P5, q2, 1, P.b50.proj, Hq, Wq);
  // residual: the 1x1 conv 64 -> 16 unpooled by mask1, into X5
  for (int t = threadIdx.x; t < h0.size() * 16; t += blockDim.x) {
    const int oc = t % 16, p = t / 16;
    const int r = h0.row(p), c = h0.col(p);
    float v = 0.f;
    if (inside(r, c, Hh, Wh)) {
      const int qr = r >> 1, qc = c >> 1;
      const int ph = 2 * (r & 1) + (c & 1);
      if (__ldg(mn + ((size_t)qr * Wq + qc) * 64 + ph * 16 + oc) != 0.f) {
        const float* xs = X4.at(qr, qc);
#pragma unroll 8
        for (int ic = 0; ic < 64; ++ic)
          v += xs[ic] * __ldg(P.b50.res_w + ic * 16 + oc);
      }
    }
    X5.at(r, c)[oc] = v;
  }
  __syncthreads();
  const Buf D5 = {Bp, h0, 9};
  deconv_stage<16, 8>(P5, D5, h0, P.b50.deconv, Hh, Wh);
  __syncthreads();
  expand_residual<8, 16>(D5, X5, h0, P.b50.exp, P.b50.res_alpha, Hh, Wh);
  __syncthreads();

  // --- Bottleneck5_1 ----------------------------------------------------
  const Buf T5 = {Ap, h0, 5};
  const Buf U5 = {Bp, h1, 5};
  conv_stage<16, 4, 1, 1>(X5, T5, h0, 1, P.b51.proj, Hh, Wh);
  __syncthreads();
  conv_stage<4, 4, 3, 3>(T5, U5, h1, 1, P.b51.conv, Hh, Wh);
  __syncthreads();
  expand_residual<4, 16>(U5, X5, h1, P.b51.exp, P.b51.res_alpha, Hh, Wh);
  __syncthreads();

  // --- Final transposed conv + argmax, phase-major so that a warp
  //     shares its taps' weights -------------------------------------
  constexpr int SIDE = 4 * TE;  // half-res positions per tile side
  for (int t = threadIdx.x; t < 4 * SIDE * SIDE; t += blockDim.x) {
    const int ph = t / (SIDE * SIDE), k = t % (SIDE * SIDE);
    const int a = ph >> 1, b = ph & 1;
    const int hy = 4 * E0 + k / SIDE, hx = 4 * F0 + k % SIDE;
    const int R = 2 * hy + a, Cc = 2 * hx + b;
    if (R >= H || Cc >= W) continue;
    // taps: rows (kh, dy) = a ? (1, 0) : {(2, 0), (0, -1)}; same for cols
    float v[2][2][16];
#pragma unroll
    for (int tr = 0; tr < 2; ++tr)
#pragma unroll
      for (int tc = 0; tc < 2; ++tc) {
        const bool used = (tr == 0 || a == 0) && (tc == 0 || b == 0);
        const float* s = X5.at(hy - tr, hx - tc);
#pragma unroll
        for (int ic = 0; ic < 16; ++ic) v[tr][tc][ic] = used ? s[ic] : 0.f;
      }
    int best_c = 0;
    float best = 0.f;
    for (int cls = 0; cls < C; ++cls) {
      float logit = 0.f;
#pragma unroll
      for (int tr = 0; tr < 2; ++tr)
#pragma unroll
        for (int tc = 0; tc < 2; ++tc) {
          const int kh = a ? 1 : (tr ? 0 : 2);
          const int kw = b ? 1 : (tc ? 0 : 2);
          const float* w = P.final_w + (kh * 3 + kw) * 16 * C + cls;
#pragma unroll
          for (int ic = 0; ic < 16; ++ic)
            logit += v[tr][tc][ic] * __ldg(w + ic * C);
        }
      if (cls == 0 || logit > best) {
        best = logit;
        best_c = cls;
      }
    }
    labels[((size_t)n * H + R) * W + Cc] = (int8_t)best_c;
  }
}

}  // namespace
}  // namespace ssal

using namespace ssal;

extern "C" int ssal_tail_pack_size(int num_classes) {
  return up_pack_size(128, 32, 16, 64) + 2 * bottleneck_pack_size(64, 16) +
         up_pack_size(64, 16, 8, 16) + bottleneck_pack_size(16, 4) +
         9 * 16 * num_classes;
}

// y [N,H8,W8,128], sw2 int8 [N,H8,W8,64], mask1 [N,2H8,2W8,64]
// -> labels int8 [N,8H8,8W8]; num_classes <= 127.
extern "C" int ssal_tail_predict(const float* y, const int8_t* sw2,
                                 const float* mask1, const float* pack,
                                 int8_t* labels, int n, int h8, int w8,
                                 int num_classes, void* stream) {
  Cursor cur{pack};
  TailParams P;
  P.b40 = take_up(cur, 128, 32, 16, 64);
  for (int k = 0; k < 2; ++k) P.b4[k] = take_bottleneck(cur, 64, 16);
  P.b50 = take_up(cur, 64, 16, 8, 16);
  P.b51 = take_bottleneck(cur, 16, 4);
  P.final_w = cur.take(9 * 16 * num_classes);
  cudaFuncSetAttribute(tail_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  const dim3 grid((w8 + TE - 1) / TE, (h8 + TE - 1) / TE, n);
  tail_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      y, sw2, mask1, P, labels, h8, w8, num_classes);
  return (int)cudaGetLastError();
}
