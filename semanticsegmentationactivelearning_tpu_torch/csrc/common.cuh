// Shared pieces of the kernels: ENet's (front.cu, mid.cu, tail.cu) and
// ICNet's (icnet_front.cu, icnet_head.cu).
//
// Every kernel works on NHWC float32 activations and a flat float32
// parameter pack whose layout the Python packers in ops/kernels/*.py
// build (BatchNorm folded into the conv weights: w * s per output
// channel plus a shift t). Weights are HWIO ([kh][kw][in][out]), the
// JAX package's layout.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssal {

__device__ __forceinline__ bool inside(int r, int c, int gh, int gw) {
  return r >= 0 && r < gh && c >= 0 && c < gw;
}

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : a * v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace ssal
