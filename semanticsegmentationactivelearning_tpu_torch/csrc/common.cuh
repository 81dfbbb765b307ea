// Shared pieces of the kernels: ENet's (front.cu, mid.cu, tail.cu,
// decoder.cu) and ICNet's (icnet_front.cu, icnet_head.cu).
//
// Every kernel works on NHWC float32 activations and a flat float32
// parameter pack whose layout the Python packers in ops/kernels/*.py
// build (BatchNorm folded into the conv weights: w * s per output
// channel plus a shift t). Weights are HWIO ([kh][kw][in][out]), the
// JAX package's layout.
//
// A shared-memory buffer (Buf) covers a rectangle of one resolution's
// grid (global coordinates) and stores a position's channels at a
// stride of its own; positions outside the image hold zero, the SAME
// zero padding every convolution sees at the image edge.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssal {

// A rectangle of one resolution's grid, in global coordinates.
struct Rect {
  int r0, c0, h, w;
  __device__ __forceinline__ int size() const { return h * w; }
  __device__ __forceinline__ int row(int p) const { return r0 + p / w; }
  __device__ __forceinline__ int col(int p) const { return c0 + p % w; }
  __device__ __forceinline__ int idx(int r, int c) const {
    return (r - r0) * w + (c - c0);
  }
};

// A shared-memory buffer over a rectangle, channel stride cs.
struct Buf {
  float* p;
  Rect r;
  int cs;
  __device__ __forceinline__ float* at(int gr, int gc) const {
    return p + r.idx(gr, gc) * cs;
  }
};

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
