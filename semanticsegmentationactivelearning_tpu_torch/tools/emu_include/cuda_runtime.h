// A CPU stand-in for the CUDA runtime, for tools/cpu_emu.py: every thread
// of a block is a ucontext fiber on one OS thread, and the blocks of a
// launch run one after another; a barrier (the block's or a warp's)
// counts arrivals and yields to the other fibers until its generation
// moves. Shared memory starts as NaN. A cp.async copy (emu::cp16) lands
// at the wait_group that needs it, or at once when EMU_IMMEDIATE is set.
#pragma once
#include <ucontext.h>
#include <stdint.h>
#include <string.h>
#include <cmath>
#include <vector>
#include <algorithm>
#include <functional>
#include <limits>
#include <cstdio>
#include <cstdlib>
using std::min; using std::max;

struct dim3 { unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaGetLastError() { return 0; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline float __expf(float x) { return std::exp(x); }
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __align__(x)

namespace emu {
struct Fiber { dim3 tid; ucontext_t ctx; bool done; char* stack; };
struct Copy { float* dst; const float* src; int n; };  // src null: zeros
inline Fiber* cur = nullptr;
inline std::vector<Fiber> fibers;
inline ucontext_t sched_ctx;
inline dim3 bidx, bdim, gdim;
inline std::vector<float> smem_buf;
inline bool deferred = true;
// per fiber: groups of pending copies (the last one open)
inline std::vector<std::vector<std::vector<Copy>>> groups;
// barriers: block and per warp
inline int bar_count = 0; inline long bar_gen = 0;
inline std::vector<int> wbar_count; inline std::vector<long> wbar_gen;
inline std::vector<float> xch;  // per-warp exchange [warp][lane][16]
inline int fid() { return (int)(cur - fibers.data()); }
inline void yield() { swapcontext(&cur->ctx, &sched_ctx); }
inline void sync_block() {
  long g = bar_gen;
  if (++bar_count == (int)fibers.size()) { bar_count = 0; ++bar_gen; return; }
  while (bar_gen == g) yield();
}
inline void sync_warp() {
  int w = fid() / 32;
  int nl = std::min<int>(32, (int)fibers.size() - 32 * w);
  long g = wbar_gen[w];
  if (++wbar_count[w] == nl) { wbar_count[w] = 0; ++wbar_gen[w]; return; }
  while (wbar_gen[w] == g) yield();
}
inline std::function<void()>* body = nullptr;
inline void trampoline() { (*body)(); cur->done = true; swapcontext(&cur->ctx, &sched_ctx); }
inline void launch(dim3 grid, dim3 block, size_t smem, std::function<void()> k) {
  gdim = grid; bdim = block; deferred = !getenv("EMU_IMMEDIATE");
  int nt = block.x;
  fibers.assign(nt, Fiber{});
  const size_t SS = 1 << 17;
  for (auto& f : fibers) f.stack = (char*)malloc(SS);
  body = &k;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        bidx = dim3(x, y, z);
        smem_buf.assign(smem / 4 + 4, std::numeric_limits<float>::quiet_NaN());
        groups.assign(nt, std::vector<std::vector<Copy>>(1));
        bar_count = 0; wbar_count.assign((nt + 31) / 32, 0); wbar_gen.assign((nt + 31) / 32, 0);
        xch.assign((size_t)((nt + 31) / 32) * 32 * 16, 0.f);
        for (int t = 0; t < nt; ++t) {
          Fiber& f = fibers[t]; f.tid = dim3(t, 0, 0); f.done = false;
          getcontext(&f.ctx); f.ctx.uc_stack.ss_sp = f.stack; f.ctx.uc_stack.ss_size = SS;
          f.ctx.uc_link = nullptr; makecontext(&f.ctx, trampoline, 0);
        }
        int live = nt;
        while (live) {
          live = 0;
          for (auto& f : fibers) if (!f.done) { cur = &f; swapcontext(&sched_ctx, &f.ctx); if (!f.done) ++live; }
        }
      }
  for (auto& f : fibers) free(f.stack);
}
inline float* smem() { return smem_buf.data(); }
// cp.async: copy now (immediate mode) or when waited on (deferred mode)
inline void land(const Copy& c) {
  if (c.src) memcpy(c.dst, c.src, 4 * c.n); else memset(c.dst, 0, 4 * c.n);
}
inline void cp(float* d, const float* s, int n) {
  if (!deferred) { land({d, s, n}); return; }
  groups[fid()].back().push_back({d, s, n});
}
inline void cp16(float* d, const float* s) { cp(d, s, 4); }
inline void cp4(float* d, const float* s, bool valid) { cp(d, valid ? s : nullptr, 1); }
inline void commit() { groups[fid()].push_back({}); }
inline void wait_group(int n) {
  auto& gs = groups[fid()];
  // closed groups are all but the last (open) one
  int closed = (int)gs.size() - 1;
  int done = closed - n;
  if (done <= 0) return;
  for (int i = 0; i < done; ++i) for (auto& c : gs[i]) land(c);
  gs.erase(gs.begin(), gs.begin() + done);
}
inline void wait_all() { auto& gs = groups[fid()]; for (auto& g : gs) for (auto& c : g) land(c); gs.assign(1, {}); }
}  // namespace emu

// __ldg is a load through the global state space: on shared memory the
// card faults (cudaErrorInvalidAddressSpace), so the stand-in aborts.
template <class T> inline T __ldg(const T* p) {
  const char* c = (const char*)p;
  const char* s = (const char*)emu::smem_buf.data();
  if (c >= s && c < s + 4 * emu::smem_buf.size()) {
    fprintf(stderr, "emu: __ldg on shared memory\n");
    abort();
  }
  return *p;
}

#define threadIdx (emu::cur->tid)
#define blockIdx (emu::bidx)
#define blockDim (emu::bdim)
#define gridDim (emu::gdim)
inline void __syncthreads() { emu::sync_block(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  int w = emu::fid() / 32, l = emu::fid() % 32;
  float* x = &emu::xch[(size_t)w * 32 * 16];
  x[l * 16] = v; emu::sync_warp(); float r = x[(l ^ m) * 16]; emu::sync_warp(); return r;
}
inline int __shfl_xor_sync(unsigned, int v, int m) {
  float f; memcpy(&f, &v, 4); f = __shfl_xor_sync(0u, f, m); int r; memcpy(&r, &f, 4); return r;
}
