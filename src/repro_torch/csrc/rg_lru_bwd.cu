// Backward of the RG-LRU gated linear recurrence (csrc/rg_lru.cu).
//
// The port's own kernel: the reference trains through
// jax.lax.associative_scan (src/repro/models/rglru.py) and has no TPU
// kernel for this gradient.
//
// With g_t the gradient of h_t, seeded by dh_last at the last step:
//   g_t  = dh_t + a_{t+1} g_{t+1}      (the forward scan run in reverse)
//   da_t = g_t h_{t-1}   db_t = g_t    dh0 = a_0 g_0   (h_{-1} = h0)
// over [B, S, W] in f32. Each step is __fadd_rn / __fmul_rn, the plain
// version's separate add and multiply (kernels/rg_lru/ref.py
// rg_lru_scan_backward_ref), so the two agree bitwise.
//
// What bounds it on the H100: bytes. It reads a, the forward's h and dh
// (12 bytes an element) and writes da and db (8): at B = 4, S = 512,
// W = 4096 (recurrentgemma-9b's train shape) that is 168 MB, 0.050 ms at
// 3.35 TB/s. The order is sequential per channel, elementwise over W.
//
// The design: one thread per (b, w) channel walks t from S - 1 down to 0,
// kUnroll steps at a time, their loads of a, h_{t-1} and dh issued before
// the dependent steps (as the forward's short kernel does). Blocks of
// kThreads channels, so a row of W = 4096 is 32 blocks.
#include "common.cuh"

namespace {

using repro::ceil_div;

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
    rg_lru_scan_backward_kernel(const float* __restrict__ a,
                                const float* __restrict__ hs,
                                const float* __restrict__ h0,
                                const float* __restrict__ dhs,
                                const float* __restrict__ dh_last,
                                float* __restrict__ da,
                                float* __restrict__ db,
                                float* __restrict__ dh0, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t row = blockIdx.y;
  const size_t base = row * (size_t)S * W + w;
  const float h_init = h0[row * W + w];
  float carry = dh_last[row * W + w];
  for (int t1 = S - 1; t1 >= 0; t1 -= kUnroll) {
    float av[kUnroll], gv[kUnroll], hp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = max(t1 - u, 0);
      const size_t off = base + (size_t)t * W;
      av[u] = a[off];
      gv[u] = dhs[off];
      hp[u] = t > 0 ? hs[off - W] : h_init;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        const size_t off = base + (size_t)t * W;
        const float g = __fadd_rn(gv[u], carry);
        da[off] = __fmul_rn(g, hp[u]);
        db[off] = g;
        carry = __fmul_rn(av[u], g);
      }
    }
  }
  dh0[row * W + w] = carry;
}

}  // namespace

// f32, contiguous: a, hs, dhs, da, db [B,S,W]; h0, dh_last, dh0 [B,W]. No
// output aliases an input.
extern "C" int repro_rg_lru_scan_backward(const void* a, const void* hs,
                                          const void* h0, const void* dhs,
                                          const void* dh_last, void* da,
                                          void* db, void* dh0, int B, int S,
                                          int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  rg_lru_scan_backward_kernel<<<dim3(ceil_div(W, kThreads), B), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(hs),
      static_cast<const float*>(h0), static_cast<const float*>(dhs),
      static_cast<const float*>(dh_last), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), S, W);
  return cudaGetLastError();
}
