// RG-LRU gated linear recurrence (RecurrentGemma, arXiv:2402.19427).
//
// Replaces: src/repro/kernels/rg_lru/kernel.py
//           rg_lru_scan_pallas (line 46, pallas_call at line 56).
//
// Computes, per batch row b and channel w, from the incoming state h0:
//   h_t = a_t * h_{t-1} + b_t          (t = 0 .. S-1, elementwise in W)
// and returns h [B,S,W] and h_last [B,W], both f32; a and b are read as
// f32 from f32 or bf16. Each step is __fadd_rn(__fmul_rn(a, h), b): the
// two roundings of the plain version's separate multiply and add (no FMA
// contraction), so the kernel is bitwise equal to it in f32.
//
// What bounds it on the H100: bytes. Two flops per element against one
// read of a and b and one write of h, 12 bytes per element in f32: at a
// B = 1, S = 600, W = 4096 prefill that is 29.5 MB, 0.0088 ms at
// 3.35 TB/s. A decode step (S = 1, B = 8, W = 4096) moves 0.5 MB, far
// below what a launch costs.
//
// What the design does about it: the Pallas kernel keeps the carry in VMEM
// across sequence chunks of one (b, w-block). Here one thread owns one
// (b, w) channel and keeps h in a register across the whole loop over S,
// so a, b and h cross device memory exactly once. A warp covers 32
// consecutive w, so every load and store of a step is one coalesced 128-byte
// row segment. The t loop is unrolled kUnroll steps: the 2 * kUnroll loads
// are independent and issued before the dependent multiply-adds, so each
// thread keeps that many loads in flight. Blocks are small (kThreads = 64)
// so that a B = 1 prefill at W = 4096 still spreads over 64 SMs. Any S >= 1
// and any W run: the last block masks the channels past W.
//
// Known weakness: the parallelism is only B * W threads, each walking S
// serially. At B = 1, W = 4096 that is 4096 threads with 16 loads each in
// flight, about 256 KB, while hiding the device memory latency at 3.35 TB/s
// needs several MB in flight; so a long prefill runs at a fraction of the
// bytes bound, paced by the latency of one unrolled chunk after another.
// The redesign is a two-pass chunked scan: split S into chunks across
// blocks, scan each chunk from zero while keeping the product of its a's,
// then carry the chunk boundaries across and fix up each chunk in a
// second pass (a linear recurrence composes as (A, B) pairs).
#include "common.cuh"

namespace {

using repro::ceil_div;
using repro::to_f32;

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rg_lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ h,
                       float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t row = blockIdx.y;
  const size_t base = row * (size_t)S * W + w;
  float hv = h0[row * W + w];
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = base + (size_t)(t + u) * W;
      av[u] = to_f32(a[off]);
      bv[u] = to_f32(b[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
      h[base + (size_t)(t + u) * W] = hv;
    }
  }
  for (; t < S; ++t) {
    const size_t off = base + (size_t)t * W;
    hv = __fadd_rn(__fmul_rn(to_f32(a[off]), hv), to_f32(b[off]));
    h[off] = hv;
  }
  h_last[row * W + w] = hv;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* h0, void* h,
                   void* h_last, int B, int S, int W, cudaStream_t stream) {
  const dim3 grid(ceil_div(W, kThreads), B);
  rg_lru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), S, W);
  return cudaGetLastError();
}

}  // namespace

// Contiguous: a/b [B,S,W] of ``dtype``; h0/h_last [B,W] f32; h [B,S,W] f32,
// no output aliasing an input.
extern "C" int repro_rg_lru_scan(int dtype, const void* a, const void* b,
                                 const void* h0, void* h, void* h_last, int B,
                                 int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(a, b, h0, h, h_last, B, S, W, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(a, b, h0, h, h_last, B, S, W, s);
    default:
      return cudaErrorInvalidValue;
  }
}
