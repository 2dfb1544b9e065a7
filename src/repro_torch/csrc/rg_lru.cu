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
// read of a and b and one write of h, 12 bytes per element in f32: a
// B = 1, S = 3000, W = 4096 prefill moves 147 MB, 0.044 ms at 3.35 TB/s,
// three times the 50 MB L2. A decode step (S = 1, B = 8, W = 4096) moves
// 0.5 MB, below what a launch costs.
//
// What the design does about it: the order stays sequential per channel
// (the dependent multiply-add chain of one channel over 3000 steps is about
// 14 us, a third of the bytes bound), and the kernel keeps enough bytes in
// flight. A block is one warp that owns kChannels consecutive channels of
// one row b and streams [kSteps x kChannels] tiles of a and b through a
// ring of up to kStages shared-memory stages, filled with 16-byte cp.async
// (each lane copies whole 16-byte pieces of the tile's 128-byte rows): at
// W = 4096 that is 128 blocks, each with up to 2 stages (64 KB in f32) in
// flight while it scans the oldest one from shared memory. Lane l walks
// channel l through the stage and stores h as one coalesced 128-byte row
// per step. Long tiles matter more than deep rings: each tile costs the
// warp a wait and a round of copy issue, and at 32 steps a tile that held
// the kernel at 2.1x the bound (tools/sweep_scans.py, NVIDIA H100 80GB
// HBM3, 700 W; 128 steps: 1.6x). A call of a few tiles allocates only the
// stages it has tiles for, and waits with as many tiles in flight as its
// ring holds. A call of fewer than kShortBelowS steps (a decode step is
// S = 1) takes rg_lru_scan_short_kernel, which reads straight from device
// memory into registers. The threshold is the crossover at B = 1 (a
// prefill call holds the prompts of one length, mostly one), between
// S = 16 (short 0.00217 ms, tile 0.00247) and S = 32 (0.00329, 0.00273);
// at S = 1, B = 8 the short kernel takes 0.00143 ms and the tile kernel
// 0.00404 (tools/sweep_scans.py, NVIDIA H100 80GB HBM3, 700 W). Any
// S >= 1 runs; W must be a multiple of 16 bytes of the input
// type (the wrapper refuses the rest), and the last block of a row masks
// the channels past W.
#include "common.cuh"

namespace {

using repro::ceil_div;
using repro::to_f32;

constexpr int kChannels = 32;   // channels per block: one per lane
constexpr int kSteps = 128;     // steps per stage (tools/sweep_scans.py)
constexpr int kStages = 3;      // ring depth at most
constexpr int kShortBelowS = 32;  // S below this: the short kernel
constexpr int kShortThreads = 128;  // the short kernel's block
constexpr int kShortUnroll = 8;

// A call shorter than one stage (a decode step): one thread per channel
// reads its steps straight from device memory, kShortUnroll loads of a
// and b issued before the dependent steps; blocks of kShortThreads
// channels, so a decode step launches few, small blocks.
template <typename T>
__global__ void __launch_bounds__(kShortThreads)
    rg_lru_scan_short_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             const float* __restrict__ h0,
                             float* __restrict__ h,
                             float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * kShortThreads + threadIdx.x;
  if (w >= W) return;
  const size_t row = blockIdx.y;
  const size_t base = row * (size_t)S * W + w;
  float hv = h0[row * W + w];
  for (int t = 0; t < S; t += kShortUnroll) {
    float av[kShortUnroll], bv[kShortUnroll];
#pragma unroll
    for (int u = 0; u < kShortUnroll; ++u) {
      const size_t off = base + (size_t)min(t + u, S - 1) * W;
      av[u] = to_f32(a[off]);
      bv[u] = to_f32(b[off]);
    }
#pragma unroll
    for (int u = 0; u < kShortUnroll; ++u) {
      if (t + u < S) {
        hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
        h[base + (size_t)(t + u) * W] = hv;
      }
    }
  }
  h_last[row * W + w] = hv;
}

// Wait until this tile's copies have landed: the stages - 1 tiles issued
// after it may stay in flight (one cp.async group per tile).
template <int N>
__device__ __forceinline__ void wait_ring(int stages) {
  if constexpr (N == 0) {
    repro::cp_async_wait<0>();
  } else {
    if (stages - 1 == N)
      repro::cp_async_wait<N>();
    else
      wait_ring<N - 1>(stages);
  }
}

template <typename T>
__global__ void __launch_bounds__(32)
    rg_lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ h,
                       float* __restrict__ h_last, int S, int W,
                       int stages) {
  constexpr int kVec = 16 / sizeof(T);              // elements per copy
  constexpr int kPieces = kChannels / kVec;         // copies per tile row
  constexpr int kTile = kSteps * kChannels;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);           // [stages][kTile]
  T* sb = sa + (size_t)stages * kTile;

  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kChannels;
  const int pieces = min(kChannels, W - w0) / kVec;  // W % kVec == 0
  const size_t row = blockIdx.y;
  const size_t base = row * (size_t)S * W + w0;
  const int n_tiles = ceil_div(S, kSteps);

  auto issue = [&](int tile) {
    const int t0 = tile * kSteps;
    const int nt = min(kSteps, S - t0);
    const int slot = tile % stages;
    for (int e = lane; e < kSteps * kPieces; e += 32) {
      const int t = e / kPieces, p = e % kPieces;
      if (t < nt && p < pieces) {
        const size_t off = base + (size_t)(t0 + t) * W + p * kVec;
        const int dst = slot * kTile + t * kChannels + p * kVec;
        repro::cp_async16(sa + dst, a + off);
        repro::cp_async16(sb + dst, b + off);
      }
    }
  };

  for (int tile = 0; tile < stages - 1; ++tile) {
    if (tile < n_tiles) issue(tile);
    repro::cp_async_commit();
  }
  const bool live = lane < pieces * kVec;
  float hv = live ? h0[row * W + w0 + lane] : 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    // refill the slot the previous tile used, then wait for this tile
    if (tile + stages - 1 < n_tiles) issue(tile + stages - 1);
    repro::cp_async_commit();
    wait_ring<kStages - 1>(stages);
    __syncwarp();
    const int t0 = tile * kSteps;
    const int nt = min(kSteps, S - t0);
    const T* ta = sa + (tile % stages) * kTile + lane;
    const T* tb = sb + (tile % stages) * kTile + lane;
    float* out = h + base + (size_t)t0 * W + lane;
    if (live) {
      if (nt == kSteps) {
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          hv = __fadd_rn(__fmul_rn(to_f32(ta[u * kChannels]), hv),
                         to_f32(tb[u * kChannels]));
          out[(size_t)u * W] = hv;
        }
      } else {
        for (int u = 0; u < nt; ++u) {
          hv = __fadd_rn(__fmul_rn(to_f32(ta[u * kChannels]), hv),
                         to_f32(tb[u * kChannels]));
          out[(size_t)u * W] = hv;
        }
      }
    }
    __syncwarp();   // every lane is done with the slot before its refill
  }
  if (live) h_last[row * W + w0 + lane] = hv;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* h0, void* h,
                   void* h_last, int B, int S, int W, cudaStream_t stream) {
  if (S < kShortBelowS) {
    rg_lru_scan_short_kernel<T>
        <<<dim3(ceil_div(W, kShortThreads), B), kShortThreads, 0, stream>>>(
            static_cast<const T*>(a), static_cast<const T*>(b),
            static_cast<const float*>(h0), static_cast<float*>(h),
            static_cast<float*>(h_last), S, W);
    return cudaGetLastError();
  }
  const int stages = min(kStages, ceil_div(S, kSteps));
  const size_t smem = 2 * (size_t)stages * kSteps * kChannels * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      rg_lru_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(W, kChannels), B);
  rg_lru_scan_kernel<T><<<grid, 32, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), S, W, stages);
  return cudaGetLastError();
}

}  // namespace

// Contiguous: a/b [B,S,W] of ``dtype``, 16-byte aligned, W a multiple of
// 16 bytes of ``dtype``; h0/h_last [B,W] f32; h [B,S,W] f32, no output
// aliasing an input.
extern "C" int repro_rg_lru_scan(int dtype, const void* a, const void* b,
                                 const void* h0, void* h, void* h_last, int B,
                                 int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      if (W % 4) return cudaErrorInvalidValue;
      return launch<float>(a, b, h0, h, h_last, B, S, W, s);
    case repro::kBFloat16:
      if (W % 8) return cudaErrorInvalidValue;
      return launch<__nv_bfloat16>(a, b, h0, h, h_last, B, S, W, s);
    default:
      return cudaErrorInvalidValue;
  }
}
