// Grouped per-expert SwiGLU FFN: y[e] = (silu(x[e] Wg[e]) * (x[e] Wu[e])) Wd[e].
//
// Replaces: src/repro/kernels/moe_gemm/kernel.py
//           moe_gemm_pallas (line 45, pallas_call at line 57).
//
// Two launches, as the Pallas kernel's arithmetic has two stages:
//   1. act[e,c,h] = silu(x.Wg) * (x.Wu), accumulated in f32 and stored in
//      x's dtype (the Pallas kernel casts act to x.dtype the same way);
//   2. y[e,c,m]   = act . Wd, accumulated in f32, stored in x's dtype.
// x [E,C,M]; Wg/Wu [E,M,H]; Wd [E,H,M]; act [E,C,H]; y [E,C,M].
//
// What bounds it on the H100: at decode the capacity C is tiny (C=1 for
// 8 slots of qwen2-moe), so the launch streams all 3*E*M*H weights for a
// handful of rows: bytes, 1.04 GB per layer at full width. At prefill
// (C=683 for 8192 tokens) it is 6*E*C*M*H flops: operations.
//
// What the design does about it: each block computes a 64x64 output tile of
// one expert with a 16-deep K loop through shared memory (256 threads, a
// 4x4 register micro-tile each), so every weight element is read from device
// memory once per 64 rows of C. Rows past C are masked on load and store,
// and a thread whose rows all lie past C skips the multiply-adds, so the
// C=1 decode launch does 1/16 of a tile's arithmetic and is left with the
// weight stream. This is a plain SIMT kernel in f32 FMA: the tensor cores
// (wgmma with TMA-fed shared-memory rings) are later work, and its prefill
// time in PERF.md shows how far it is from the 989 TFLOP/s bf16 peak.
#include "common.cuh"

namespace {

using repro::ceil_div;
using repro::from_f32;
using repro::to_f32;

constexpr int kBM = 64;   // rows of C per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 16;   // depth of one shared-memory stage
constexpr int kThreads = 256;

// Out[e] = A[e] . B0[e]           (kSwiGLU = false)
// Out[e] = silu(A.B0) * (A.B1)    (kSwiGLU = true)
// A [E,R,K]; B0/B1 [E,K,N]; Out [E,R,N].
template <typename T, bool kSwiGLU>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B0,
                        const T* __restrict__ B1, T* __restrict__ Out, int R,
                        int K, int N) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs0[kBK][kBN];
  __shared__ float Bs1[kSwiGLU ? kBK : 1][kBN];
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const T* a = A + (size_t)e * R * K;
  const T* b0 = B0 + (size_t)e * K * N;
  const T* b1 = kSwiGLU ? B1 + (size_t)e * K * N : nullptr;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns n0 + tx + 16*j
  const int ty = tid / 16;  // rows    r0 + ty + 16*i
  float acc0[4][4], acc1[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc0[i][j] = acc1[i][j] = 0.f;
  const bool active = r0 + ty < R;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / kBK;
      const int col = idx % kBK;
      const int r = r0 + row;
      const int kk = k0 + col;
      As[col][row] = (r < R && kk < K) ? to_f32(a[(size_t)r * K + kk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / kBN;
      const int col = idx % kBN;
      const int kk = k0 + row;
      const int n = n0 + col;
      const bool ok = kk < K && n < N;
      const size_t off = (size_t)kk * N + n;
      Bs0[row][col] = ok ? to_f32(b0[off]) : 0.f;
      if constexpr (kSwiGLU) Bs1[row][col] = ok ? to_f32(b1[off]) : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], bv0[4], bv1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bv0[j] = Bs0[kk][tx + 16 * j];
          if constexpr (kSwiGLU) bv1[j] = Bs1[kk][tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc0[i][j] = fmaf(av[i], bv0[j], acc0[i][j]);
            if constexpr (kSwiGLU) acc1[i][j] = fmaf(av[i], bv1[j], acc1[i][j]);
          }
      }
    }
    __syncthreads();
  }

  T* o = Out + (size_t)e * R * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float val = acc0[i][j];
      if constexpr (kSwiGLU) val = val / (1.f + expf(-val)) * acc1[i][j];
      o[(size_t)r * N + n] = from_f32<T>(val);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, void* act, void* y, int E, int C, int M,
                   int H, cudaStream_t stream) {
  const dim3 block(kThreads);
  const dim3 grid_up(ceil_div(H, kBN), ceil_div(C, kBM), E);
  grouped_gemm_kernel<T, true><<<grid_up, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<T*>(act), C, M, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_down(ceil_div(M, kBN), ceil_div(C, kBM), E);
  grouped_gemm_kernel<T, false><<<grid_down, block, 0, stream>>>(
      static_cast<const T*>(act), static_cast<const T*>(wd), nullptr,
      static_cast<T*>(y), C, H, M);
  return cudaGetLastError();
}

}  // namespace

// x [E,C,M]; wg/wu [E,M,H]; wd [E,H,M]; act scratch [E,C,H]; y [E,C,M].
extern "C" int repro_moe_gemm(int dtype, const void* x, const void* wg,
                              const void* wu, const void* wd, void* act,
                              void* y, int E, int C, int M, int H,
                              void* stream) {
  if (E <= 0 || C <= 0 || M <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (E > 65535 || repro::ceil_div(C, kBM) > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, wg, wu, wd, act, y, E, C, M, H, s);
  if (dtype == repro::kFloat32)
    return launch<float>(x, wg, wu, wd, act, y, E, C, M, H, s);
  return cudaErrorInvalidValue;
}
