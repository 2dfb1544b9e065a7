// Grouped per-expert SwiGLU FFN: y[e] = (silu(x[e] Wg[e]) * (x[e] Wu[e])) Wd[e].
//
// Replaces: src/repro/kernels/moe_gemm/kernel.py
//           moe_gemm_pallas (line 45, pallas_call at line 57).
//
// Two launches, as the Pallas kernel's arithmetic has two stages:
//   1. act[e,c,h] = silu(x.Wg) * (x.Wu), accumulated in f32 and stored in
//      x's dtype (the Pallas kernel casts act to x.dtype the same way);
//   2. y[e,c,m]   = act . Wd, accumulated in f32, stored in x's dtype.
// x [E,C,M]; Wg/Wu [E,M,H]; Wd [E,H,M]; act [E,C,H]; y [E,C,M]. The
// weights keep the JAX layout: W is N-contiguous ([K, N]).
//
// Two kernels, chosen by dtype:
//
// * bf16, every C — a tensor-core GEMM. At prefill it is bound by
//   operations: 6*E*C*M*H flops (0.717 ms at 989 TFLOP/s for C=683). At
//   decode (C=1 for 8 slots of qwen2-moe) it is bound by bytes: each
//   launch streams all of its weights (1.04 GB per layer at E=60,
//   M=2048, H=1408: 0.310 ms at 3.35 TB/s) for a handful of rows. The
//   kernel: 128 x 128 output tiles per block (two consumer warpgroups of
//   64 rows and one producer warp), TMA bringing 64-deep tiles of x and W
//   into a 4-stage shared-memory ring with the 128-byte swizzle,
//   full/empty mbarriers between producer and consumers, and
//   wgmma.mma_async m64n128k16 (bf16 -> f32) reading both operands from
//   shared memory, one k-tile's products kept in flight while the next
//   is issued. W is N-contiguous, so B is MN-major and wgmma reads it
//   with the transpose bit: no re-layout. The SwiGLU launch carries two
//   accumulators (gate and up) over the same x tile and applies
//   silu(g)*u in f32 in the epilogue; the down launch covers 256 columns
//   per block as two 128-column accumulators. Ragged C (and K, N) are
//   zero-filled by TMA on load and masked on store.
// * f32 — the SIMT kernel of the first port (64x64x16 tiles, f32 FMA),
//   kept so the f32 parity checks hold the card to the CPU at 1e-4.
//
// One bf16 kernel at every C, decode included: chip_smoke.py times it
// at C = 1, 2, 4, 8 (device time at E=60, M=2048, H=1408 on an H100 80GB
// HBM3 at 700 W: 0.338-0.347 ms, against the 0.310 ms bytes bound), where
// the padded rows' tensor-core time hides under the weight stream. A
// dedicated weight-stream kernel (16-byte loads, f32 FMA) was measured
// beside it and won at no C (PERF.md section 6), so there is no threshold.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::ceil_div;
using repro::from_f32;
using repro::to_f32;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// f32: SIMT tiles
// ---------------------------------------------------------------------------

constexpr int kBM = 64;   // rows of C per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 16;   // depth of one shared-memory stage
constexpr int kThreads = 256;

// Out[e] = A[e] . B0[e]           (kSwiGLU = false)
// Out[e] = silu(A.B0) * (A.B1)    (kSwiGLU = true)
// A [E,R,K]; B0/B1 [E,K,N]; Out [E,R,N].
template <typename T, bool kSwiGLU>
__global__ void __launch_bounds__(kThreads)
    moe_gemm_simt_kernel(const T* __restrict__ A, const T* __restrict__ B0,
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
cudaError_t launch_simt(const void* x, const void* wg, const void* wu,
                        const void* wd, void* act, void* y, int E, int C,
                        int M, int H, cudaStream_t stream) {
  const dim3 block(kThreads);
  const dim3 grid_up(ceil_div(H, kBN), ceil_div(C, kBM), E);
  moe_gemm_simt_kernel<T, true><<<grid_up, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<T*>(act), C, M, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_down(ceil_div(M, kBN), ceil_div(C, kBM), E);
  moe_gemm_simt_kernel<T, false><<<grid_down, block, 0, stream>>>(
      static_cast<const T*>(act), static_cast<const T*>(wd), nullptr,
      static_cast<T*>(y), C, H, M);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

namespace sm90 = repro::sm90;

constexpr int kTcRows = 128;            // rows of C per block (2 x 64)
constexpr int kTcDepth = 64;            // k per stage: one 128-byte row
constexpr int kTcCols = 128;            // columns per B operand
constexpr int kTcStages = 4;
constexpr int kTcConsumers = 2;         // warpgroups
constexpr int kTcThreads = 128 * kTcConsumers + 32;  // + a producer warp
constexpr uint32_t kTileA = kTcRows * kTcDepth * 2;          // 16 KB
constexpr uint32_t kTileB = kTcDepth * kTcCols * 2;          // 16 KB
constexpr uint32_t kChunkB = kTileB / 2;                     // 64 columns
constexpr uint32_t kStageBytes = kTileA + 2 * kTileB;        // 48 KB
constexpr size_t kTcSmem = kTcStages * kStageBytes + 1024 + 2 * kTcStages * 8;

// Out[e] tile (128 rows) = silu(A.B0) * (A.B1) over 128 columns
// (kSwiGLU), or A.B0 over 256 columns, the second 128 from the same map
// (B1 is B0 then). A [E,R,K] K-contiguous; B [E,K,N] N-contiguous.
template <bool kSwiGLU>
__global__ void __launch_bounds__(kTcThreads, 1)
    moe_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b0,
                          const __grid_constant__ CUtensorMap map_b1,
                          bf16* __restrict__ Out, int R, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTcStages * kStageBytes);
  uint64_t* empty = full + kTcStages;
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kTcRows;
  const int n0 = blockIdx.x * (kSwiGLU ? kTcCols : 2 * kTcCols);
  const int n1 = kSwiGLU ? n0 : n0 + kTcCols;
  const int nk = ceil_div(K, kTcDepth);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kTcConsumers * 4);  // one arrive per warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kTcConsumers * 4) {  // producer warp: one thread issues TMA
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kTcStages;
        if (kt >= kTcStages) sm90::mbar_wait(&empty[s], ((kt / kTcStages) - 1) & 1);
        uint8_t* st = smem + s * kStageBytes;
        const int k0 = kt * kTcDepth;
        sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);
        sm90::tma_load_3d(st, &map_a, &full[s], k0, r0, e);
        sm90::tma_load_3d(st + kTileA, &map_b0, &full[s], n0, k0, e);
        sm90::tma_load_3d(st + kTileA + kChunkB, &map_b0, &full[s], n0 + 64, k0, e);
        sm90::tma_load_3d(st + kTileA + kTileB, &map_b1, &full[s], n1, k0, e);
        sm90::tma_load_3d(st + kTileA + kTileB + kChunkB, &map_b1, &full[s],
                          n1 + 64, k0, e);
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc0[kTcCols / 2], acc1[kTcCols / 2];
#pragma unroll
  for (int i = 0; i < kTcCols / 2; ++i) acc0[i] = acc1[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kTcStages;
    sm90::mbar_wait(&full[s], (kt / kTcStages) & 1);
    const uint8_t* st = smem + s * kStageBytes;
    sm90::fence_regs(acc0);
    sm90::fence_regs(acc1);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcDepth / 16; ++kk) {
      // A: K-major rows of 128 bytes; B: MN-major, 64-column chunks
      const uint64_t da = sm90::smem_desc(st + wg * 64 * 128 + kk * 32, 16,
                                          1024, sm90::kLayoutSW128);
      const uint64_t db0 = sm90::smem_desc(st + kTileA + kk * 16 * 128,
                                           kChunkB, 1024, sm90::kLayoutSW128);
      const uint64_t db1 = sm90::smem_desc(
          st + kTileA + kTileB + kk * 16 * 128, kChunkB, 1024,
          sm90::kLayoutSW128);
      sm90::wgmma_ss<kTcCols, 1>(acc0, da, db0, 1);
      sm90::wgmma_ss<kTcCols, 1>(acc1, da, db1, 1);
    }
    sm90::wgmma_commit();
    // keep this k-tile's products in flight; the previous tile's are
    // done, so its stage goes back to the producer
    sm90::wgmma_wait<1>();
    sm90::fence_regs(acc0);
    sm90::fence_regs(acc1);
    __syncwarp();
    if (kt > 0 && lane == 0)
      sm90::mbar_arrive(&empty[(kt - 1) % kTcStages]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc0);
  sm90::fence_regs(acc1);

  // epilogue: accumulator (row, column) of register i: row +8 for i&2,
  // column 8*(i/4) + 2*(lane%4) + (i&1)
  const int row_a = r0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  bf16* o = Out + (size_t)e * R * N;
#pragma unroll
  for (int j = 0; j < kTcCols / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      if (row >= R) continue;
      const int i = 4 * j + 2 * half;
      const int c = 8 * j + cq;
      bf16* orow = o + (size_t)row * N;
      if constexpr (kSwiGLU) {
        if (n0 + c < N) {
          const float g0 = acc0[i], g1 = acc0[i + 1];
          const float v0 = g0 / (1.f + expf(-g0)) * acc1[i];
          const float v1 = g1 / (1.f + expf(-g1)) * acc1[i + 1];
          *reinterpret_cast<__nv_bfloat162*>(orow + n0 + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      } else {
        if (n0 + c < N)
          *reinterpret_cast<__nv_bfloat162*>(orow + n0 + c) =
              __floats2bfloat162_rn(acc0[i], acc0[i + 1]);
        if (n1 + c < N)
          *reinterpret_cast<__nv_bfloat162*>(orow + n1 + c) =
              __floats2bfloat162_rn(acc1[i], acc1[i + 1]);
      }
    }
  }
}

// [E, rows, cols] bf16, cols contiguous, read in boxes of 64 x box_rows
cudaError_t map3(CUtensorMap* map, const void* p, int E, int rows, int cols,
                 int box_rows) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)E};
  const uint64_t strides[2] = {(uint64_t)cols * 2, (uint64_t)rows * cols * 2};
  const uint32_t box[3] = {64, (uint32_t)box_rows, 1};
  return sm90::make_map_bf16(map, 3, p, dims, strides, box, 128);
}

cudaError_t launch_wgmma(const void* x, const void* wg, const void* wu,
                         const void* wd, void* act, void* y, int E, int C,
                         int M, int H, cudaStream_t stream) {
  if (M % 8 != 0 || H % 8 != 0) return cudaErrorInvalidValue;
  CUtensorMap mx, mwg, mwu, mact, mwd;
  cudaError_t err;
  if ((err = map3(&mx, x, E, C, M, kTcRows)) != cudaSuccess) return err;
  if ((err = map3(&mwg, wg, E, M, H, kTcDepth)) != cudaSuccess) return err;
  if ((err = map3(&mwu, wu, E, M, H, kTcDepth)) != cudaSuccess) return err;
  if ((err = map3(&mact, act, E, C, H, kTcRows)) != cudaSuccess) return err;
  if ((err = map3(&mwd, wd, E, H, M, kTcDepth)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(moe_gemm_wgmma_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kTcSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(moe_gemm_wgmma_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kTcSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid_up(ceil_div(H, kTcCols), ceil_div(C, kTcRows), E);
  moe_gemm_wgmma_kernel<true><<<grid_up, kTcThreads, kTcSmem, stream>>>(
      mx, mwg, mwu, static_cast<bf16*>(act), C, M, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_down(ceil_div(M, 2 * kTcCols), ceil_div(C, kTcRows), E);
  moe_gemm_wgmma_kernel<false><<<grid_down, kTcThreads, kTcSmem, stream>>>(
      mact, mwd, mwd, static_cast<bf16*>(y), C, H, M);
  return cudaGetLastError();
}

}  // namespace

// x [E,C,M]; wg/wu [E,M,H]; wd [E,H,M]; act scratch [E,C,H]; y [E,C,M].
// f32 runs the SIMT kernel, bf16 the wgmma kernel.
extern "C" int repro_moe_gemm(int dtype, const void* x, const void* wg,
                              const void* wu, const void* wd, void* act,
                              void* y, int E, int C, int M, int H,
                              void* stream) {
  if (E <= 0 || C <= 0 || M <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (E > 65535 || repro::ceil_div(C, kBM) > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_simt<float>(x, wg, wu, wd, act, y, E, C, M, H, s);
  if (dtype == repro::kBFloat16)
    return launch_wgmma(x, wg, wu, wd, act, y, E, C, M, H, s);
  return cudaErrorInvalidValue;
}
