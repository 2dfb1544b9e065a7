// Stabilised mLSTM matrix-memory recurrence (xLSTM, arXiv:2405.04517).
//
// Replaces: src/repro/kernels/mlstm_scan/kernel.py
//           mlstm_scan_pallas (line 65, pallas_call at line 76).
//
// Computes, per (b, h) and timestep t, from the incoming state (C, n, m):
//   m_t = max(lf_t + m, i_t);  f' = exp(lf_t + m - m_t);  i' = exp(i_t - m_t)
//   C  <- f' C + i' v_t k_t^T       (C is [D, D]: row r follows v[r])
//   n  <- f' n + i' k_t
//   h_t = C q_t / max(|n . q_t|, 1)
// and returns h [B,H,S,D] and the final C, n, m, all in f32.
//
// What bounds it on the H100: f32 operations. Each step touches every entry
// of C twice (the update and the row dot with q), about 4*D^2 flops per
// (b, h, t), while the bytes are one read of q/k/v/gates, one write of h,
// and one read and one write of C. At xlstm-1.3b's width (D = 1024, H = 4)
// and a 600-token prompt (B = 1) that is 10.1 GFLOP against 73 MB: 0.150 ms
// at 67 TFLOP/s (no tensor cores: the update is an outer product) and
// 0.021 ms at 3.35 TB/s. A decode step (S = 1, B = 8) is the other way
// round: 268 MB of state in and out against 0.13 GFLOP, so bytes.
//
// What the design does about it: the Pallas kernel keeps C whole in VMEM
// (4 MB f32 per (b, h)); an SM has 227 KB of shared memory. The rows of C
// update independently, so the grid splits them: a block owns
// kRowsPerBlock rows of one (b, h), and each of its warps holds
// kRowsPerWarp rows in registers (lane l holds columns l, l+32, ...) for the
// whole sequential loop over S, so C crosses device memory once in and once
// out. Every warp recomputes the scalars m, f', i' and its lanes' share of n
// (a quarter more arithmetic at two rows per warp), which makes the warp
// self-sufficient: h[t, r] and n . q are warp reductions, and no block-wide
// barrier sits inside the time loop. The block stages kSteps timesteps of
// q, k, gates and its rows' v in shared memory between two barriers. At
// D = 1024 a (b, h) gives 64 blocks, so B = 1, H = 4 already fills the card
// with 256 blocks. Any S (including S = 1 for decode) and any D <= 1024 run;
// rows and columns past D are masked.
#include "common.cuh"

namespace {

using repro::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kSteps = 8;       // timesteps staged in shared memory at once
constexpr int kMaxD = 1024;     // 32 lanes x 32 columns in registers

template <int NC>  // columns per lane: D <= 32 * NC
__global__ void __launch_bounds__(kThreads)
    mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ ig,
                      const float* __restrict__ lf,
                      const float* __restrict__ C0,
                      const float* __restrict__ n0,
                      const float* __restrict__ m0, float* __restrict__ h,
                      float* __restrict__ C1, float* __restrict__ n1,
                      float* __restrict__ m1, int S, int D, int row_blocks) {
  extern __shared__ float smem[];
  float* qs = smem;                            // [kSteps][D]
  float* ks = qs + kSteps * D;                 // [kSteps][D]
  float* vs = ks + kSteps * D;                 // [kSteps][kRowsPerBlock]
  float* is = vs + kSteps * kRowsPerBlock;     // [kSteps]
  float* fs = is + kSteps;                     // [kSteps]

  const int bh = blockIdx.x / row_blocks;
  const int rb = blockIdx.x % row_blocks;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int block_row0 = rb * kRowsPerBlock;
  const int row0 = block_row0 + warp * kRowsPerWarp;
  const size_t seq = (size_t)bh * S;
  const size_t DD = (size_t)D * D;

  float c[kRowsPerWarp][NC];
  float n[NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      c[r][j] = (row < D && col < D) ? C0[bh * DD + (size_t)row * D + col]
                                     : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = lane + 32 * j;
    n[j] = col < D ? n0[(size_t)bh * D + col] : 0.f;
  }
  float m = m0[bh];

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int nt = min(kSteps, S - t0);
    __syncthreads();  // every warp is done with the previous chunk
    const size_t base = (seq + t0) * D;
    for (int i = threadIdx.x; i < nt * D; i += kThreads) {
      qs[i] = q[base + i];
      ks[i] = k[base + i];
    }
    for (int i = threadIdx.x; i < nt * kRowsPerBlock; i += kThreads) {
      const int tt = i / kRowsPerBlock;
      const int row = block_row0 + (i - tt * kRowsPerBlock);
      vs[i] = row < D ? v[base + (size_t)tt * D + row] : 0.f;
    }
    if (threadIdx.x < nt) {
      is[threadIdx.x] = ig[seq + t0 + threadIdx.x];
      fs[threadIdx.x] = lf[seq + t0 + threadIdx.x];
    }
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      const float it = is[tt];
      const float lft = fs[tt];
      const float m_new = fmaxf(lft + m, it);
      const float fp = expf(lft + m - m_new);
      const float ip = expf(it - m_new);
      m = m_new;
      float iv[kRowsPerWarp], hacc[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        iv[r] = ip * vs[tt * kRowsPerBlock + warp * kRowsPerWarp + r];
        hacc[r] = 0.f;
      }
      float dacc = 0.f;
      const float* qt = qs + tt * D;
      const float* kt = ks + tt * D;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = lane + 32 * j;
        if (col < D) {
          const float kc = kt[col];
          const float qc = qt[col];
          n[j] = fp * n[j] + ip * kc;
          dacc = fmaf(n[j], qc, dacc);
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            c[r][j] = fp * c[r][j] + iv[r] * kc;
            hacc[r] = fmaf(c[r][j], qc, hacc[r]);
          }
        }
      }
      dacc = warp_sum(dacc);
      const float denom = fmaxf(fabsf(dacc), 1.f);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float hr = warp_sum(hacc[r]);
        const int row = row0 + r;
        if (lane == 0 && row < D) h[(seq + t0 + tt) * D + row] = hr / denom;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row < D) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = lane + 32 * j;
        if (col < D) C1[bh * DD + (size_t)row * D + col] = c[r][j];
      }
    }
  }
  if (rb == 0 && warp == 0) {
    // every warp holds the same n and m; one writes them
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      if (col < D) n1[(size_t)bh * D + col] = n[j];
    }
    if (lane == 0) m1[bh] = m;
  }
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* ig, const float* lf, const float* C0,
                   const float* n0, const float* m0, float* h, float* C1,
                   float* n1, float* m1, int BH, int S, int D,
                   cudaStream_t stream) {
  const int row_blocks = repro::ceil_div(D, kRowsPerBlock);
  const size_t smem = sizeof(float) * (2 * (size_t)kSteps * D +
                                       (size_t)kSteps * kRowsPerBlock +
                                       2 * (size_t)kSteps);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  mlstm_scan_kernel<NC><<<BH * row_blocks, kThreads, smem, stream>>>(
      q, k, v, ig, lf, C0, n0, m0, h, C1, n1, m1, S, D, row_blocks);
  return cudaGetLastError();
}

}  // namespace

// f32, contiguous: q/k/v [BH,S,D]; ig/lf [BH,S]; C0 [BH,D,D]; n0 [BH,D];
// m0 [BH]; outputs h [BH,S,D], C1 [BH,D,D], n1 [BH,D], m1 [BH], none of
// them aliasing an input.
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* ig, const void* lf,
                                const void* C0, const void* n0,
                                const void* m0, void* h, void* C1, void* n1,
                                void* m1, int BH, int S, int D,
                                void* stream) {
  if (BH <= 0 || S <= 0 || D <= 0 || D > kMaxD) return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* igf = static_cast<const float*>(ig);
  const float* lff = static_cast<const float*>(lf);
  const float* C0f = static_cast<const float*>(C0);
  const float* n0f = static_cast<const float*>(n0);
  const float* m0f = static_cast<const float*>(m0);
  float* hf = static_cast<float*>(h);
  float* C1f = static_cast<float*>(C1);
  float* n1f = static_cast<float*>(n1);
  float* m1f = static_cast<float*>(m1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 128)
    return launch<4>(qf, kf, vf, igf, lff, C0f, n0f, m0f, hf, C1f, n1f, m1f,
                     BH, S, D, s);
  if (D <= 256)
    return launch<8>(qf, kf, vf, igf, lff, C0f, n0f, m0f, hf, C1f, n1f, m1f,
                     BH, S, D, s);
  if (D <= 512)
    return launch<16>(qf, kf, vf, igf, lff, C0f, n0f, m0f, hf, C1f, n1f, m1f,
                      BH, S, D, s);
  return launch<32>(qf, kf, vf, igf, lff, C0f, n0f, m0f, hf, C1f, n1f, m1f,
                    BH, S, D, s);
}
