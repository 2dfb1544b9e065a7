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
// of C twice (the update and the product with q), about 4*D^2 flops per
// (b, h, t), while the bytes are one read of q/k/v/gates, one write of h,
// and one read and one write of C. At xlstm-1.3b's width (D = 1024, H = 4)
// and a 600-token prompt (B = 1) that is 10.1 GFLOP against 73 MB: 0.150 ms
// at 67 TFLOP/s (no tensor cores: single-pass TF32 keeps too few digits for
// the f32 tolerance) and 0.021 ms at 3.35 TB/s. A decode step (S = 1, B = 8)
// is the other way round: 268 MB of state in and out against 0.13 GFLOP.
//
// Two routes, chosen by the wrapper from S alone
// (kernels/mlstm_scan/ops.py CHUNKWISE_MIN_S):
//
// Recurrent (decode): mlstm_scan_kernel walks the steps one at a time. A
// block owns kRowsPerBlock rows of C of one (b, h); each warp holds
// kRowsPerWarp rows in registers for the whole loop, so C crosses device
// memory once in and once out, which is what a decode step is bound by.
// Per step it is a matrix-vector product: at prefill it reached 6.8 of the
// card's 67 f32 TFLOP/s (1.49 ms at the shape above, NVIDIA H100 80GB
// HBM3, 700 W), paced by shared-memory loads and warp reductions.
//
// Chunkwise (prefill): S is cut into chunks of kChunk steps. With the
// carried state (C, n, m_{c0-1}) at a chunk's start c0, F_t the chunk's
// prefix sum of lf up to t, and the same m recurrence as above (computed in
// the same order, so m is bitwise the plain version's):
//   g_t     = exp(F_t + m_{c0-1} - m_t)
//   w_{t,s} = exp(F_t - F_s + i_s - m_t)                 (s <= t)
// both <= 1 by the max recurrence, and with P[t,s] = w_{t,s} (q_t . k_s):
//   C_t q_t   = g_t C q_t + sum_s P[t,s] v_s
//   n_t . q_t = g_t n . q_t + sum_s P[t,s]
//   C <- g_e C + sum_s w_{e,s} v_s k_s^T    n <- g_e n + sum_s w_{e,s} k_s
// (e the chunk's last step): the same operations as the recurrence, but the
// D^2 work is two matrix products per chunk instead of a matrix-vector
// product per step.
//   mlstm_chunk_prep_kernel, one block per (b, h, chunk), in parallel:
//     one warp walks m while eight warps form the [L x L] q.k products over
//     D (register-tiled f32, Q and K tiles double-buffered by cp.async);
//     then g, w_{e,.} and P go into a small record per chunk.
//   mlstm_chunk_scan_kernel, one block per (b, h, kRows rows of C), walks
//     the chunks. Its 256 threads hold the block's rows of C in registers
//     for the whole sequence (thread: 8 rows x 4 NJ columns), and n split
//     over them. The chunk's Q and K tiles ([kChunk x D]) stream through a
//     kScanStages-deep ring of shared memory, filled by TMA bulk copies (a
//     row each) that complete on an mbarrier per stage.
//     On a Q tile each thread forms its share of Q C^T (32 FFMA per 16-byte
//     shared load; the 4 lanes of a warp that share columns read the same
//     address), reduces it over the warp's column groups with shuffles and
//     over the warps through shared memory; on the K tile it writes h for
//     the chunk and updates its C entries (a [rows x L] by [L x D]
//     product). Each row block re-reads the chunk's Q and K (from L2):
//     kRows / 2 flops per byte.
//   The pair runs at about 40% of the operations bound at the shape above
//   (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6, row 5). Its two
//   products run near the FFMA rate; the rest is mostly per step
//   (reducing 64 column groups' partials of Q C^T, the tile copies); the
//   work done once per chunk (record and v rows, w.v, two of its four
//   barriers) costs about 3% (tools/ablate_mlstm_scan.py), so a longer
//   chunk would gain little. A 3xTF32 tensor-core form is the next step;
//   single-pass TF32 would not hold the f32 tolerance.
// Any S >= 1 and D <= 1024 with D % 4 == 0 (16-byte copies) run; steps
// past S, rows and columns past D are masked (zero-filled copies).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::warp_sum;
namespace sm90 = repro::sm90;

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
                      const float* C0,  // may be C1: see repro_mlstm_scan
                      const float* __restrict__ n0,
                      const float* __restrict__ m0, float* __restrict__ h,
                      float* C1, float* __restrict__ n1,
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

// ---------------------------------------------------------------------------
// chunkwise route
// ---------------------------------------------------------------------------

// Steps per chunk: kernels/mlstm_scan CHUNK. The scan kernel's ring holds
// kScanStages full-width [kChunk x D] tiles: 192 KB at D = 1024 and
// kChunk = 16, of the 227 KB a block may have, so 32 would need the tiles
// split along D; the thread layouts below tie it to 16 as well.
constexpr int kChunk = 16;
constexpr int kRec = kChunk * kChunk + 4 * kChunk;  // record floats per chunk
// record layout: P [kChunk][kChunk], g [kChunk], w_e [kChunk],
// psum [kChunk] (sum_s P[t,s]), extra [kChunk] (extra[0] = g_e)
constexpr int kRecG = kChunk * kChunk;
constexpr int kRecW = kRecG + kChunk;
constexpr int kRecSum = kRecW + kChunk;
constexpr int kRecExtra = kRecSum + kChunk;

constexpr int kDotThreads = 256;                // warps 0-7: the q.k products
constexpr int kPrepThreads = kDotThreads + 32;  // warp 8: the m walk
constexpr int kPrepTile = 256;   // columns of Q and K staged at once
constexpr int kPrepPad = kPrepTile + 4;
constexpr int kMTile = 512;      // gate steps staged per pass of the m walk
// dynamic shared memory of the prep kernel, in floats
constexpr int kPrepSmem = 2 * 2 * kChunk * kPrepPad + 2 * kMTile +
                          (kDotThreads / 32) * kChunk * kChunk + 2 * kChunk;

__device__ __forceinline__ void dot_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kDotThreads) : "memory");
}

// One block per (b, h, chunk): the record of chunk c. kChunk * kChunk must
// equal kDotThreads (one (t, s) pair per thread at the end).
__global__ void __launch_bounds__(kPrepThreads)
    mlstm_chunk_prep_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ ig,
                            const float* __restrict__ lf,
                            const float* __restrict__ m0,
                            float* __restrict__ rec, float* __restrict__ m1,
                            int S, int D, int n_chunks) {
  static_assert(kChunk * kChunk == kDotThreads, "one pair per thread");
  extern __shared__ __align__(16) float psmem[];
  float* qs = psmem;                                // [2][kChunk][kPrepPad]
  float* ks = qs + 2 * kChunk * kPrepPad;           // [2][kChunk][kPrepPad]
  float* gl = ks + 2 * kChunk * kPrepPad;           // [kMTile]
  float* gi = gl + kMTile;                          // [kMTile]
  float* red = gi + kMTile;                         // [8][kChunk * kChunk]
  float* A = red + (kDotThreads / 32) * kChunk * kChunk;   // [kChunk]
  float* Bs = A + kChunk;                                  // [kChunk]
  __shared__ float mprev_s;

  const int bh = blockIdx.x / n_chunks;
  const int c = blockIdx.x % n_chunks;
  const int c0 = c * kChunk;
  const int Lc = min(kChunk, S - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t seq = (size_t)bh * S;

  if (warp == kDotThreads / 32) {
    // the m walk from step 0 in the plain version's order (lane 0), with
    // the chunk's prefix sums: A_t = F_t - m_t, B_s = F_s - i_s
    float m = m0[bh], mprev = m, F = 0.f;
    for (int base = 0; base < c0 + Lc; base += kMTile) {
      const int n = min(kMTile, c0 + Lc - base);
      for (int u = lane; u < n; u += 32) {
        gl[u] = lf[seq + base + u];
        gi[u] = ig[seq + base + u];
      }
      __syncwarp();
      if (lane == 0) {
        const int pre = min(n, max(0, c0 - base));   // steps before c0
        int u = 0;
        for (; u + 8 <= pre; u += 8) {
#pragma unroll
          for (int x = 0; x < 8; ++x) m = fmaxf(gl[u + x] + m, gi[u + x]);
        }
        for (; u < pre; ++u) m = fmaxf(gl[u] + m, gi[u]);
        if (base + pre == c0) mprev = m;
        for (; u < n; ++u) {
          m = fmaxf(gl[u] + m, gi[u]);
          F += gl[u];
          A[base + u - c0] = F - m;
          Bs[base + u - c0] = F - gi[u];
        }
      }
      __syncwarp();
    }
    if (lane == 0) {
      mprev_s = mprev;
      if (c == n_chunks - 1) m1[bh] = m;
    }
  } else {
    // S[t,s] = q_t . k_s: warp w takes 32 of each staged tile's columns,
    // lane (ti, si) the pairs t in {ti + 4u}, s in {si + 8v}
    auto stage = [&](int d0, int buf) {
      float* qd = qs + buf * kChunk * kPrepPad;
      float* kd = ks + buf * kChunk * kPrepPad;
      for (int e = tid; e < kChunk * (kPrepTile / 4); e += kDotThreads) {
        const int t = e / (kPrepTile / 4), c4 = 4 * (e % (kPrepTile / 4));
        const bool ok = t < Lc && d0 + c4 < D;
        const size_t off = ok ? (seq + c0 + t) * D + d0 + c4 : 0;
        repro::cp_async16(qd + t * kPrepPad + c4, q + off, ok ? 16 : 0);
        repro::cp_async16(kd + t * kPrepPad + c4, k + off, ok ? 16 : 0);
      }
    };
    const int ti = lane >> 3, si = lane & 7;
    float acc[4][2] = {};
    const int n_tiles = repro::ceil_div(D, kPrepTile);
    stage(0, 0);
    repro::cp_async_commit();
    for (int tile = 0; tile < n_tiles; ++tile) {
      if (tile + 1 < n_tiles) stage((tile + 1) * kPrepTile, (tile + 1) & 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
      dot_barrier();
      const float* qd = qs + (tile & 1) * kChunk * kPrepPad;
      const float* kd = ks + (tile & 1) * kChunk * kPrepPad;
      const int dend = min(D - tile * kPrepTile, 32 * warp + 32);
      for (int d = 32 * warp; d < dend; ++d) {
        float qv[4], kv[2];
#pragma unroll
        for (int u = 0; u < 4; ++u) qv[u] = qd[(ti + 4 * u) * kPrepPad + d];
#pragma unroll
        for (int v = 0; v < 2; ++v) kv[v] = kd[(si + 8 * v) * kPrepPad + d];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v)
            acc[u][v] = fmaf(qv[u], kv[v], acc[u][v]);
      }
      dot_barrier();   // the buffer may be refilled next
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        red[warp * kChunk * kChunk + (ti + 4 * u) * kChunk + si + 8 * v] =
            acc[u][v];
  }
  __syncthreads();

  float* out = rec + ((size_t)bh * n_chunks + c) * kRec;
  const int t = tid / kChunk, s = tid % kChunk;
  float p = 0.f;
  if (tid < kDotThreads) {
    float sv = 0.f;
#pragma unroll
    for (int w = 0; w < kDotThreads / 32; ++w)
      sv += red[w * kChunk * kChunk + tid];
    p = (s <= t && t < Lc) ? expf(A[t] - Bs[s]) * sv : 0.f;
    out[tid] = p;
  }
  __syncthreads();                   // every warp has read red
  if (tid < kDotThreads) red[tid] = p;
  __syncthreads();
  if (tid < kChunk) {
    const int e = Lc - 1;
    float ps = 0.f;
    for (int j = 0; j < kChunk; ++j) ps += red[tid * kChunk + j];
    out[kRecG + tid] = tid < Lc ? expf(A[tid] + mprev_s) : 0.f;
    out[kRecW + tid] = tid < Lc ? expf(A[e] - Bs[tid]) : 0.f;
    out[kRecSum + tid] = ps;
    out[kRecExtra + tid] = tid == 0 ? expf(A[e] + mprev_s) : 0.f;
  }
}

constexpr int kScanThreads = 256;
constexpr int kRows = 32;        // rows of C per block: kernels/mlstm_scan ROWS
constexpr int kScanStages = 3;   // ring of [kChunk x Dp] Q and K tiles
static_assert(kScanStages >= 3, "an item is issued two ahead of its use");
constexpr int kSide = kRec + kChunk * kRows;  // record + the chunk's v rows
static_assert(kChunk % 8 == 0 && kChunk <= 32 &&
                  kChunk * kRows / 2 == kScanThreads,
              "the h pass gives each thread two rows of one step");

// Keep the half of x[0, 2H) selected by ``upper``, summed with the same
// half of the partner lane ``mask`` away (a reduce-scatter step).
template <int H>
__device__ __forceinline__ void halve(float* x, bool upper, int mask) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = upper ? x[H + i] : x[i];
    const float send = upper ? x[i] : x[H + i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// x[i] += the partner lane's x[H + i] (``mask`` away), for i < H: a
// reduce-scatter step without selects, for slots whose order each lane has
// flipped so that the half it keeps is always the low one.
template <int H>
__device__ __forceinline__ void fold(float* x, int mask) {
#pragma unroll
  for (int i = 0; i < H; ++i)
    x[i] += __shfl_xor_sync(0xffffffffu, x[H + i], mask);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ float4 scale4(float a, float4 x) {
  return make_float4(a * x.x, a * x.y, a * x.z, a * x.w);
}

// Thread layout: warp w, lane = 8 rg + dl. The thread holds rows
// 8 rg .. 8 rg + 7 of the block's kRows and the columns 4 (dg + 64 j) ..
// + 3 for j < NJ, dg = 8 w + dl, so D <= 256 NJ; a 16-byte shared load
// feeds 32 FFMA, and the 4 lanes that share columns read one address. The
// thread also holds n's columns 4 (dg + 64 rg) .. + 3 when rg < NJ (every
// column once).
template <int NJ>
__global__ void __launch_bounds__(kScanThreads, 1)
    mlstm_chunk_scan_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ rec,
                            const float* __restrict__ C0,
                            const float* __restrict__ n0,
                            float* __restrict__ h, float* __restrict__ C1,
                            float* __restrict__ n1, int S, int D,
                            int row_blocks, int n_chunks) {
  constexpr int Dp = 256 * NJ;             // padded row of a Q/K tile
  constexpr int kTile = kChunk * Dp;
  constexpr int kWarps = kScanThreads / 32;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                               // [stages][kChunk][Dp]
  float* side = ring + kScanStages * kTile;         // [2][kSide]
  float* red = side + 2 * kSide;                    // [warps][kChunk][kRows]
  float* red_dot = red + kWarps * kChunk * kRows;   // [warps][kChunk]
  float* wvs = red_dot + kWarps * kChunk;           // [kChunk][kRows]

  const int bh = blockIdx.x / row_blocks;
  const int row0 = (blockIdx.x % row_blocks) * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dl = lane & 7, rg = lane >> 3, dg = 8 * warp + dl;
  const size_t seq = (size_t)bh * S;
  const size_t DD = (size_t)D * D;
  const bool has_n = rg < NJ;
  const int ncol = 4 * (dg + 64 * (has_n ? rg : 0));

  float4 c[8][NJ];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = row0 + 8 * rg + r;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 4 * (dg + 64 * j);
      c[r][j] = (row < D && col < D)
                    ? *reinterpret_cast<const float4*>(C0 + bh * DD +
                                                       (size_t)row * D + col)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float4 nv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (has_n && ncol < D)
    nv = *reinterpret_cast<const float4*>(n0 + (size_t)bh * D + ncol);

  // Columns past D are never copied: zero the ring once (the bulk copies
  // below write whole rows of D values). Rows past S in the last chunk keep
  // zeros or an earlier chunk's finite values: they meet zero weights (w_e,
  // v) in the update, and their h is not written.
  __shared__ uint64_t full[kScanStages];
  for (int e = tid; e < kScanStages * kTile / 4; e += kScanThreads)
    reinterpret_cast<float4*>(ring)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid == 0) {
    for (int st = 0; st < kScanStages; ++st) sm90::mbar_init(&full[st], 1);
    sm90::fence_barrier_init();
  }
  sm90::fence_proxy_async();
  __syncthreads();

  // item i: chunk i / 2, its Q tile (even) or K tile (odd), one bulk copy
  // per row by the lanes of warp 0 onto full[slot]; an even item also
  // brings the chunk's record and v rows into side[chunk % 2] (cp.async,
  // all threads)
  const int items = 2 * n_chunks;
  auto issue = [&](int i) {
    const int ch = i >> 1, t0 = ch * kChunk;
    if (warp == 0) {
      const int rows = min(kChunk, S - t0);
      const float* src = ((i & 1) ? k : q) + (seq + t0) * D;
      float* dst = ring + (i % kScanStages) * kTile;
      uint64_t* bar = &full[i % kScanStages];
      if (lane == 0) sm90::mbar_arrive_expect_tx(bar, rows * D * 4);
      __syncwarp();
      if (lane < rows)
        sm90::bulk_load(dst + lane * Dp, src + (size_t)lane * D, D * 4, bar);
    }
    if ((i & 1) == 0) {
      float* sd = side + (ch & 1) * kSide;
      const float* rs = rec + ((size_t)bh * n_chunks + ch) * kRec;
      for (int e = tid; e < kRec / 4; e += kScanThreads)
        repro::cp_async16(sd + 4 * e, rs + 4 * e);
      for (int e = tid; e < kChunk * kRows / 4; e += kScanThreads) {
        const int t = e / (kRows / 4), c4 = 4 * (e % (kRows / 4));
        const bool ok = t0 + t < S && row0 + c4 < D;
        const float* vs = v + (seq + t0 + t) * D + row0 + c4;
        repro::cp_async16(sd + kRec + t * kRows + c4, ok ? vs : v,
                          ok ? 16 : 0);
      }
    }
  };

  issue(0);
  repro::cp_async_commit();
  if (items > 1) issue(1);
  repro::cp_async_commit();
  for (int i = 0; i < items; ++i) {
    if (i + 2 < items) issue(i + 2);   // into the slot item i - 1 used
    repro::cp_async_commit();
    repro::cp_async_wait<2>();
    sm90::mbar_wait(&full[i % kScanStages], (i / kScanStages) & 1);
    __syncthreads();
    const float* tile = ring + (i % kScanStages) * kTile;
    const int ch = i >> 1, t0 = ch * kChunk;
    const float* sd = side + (ch & 1) * kSide;
    if ((i & 1) == 0) {
      // w_{e,s} v_s for the block's rows, for the update on the K tile
      for (int x = tid; x < kChunk * kRows; x += kScanThreads)
        wvs[x] = sd[kRecW + x / kRows] * sd[kRec + x];
      // (C q_t)[rows] over this thread's columns, reduced over the warp's
      // eight column groups (lanes 4, 2 and 1 apart) and written per warp.
      // Slot tt of a lane holds step tt ^ f, f = dl >> 1, so the two step
      // halvings keep the low slots (fold); the row halving selects.
      const int f = dl >> 1;
#pragma unroll
      for (int pass = 0; pass < kChunk / 4; ++pass) {
        float hp[32];                  // [4 slots][8 rows]
#pragma unroll
        for (int x = 0; x < 32; ++x) hp[x] = 0.f;
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          const float* qt = tile + (4 * pass + (tt ^ f)) * Dp;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float4 q4 =
                *reinterpret_cast<const float4*>(qt + 4 * (dg + 64 * j));
            float* acc = hp + 8 * tt;
#pragma unroll
            for (int r = 0; r < 8; ++r) acc[r] = fmaf(c[r][j].x, q4.x, acc[r]);
#pragma unroll
            for (int r = 0; r < 8; ++r) acc[r] = fmaf(c[r][j].y, q4.y, acc[r]);
#pragma unroll
            for (int r = 0; r < 8; ++r) acc[r] = fmaf(c[r][j].z, q4.z, acc[r]);
#pragma unroll
            for (int r = 0; r < 8; ++r) acc[r] = fmaf(c[r][j].w, q4.w, acc[r]);
          }
        }
        fold<16>(hp, 4);               // keep slots 0, 1
        fold<8>(hp, 2);                // keep slot 0: step 4 pass + f
        halve<4>(hp, dl & 1, 1);       // keep rows 4 (dl & 1) .. + 3
        const int t = 4 * pass + f;
        *reinterpret_cast<float4*>(red + (warp * kChunk + t) * kRows +
                                   8 * rg + 4 * (dl & 1)) =
            make_float4(hp[0], hp[1], hp[2], hp[3]);
      }
      // n . q_t over this thread's n columns, reduced over the warp
      // (slot x holds step x ^ (lane >> 1): every halving keeps the low half)
      float dp[kChunk];
#pragma unroll
      for (int x = 0; x < kChunk; ++x)
        dp[x] = dot4(nv, *reinterpret_cast<const float4*>(
                             tile + (x ^ (lane >> 1)) * Dp + ncol), 0.f);
      fold<8>(dp, 16);
      fold<4>(dp, 8);
      fold<2>(dp, 4);
      fold<1>(dp, 2);
      dp[0] += __shfl_xor_sync(0xffffffffu, dp[0], 1);
      if ((lane & 1) == 0) red_dot[warp * kChunk + (lane >> 1)] = dp[0];
    } else {
      // h for the chunk: two rows of one step per thread
      const float* P = sd;
      const float* V = sd + kRec;
      const int t = tid / (kRows / 2), r = 2 * (tid % (kRows / 2));
      float hq0 = 0.f, hq1 = 0.f, nq = 0.f, pv0 = 0.f, pv1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float2 x = *reinterpret_cast<const float2*>(
            red + (w * kChunk + t) * kRows + r);
        hq0 += x.x;
        hq1 += x.y;
        nq += red_dot[w * kChunk + t];
      }
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const float p = P[t * kChunk + s];
        const float2 vs = *reinterpret_cast<const float2*>(V + s * kRows + r);
        pv0 = fmaf(p, vs.x, pv0);
        pv1 = fmaf(p, vs.y, pv1);
      }
      const float g = sd[kRecG + t];
      const float den = fmaxf(fabsf(fmaf(g, nq, sd[kRecSum + t])), 1.f);
      if (t0 + t < S && row0 + r < D)
        *reinterpret_cast<float2*>(h + (seq + t0 + t) * D + row0 + r) =
            make_float2(fmaf(g, hq0, pv0) / den, fmaf(g, hq1, pv1) / den);

      // C <- g_e C + sum_s (w_{e,s} v_s) k_s^T; n <- g_e n + sum_s w_{e,s} k_s
      // (a thread without n columns keeps its nv at zero)
      const float ge = sd[kRecExtra];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr)
#pragma unroll
        for (int j = 0; j < NJ; ++j) c[rr][j] = scale4(ge, c[rr][j]);
      nv = scale4(ge, nv);
#pragma unroll 4
      for (int s = 0; s < kChunk; ++s) {
        const float ws = sd[kRecW + s];
        const float4 va =
            *reinterpret_cast<const float4*>(wvs + s * kRows + 8 * rg);
        const float4 vb =
            *reinterpret_cast<const float4*>(wvs + s * kRows + 8 * rg + 4);
        const float wv[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
        const float* kt = tile + s * Dp;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 k4 =
              *reinterpret_cast<const float4*>(kt + 4 * (dg + 64 * j));
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) axpy4(wv[rr], k4, c[rr][j]);
        }
        axpy4(has_n ? ws : 0.f, *reinterpret_cast<const float4*>(kt + ncol),
              nv);
      }
    }
    __syncthreads();   // the slot and side buffer may be refilled next
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = row0 + 8 * rg + r;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 4 * (dg + 64 * j);
      if (row < D && col < D)
        *reinterpret_cast<float4*>(C1 + bh * DD + (size_t)row * D + col) =
            c[r][j];
    }
  }
  if (row0 == 0 && has_n && ncol < D)
    *reinterpret_cast<float4*>(n1 + (size_t)bh * D + ncol) = nv;
}

template <int NJ>
cudaError_t launch_chunkwise(const float* q, const float* k, const float* v,
                             const float* ig, const float* lf,
                             const float* C0, const float* n0,
                             const float* m0, float* rec, float* h, float* C1,
                             float* n1, float* m1, int BH, int S, int D,
                             cudaStream_t stream) {
  const int n_chunks = repro::ceil_div(S, kChunk);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * kPrepSmem));
  if (err != cudaSuccess) return err;
  mlstm_chunk_prep_kernel<<<BH * n_chunks, kPrepThreads,
                            sizeof(float) * kPrepSmem, stream>>>(
      q, k, ig, lf, m0, rec, m1, S, D, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int Dp = 256 * NJ;
  const size_t smem =
      sizeof(float) * ((size_t)kScanStages * kChunk * Dp + 2 * kSide +
                       (kScanThreads / 32) * kChunk * (kRows + 1) +
                       kChunk * kRows);
  err = cudaFuncSetAttribute(mlstm_chunk_scan_kernel<NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int row_blocks = repro::ceil_div(D, kRows);
  mlstm_chunk_scan_kernel<NJ><<<BH * row_blocks, kScanThreads, smem,
                                 stream>>>(q, k, v, rec, C0, n0, h, C1, n1, S,
                                           D, row_blocks, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// f32, contiguous: q/k/v [BH,S,D]; ig/lf [BH,S]; C0 [BH,D,D]; n0 [BH,D];
// m0 [BH]; outputs h [BH,S,D], C1 [BH,D,D], n1 [BH,D], m1 [BH]. C1 may be
// C0 (the decode step updates its state in place): each thread reads its
// entries of C0 into registers before it writes them, and no other thread
// touches them. No other output aliases an input (every block reads n0 and
// m0, one writes n1 and m1).
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

// The chunkwise route, same operands as repro_mlstm_scan plus ``rec``,
// scratch of BH * ceil(S / kChunk) * kRec f32 (kernels/mlstm_scan
// record_numel). q/k/v/h/C0/C1/n0/n1 and rec 16-byte aligned, D % 4 == 0.
extern "C" int repro_mlstm_scan_chunkwise(
    const void* q, const void* k, const void* v, const void* ig,
    const void* lf, const void* C0, const void* n0, const void* m0,
    void* rec, void* h, void* C1, void* n1, void* m1, int BH, int S, int D,
    void* stream) {
  if (BH <= 0 || S <= 0 || D <= 0 || D > kMaxD || D % 4 != 0)
    return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* igf = static_cast<const float*>(ig);
  const float* lff = static_cast<const float*>(lf);
  const float* C0f = static_cast<const float*>(C0);
  const float* n0f = static_cast<const float*>(n0);
  const float* m0f = static_cast<const float*>(m0);
  float* recf = static_cast<float*>(rec);
  float* hf = static_cast<float*>(h);
  float* C1f = static_cast<float*>(C1);
  float* n1f = static_cast<float*>(n1);
  float* m1f = static_cast<float*>(m1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_MLSTM_CHUNKWISE(NJ)                                           \
  return launch_chunkwise<NJ>(qf, kf, vf, igf, lff, C0f, n0f, m0f, recf,  \
                               hf, C1f, n1f, m1f, BH, S, D, s)
  if (D <= 256) REPRO_MLSTM_CHUNKWISE(1);
  if (D <= 512) REPRO_MLSTM_CHUNKWISE(2);
  REPRO_MLSTM_CHUNKWISE(4);
#undef REPRO_MLSTM_CHUNKWISE
}
