// Ragged single-token GQA decode attention over a dense KV cache or over
// page pools addressed through a block table, as split-KV over fixed
// chunks of positions plus a combine pass.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py
//           decode_attention_pallas (line 203, pallas_call at line 243)
//           and paged_decode_attention_pallas (line 139, pallas_call at
//           line 190, with paged_kv_index_map at lines 69-79).
//
// Computes, for row b and query head h (KV head kv = h / g):
//   out[b,h] = softmax(q[b,h] . k[b,:len_b,kv] / sqrt(D)) @ v[b,:len_b,kv]
// with len_b = clamp(lengths[b], 0, C); a row with len 0 gives exact zeros.
//
// What bounds it on the H100: bytes. Each live cache position is read once
// (K and V, Kv*D values each) and used for g query heads: 4*g*D flops per
// 4*D bytes in bf16, 1 flop per byte at g = 1 (qwen2-moe) and 6 at g = 6,
// far below even the f32 cores' ~20 flops per byte. The least time is
// sum_b len_b * Kv * D * 2 * elem / 3.35 TB/s, so the design is about
// keeping enough bytes in flight, not about tensor cores.
//
// The design, two kernels per call:
//  * decode_attention_split_kernel: one block of 4 warps per (row b, KV
//    head, chunk j), chunk j being positions [j*kChunk, (j+1)*kChunk). The
//    grid, B * Kv * ceil(C / kChunk), follows from the shapes alone (no
//    length is read on the host); a block whose chunk starts at or past
//    len_b exits at once, so the bytes streamed follow the ledger lengths
//    (the Pallas kernel's block skip). The grid is chunk-major: every
//    row's first chunks (the live ones) come first and the dead tails of
//    the short rows last. With 8 slots of qwen2-moe (Kv = 16) at ~300
//    positions that is ~640 live blocks, ~5 per SM, where one block per
//    (row, KV head) gave 128 blocks, one per SM.
//  * K and V rows (D contiguous values per position and KV head in both
//    layouts) are copied into shared memory in their stored dtype with
//    16-byte cp.async.cg, neighbouring threads on neighbouring 16 bytes,
//    through a ring of kStages sub-tiles of kStageBytes: the chunk's K
//    sub-tiles, then its V sub-tiles. The first kStages copies go out
//    before any other work of the block (q's load overlaps them), and a
//    stage is refilled as soon as its sub-tile has been used.
//    Sizes: a sub-tile of 8 KB is 32 positions of D = 128 in bf16, so the
//    2 stages put a bf16 chunk's K (16 KB) in flight from the block's
//    start, and each V sub-tile goes out as soon as a K sub-tile is used.
//    A block takes ~21 KB of shared memory and 56 registers a thread
//    (bf16, D = 128, g = 1), so 9 share an SM (1188 on the card): ~144 KB
//    of loads in flight per SM, against the ~25-32 KB that 3.35 TB/s
//    needs at ~1 us of latency. What bounds a block is its chain of
//    dependent steps (the length, the copies, the math, the partials), so
//    blocks resident at once matter more than bytes in flight per block.
//    Ring depth and grid order were chosen by
//    tools/sweep_decode_attention.py on the decode step's shape (8 rows of
//    ~300 positions, each call on its own layer's cache, out of L2): 2
//    stages, chunk-major, took the least time there. With the K/V in L2,
//    3 stages are faster at the checks' mixed lengths and 4 at 8 rows of
//    ~300 (PERF.md has the readings).
//  * Scores: a power of two of neighbouring threads per (head, position),
//    each reading every tpr-th 16-byte vector of the K row from shared
//    memory, reduce with tpr-lane shuffles (8 threads per row at D = 128
//    in bf16: 16 positions per pass of the block). The chunk's softmax is
//    exact, not online: once all its scores are in shared memory, one
//    warp per head takes max and sum with shuffles. P.V: each thread owns
//    one 16-byte vector of one head's accumulator in one of `groups`
//    position groups (8 at g = 1, D = 128 in bf16), reading V rows as
//    16-byte vectors; the groups are summed in order at the end.
//    The block writes its f32 partials (m, l, acc[g, D]) to scratch that
//    the wrapper allocates; the kernel allocates nothing.
//  * decode_attention_combine_kernel: one block per (row, query head)
//    rescales the row's live chunks in chunk order (log-sum-exp) and
//    writes out in the working dtype; a row with no live chunk writes
//    zeros.
// No atomics: a row's output depends only on its own contents and length,
// not on C, B, the other rows or the page size, and two identical calls
// give the same bits.
//
// Paged mode: the same template with another address policy. Cache
// position p of row b lives in page max(tbl[b, p / bs], 0) at row p % bs
// (entries < 0 are unallocated and read the reserved scratch page 0, as
// paged_kv_index_map clamps them; they lie past the row's length). A block
// reads the table entries its chunk covers (ceil(kChunk / bs), +1 where bs
// does not divide kChunk) once into shared memory and works out its
// positions' row addresses from them before its first copy. Chunks, tiles
// and the arithmetic do not depend on the page size, so at any bs >= 1
// the paged output is bitwise the dense kernel's over the gathered
// contents. Lengths are clamped to [0, n_blocks * bs].
//
// Operands: K and V must be 16-byte aligned with D * elem a multiple of 16
// bytes (D a multiple of 8 in bf16, 4 in f32); the entry points refuse
// others, and so does the Python wrapper, with a message.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::from_f32;
using repro::to_f32;
using repro::warp_max;
using repro::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;         // positions per split: kernel.py CHUNK
constexpr int kStages = 2;         // ring depth
constexpr int kStageBytes = 8192;  // one K or V sub-tile
constexpr int kMaxGroup = 128;         // kernel.py MAX_GROUP
constexpr int kMaxGroupWidth = 4096;   // kernel.py MAX_GROUP_WIDTH

// Where the chunk's positions live: fills row_s[p] (p < n) with the index
// of the [Kv, D] row of cache position p0 + p of row b (positions are rows
// of Kv*D values in both modes; the wrappers refuse caches of 2^31 rows or
// more, so the index fits an int). Called by every thread of the block.
struct DenseRows {
  int C;  // cache positions per row
  __device__ __forceinline__ void prepare(int b, int p0, int n, int* row_s,
                                          int*) const {
    for (int p = threadIdx.x; p < n; p += kThreads) row_s[p] = b * C + p0 + p;
  }
};

struct PagedRows {
  const int* table;  // [B, n_blocks], < 0 = unallocated
  int n_blocks;
  int bs;  // positions per page
  __device__ __forceinline__ void prepare(int b, int p0, int n, int* row_s,
                                          int* ent_s) const {
    const int first = p0 / bs;
    const int n_ent = (p0 + n - 1) / bs - first + 1;  // <= n
    for (int t = threadIdx.x; t < n_ent; t += kThreads)
      ent_s[t] = max(table[(size_t)b * n_blocks + first + t], 0);
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += kThreads) {
      const int pos = p0 + p;
      row_s[p] = ent_s[pos / bs - first] * bs + pos % bs;
    }
  }
};

// 16 bytes of T at p (16-byte aligned, shared memory) as f32
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&x)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_attention_split_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const int* __restrict__ lengths,
                                  float2* __restrict__ part_ml,
                                  float* __restrict__ part_acc, Rows rows,
                                  int H, int Kv, int C, int D, int n_chunks,
                                  int tile_rows, int tpr, int groups,
                                  float scale) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte vector
  // chunk-major: every row's first chunks (the live ones) come first in
  // the grid, and the dead chunks of short rows last
  const int n_bk = gridDim.x / n_chunks;  // B * Kv
  const int j = blockIdx.x / n_bk;
  const int bk = blockIdx.x - j * n_bk;   // b * Kv + kv head
  const int b = bk / Kv;
  const int kvh = bk - b * Kv;
  const int p0 = j * kChunk;
  const int len = max(0, min(lengths[b], C));
  if (p0 >= len) return;
  const int n = min(kChunk, len - p0);  // live positions of the chunk
  const int g = H / Kv;
  const int nv = D / V;  // vectors per K/V row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = D * (int)sizeof(T);
  const int stage_bytes = tile_rows * row_bytes;
  unsigned char* ring = smem;  // [kStages][tile_rows][D] of T
  int* row_s = reinterpret_cast<int*>(ring + kStages * stage_bytes);
  float* q_s = reinterpret_cast<float*>(row_s + kChunk);  // [g][D], scaled
  float* s_s = q_s + g * D;          // [g][kChunk] scores, then exp
  float* acc_s = s_s + g * kChunk;   // [groups][g][D]
  float* m_s = acc_s + groups * g * D;  // [g]
  float* l_s = m_s + g;                 // [g]
  int* ent_s = reinterpret_cast<int*>(l_s + g);  // [kChunk] table entries

  rows.prepare(b, p0, n, row_s, ent_s);
  __syncthreads();

  const int n_tiles = (n + tile_rows - 1) / tile_rows;  // of K, and of V
  const int total = 2 * n_tiles;
  const size_t pos_stride = (size_t)Kv * D;
  const T* kb = k + (size_t)kvh * D;
  const T* vb = v + (size_t)kvh * D;
  // copy i = r * nv + c of a sub-tile (row r, vector c): this thread's
  // first one and its step of kThreads, without a division per copy
  const int r_first = tid / nv;
  const int c_first = tid - r_first * nv;
  const int r_step = kThreads / nv;
  const int c_step = kThreads - r_step * nv;
  auto issue = [&](int t) {  // sub-tile t: K for t < n_tiles, then V
    const bool is_k = t < n_tiles;
    const T* src = is_k ? kb : vb;
    const int r0 = (is_k ? t : t - n_tiles) * tile_rows;
    const int nr = min(tile_rows, n - r0);
    T* dst = reinterpret_cast<T*>(ring + (t % kStages) * stage_bytes);
    for (int r = r_first, c = c_first; r < nr;) {
      cp_async16(dst + r * D + c * V,
                 src + (size_t)row_s[r0 + r] * pos_stride + c * V);
      r += r_step;
      c += c_step;
      if (c >= nv) {
        c -= nv;
        ++r;
      }
    }
  };
  // the copies go out first; q's load and the zeroing overlap them
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t < total) issue(t);
    cp_async_commit();
  }
  const T* qb = q + ((size_t)b * H + (size_t)kvh * g) * D;
  for (int i = tid; i < g * D; i += kThreads) q_s[i] = to_f32(qb[i]) * scale;
  for (int i = tid; i < groups * g * D; i += kThreads) acc_s[i] = 0.f;

  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 1>();  // this thread's copies of sub-tile t
    __syncthreads();               // everyone's (and q_s, acc_s)
    const T* tile = reinterpret_cast<const T*>(ring + (t % kStages) *
                                                          stage_bytes);
    if (t < n_tiles) {
      // scores: tpr neighbouring threads per (head, position), each over
      // every tpr-th vector of the row, then tpr-lane shuffles
      const int r0 = t * tile_rows;
      const int nr = min(tile_rows, n - r0);
      const int sub = tid % tpr;
      for (int base = 0; base < g * nr; base += kThreads / tpr) {
        const int pair = base + tid / tpr;
        const bool live = pair < g * nr;
        const int h = live ? pair / nr : 0;
        const int r = live ? pair - h * nr : 0;
        const T* kr = tile + r * D;
        const float* qh = q_s + h * D;
        float s = 0.f;
        for (int vi = sub; vi < nv; vi += tpr) {
          float kx[V], qx[4];
#pragma unroll
          for (int u = 0; u < V; u += 4) {
            load16(qh + vi * V + u, qx);
            if (u == 0) load16(kr + vi * V, kx);
#pragma unroll
            for (int w = 0; w < 4; ++w) s = fmaf(qx[w], kx[u + w], s);
          }
        }
        for (int o = tpr / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (live && sub == 0) s_s[h * kChunk + r0 + r] = s;
      }
      if (t == n_tiles - 1) {  // every score of the chunk: its softmax
        __syncthreads();
        for (int h = warp; h < g; h += kWarps) {
          float* sh = s_s + h * kChunk;
          float mx = -INFINITY;
          for (int p = lane; p < n; p += 32) mx = fmaxf(mx, sh[p]);
          mx = warp_max(mx);  // finite: the chunk has n >= 1 positions
          float sum = 0.f;
          for (int p = lane; p < n; p += 32) {
            const float e = expf(sh[p] - mx);
            sh[p] = e;
            sum += e;
          }
          sum = warp_sum(sum);
          if (lane == 0) {
            m_s[h] = mx;
            l_s[h] = sum;
          }
        }
      }
    } else {
      // P.V: each thread owns one vector of one head's accumulator in one
      // of `groups` position groups (positions r = group mod groups)
      const int r0 = (t - n_tiles) * tile_rows;
      const int nr = min(tile_rows, n - r0);
      const int ents = g * nv;
      for (int e = tid; e < groups * ents; e += kThreads) {
        const int grp = e / ents;
        const int h = (e - grp * ents) / nv;
        const int vi = e - grp * ents - h * nv;
        float* a = acc_s + (size_t)(grp * g + h) * D + vi * V;
        const float* ph = s_s + h * kChunk + r0;
        float ax[V];
#pragma unroll
        for (int u = 0; u < V; u += 4) {
          float x[4];
          load16(a + u, x);
#pragma unroll
          for (int w = 0; w < 4; ++w) ax[u + w] = x[w];
        }
        for (int r = grp; r < nr; r += groups) {
          float vx[V];
          load16(tile + r * D + vi * V, vx);
          const float p = ph[r];
#pragma unroll
          for (int u = 0; u < V; ++u) ax[u] = fmaf(p, vx[u], ax[u]);
        }
#pragma unroll
        for (int u = 0; u < V; u += 4)
          *reinterpret_cast<float4*>(a + u) =
              make_float4(ax[u], ax[u + 1], ax[u + 2], ax[u + 3]);
      }
    }
    if (t + kStages < total) {  // refill this stage once all have used it
      __syncthreads();
      issue(t + kStages);
    }
    cp_async_commit();
  }
  __syncthreads();

  // partials of (b, kvh, j) at ((b * Kv + kvh) * n_chunks + j) * g; the
  // position groups summed in order
  const size_t slot = ((size_t)bk * n_chunks + j) * g;
  for (int e = tid; e < g * D; e += kThreads) {
    float a = acc_s[e];
    for (int grp = 1; grp < groups; ++grp) a += acc_s[grp * g * D + e];
    part_acc[slot * D + e] = a;
  }
  for (int h = tid; h < g; h += kThreads)
    part_ml[slot + h] = make_float2(m_s[h], l_s[h]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attention_combine_kernel(const float2* __restrict__ part_ml,
                                    const float* __restrict__ part_acc,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ out, int H, int Kv,
                                    int C, int D, int n_chunks) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int g = H / Kv;
  const int kvh = h / g;
  const int hh = h - kvh * g;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int len = max(0, min(lengths[b], C));
  const int n = (len + kChunk - 1) / kChunk;  // live chunks
  T* o = out + ((size_t)b * H + h) * D;
  if (n == 0) {
    for (int d = tid; d < D; d += kThreads) o[d] = from_f32<T>(0.f);
    return;
  }
  // chunk jj of this head: ml[jj * g], acc[jj * g * D]
  const size_t slot = ((size_t)(b * Kv + kvh) * n_chunks) * g + hh;
  const float2* ml = part_ml + slot;
  const float* acc = part_acc + slot * D;
  // every warp works out the same max and sum, in the same order
  float mx = -INFINITY;
  for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, ml[(size_t)jj * g].x);
  mx = warp_max(mx);
  float l = 0.f;
  for (int jj = lane; jj < n; jj += 32) {
    const float2 p = ml[(size_t)jj * g];
    l = fmaf(p.y, expf(p.x - mx), l);
  }
  l = warp_sum(l);
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
    for (int jj = 0; jj < n; ++jj)
      a = fmaf(expf(ml[(size_t)jj * g].x - mx),
               acc[(size_t)jj * g * D + d], a);
    o[d] = from_f32<T>(a / l);
  }
}

template <typename T, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* scratch, void* out, Rows rows,
                   int B, int H, int Kv, int C, int D, cudaStream_t stream) {
  const int row_bytes = D * (int)sizeof(T);
  if (row_bytes % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return cudaErrorInvalidValue;
  const int g = H / Kv;
  const int n_chunks = repro::ceil_div(C, kChunk);
  // scratch: f32 pairs (m, l) [B, Kv, n_chunks, g], then acc [.., g, D]
  float2* part_ml = static_cast<float2*>(scratch);
  float* part_acc =
      reinterpret_cast<float*>(part_ml + (size_t)B * Kv * n_chunks * g);
  if (n_chunks > 0) {
    const int fit = kStageBytes / row_bytes;  // rows of one sub-tile
    const int tile_rows = fit < 1 ? 1 : (fit > kChunk ? kChunk : fit);
    // scores: a power of two <= 32 of threads per row, ~2 vectors each
    const int nv = row_bytes / 16;
    int tpr = 1;
    while (tpr < 32 && 2 * tpr < nv) tpr *= 2;
    // P.V: position groups that keep the block's threads busy
    const int groups = g * nv >= kThreads ? 1 : kThreads / (g * nv);
    const size_t smem =
        (size_t)kStages * tile_rows * row_bytes + sizeof(int) * kChunk +
        sizeof(float) * ((size_t)g * D * (1 + groups) + (size_t)g * kChunk +
                         2 * (size_t)g) +
        sizeof(int) * kChunk;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          decode_attention_split_kernel<T, Rows>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    decode_attention_split_kernel<T, Rows>
        <<<B * Kv * n_chunks, kThreads, smem, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), lengths, part_ml, part_acc, rows, H,
            Kv, C, D, n_chunks, tile_rows, tpr, groups,
            1.0f / sqrtf((float)D));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  decode_attention_combine_kernel<T><<<B * H, kThreads, 0, stream>>>(
      part_ml, part_acc, lengths, static_cast<T*>(out), H, Kv, C, D,
      n_chunks);
  return cudaGetLastError();
}

bool valid_heads(int B, int H, int Kv, int D) {
  if (B <= 0 || Kv <= 0 || H % Kv != 0 || D <= 0) return false;
  const int g = H / Kv;
  return g <= kMaxGroup && g * D <= kMaxGroupWidth;
}

template <typename Rows>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* lengths, void* scratch, void* out, Rows rows, int B,
             int H, int Kv, int C, int D, void* stream) {
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, lens, scratch, out, rows, B, H, Kv,
                                 C, D, s);
  if (dtype == repro::kFloat32)
    return launch<float>(q, k, v, lens, scratch, out, rows, B, H, Kv, C, D,
                         s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,H,D]; k/v [B,C,Kv,D]; lengths int32 [B]; scratch f32
// [B * Kv * ceil(C / 64) * H / Kv * (D + 2)]; out [B,H,D]; all contiguous.
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* scratch, void* out, int B, int H,
                                      int Kv, int C, int D, void* stream) {
  if (!valid_heads(B, H, Kv, D) || C < 0 || (long long)B * C > INT32_MAX)
    return cudaErrorInvalidValue;
  return dispatch(dtype, q, k, v, lengths, scratch, out, DenseRows{C}, B, H,
                  Kv, C, D, stream);
}

// q [B,H,D]; k/v pages [P,bs,Kv,D]; lengths int32 [B]; table int32
// [B,n_blocks]; scratch as above with C = n_blocks * bs; out [B,H,D]; all
// contiguous. Row b attends its first clamp(lengths[b], 0, n_blocks * bs)
// logical positions.
extern "C" int repro_decode_attention_paged(int dtype, const void* q,
                                            const void* k, const void* v,
                                            const void* lengths,
                                            const void* table, void* scratch,
                                            void* out, int B, int H, int Kv,
                                            int bs, int n_blocks, int D,
                                            void* stream) {
  if (!valid_heads(B, H, Kv, D) || bs <= 0 || n_blocks <= 0)
    return cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(table), n_blocks, bs};
  return dispatch(dtype, q, k, v, lengths, scratch, out, rows, B, H, Kv,
                  n_blocks * bs, D, stream);
}
