// Ragged single-token GQA decode attention over a dense KV cache or over
// page pools addressed through a block table.
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
// (K and V, Kv*D values each) and used for g query heads, so the work is
// 4*g*D flops per 4*D bytes (bf16) -- far below the card's ~295 flops/byte
// ridge. The least time is sum_b len_b * Kv * D * 2 * elem / 3.35 TB/s.
//
// What the design does about it: one block per (row, KV head) walks only
// ceil(len_b / kTile) tiles of its row (the Pallas kernel's block skip), so
// the bytes streamed follow the ledger lengths and not the cache capacity.
// The g query heads of the group share each K/V tile loaded into shared
// memory, and the online-softmax state (m, l, acc) stays in f32 in shared
// memory and registers. Known weakness, left for a later change: with
// qwen2-moe (g=1, Kv=16) and 8 slots the grid is only 128 blocks of 128
// threads, about one block per SM, so the card's memory system is far from
// saturated; split-KV over the cache length plus a combine pass is the fix.
//
// Paged mode: the body is the same template, instantiated with another K/V
// address policy. Cache position p of row b lives in page
// max(tbl[b, p / bs], 0) at row p % bs (entries < 0 are unallocated and
// read the reserved scratch page 0, as paged_kv_index_map clamps them;
// they lie past the row's length, so no live position reads one). There is
// no scalar prefetch on Hopper: each block reads its own table row, one
// entry per position of the tile, into shared memory before the tile load.
// The tile loop, kTile and the online-softmax order do not depend on the
// page size, so at any bs the paged kernel does the same arithmetic in the
// same order as the dense kernel over the gathered contents, and the two
// outputs are bitwise equal (the bar tests/test_paging.py locks for the
// TPU kernels at bc == bs). Lengths are clamped to [0, n_blocks * bs].
// Bound: bytes again, the live positions' K/V plus the table row; the
// weakness is the dense kernel's, B*Kv blocks (128 at the serve shape).
#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 128;
constexpr int kTile = 32;     // cache positions per shared-memory tile
constexpr int kMaxAcc = 32;   // accumulator entries per thread: g*D <= 4096

// Where cache position `pos` of row `b` lives: the index of its [Kv, D]
// row in the K/V arrays (positions are rows of Kv*D values in both modes).
struct DenseRows {
  int C;  // cache positions per row
  __device__ __forceinline__ size_t row(int b, int pos) const {
    return (size_t)b * C + pos;
  }
};

struct PagedRows {
  const int* table;  // [B, n_blocks], < 0 = unallocated
  int n_blocks;
  int bs;  // positions per page
  __device__ __forceinline__ size_t row(int b, int pos) const {
    const int page = max(table[(size_t)b * n_blocks + pos / bs], 0);
    return (size_t)page * bs + pos % bs;
  }
};

template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, Rows rows, int H, int Kv,
                            int C, int D, float scale) {
  extern __shared__ float smem[];
  const int g = H / Kv;
  const int b = blockIdx.x / Kv;
  const int kvh = blockIdx.x % Kv;
  const int Dp = D + 1;  // padded K rows: conflict-free column reads
  size_t* row_s = reinterpret_cast<size_t*>(smem);  // [kTile] K/V rows
  float* ks = smem + 2 * kTile;    // [kTile][Dp]
  float* vs = ks + kTile * Dp;     // [kTile][D]
  float* qs = vs + kTile * D;      // [g][D], pre-scaled
  float* ps = qs + g * D;          // [g][kTile] scores, then probabilities
  float* m_s = ps + g * kTile;     // [g] running max
  float* l_s = m_s + g;            // [g] running sum
  float* corr_s = l_s + g;         // [g] rescale of this tile
  const int tid = threadIdx.x;

  int len = lengths[b];
  len = max(0, min(len, C));

  const T* qb = q + ((size_t)b * H + (size_t)kvh * g) * D;
  for (int i = tid; i < g * D; i += kThreads) qs[i] = to_f32(qb[i]) * scale;
  if (tid < g) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;
  const int n_acc = g * D;
  const size_t pos_stride = (size_t)Kv * D;
  const T* kb = k + (size_t)kvh * D;
  const T* vb = v + (size_t)kvh * D;
  __syncthreads();

  for (int start = 0; start < len; start += kTile) {
    const int n = min(kTile, len - start);
    if (tid < n) row_s[tid] = rows.row(b, start + tid);
    __syncthreads();
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      float kx = 0.f, vx = 0.f;
      if (j < n) {
        const size_t off = row_s[j] * pos_stride + d;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      ks[j * Dp + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < g * kTile; i += kThreads) {
      const int h = i / kTile;
      const int j = i - h * kTile;
      float s = -INFINITY;
      if (j < n) {
        const float* qr = qs + h * D;
        const float* kr = ks + j * Dp;
        s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      }
      ps[i] = s;
    }
    __syncthreads();

    if (tid < g) {
      // every tile holds n >= 1 live positions, so the new max is finite
      float* pr = ps + tid * kTile;
      const float m_old = m_s[tid];
      float mx = m_old;
      for (int j = 0; j < n; ++j) mx = fmaxf(mx, pr[j]);
      float sum = 0.f;
      for (int j = 0; j < kTile; ++j) {
        const float p = (j < n) ? expf(pr[j] - mx) : 0.f;
        pr[j] = p;
        sum += p;
      }
      const float c = expf(m_old - mx);  // 0 on the first tile
      corr_s[tid] = c;
      l_s[tid] = l_s[tid] * c + sum;
      m_s[tid] = mx;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int e = tid + r * kThreads;
      if (e < n_acc) {
        const int h = e / D;
        const int d = e - h * D;
        const float* pr = ps + h * kTile;
        float a = acc[r] * corr_s[h];
        for (int j = 0; j < n; ++j) a = fmaf(pr[j], vs[j * D + d], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * H + (size_t)kvh * g) * D;
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int e = tid + r * kThreads;
    if (e < n_acc) {
      const int h = e / D;
      ob[e] = from_f32<T>(acc[r] / fmaxf(l_s[h], 1e-30f));
    }
  }
}

template <typename T, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, Rows rows, int B, int H,
                   int Kv, int C, int D, cudaStream_t stream) {
  const int g = H / Kv;
  const size_t smem = sizeof(float) * (2 * (size_t)kTile +
                                       (size_t)kTile * (D + 1) +
                                       (size_t)kTile * D + (size_t)g * D +
                                       (size_t)g * kTile + 3 * (size_t)g);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, Rows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<T, Rows><<<B * Kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), rows, H, Kv,
      C, D, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

bool valid_heads(int B, int H, int Kv, int D) {
  if (B <= 0 || Kv <= 0 || H % Kv != 0 || D <= 0) return false;
  const int g = H / Kv;
  return g <= kThreads && g * D <= kThreads * kMaxAcc;
}

template <typename Rows>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* lengths, void* out, Rows rows, int B, int H, int Kv,
             int C, int D, void* stream) {
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, lens, out, rows, B, H, Kv, C, D, s);
  if (dtype == repro::kFloat32)
    return launch<float>(q, k, v, lens, out, rows, B, H, Kv, C, D, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,H,D]; k/v [B,C,Kv,D]; lengths int32 [B]; out [B,H,D]; all contiguous.
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int B, int H, int Kv, int C,
                                      int D, void* stream) {
  if (!valid_heads(B, H, Kv, D) || C < 0) return cudaErrorInvalidValue;
  return dispatch(dtype, q, k, v, lengths, out, DenseRows{C}, B, H, Kv, C, D,
                  stream);
}

// q [B,H,D]; k/v pages [P,bs,Kv,D]; lengths int32 [B]; table int32
// [B,n_blocks]; out [B,H,D]; all contiguous. Row b attends its first
// clamp(lengths[b], 0, n_blocks * bs) logical positions.
extern "C" int repro_decode_attention_paged(int dtype, const void* q,
                                            const void* k, const void* v,
                                            const void* lengths,
                                            const void* table, void* out,
                                            int B, int H, int Kv, int bs,
                                            int n_blocks, int D,
                                            void* stream) {
  if (!valid_heads(B, H, Kv, D) || bs <= 0 || n_blocks <= 0)
    return cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(table), n_blocks, bs};
  return dispatch(dtype, q, k, v, lengths, out, rows, B, H, Kv, n_blocks * bs,
                  D, stream);
}
