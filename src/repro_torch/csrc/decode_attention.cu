// Ragged single-token GQA decode attention over a dense KV cache.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py
//           decode_attention_pallas (line 203, pallas_call at line 243).
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
#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 128;
constexpr int kTile = 32;     // cache positions per shared-memory tile
constexpr int kMaxAcc = 32;   // accumulator entries per thread: g*D <= 4096

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, int H, int Kv, int C, int D,
                            float scale) {
  extern __shared__ float smem[];
  const int g = H / Kv;
  const int b = blockIdx.x / Kv;
  const int kvh = blockIdx.x % Kv;
  const int Dp = D + 1;  // padded K rows: conflict-free column reads
  float* ks = smem;                // [kTile][Dp]
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
  const T* kb = k + (size_t)b * C * pos_stride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * C * pos_stride + (size_t)kvh * D;
  __syncthreads();

  for (int start = 0; start < len; start += kTile) {
    const int n = min(kTile, len - start);
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      float kx = 0.f, vx = 0.f;
      if (j < n) {
        const size_t off = (size_t)(start + j) * pos_stride + d;
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int H, int Kv, int C,
                   int D, cudaStream_t stream) {
  const int g = H / Kv;
  const size_t smem = sizeof(float) * ((size_t)kTile * (D + 1) +
                                       (size_t)kTile * D + (size_t)g * D +
                                       (size_t)g * kTile + 3 * (size_t)g);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<T><<<B * Kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), H, Kv, C, D,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// q [B,H,D]; k/v [B,C,Kv,D]; lengths int32 [B]; out [B,H,D]; all contiguous.
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int B, int H, int Kv, int C,
                                      int D, void* stream) {
  if (B <= 0 || Kv <= 0 || H % Kv != 0 || D <= 0) return cudaErrorInvalidValue;
  const int g = H / Kv;
  if (g > kThreads || g * D > kThreads * kMaxAcc) return cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, lens, out, B, H, Kv, C, D, s);
  if (dtype == repro::kFloat32)
    return launch<float>(q, k, v, lens, out, B, H, Kv, C, D, s);
  return cudaErrorInvalidValue;
}
