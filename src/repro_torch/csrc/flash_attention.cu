// Causal GQA flash attention for prefill, optional sliding window.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
//           flash_attention_pallas (line 85, pallas_call at line 106).
//
// q [B,S,H,D]; k/v [B,S,Kv,D]; out [B,S,H,D]. Head h reads KV head h / g
// (g = H / Kv). Query row i attends key j when j <= i (causal) and
// i - j < window (when a window is given); scores are scaled by 1/sqrt(D)
// and the softmax runs online in f32.
//
// What bounds it on the H100: a causal prefill does 2*2*B*H*D*S*(S+1)/2
// flops on 4*B*S*H*D values (Kv = H), about S/4 flops per bf16 byte: bytes
// below S ~ 1200, operations above (the ridge is ~295 flops/byte). At the
// serving path's S <= 1024 the bound is bytes, but a SIMT kernel is far
// from either bound: its own limit is the f32 FMA rate of the SM cores.
//
// What the design does about it: one block per (64-row query tile, head,
// batch row) keeps its query tile, the current 32-row K/V tile and the tile's
// scores in shared memory, and the online-softmax state in f32 (m, l in
// shared memory, the 64 x D accumulator in registers, 32 values a thread at
// D=128). The KV loop is bounded by causality (it stops at the tile's last
// query row) and by the window (it starts at the first key any row can see),
// so the work follows the mask instead of the full S x S square; ragged tails
// of S are masked in place, so any S runs. The products are plain f32 FMA on
// the SIMT cores: wgmma on bf16 tiles is later work, and PERF.md records how
// far this kernel is from the tensor-core bound.
#include "common.cuh"

namespace {

using repro::ceil_div;
using repro::from_f32;
using repro::to_f32;
using repro::warp_max;
using repro::warp_sum;

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 32;   // key rows per shared-memory tile (one per lane)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int S, int H, int Kv, int causal, int window,
                           float scale) {
  extern __shared__ float smem[];
  constexpr int Dp = D + 1;        // padded K rows: conflict-free reads
  constexpr int Sp = kBK + 1;      // padded score rows
  constexpr int NE = kBQ * D / kThreads;  // accumulator values per thread
  float* qs = smem;                // [kBQ][D], pre-scaled
  float* ks = qs + kBQ * D;        // [kBK][Dp]
  float* vs = ks + kBK * Dp;       // [kBK][D]
  float* ss = vs + kBK * D;        // [kBQ][Sp] scores, then probabilities
  float* m_s = ss + kBQ * Sp;      // [kBQ] running max
  float* l_s = m_s + kBQ;          // [kBQ] running sum
  float* corr_s = l_s + kBQ;       // [kBQ] rescale of this tile

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int s = q0 + r;
    qs[i] = s < S ? to_f32(q[(((size_t)b * S + s) * H + h) * D + d]) * scale
                  : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[NE];
#pragma unroll
  for (int r = 0; r < NE; ++r) acc[r] = 0.f;

  const int q_last = min(S, q0 + kBQ) - 1;
  const int k_hi = causal ? q_last + 1 : S;             // exclusive
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  __syncthreads();

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const int s = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        const size_t off = (((size_t)b * S + s) * Kv + kvh) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j * Dp + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK;
      const int j = i - r * kBK;
      const int qp = q0 + r;
      const int kp = k0 + j;
      bool ok = qp < S && kp < S;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && (qp - kp) < window;
      float s = -INFINITY;
      if (ok) {
        const float* qr = qs + r * D;
        const float* kr = ks + j * Dp;
        s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      }
      ss[r * Sp + j] = s;
    }
    __syncthreads();

    // one warp per query row, one key per lane
    for (int r = warp; r < kBQ; r += kWarps) {
      float* sr = ss + r * Sp;
      const float x = sr[lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      float p, c;
      if (m_new == -INFINITY) {  // nothing visible to this row yet
        p = 0.f;
        c = 1.f;
      } else {
        p = expf(x - m_new);
        c = expf(m_old - m_new);
      }
      sr[lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * c + sum;
        corr_s[r] = c;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < NE; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / D;
      const int d = e - row * D;
      const float* pr = ss + row * Sp;
      float a = acc[r] * corr_s[row];
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) a = fmaf(pr[j], vs[j * D + d], a);
      acc[r] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < NE; ++r) {
    const int e = tid + r * kThreads;
    const int row = e / D;
    const int d = e - row * D;
    const int s = q0 + row;
    if (s < S)
      out[(((size_t)b * S + s) * H + h) * D + d] =
          from_f32<T>(acc[r] / fmaxf(l_s[row], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int Kv, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) +
                       (size_t)kBK * D + (size_t)kBQ * (kBK + 1) + 3 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(S, kBQ), H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, Kv, causal,
      window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       int B, int S, int H, int Kv, int D, int causal,
                       int window, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, Kv, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, Kv, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, Kv, causal, window, s);
    case 256: return launch<T, 256>(q, k, v, out, B, S, H, Kv, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,S,H,D]; k/v [B,S,Kv,D]; out [B,S,H,D]; window <= 0 means none.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int H, int Kv, int D, int causal,
                                     int window, void* stream) {
  if (B <= 0 || S <= 0 || Kv <= 0 || H % Kv != 0) return cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, H, Kv, D, causal,
                                     window, s);
  if (dtype == repro::kFloat32)
    return dispatch_d<float>(q, k, v, out, B, S, H, Kv, D, causal, window, s);
  return cudaErrorInvalidValue;
}
