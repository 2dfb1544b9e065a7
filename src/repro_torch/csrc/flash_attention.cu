// GQA flash attention: causal for prefill, optional sliding window, or
// bidirectional (causal = 0) for an encoder.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
//           flash_attention_pallas (line 85, pallas_call at line 106).
//
// q [B,S,H,D]; k/v [B,S,Kv,D]; out [B,S,H,D]. Head h reads KV head h / g
// (g = H / Kv). Query row i attends key j when j <= i (if causal) and
// i - j < window (when a window is given); scores are scaled by 1/sqrt(D)
// and the softmax runs online in f32.
//
// What bounds it on the H100: a causal prefill does 2*2*B*H*D*S*(S+1)/2
// flops on 4*B*S*H*D values (Kv = H), about S/4 flops per bf16 byte: bytes
// below S ~ 1200, operations above (the ridge is ~295 flops/byte). The
// hybrid path's local attention (S=3000, window 2048, Kv=1, D=256) does
// 66 GFLOP on 25 MB: operations. At the qwen2-moe shape (B=2, S=1024)
// 8.6 GFLOP is ~10 us of tensor-core time, so launch and the tail of the
// last wave weigh as much as the products.
//
// bf16 (the serving path): a tensor-core kernel in the flash-attention-3
// structure, without warp specialisation. One block per (128-row query
// tile, head, batch row), two warpgroups of 64 query rows each; the
// heaviest (last) query tiles are scheduled first. Q is loaded once by
// TMA; K and V tiles of 64 keys come by TMA into a 2-stage shared-memory
// ring (128-byte swizzle; 64-byte at D=32), the next tile's load issued
// before the current tile's products. S = Q.K^T is a wgmma with both
// operands in shared memory (K is D-contiguous: K-major). The online
// softmax stays in registers (row max and sum across the 4 threads of a
// quad by shuffles, exp2 with the scale folded in), P is rounded to bf16
// in registers, as the reference rounds p to v's dtype, and is the
// register A operand of O += P.V (wgmma RS; V is D-contiguous: MN-major,
// read with the transpose bit). Work follows the mask: the KV loop stops
// at the tile's last query row and starts at the window's first visible
// key, and only the diagonal, window-edge and ragged tiles compute the
// mask; rows that see nothing keep the m == -inf guard and the final
// division keeps the l floor. At D=256 the O accumulator is 128 f32
// registers per thread; 64-key tiles keep S at 32 and P at 16 (197
// registers, no spill). At D <= 128 the kernel is held to 128 registers
// so two blocks share an SM: the qwen2-moe shape's 256 blocks then run
// in one wave, and its device time fell from 0.046 to 0.036 ms (H100
// 80GB HBM3, 700 W, chip_smoke.py's flash timing).
//
// f32: the SIMT kernel of the first port (scalar f32 FMA through shared
// memory), kept so the f32 parity checks hold the card to the CPU at 1e-4.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;


using repro::ceil_div;
using repro::from_f32;
using repro::to_f32;
using repro::warp_max;
using repro::warp_sum;

// ---------------------------------------------------------------------------
// f32: SIMT
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 32;   // key rows per shared-memory tile (one per lane)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int Kv, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) +
                       (size_t)kBK * D + (size_t)kBQ * (kBK + 1) + 3 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_simt_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(S, kBQ), H, B);
  flash_attention_simt_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, Kv, causal,
      window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

namespace sm90 = repro::sm90;

constexpr int kTcQ = 128;     // query rows per block (2 warpgroups x 64)
constexpr int kTcK = 64;      // keys per K/V tile
constexpr int kTcThreads = 256;

template <int D>
struct TcTile {
  static constexpr int kSwz = D >= 64 ? 128 : 64;     // bytes of a tile row
  static constexpr int kCE = kSwz / 2;                // elements per chunk
  static constexpr int kChunks = D / kCE;
  static constexpr uint32_t kLayout =
      kSwz == 128 ? sm90::kLayoutSW128 : sm90::kLayoutSW64;
  static constexpr uint32_t kQBytes = kTcQ * D * 2;
  static constexpr uint32_t kKVBytes = kTcK * D * 2;  // one K (or V) tile
  static constexpr size_t kSmem = kQBytes + 4 * kKVBytes + 1024 + 64;
};

// One thread: the K and V tiles `tile` (64 keys) into ring stage `stage`.
template <int D>
__device__ __forceinline__ void load_kv(uint8_t* kv, uint64_t* bar,
                                        const CUtensorMap* map_k,
                                        const CUtensorMap* map_v, int stage,
                                        int tile, int kvh, int b) {
  using T = TcTile<D>;
  uint8_t* ks = kv + 2 * stage * T::kKVBytes;
  uint8_t* vs = ks + T::kKVBytes;
  sm90::mbar_arrive_expect_tx(bar, 2 * T::kKVBytes);
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c) {
    sm90::tma_load_4d(ks + c * kTcK * T::kSwz, map_k, bar, c * T::kCE, kvh,
                      tile * kTcK, b);
    sm90::tma_load_4d(vs + c * kTcK * T::kSwz, map_v, bar, c * T::kCE, kvh,
                      tile * kTcK, b);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 128 ? 2 : 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 bf16* __restrict__ out, int S, int H, int Kv,
                                 int causal, int window, float scale_log2) {
  using T = TcTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kv = qs + T::kQBytes;    // stage s: K at 2*s, V at 2*s+1 tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv + 4 * T::kKVBytes);
  uint64_t* q_bar = bars;
  uint64_t* kv_bar = bars + 1;      // [2]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int tid = threadIdx.x;
  const int q_last = min(S, q0 + kTcQ) - 1;
  const int k_hi = causal ? q_last + 1 : S;             // exclusive
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kTcK;
  const int n_t = (k_hi + kTcK - 1) / kTcK - t_lo;

  if (tid == 0) {
    sm90::mbar_init(q_bar, 1);
    sm90::mbar_init(&kv_bar[0], 1);
    sm90::mbar_init(&kv_bar[1], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(q_bar, T::kQBytes);
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
      sm90::tma_load_4d(qs + c * kTcQ * T::kSwz, &map_q, q_bar, c * T::kCE, h,
                        q0, b);
    load_kv<D>(kv, &kv_bar[0], &map_k, &map_v, 0, t_lo, kvh, b);
  }

  const int wg = tid / 128;
  const int lane = tid % 32;
  // this thread's two rows of the accumulator fragments
  const int row_a = q0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int row_b = row_a + 8;
  const int cq = 2 * (lane % 4);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const uint8_t* q_wg = qs + wg * 64 * T::kSwz;

  sm90::mbar_wait(q_bar, 0);
  for (int j = 0; j < n_t; ++j) {
    const int tile = t_lo + j;
    const int st = j & 1;
    if (tid == 0 && j + 1 < n_t)
      load_kv<D>(kv, &kv_bar[st ^ 1], &map_k, &map_v, st ^ 1, tile + 1, kvh, b);
    sm90::mbar_wait(&kv_bar[st], (j >> 1) & 1);
    const uint8_t* ks = kv + 2 * st * T::kKVBytes;
    const uint8_t* vs = ks + T::kKVBytes;

    // S = Q K^T (64 x 64 per warpgroup), both operands K-major
    float s[kTcK / 2];
#pragma unroll
    for (int i = 0; i < kTcK / 2; ++i) s[i] = 0.f;
    sm90::fence_regs(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / (T::kCE / 16);
      const int w = kk % (T::kCE / 16);
      const uint64_t da = sm90::smem_desc(q_wg + c * kTcQ * T::kSwz + w * 32,
                                          16, 8 * T::kSwz, T::kLayout);
      const uint64_t db = sm90::smem_desc(ks + c * kTcK * T::kSwz + w * 32,
                                          16, 8 * T::kSwz, T::kLayout);
      sm90::wgmma_ss<kTcK, 0>(s, da, db, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // mask the diagonal, window-edge and ragged tiles
    const int k0 = tile * kTcK;
    const bool edge = (causal && k0 + kTcK - 1 > q0) ||
                      (window > 0 && q_last - k0 >= window) || k0 + kTcK > S;
    if (edge) {
#pragma unroll
      for (int i = 0; i < kTcK / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + cq + (i & 1);
        const int row = (i & 2) ? row_b : row_a;
        const bool ok = key < S && (!causal || key <= row) &&
                        (window <= 0 || row - key < window);
        if (!ok) s[i] = -INFINITY;
      }
    }

    // online softmax in base 2, the scale folded into the exponent
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < kTcK / 2; ++i) {
      if (i & 2) mx_b = fmaxf(mx_b, s[i]);
      else mx_a = fmaxf(mx_a, s[i]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * scale_log2);
    const float mn_b = fmaxf(m_b, mx_b * scale_log2);
    // a row that has seen nothing yet keeps p = 0 and its (zero) state
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float corr_a = exp2f(m_a - base_a);
    const float corr_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < kTcK / 2; ++i) {
      const float p = exp2f(fmaf(s[i], scale_log2, (i & 2) ? -base_b : -base_a));
      s[i] = p;
      if (i & 2) sum_b += p;
      else sum_a += p;
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? corr_b : corr_a;

    // P in bf16 as the A fragments of O += P V, 16 keys each
    uint32_t p16[kTcK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p16[kk][r] = sm90::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
    sm90::fence_regs(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
      const uint8_t* vk = vs + kk * 16 * T::kSwz;
      if constexpr (D <= 128) {
        const uint64_t db = sm90::smem_desc(vk, kTcK * T::kSwz, 8 * T::kSwz,
                                            T::kLayout);
        sm90::wgmma_rs<D, 1>(o, p16[kk], db, 1);
      } else {
        // D = 256: two 128-column halves (chunks 0-1 and 2-3)
#pragma unroll
        for (int half = 0; half < D / 128; ++half) {
          const uint64_t db = sm90::smem_desc(
              vk + half * 2 * kTcK * T::kSwz, kTcK * T::kSwz, 8 * T::kSwz,
              T::kLayout);
          sm90::wgmma_rs<128, 1>(o + half * 64, p16[kk], db, 1);
        }
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) sm90::fence_regs(p16[kk]);
    __syncthreads();  // every warpgroup is done with this stage
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f);
  const float den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= S) continue;
    const float den = half ? den_b : den_a;
    bf16* orow = out + (((size_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
          __floats2bfloat162_rn(o[i] / den, o[i + 1] / den);
    }
  }
}

// [B, S, heads, D] bf16, read in boxes of (chunk of D) x 1 head x rows
template <int D>
cudaError_t map4(CUtensorMap* map, const void* p, int B, int S, int heads,
                 int rows) {
  using T = TcTile<D>;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)S,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)heads * D * 2,
                               (uint64_t)S * heads * D * 2};
  const uint32_t box[4] = {(uint32_t)T::kCE, 1, (uint32_t)rows, 1};
  return sm90::make_map_bf16(map, 4, p, dims, strides, box, T::kSwz);
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int H, int Kv, int causal,
                         int window, cudaStream_t stream) {
  using T = TcTile<D>;
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = map4<D>(&mq, q, B, S, H, kTcQ)) != cudaSuccess) return err;
  if ((err = map4<D>(&mk, k, B, S, Kv, kTcK)) != cudaSuccess) return err;
  if ((err = map4<D>(&mv, v, B, S, Kv, kTcK)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(S, kTcQ), H, B);
  flash_attention_wgmma_kernel<D><<<grid, kTcThreads, T::kSmem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), S, H, Kv, causal, window,
      1.4426950408889634f / sqrtf((float)D));
  return cudaGetLastError();
}

cudaError_t dispatch_d(int dtype, const void* q, const void* k, const void* v,
                       void* out, int B, int S, int H, int Kv, int D,
                       int causal, int window, cudaStream_t s) {
  if (dtype == repro::kBFloat16) {
    switch (D) {
      case 32: return launch_wgmma<32>(q, k, v, out, B, S, H, Kv, causal, window, s);
      case 64: return launch_wgmma<64>(q, k, v, out, B, S, H, Kv, causal, window, s);
      case 128: return launch_wgmma<128>(q, k, v, out, B, S, H, Kv, causal, window, s);
      case 256: return launch_wgmma<256>(q, k, v, out, B, S, H, Kv, causal, window, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == repro::kFloat32) {
    switch (D) {
      case 32: return launch_simt<float, 32>(q, k, v, out, B, S, H, Kv, causal, window, s);
      case 64: return launch_simt<float, 64>(q, k, v, out, B, S, H, Kv, causal, window, s);
      case 128: return launch_simt<float, 128>(q, k, v, out, B, S, H, Kv, causal, window, s);
      case 256: return launch_simt<float, 256>(q, k, v, out, B, S, H, Kv, causal, window, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,S,H,D]; k/v [B,S,Kv,D]; out [B,S,H,D]; window <= 0 means none.
// bf16 runs the wgmma kernel, f32 the SIMT kernel.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int H, int Kv, int D, int causal,
                                     int window, void* stream) {
  if (B <= 0 || S <= 0 || Kv <= 0 || H % Kv != 0) return cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return cudaErrorInvalidValue;
  return dispatch_d(dtype, q, k, v, out, B, S, H, Kv, D, causal, window,
                    static_cast<cudaStream_t>(stream));
}
