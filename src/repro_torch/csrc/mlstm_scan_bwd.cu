// Backward of the stabilised mLSTM recurrence (csrc/mlstm_scan.cu).
//
// The port's own kernel: the reference trains through a lax.scan of
// _mlstm_cell (src/repro/models/ssm.py:61-73), which jax.grad
// differentiates, and has no TPU kernel for this gradient. This computes
// the gradient of kernels/mlstm_scan/ref.py mlstm_scan_ref's function with
// respect to q, k, v, i, log_f, C0, n0 and m0; mlstm_scan_backward_ref in
// the same file is its plain version, and its docstring has the formulas.
// The stabiliser m carries a gradient (where the clamp holds the
// denominator at 1, h scales with exp(-m)), so the gate gradients end in
// a reverse walk of m's max recurrence.
//
// What bounds it on the H100: f32 operations. The reverse walk touches
// every entry of the [D x D] state per step: recompute C_t, add
// (dh_t / d_t) q_t^T to dC, and the four contractions dq (C_t^T dnum),
// dk (dC^T v), dv (dC k) and df' (<dC, C_{t-1}>): about 12 D^2 flops per
// (b, h, t). At xlstm-1.3b's train shape (B = 4, H = 4, S = 512, D =
// 1024) that is 103 GFLOP, 1.5 ms at 67 TFLOP/s.
//
// What the design does about the state: one (b, h) state is D^2 f32, 4 MiB
// at D = 1024, so the states cannot be kept per step (2 GiB a head at S =
// 512), and a state cannot be stepped back (C_{t-1} = (C_t - i' v k^T) /
// f' loses every digit where f' is small). Five kernels, in order:
//   mlstm_bwd_prep_kernel   one block per (b, h), a thread per column:
//     m, f' and i' for every step (one thread, the forward's order); n_t
//     for every step (kept, D floats a step), n_t . q_t and dh_t . h_t,
//     so d_t and dnq_t; then dn in reverse: dn0, the n terms of dq and dk,
//     and of df' and di' per step.
//   mlstm_bwd_ckpt_kernel   one block per (b, h, 64 x 64 tile of C): the
//     forward recurrence from C0, writing the state that enters every
//     chunk of kT steps (S / kT states a head: 128 MiB at S = 512).
//   mlstm_bwd_tile_kernel   one block per (b, h, tile), chunks in reverse:
//     dC's tile in registers for the whole walk; within a chunk, each
//     step's C_{t-1} and C_t recomputed from the chunk's state (on average
//     kT / 2 forward steps a step, held in registers), then the tile's
//     share of dq, dk (over its rows), dv (over its columns), df' and di'
//     (over both): 4 x 4 entries a thread, reduced by shuffles and shared
//     atomics per step, written per chunk into partial buffers.
//   mlstm_bwd_sum_kernel    dq, dk and dv: the prep's n terms plus the
//     tiles' partials, float4 over [B, H, S, D].
//   mlstm_bwd_gates_kernel  one block per (b, h): df' and di' summed over
//     the tiles, then the reverse walk of m (one thread): dlf, di, dm0.
// The partials take 3 x (D / 64) x B H S D floats (1.5 GiB at the train
// shape above), freed with the call. The warps of a tile add their shares
// of dq, dk, df' and di' with shared-memory atomics, in no fixed order, so
// two calls can differ in the last bits.
// D <= 1024 with D % 4 == 0; any S >= 1; rows and columns past D masked.
#include "common.cuh"

namespace {

using repro::ceil_div;
using repro::warp_sum;

constexpr int kT = 16;          // steps per checkpoint (ops.py BACKWARD_CHUNK)
constexpr int kTile = 64;       // rows and columns of C per tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 entries each
constexpr int kMaxD = 1024;
constexpr int kPrepSteps = 32;  // steps whose dot products a prep pass holds

// ---------------------------------------------------------------------------
// prep
// ---------------------------------------------------------------------------

// gates [BH][3][S]: f', i', the weight of (lf + m_{t-1}) in dm_t (1, 0 or
// 0.5 on a tie); stats [BH][4][S]: 1 / d_t, dnq_t, then the n terms of df'
// and di' (mlstm_bwd_gates_kernel adds the tiles' terms in place).
__global__ void mlstm_bwd_prep_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ ig, const float* __restrict__ lf,
    const float* __restrict__ m0, const float* __restrict__ n0,
    const float* __restrict__ h, const float* __restrict__ dh,
    const float* __restrict__ dn_in, float* __restrict__ gates,
    float* __restrict__ stats, float* __restrict__ nbuf,
    float* __restrict__ dq, float* __restrict__ dk,
    float* __restrict__ dn0, int S, int D) {
  __shared__ float red_a[kPrepSteps][32], red_b[kPrepSteps][32];
  const int bh = blockIdx.x;
  const int c = threadIdx.x, warp = c >> 5, lane = c & 31;
  const int n_warps = blockDim.x >> 5;
  const bool live = c < D;
  const size_t seq = (size_t)bh * S;
  float* fp_s = gates + (size_t)bh * 3 * S;
  float* ip_s = fp_s + S;
  float* wa_s = ip_s + S;
  float* inv_d = stats + (size_t)bh * 4 * S;
  float* dnq_s = inv_d + S;
  float* sf_s = dnq_s + S;
  float* si_s = sf_s + S;

  if (c == 0) {   // the m walk, in the forward's order
    float m = m0[bh];
    for (int t = 0; t < S; ++t) {
      const float it = ig[seq + t], lft = lf[seq + t];
      const float a = lft + m;
      const float m_new = fmaxf(a, it);
      fp_s[t] = expf(lft + m - m_new);
      ip_s[t] = expf(it - m_new);
      wa_s[t] = a > it ? 1.f : (a < it ? 0.f : 0.5f);
      m = m_new;
    }
  }
  __syncthreads();

  // n forward: n_t kept; n_t . q_t and dh_t . h_t per step
  float n = live ? n0[(size_t)bh * D + c] : 0.f;
  for (int t0 = 0; t0 < S; t0 += kPrepSteps) {
    const int nt = min(kPrepSteps, S - t0);
    for (int u = 0; u < nt; ++u) {
      const size_t off = (seq + t0 + u) * D + c;
      float pa = 0.f, pb = 0.f;
      if (live) {
        n = fp_s[t0 + u] * n + ip_s[t0 + u] * k[off];
        nbuf[off] = n;
        pa = n * q[off];
        pb = dh[off] * h[off];
      }
      pa = warp_sum(pa);
      pb = warp_sum(pb);
      if (lane == 0) {
        red_a[u][warp] = pa;
        red_b[u][warp] = pb;
      }
    }
    __syncthreads();
    if (c < nt) {
      float nq = 0.f, hh = 0.f;
      for (int w = 0; w < n_warps; ++w) {
        nq += red_a[c][w];
        hh += red_b[c][w];
      }
      const float d = fmaxf(fabsf(nq), 1.f);
      const float sgn = nq > 0.f ? 1.f : (nq < 0.f ? -1.f : 0.f);
      inv_d[t0 + c] = 1.f / d;
      dnq_s[t0 + c] = fabsf(nq) >= 1.f ? -hh / d * sgn : 0.f;
    }
    __syncthreads();
  }

  // dn reverse: the n terms of dq, dk, df' and di'
  float dn = live ? dn_in[(size_t)bh * D + c] : 0.f;
  for (int t1 = S - 1; t1 >= 0; t1 -= kPrepSteps) {
    const int nt = min(kPrepSteps, t1 + 1);
    for (int u = 0; u < nt; ++u) {
      const int t = t1 - u;
      const size_t off = (seq + t) * D + c;
      float pa = 0.f, pb = 0.f;
      if (live) {
        const float dnq = dnq_s[t];
        const float kc = k[off];
        const float dnt = dn + dnq * q[off];
        const float nprev = t > 0 ? nbuf[off - D] : n0[(size_t)bh * D + c];
        dq[off] = dnq * nbuf[off];
        dk[off] = ip_s[t] * dnt;
        pa = dnt * nprev;
        pb = dnt * kc;
        dn = fp_s[t] * dnt;
      }
      pa = warp_sum(pa);
      pb = warp_sum(pb);
      if (lane == 0) {
        red_a[u][warp] = pa;
        red_b[u][warp] = pb;
      }
    }
    __syncthreads();
    if (c < nt) {
      float sf = 0.f, si = 0.f;
      for (int w = 0; w < n_warps; ++w) {
        sf += red_a[c][w];
        si += red_b[c][w];
      }
      sf_s[t1 - c] = sf;
      si_s[t1 - c] = si;
    }
    __syncthreads();
  }
  if (live) dn0[(size_t)bh * D + c] = dn;
}

// ---------------------------------------------------------------------------
// the tile kernels: thread (ty, tx) = (tid / 16, tid % 16) holds rows
// 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 of its block's tile
// ---------------------------------------------------------------------------

struct Tile {
  int bh, r0, c0;     // the tile's first row and column in C
  int rows, cols;     // this thread's first row and column
  bool live;          // its columns lie inside D (D % 4 == 0: all or none)
};

__device__ __forceinline__ Tile tile_of(int D) {
  const int tiles_c = ceil_div(D, kTile);
  Tile t;
  t.bh = blockIdx.y;
  t.r0 = (blockIdx.x / tiles_c) * kTile;
  t.c0 = (blockIdx.x % tiles_c) * kTile;
  t.rows = t.r0 + 4 * (threadIdx.x >> 4);
  t.cols = t.c0 + 4 * (threadIdx.x & 15);
  t.live = t.cols < D;
  return t;
}

__device__ __forceinline__ void load_tile(float (&x)[4][4],
                                          const float* __restrict__ src,
                                          const Tile& t, int D) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t.live && t.rows + i < D)
      v = *reinterpret_cast<const float4*>(src + (size_t)(t.rows + i) * D +
                                           t.cols);
    x[i][0] = v.x;
    x[i][1] = v.y;
    x[i][2] = v.z;
    x[i][3] = v.w;
  }
}

__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           const float (&x)[4][4],
                                           const Tile& t, int D) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (t.live && t.rows + i < D)
      *reinterpret_cast<float4*>(dst + (size_t)(t.rows + i) * D + t.cols) =
          make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
}

// One forward step on the thread's entries: C <- f' C + (i' v_r) k_c.
__device__ __forceinline__ void advance(float (&x)[4][4], float fp, float ip,
                                        const float* vr, const float* kc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float iv = ip * vr[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = fmaf(fp, x[i][j], iv * kc[j]);
  }
}

// Stage steps t0 .. t0 + kT - 1 (zeros past S) of a [BH, S, D] operand's
// 64 entries from ``first`` on into dst[kT][kTile], times ``scale[u]`` when
// given.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ x,
                                      size_t seq, int t0, int S, int first,
                                      int D, const float* scale = nullptr) {
  for (int e = threadIdx.x; e < kT * kTile; e += kThreads) {
    const int u = e / kTile, i = e % kTile;
    const int t = t0 + u, d = first + i;
    float val = 0.f;
    if (t < S && d < D) {
      val = x[(seq + t) * D + d];
      if (scale) val *= scale[u];
    }
    dst[e] = val;
  }
}

// ckpt [BH][n_ck][D][D]: the state entering step kT j (j = 0: C0).
__global__ void __launch_bounds__(kThreads)
    mlstm_bwd_ckpt_kernel(const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ gates,
                          const float* __restrict__ C0,
                          float* __restrict__ ckpt, int S, int D, int n_ck) {
  __shared__ __align__(16) float ks[kT * kTile];
  __shared__ __align__(16) float vs[kT * kTile];
  __shared__ float fps[kT], ips[kT];
  const Tile t = tile_of(D);
  const size_t DD = (size_t)D * D;
  const size_t seq = (size_t)t.bh * S;
  const float* fp_s = gates + (size_t)t.bh * 3 * S;
  const float* ip_s = fp_s + S;
  const int lr = t.rows - t.r0, lc = t.cols - t.c0;
  float c[4][4];
  load_tile(c, C0 + t.bh * DD, t, D);
  for (int j = 0; j < n_ck; ++j) {
    store_tile(ckpt + ((size_t)t.bh * n_ck + j) * DD, c, t, D);
    if (j == n_ck - 1) break;
    const int t0 = j * kT;   // a whole chunk: j < n_ck - 1
    __syncthreads();
    stage(ks, k, seq, t0, S, t.c0, D);
    stage(vs, v, seq, t0, S, t.r0, D);
    if (threadIdx.x < kT) {
      fps[threadIdx.x] = fp_s[t0 + threadIdx.x];
      ips[threadIdx.x] = ip_s[t0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll 4
    for (int u = 0; u < kT; ++u)
      advance(c, fps[u], ips[u], vs + u * kTile + lr, ks + u * kTile + lc);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    mlstm_bwd_tile_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dh,
                          const float* __restrict__ gates,
                          const float* __restrict__ stats,
                          const float* __restrict__ ckpt,
                          const float* __restrict__ dC_in,
                          float* __restrict__ dC0,
                          float* __restrict__ dq_part,
                          float* __restrict__ dk_part,
                          float* __restrict__ dv_part,
                          float* __restrict__ sf_part,
                          float* __restrict__ si_part, int BH, int S, int D,
                          int n_ck) {
  __shared__ __align__(16) float ks[kT * kTile];
  __shared__ __align__(16) float qs[kT * kTile];
  __shared__ __align__(16) float vs[kT * kTile];
  __shared__ __align__(16) float ds[kT * kTile];   // dh_t / d_t, rows
  __shared__ float dqs[kT * kTile], dks[kT * kTile], dvs[kT * kTile];
  __shared__ float fps[kT], ips[kT], invd[kT], sfs[kT], sis[kT];
  const Tile t = tile_of(D);
  const size_t DD = (size_t)D * D;
  const size_t seq = (size_t)t.bh * S;
  const size_t N = (size_t)BH * S * D;
  const int tr = t.r0 / kTile, tc = t.c0 / kTile;
  const int n_tiles = gridDim.x;
  const float* fp_s = gates + (size_t)t.bh * 3 * S;
  const float* ip_s = fp_s + S;
  const float* inv_d = stats + (size_t)t.bh * 4 * S;
  const int tid = threadIdx.x, lane = tid & 31;
  const int lr = t.rows - t.r0, lc = t.cols - t.c0;

  float dC[4][4];
  load_tile(dC, dC_in + t.bh * DD, t, D);
  for (int j = n_ck - 1; j >= 0; --j) {
    const int t0 = j * kT;
    const int nt = min(kT, S - t0);
    __syncthreads();   // the last chunk's partials are written out
    if (tid < kT) {
      const bool ok = t0 + tid < S;
      fps[tid] = ok ? fp_s[t0 + tid] : 0.f;
      ips[tid] = ok ? ip_s[t0 + tid] : 0.f;
      invd[tid] = ok ? inv_d[t0 + tid] : 0.f;
      sfs[tid] = 0.f;
      sis[tid] = 0.f;
    }
    for (int e = tid; e < kT * kTile; e += kThreads) {
      dqs[e] = 0.f;
      dks[e] = 0.f;
    }
    __syncthreads();
    stage(ks, k, seq, t0, S, t.c0, D);
    stage(qs, q, seq, t0, S, t.c0, D);
    stage(vs, v, seq, t0, S, t.r0, D);
    stage(ds, dh, seq, t0, S, t.r0, D, invd);
    float cs[4][4];
    load_tile(cs, ckpt + ((size_t)t.bh * n_ck + j) * DD, t, D);
    __syncthreads();

    for (int p = nt - 1; p >= 0; --p) {
      float cp[4][4];   // C_{t-1}
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) cp[i][jj] = cs[i][jj];
      for (int u = 0; u < p; ++u)
        advance(cp, fps[u], ips[u], vs + u * kTile + lr, ks + u * kTile + lc);
      const float* vr = vs + p * kTile + lr;
      const float* kc = ks + p * kTile + lc;
      const float* qc = qs + p * kTile + lc;
      const float* dr = ds + p * kTile + lr;
      const float fp = fps[p], ip = ips[p];
      float pq[4] = {}, pk[4] = {}, pv[4] = {};
      float sf = 0.f, si = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float iv = ip * vr[i];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float cur = fmaf(fp, cp[i][jj], iv * kc[jj]);   // C_t
          pq[jj] = fmaf(cur, dr[i], pq[jj]);
          const float g = fmaf(dr[i], qc[jj], dC[i][jj]);        // dC_t~
          pk[jj] = fmaf(g, vr[i], pk[jj]);
          pv[i] = fmaf(g, kc[jj], pv[i]);
          sf = fmaf(g, cp[i][jj], sf);
          dC[i][jj] = fp * g;
        }
        si = fmaf(vr[i], pv[i], si);
      }
      // dv: over the 16 threads of a row group (lanes of one half-warp)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 1; o < 16; o <<= 1)
          pv[i] += __shfl_xor_sync(0xffffffffu, pv[i], o);
      if ((tid & 15) == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i) dvs[p * kTile + lr + i] = ip * pv[i];
      // dq, dk: the warp's two row groups, then the warps (shared atomics)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        pq[jj] += __shfl_xor_sync(0xffffffffu, pq[jj], 16);
        pk[jj] += __shfl_xor_sync(0xffffffffu, pk[jj], 16);
      }
      if (lane < 16)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          atomicAdd(dqs + p * kTile + lc + jj, pq[jj]);
          atomicAdd(dks + p * kTile + lc + jj, pk[jj]);
        }
      sf = warp_sum(sf);
      si = warp_sum(si);
      if (lane == 0) {
        atomicAdd(sfs + p, sf);
        atomicAdd(sis + p, si);
      }
    }
    __syncthreads();
    // the chunk's partials: dq, dk of the tile's columns (over its rows),
    // dv of its rows (over its columns), df' and di' (over both)
    for (int e = tid; e < nt * kTile; e += kThreads) {
      const int u = e / kTile, i = e % kTile;
      const size_t step = seq + t0 + u;
      if (t.c0 + i < D) {
        dq_part[(size_t)tr * N + step * D + t.c0 + i] = dqs[e];
        dk_part[(size_t)tr * N + step * D + t.c0 + i] = ips[u] * dks[e];
      }
      if (t.r0 + i < D)
        dv_part[(size_t)tc * N + step * D + t.r0 + i] = dvs[e];
    }
    if (tid < nt) {
      const size_t at = ((size_t)t.bh * n_tiles + blockIdx.x) * S + t0 + tid;
      sf_part[at] = sfs[tid];
      si_part[at] = sis[tid];
    }
  }
  store_tile(dC0 + t.bh * DD, dC, t, D);
}

// dq += sum of the row tiles' partials, dk likewise, dv = the column
// tiles' (N = BH S D, a multiple of 4).
__global__ void mlstm_bwd_sum_kernel(const float4* __restrict__ dq_part,
                                     const float4* __restrict__ dk_part,
                                     const float4* __restrict__ dv_part,
                                     float4* __restrict__ dq,
                                     float4* __restrict__ dk,
                                     float4* __restrict__ dv, size_t N4,
                                     int n_parts) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < N4;
       e += (size_t)gridDim.x * blockDim.x) {
    float4 a = dq[e], b = dk[e], c = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < n_parts; ++p) {
      const float4 x = dq_part[p * N4 + e];
      const float4 y = dk_part[p * N4 + e];
      const float4 z = dv_part[p * N4 + e];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
      c.x += z.x; c.y += z.y; c.z += z.z; c.w += z.w;
    }
    dq[e] = a;
    dk[e] = b;
    dv[e] = c;
  }
}

// One block per (b, h): df'_t and di'_t over the tiles, then the reverse
// walk of m: dlf, di and dm0.
__global__ void mlstm_bwd_gates_kernel(const float* __restrict__ gates,
                                       float* __restrict__ stats,
                                       const float* __restrict__ sf_part,
                                       const float* __restrict__ si_part,
                                       const float* __restrict__ dm_in,
                                       float* __restrict__ di,
                                       float* __restrict__ dlf,
                                       float* __restrict__ dm0, int S,
                                       int n_tiles) {
  const int bh = blockIdx.x;
  const float* fp_s = gates + (size_t)bh * 3 * S;
  const float* ip_s = fp_s + S;
  const float* wa_s = ip_s + S;
  float* sf_s = stats + (size_t)bh * 4 * S + 2 * S;
  float* si_s = sf_s + S;
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    float sf = sf_s[t], si = si_s[t];
    for (int p = 0; p < n_tiles; ++p) {
      sf += sf_part[((size_t)bh * n_tiles + p) * S + t];
      si += si_part[((size_t)bh * n_tiles + p) * S + t];
    }
    sf_s[t] = sf;
    si_s[t] = si;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const size_t seq = (size_t)bh * S;
  float carry = dm_in[bh];
  for (int t = S - 1; t >= 0; --t) {
    const float gf = sf_s[t] * fp_s[t], gi = si_s[t] * ip_s[t];
    const float wa = wa_s[t];
    const float dmt = carry - gf - gi;
    dlf[seq + t] = gf + dmt * wa;
    di[seq + t] = gi + dmt * (1.f - wa);
    carry = gf + dmt * wa;
  }
  dm0[bh] = carry;
}

}  // namespace

// f32, contiguous. Inputs: q/k/v/h/dh [BH,S,D], ig/lf [BH,S], C0/dC
// [BH,D,D], n0/dn [BH,D], m0/dm [BH] (h the forward's output; dC, dn, dm
// the gradients of the final state). Scratch (kernels/mlstm_scan
// backward_scratch): gates [BH,3,S], stats [BH,4,S], nbuf [BH,S,D], ckpt
// [BH, ceil(S/kT), D, D], dq_part/dk_part/dv_part [ceil(D/64), BH, S, D],
// sf_part/si_part [BH, ceil(D/64)^2, S]. Outputs: dq/dk/dv [BH,S,D],
// di/dlf [BH,S], dC0 [BH,D,D], dn0 [BH,D], dm0 [BH]. 16-byte aligned.
extern "C" int repro_mlstm_scan_backward(
    const void* q, const void* k, const void* v, const void* ig,
    const void* lf, const void* C0, const void* n0, const void* m0,
    const void* h, const void* dh, const void* dC, const void* dn,
    const void* dm, void* gates, void* stats, void* nbuf, void* ckpt,
    void* dq_part, void* dk_part, void* dv_part, void* sf_part,
    void* si_part, void* dq, void* dk, void* dv, void* di, void* dlf,
    void* dC0, void* dn0, void* dm0, int BH, int S, int D, void* stream) {
  if (BH <= 0 || S <= 0 || D <= 0 || D > kMaxD || D % 4 != 0 ||
      BH > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto F = [](const void* p) { return static_cast<const float*>(p); };
  const auto W = [](void* p) { return static_cast<float*>(p); };
  const int n_ck = ceil_div(S, kT);
  const int tiles = ceil_div(D, kTile);
  const int threads = 32 * ceil_div(D, 32);
  mlstm_bwd_prep_kernel<<<BH, threads, 0, s>>>(
      F(q), F(k), F(ig), F(lf), F(m0), F(n0), F(h), F(dh), F(dn), W(gates),
      W(stats), W(nbuf), W(dq), W(dk), W(dn0), S, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles * tiles, BH);
  mlstm_bwd_ckpt_kernel<<<grid, kThreads, 0, s>>>(F(k), F(v), F(gates),
                                                  F(C0), W(ckpt), S, D, n_ck);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_tile_kernel<<<grid, kThreads, 0, s>>>(
      F(q), F(k), F(v), F(dh), F(gates), F(stats), F(ckpt), F(dC), W(dC0),
      W(dq_part), W(dk_part), W(dv_part), W(sf_part), W(si_part), BH, S, D,
      n_ck);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t N4 = (size_t)BH * S * D / 4;
  const size_t want = (N4 + 255) / 256;
  const int sum_blocks = (int)(want < 2048 ? want : 2048);
  mlstm_bwd_sum_kernel<<<sum_blocks, 256, 0, s>>>(
      static_cast<const float4*>(dq_part), static_cast<const float4*>(dk_part),
      static_cast<const float4*>(dv_part), static_cast<float4*>(dq),
      static_cast<float4*>(dk), static_cast<float4*>(dv), N4, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_gates_kernel<<<BH, 256, 0, s>>>(F(gates), W(stats), F(sf_part),
                                            F(si_part), F(dm), W(di), W(dlf),
                                            W(dm0), S, tiles * tiles);
  return cudaGetLastError();
}
