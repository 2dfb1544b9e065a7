// Backward of the stabilised mLSTM recurrence (csrc/mlstm_scan.cu).
//
// The port's own kernels: the reference trains through a lax.scan of
// _mlstm_cell (src/repro/models/ssm.py:61-73), which jax.grad
// differentiates, and has no TPU kernel for this gradient. This computes
// the gradient of kernels/mlstm_scan/ref.py mlstm_scan_ref's function with
// respect to q, k, v, i, log_f, C0, n0 and m0; mlstm_scan_backward_ref in
// the same file is its plain version (its docstring has the step rules),
// and mlstm_scan_backward_chunkwise_ref mirrors the algebra below in
// plain PyTorch.
//
// The form: the backward of the chunkwise forward. S is cut into chunks
// of L steps (the last one ragged). Per (b, h) and chunk c over steps
// c0..e, with the forward's A_t = F_t - m_t and B_s = F_s - i_s (F the
// chunk's prefix sum of lf), g_t = exp(A_t + m_{c0-1}), w_{t,s} =
// exp(A_t - B_s) for s <= t (every factor <= 1), P = W * (Q K^T), dNum_t =
// dh_t / d_t, R = W * (dNum V^T), C_c the state entering chunk c and G_c
// the gradient that reaches the state leaving it (the last chunk's: dC):
//   C_{c+1} = g_e C_c + V^T diag(w_e) K   G_{c-1} = g_e G_c + dNum^T diag(g) Q
//   dQ = diag(g) dNum C_c + R K     dK = diag(w_e) V G_c + R^T Q
//   dV = diag(w_e) K G_c^T + P^T dNum               (G_{-1} = dC0)
// plus the n path's terms. The gate terms take no D^2 contraction per
// step: a_t = f'_t <dC_t~, C_{t-1}> is, within the chunk,
//   a_t = sum_{u>=t} g_u X_u + g_e Z + sum_{s<t} w_{e,s} Y_s
//         + sum_{u>=t, s<t} R[u,s] (q_u . k_s)
// with X_u = dNum_u^T C_c q_u and Y_s = v_s^T G_c k_s (row dots of the dQ
// and dV products before their diagonal scale) and Z = <G_c, C_c>, one D^2
// dot a chunk. (The recurrence a_t = a_{t+1} + dh_t . h_t - v_t . dv_t
// from <dC, C_S> is exact too, but subtracts the decayed seed from terms
// of its size; the sums above have weights <= 1 and cancel nothing.)
//
// What bounds it on the H100: tensor-core operations and the states.
// About 10 D^2 flops a step of each head go through products over D (two
// state passes, three gradient products) and 5 (L + 1) D through the
// lower-triangular [L x L] ones (kernel.backward_flops counts them;
// mlstm_scan_backward_work counts 12 D^2, the step-by-step form's), and
// the states C_c and G_c, D^2 f32 a chunk each, are written once and read
// back (2.5 GiB at xlstm-1.3b's train shape, B = 4, H = 4, S = 512, D =
// 1024, L = 64). Every product runs on the tensor cores in 3xTF32
// (mma.sync m16n8k8: each operand x split into hi, x with its low 13 bits
// cleared, and lo = x - hi, which the tensor cores read to its top 19
// bits; lo.hi' + hi.lo' + hi.hi' summed in f32; single-pass TF32 keeps
// about three digits, too few for the f32 tolerance). The splits'
// instructions weigh on the products as much as the tensor cores do
// (rounding both halves with cvt.rna was slower: PERF.md section 6).
// mma.sync takes its operands from registers, so any stored layout of a
// state serves (wgmma's tf32 operands must be K-major in shared memory,
// and the products contract over both axes of the states). The tensor
// cores sum with truncation: every product adds one 32-deep slice into
// zeroed registers and then into the f32 sum (rounded to nearest); summed
// straight through, the train shape missed the f32 tolerance (PERF.md
// section 6).
//
// Eight kernels, in order:
//   mlstm_bwd_record_kernel  one block per (b, h, chunk): the walk of m
//     from step 0 (one thread, the forward's order) writing m, f', i' for
//     the chunk's steps; Q K^T and dh V^T over D (3-deep cp.async ring);
//     then P, R, the prefix sums EC, g, w_e and g_e into the record.
//   the n path (n_t = f' n_{t-1} + i' k_t and its gradient), a two-level
//   scan: one block per (b, h, chunk, 128 columns), a thread per column,
//   32 steps' operands loaded into registers at a time and their dot
//   products summed across a warp at once:
//   mlstm_bwd_nfwd_kernel    n within the chunk from zero (kept), the
//     tile's shares of its n_t . q_t and of dh_t . h_t, the chunk's end;
//   mlstm_bwd_nfix_kernel    n entering the chunk (the chunk ends before
//     it walked from n0), and g_t (n_c . q_t) added to the shares;
//   mlstm_bwd_nrev_kernel    d_t and dnq_t; dn within the chunk from zero
//     in reverse: the n terms of dq (whole), dk, df' and di' (local), and
//     dn leaving the chunk at its start;
//   mlstm_bwd_ncarry_kernel  the dn entering the chunk from its end (the
//     later chunks' starts walked from dn), its share of dk, df' and di',
//     and dn0.
//   mlstm_bwd_state_kernel   one block per (b, h, 64 x 128 tile of the
//     state): the tile in registers, the chunks forward (writing C_c), then
//     in reverse (writing G_c, the tile's share of Z_c, and dC0); each
//     chunk's V or dh and K or Q rows double-buffered by cp.async.
//   mlstm_bwd_grad_kernel    one block per (b, h, chunk, 128 columns), all
//     chunks in parallel: the three products over D (dh C_c, V G_c, K G_c^T)
//     through a 3-deep cp.async ring of 32-deep slices, each then scaled
//     and given its [L x L] term from the record; dq and dk added to the
//     n terms, dv written; the tile's shares of X, Y and v . dv.
//   mlstm_bwd_gates_kernel   one block per (b, h): the shares summed, a_t
//     per step (float64), df' f' and di' i', then the reverse walk of m
//     (one thread): dlf, di, dm0.
// Each output entry and each partial is written by one thread, and every
// sum runs in a fixed order: two calls are bitwise equal.
// D <= 1024 with D % 4 == 0; any S >= 1; rows past S and rows and columns
// past D masked (zero-filled copies, masked stores).
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::ceil_div;
using repro::warp_sum;

constexpr int kMaxD = 1024;
// steps per chunk, L in the formulas (kernels/mlstm_scan BACKWARD_CHUNK;
// PERF.md section 6 has the times of L = 128 against 64)
constexpr int L = 64;
static_assert(L % 32 == 0, "warp tiles of 32 rows over 4 L threads");
constexpr int kPrepSteps = 32;     // steps of an n-path batch (a warp's lanes)
constexpr int kTileN = 128;        // columns of a state or gradient tile
constexpr int kStateRows = 64;     // rows of a state tile
constexpr int kStateThreads = 256;
constexpr int kKT = 32;            // depth of one staged slice of D
constexpr int kStages = 3;         // the gradient and record kernels' ring
// blocks an SM holds, registers capped to fit, for the state and gradient
// kernels (one block an SM was slower for both: PERF.md section 6)
constexpr int kMinBlocks = 2;
// shared-memory row lengths (floats), padded so the fragment loads of a
// warp hit 32 banks: a row read along k with the 8 row groups apart needs
// a length of 4 mod 32, one read across rows with the 4 k lanes apart 8
constexpr int kLdK = kKT + 4;          // [rows][32 deep]
constexpr int kLdN = kTileN + 8;       // [k][128 columns]
constexpr int kLdM = kStateRows + 8;   // [k][64 rows of the state]

// A chunk's record (floats): P [L][L] (P[u,s] = w_{u,s} q_u . k_s), R
// [L][L] (R[u,s] = w_{u,s} dh_u . v_s: over d_u where it is used), EC
// [L][L] (EC[u][tau] = sum_{s < tau} R[u,s] q_u . k_s), g [L], w_e [L],
// g_e and three zeros.
struct Rec {
  static constexpr int kP = 0, kR = L * L, kEC = 2 * L * L, kG = 3 * L * L,
                       kW = kG + L, kGE = kW + L, kSize = kGE + 4;
};

// ---------------------------------------------------------------------------
// 3xTF32 warp products (mma.sync.m16n8k8)
// ---------------------------------------------------------------------------

// hi = x with its low 13 bits cleared (one AND), lo = x - hi passed whole
// (the tensor cores read its top 19 bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  // not volatile: the compiler interleaves independent accumulators
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The warp's fragments: element (mi, ni, e) of acc is row m0 + 16 mi + gid
// + 8 (e >> 1), column n0 + 8 ni + 2 tig + (e & 1) (gid = lane / 4, tig =
// lane % 4).
template <int MI, int NI>
__device__ __forceinline__ void zero(float (&x)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][j][e] = 0.f;
}

template <int MI, int NI>
__device__ __forceinline__ void add(float (&acc)[MI][NI][4],
                                    const float (&p)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += p[i][j][e];
}

// acc += A B over k in [0, 8 KS): A(m, k) = A[m am + k ak], B(k, n) =
// B[k bk + n bn] (times bs[k] with kScale), for the warp's rows from m0
// and columns from n0, in 3xTF32: per 8-deep step every fragment is split
// first, then the three passes (lo.hi, hi.lo, hi.hi) each run over all
// of the warp's accumulators, which are independent.
template <int MI, int NI, int KS, bool kScale>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][4],
                                         const float* A, int am, int ak,
                                         const float* B, int bk, int bn,
                                         const float* bs, int m0, int n0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = 8 * ks + tig, k1 = k0 + 4;
    uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int r0 = m0 + 16 * mi + gid, r1 = r0 + 8;
      split(A[r0 * am + k0 * ak], ah[mi][0], al[mi][0]);
      split(A[r1 * am + k0 * ak], ah[mi][1], al[mi][1]);
      split(A[r0 * am + k1 * ak], ah[mi][2], al[mi][2]);
      split(A[r1 * am + k1 * ak], ah[mi][3], al[mi][3]);
    }
    float s0 = 1.f, s1 = 1.f;
    if (kScale) {
      s0 = bs[k0];
      s1 = bs[k1];
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int c = n0 + 8 * ni + gid;
      split(B[k0 * bk + c * bn] * s0, bh[ni][0], bl[ni][0]);
      split(B[k1 * bk + c * bn] * s1, bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], al[mi], bh[ni]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
  }
}

// acc += A B over k in [0, 32 NSEG), each 32-deep slice summed on its own
// first (the tensor cores truncate; the slices' sums round to nearest).
// The operands' k step between slices is 32 ak and 32 bk.
template <int MI, int NI, int NSEG, bool kScale>
__device__ __forceinline__ void block_mma(float (&acc)[MI][NI][4],
                                          const float* A, int am, int ak,
                                          const float* B, int bk, int bn,
                                          const float* bs, int m0, int n0) {
#pragma unroll 1
  for (int seg = 0; seg < NSEG; ++seg) {
    const float* as = A + 32 * seg * ak;
    const float* bsg = B + 32 * seg * bk;
    const float* ss = kScale ? bs + 32 * seg : bs;
    float part[MI][NI][4];
    zero(part);
    warp_mma<MI, NI, 4, kScale>(part, as, am, ak, bsg, bk, bn, ss, m0, n0);
    add(acc, part);
  }
}

// ---------------------------------------------------------------------------
// record: one block per (b, h, chunk), 4 L threads
// ---------------------------------------------------------------------------

struct RecSmem {
  static constexpr int kTile = L * kLdK;          // [L][36]
  static constexpr int kStage = 4 * kTile;        // Q, K, dh, V
  static constexpr int kRing = kStages * kStage;
  static constexpr int kMT = 2048;                // gate steps staged at once
  static_assert(2 * kMT <= kRing && L * (L + 1) <= kRing, "ring reuse");
  static constexpr int kFloats = kRing + 2 * L;   // + A_t, B_t
};

// gates [BH][4][S]: f', i', the weight of (lf + m_{t-1}) in dm_t (1, 0 or
// 0.5 on a tie), m_t, written for the chunk's steps after a walk of m from
// step 0 in the forward's order; then Q K^T and dh V^T over D, and the
// record.
__global__ void __launch_bounds__(4 * L)
    mlstm_bwd_record_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dh,
                            const float* __restrict__ ig,
                            const float* __restrict__ lf,
                            const float* __restrict__ m0,
                            float* __restrict__ gates,
                            float* __restrict__ rec, int S, int D,
                            int n_chunks) {
  using SM = RecSmem;
  constexpr int kThreads = 4 * L;
  constexpr int NI = L / 32;               // warp tile 32 x (L / 4)
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                      // [kStages][kStage]
  float* As = ring + SM::kRing;            // [L]
  float* Bs = As + L;                      // [L]
  __shared__ float mprev_s;

  const int c = blockIdx.x, bh = blockIdx.y;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mrow = 32 * (warp >> 2), ncol = (L / 4) * (warp & 3);
  const size_t seq = (size_t)bh * S;
  float* fp_s = gates + (size_t)bh * 4 * S;
  float* ip_s = fp_s + S;
  float* wa_s = ip_s + S;
  float* m_s = wa_s + S;

  // the walk of m from step 0 (one thread, the gates staged by the block)
  {
    float* gl = ring;
    float* gi = ring + SM::kMT;
    float m = m0[bh], F = 0.f;
    for (int base = 0; base < t0 + Lc; base += SM::kMT) {
      const int n = min(SM::kMT, t0 + Lc - base);
      __syncthreads();
      for (int u = tid; u < n; u += kThreads) {
        gl[u] = lf[seq + base + u];
        gi[u] = ig[seq + base + u];
      }
      __syncthreads();
      if (tid == 0) {
        int u = 0;
        for (; u < n && base + u < t0; ++u) m = fmaxf(gl[u] + m, gi[u]);
        if (base + u == t0) mprev_s = m;
        for (; u < n; ++u) {
          const int t = base + u;
          const float a = gl[u] + m, it = gi[u];
          const float m_new = fmaxf(a, it);
          F += gl[u];
          As[t - t0] = F - m_new;
          Bs[t - t0] = F - it;
          fp_s[t] = expf(gl[u] + m - m_new);
          ip_s[t] = expf(it - m_new);
          wa_s[t] = a > it ? 1.f : (a < it ? 0.f : 0.5f);
          m_s[t] = m_new;
          m = m_new;
        }
      }
    }
    __syncthreads();   // the ring is free for the products
  }

  auto issue = [&](int kt, int slot) {
    float* st = ring + slot * SM::kStage;
    const int d0 = kt * kKT;
    for (int e = tid; e < L * (kKT / 4); e += kThreads) {
      const int t = e / (kKT / 4), c4 = 4 * (e % (kKT / 4));
      const bool ok = t < Lc && d0 + c4 < D;
      const size_t off = ok ? (seq + t0 + t) * D + d0 + c4 : 0;
      const int n = ok ? 16 : 0;
      repro::cp_async16(st + t * kLdK + c4, q + off, n);
      repro::cp_async16(st + SM::kTile + t * kLdK + c4, k + off, n);
      repro::cp_async16(st + 2 * SM::kTile + t * kLdK + c4, dh + off, n);
      repro::cp_async16(st + 3 * SM::kTile + t * kLdK + c4, v + off, n);
    }
  };
  float qk[2][NI][4], dv[2][NI][4];
  zero(qk);
  zero(dv);
  const int nk = ceil_div(D, kKT);
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s, s);
    repro::cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    repro::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk)
      issue(kt + kStages - 1, (kt + kStages - 1) % kStages);
    repro::cp_async_commit();
    const float* st = ring + (kt % kStages) * SM::kStage;
    // Q K^T and dh V^T: B(k = d, n = s) = K[s][d]
    block_mma<2, NI, 1, false>(qk, st, kLdK, 1, st + SM::kTile, 1, kLdK,
                               nullptr, mrow, ncol);
    block_mma<2, NI, 1, false>(dv, st + 2 * SM::kTile, kLdK, 1,
                               st + 3 * SM::kTile, 1, kLdK, nullptr, mrow,
                               ncol);
  }
  repro::cp_async_wait<0>();
  __syncthreads();   // the ring is free: E goes there

  float* E = ring;   // [L][L + 1]: R[u,s] (q_u . k_s)
  float* out = rec + ((size_t)bh * n_chunks + c) * Rec::kSize;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int u = mrow + 16 * mi + gid + 8 * hh;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int s = ncol + 8 * ni + 2 * tig;
        float pv[2], rv[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float w =
              (s + x <= u && u < Lc) ? expf(As[u] - Bs[s + x]) : 0.f;
          pv[x] = w * qk[mi][ni][2 * hh + x];
          rv[x] = w * dv[mi][ni][2 * hh + x];
          E[u * (L + 1) + s + x] = rv[x] * qk[mi][ni][2 * hh + x];
        }
        *reinterpret_cast<float2*>(out + Rec::kP + u * L + s) =
            make_float2(pv[0], pv[1]);
        *reinterpret_cast<float2*>(out + Rec::kR + u * L + s) =
            make_float2(rv[0], rv[1]);
      }
    }
  __syncthreads();
  const float mprev = mprev_s;
  for (int t = tid; t < L; t += kThreads) {
    const bool ok = t < Lc;
    out[Rec::kG + t] = ok ? expf(As[t] + mprev) : 0.f;
    out[Rec::kW + t] = ok ? expf(As[Lc - 1] - Bs[t]) : 0.f;
    // EC[u][tau] = sum_{s < tau} E[u, s], row u = t
    float ec = 0.f;
    for (int tau = 0; tau < L; ++tau) {
      out[Rec::kEC + t * L + tau] = ec;
      if (tau < t) ec += E[t * (L + 1) + tau];
    }
  }
  if (tid < 4) out[Rec::kGE + tid] = tid == 0 ? expf(As[Lc - 1] + mprev) : 0.f;
}

// ---------------------------------------------------------------------------
// the n path: one block per (b, h, chunk, 128 columns), a thread per column
// ---------------------------------------------------------------------------

// parts [7][BH][ceil(D / 128)][S]: the column tiles' shares of X, Y, v .
// dv, the n terms of df' and di', n_t . q_t and dh_t . h_t.
__device__ __forceinline__ float* part_row(float* parts, int row, int BH,
                                           int n_jt, int bh, int j, int S) {
  return parts + (((size_t)row * BH + bh) * n_jt + j) * S;
}

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

// x[0, 32) in every lane of the warp -> lane l returns the warp's sum of
// x[l]: 31 shuffles for 32 sums
__device__ __forceinline__ float transpose_sum(float (&x)[32]) {
  const int lane = threadIdx.x & 31;
  halve<16>(x, lane & 16, 16);
  halve<8>(x, lane & 8, 8);
  halve<4>(x, lane & 4, 4);
  halve<2>(x, lane & 2, 2);
  halve<1>(x, lane & 1, 1);
  return x[0];
}

// The block's sum of slot c of x over its threads (columns), for c < nt
// (lane u of each warp takes slot u's warp sum, the warps summed in order).
__device__ __forceinline__ float batch_sum(float (&x)[kPrepSteps],
                                           float* red, int nt) {
  constexpr int kW = kTileN / 32;
  const int c = threadIdx.x, warp = c >> 5, lane = c & 31;
  red[lane * kW + warp] = transpose_sum(x);
  __syncthreads();
  float s = 0.f;
  if (c < nt)
    for (int w = 0; w < kW; ++w) s += red[c * kW + w];
  __syncthreads();
  return s;
}

// The n path runs as a two-level scan over the chunks: a block per
// (128 columns, chunk, b h) walks its chunk's steps alone, from a zero
// state (forward) or a zero gradient (reverse), a batch of 32 steps'
// operands loaded into registers before the walk through them; a second
// pass adds what enters the chunk, which each block forms by walking the
// chunk ends before it (one D-vector FMA a chunk). nvec [3][BH][NC][D]:
// the local n at each chunk's end, the n entering each chunk, the local dn
// leaving each chunk at its start.
__device__ __forceinline__ float* nvec_row(float* nvec, int row, int BH,
                                           int n_chunks, int bh, int c,
                                           int D) {
  return nvec + (((size_t)row * BH + bh) * n_chunks + c) * D;
}

struct NBlock {
  int j, c, bh, col, t0, Lc;
  bool live;
  size_t seq;
};

__device__ __forceinline__ NBlock n_block(int S, int D) {
  NBlock b;
  b.j = blockIdx.x;
  b.c = blockIdx.y;
  b.bh = blockIdx.z;
  b.col = b.j * kTileN + threadIdx.x;
  b.live = b.col < D;
  b.t0 = b.c * L;
  b.Lc = min(L, S - b.t0);
  b.seq = (size_t)b.bh * S;
  return b;
}

// n forward within the chunk from zero: the local n_t (kept), the tile's
// shares of local n_t . q_t and of dh_t . h_t, the local n at the end
__global__ void __launch_bounds__(kTileN)
    mlstm_bwd_nfwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ h,
                          const float* __restrict__ dh,
                          const float* __restrict__ gates,
                          float* __restrict__ nbuf, float* __restrict__ nvec,
                          float* __restrict__ parts, int BH, int S, int D,
                          int n_chunks) {
  constexpr int T = kPrepSteps;
  __shared__ float red[T * (kTileN / 32)], fps[T], ips[T];
  const NBlock b = n_block(S, D);
  const int n_jt = gridDim.x, c = threadIdx.x;
  const float* fp_s = gates + (size_t)b.bh * 4 * S;
  const float* ip_s = fp_s + S;
  float* nq_out = part_row(parts, 5, BH, n_jt, b.bh, b.j, S);
  float* hh_out = part_row(parts, 6, BH, n_jt, b.bh, b.j, S);
  float n = 0.f;
  for (int u0 = b.t0; u0 < b.t0 + b.Lc; u0 += T) {
    const int nt = min(T, b.t0 + b.Lc - u0);
    if (c < nt) {
      fps[c] = fp_s[u0 + c];
      ips[c] = ip_s[u0 + c];
    }
    float kv[T], qv[T], dv[T], hv[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const bool ok = b.live && u < nt;
      const size_t off = (b.seq + u0 + u) * D + b.col;
      kv[u] = ok ? k[off] : 0.f;
      qv[u] = ok ? q[off] : 0.f;
      dv[u] = ok ? dh[off] : 0.f;
      hv[u] = ok ? h[off] : 0.f;
    }
    __syncthreads();
    float pa[T], pb[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      if (u < nt) n = fps[u] * n + ips[u] * kv[u];
      if (b.live && u < nt) nbuf[(b.seq + u0 + u) * D + b.col] = n;
      pa[u] = n * qv[u];
      pb[u] = dv[u] * hv[u];
    }
    const float sa = batch_sum(pa, red, nt);
    const float sb = batch_sum(pb, red, nt);
    if (c < nt) {
      nq_out[u0 + c] = sa;
      hh_out[u0 + c] = sb;
    }
  }
  if (b.live) nvec_row(nvec, 0, BH, n_chunks, b.bh, b.c, D)[b.col] = n;
}

// The n entering the chunk, n_c = g_e n_{c-1} + (the local end of chunk
// c - 1) from n0, kept; the tile's shares of n_t . q_t completed with
// g_t (n_c . q_t)
__global__ void __launch_bounds__(kTileN)
    mlstm_bwd_nfix_kernel(const float* __restrict__ q,
                          const float* __restrict__ n0,
                          const float* __restrict__ rec,
                          float* __restrict__ nvec, float* __restrict__ parts,
                          int BH, int S, int D, int n_chunks) {
  constexpr int T = kPrepSteps;
  __shared__ float red[T * (kTileN / 32)], gs[L];
  const NBlock b = n_block(S, D);
  const int n_jt = gridDim.x, c = threadIdx.x;
  const float* rec_bh = rec + (size_t)b.bh * n_chunks * Rec::kSize;
  float n = b.live ? n0[(size_t)b.bh * D + b.col] : 0.f;
  for (int cc = 0; cc < b.c; ++cc) {
    const float ge = rec_bh[(size_t)cc * Rec::kSize + Rec::kGE];
    const float end =
        b.live ? nvec_row(nvec, 0, BH, n_chunks, b.bh, cc, D)[b.col] : 0.f;
    n = ge * n + end;
  }
  if (b.live) nvec_row(nvec, 1, BH, n_chunks, b.bh, b.c, D)[b.col] = n;
  for (int e = c; e < L; e += kTileN)
    gs[e] = rec_bh[(size_t)b.c * Rec::kSize + Rec::kG + e];
  __syncthreads();
  float* nq_out = part_row(parts, 5, BH, n_jt, b.bh, b.j, S);
  for (int u0 = b.t0; u0 < b.t0 + b.Lc; u0 += T) {
    const int nt = min(T, b.t0 + b.Lc - u0);
    float pa[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const bool ok = b.live && u < nt;
      const size_t off = (b.seq + u0 + u) * D + b.col;
      pa[u] = ok ? n * q[off] : 0.f;
    }
    const float sa = batch_sum(pa, red, nt);
    if (c < nt) nq_out[u0 + c] += gs[u0 - b.t0 + c] * sa;
  }
}

// dn reverse within the chunk from zero: d_t and dnq_t from the tiles'
// shares (the tile j = 0 writes 1 / d_t); the n terms of dq (whole), of dk
// and of df' and di' (local); the local dn leaving the chunk at its start
__global__ void __launch_bounds__(kTileN)
    mlstm_bwd_nrev_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ gates,
                          const float* __restrict__ rec,
                          const float* __restrict__ nbuf,
                          float* __restrict__ nvec, float* __restrict__ stats,
                          float* __restrict__ parts, float* __restrict__ dq,
                          float* __restrict__ dk, int BH, int S, int D,
                          int n_chunks) {
  constexpr int T = kPrepSteps;
  __shared__ float red[T * (kTileN / 32)], dnq_b[T], fps[T], ips[T];
  __shared__ float gs[L + 1];   // gs[tau + 1]: g at chunk step tau; gs[0] 1
  const NBlock b = n_block(S, D);
  const int n_jt = gridDim.x, c = threadIdx.x;
  const float* fp_s = gates + (size_t)b.bh * 4 * S;
  const float* ip_s = fp_s + S;
  float* inv_d = stats + (size_t)b.bh * 7 * S;
  const float* nq_in = part_row(parts, 5, BH, n_jt, b.bh, 0, S);
  const float* hh_in = part_row(parts, 6, BH, n_jt, b.bh, 0, S);
  float* sf_out = part_row(parts, 3, BH, n_jt, b.bh, b.j, S);
  float* si_out = part_row(parts, 4, BH, n_jt, b.bh, b.j, S);
  const float* rc = rec + ((size_t)b.bh * n_chunks + b.c) * Rec::kSize;
  for (int e = c; e <= L; e += kTileN)
    gs[e] = e == 0 ? 1.f : rc[Rec::kG + e - 1];
  const float n_c =
      b.live ? nvec_row(nvec, 1, BH, n_chunks, b.bh, b.c, D)[b.col] : 0.f;
  float dn = 0.f;
  for (int t1 = b.t0 + b.Lc - 1; t1 >= b.t0; t1 -= T) {
    const int nt = min(T, t1 - b.t0 + 1);
    // slot u holds step t1 - u
    if (c < nt) {
      const int t = t1 - c;
      float nq = 0.f, hh = 0.f;
      for (int jj = 0; jj < n_jt; ++jj) {
        nq += nq_in[(size_t)jj * S + t];
        hh += hh_in[(size_t)jj * S + t];
      }
      const float d = fmaxf(fabsf(nq), 1.f);
      const float sgn = nq > 0.f ? 1.f : (nq < 0.f ? -1.f : 0.f);
      dnq_b[c] = fabsf(nq) >= 1.f ? -hh / d * sgn : 0.f;
      fps[c] = fp_s[t];
      ips[c] = ip_s[t];
      if (b.j == 0) inv_d[t] = 1.f / d;
    }
    float qv[T], kv[T], nv[T], np[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const int t = t1 - u;
      const bool ok = b.live && u < nt;
      const size_t off = (b.seq + (ok ? t : b.t0)) * D + b.col;
      qv[u] = ok ? q[off] : 0.f;
      kv[u] = ok ? k[off] : 0.f;
      nv[u] = ok ? nbuf[off] : 0.f;
      np[u] = ok && t > b.t0 ? nbuf[off - D] : 0.f;
    }
    __syncthreads();
    float pa[T], pb[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const int tau = t1 - u - b.t0;
      const float dnq = dnq_b[u];
      const float dnt = dn + dnq * qv[u];
      // n_t and n_{t-1}: the local values plus what enters the chunk
      const float n_t = nv[u] + gs[tau + 1] * n_c;
      const float n_p = np[u] + gs[tau] * n_c;
      if (b.live && u < nt) {
        const size_t off = (b.seq + t1 - u) * D + b.col;
        dq[off] = dnq * n_t;
        dk[off] = ips[u] * dnt;
      }
      pa[u] = u < nt ? dnt * n_p : 0.f;
      pb[u] = u < nt ? dnt * kv[u] : 0.f;
      if (u < nt) dn = fps[u] * dnt;
    }
    const float sa = batch_sum(pa, red, nt);
    const float sb = batch_sum(pb, red, nt);
    if (c < nt) {
      sf_out[t1 - c] = sa;
      si_out[t1 - c] = sb;
    }
  }
  if (b.live) nvec_row(nvec, 2, BH, n_chunks, b.bh, b.c, D)[b.col] = dn;
}

// The dn leaving the chunk, dN_c, from dn_final and the later chunks'
// local starts (dN_{c-1} = local start of c + g_e dN_c), and what it adds
// inside the chunk: gamma_t dN_c to dn_t~ (gamma_t the product of f' over
// the chunk's steps after t), so w_{e,t} dN_c to dk_t and the tile's
// shares of gamma_t dN_c . n_{t-1} and gamma_t dN_c . k_t to the n terms of
// df' and di'; the chunk c = 0 writes dn0
__global__ void __launch_bounds__(kTileN)
    mlstm_bwd_ncarry_kernel(const float* __restrict__ k,
                            const float* __restrict__ dn_in,
                            const float* __restrict__ gates,
                            const float* __restrict__ rec,
                            const float* __restrict__ nbuf,
                            float* __restrict__ nvec,
                            float* __restrict__ parts, float* __restrict__ dk,
                            float* __restrict__ dn0, int BH, int S, int D,
                            int n_chunks) {
  constexpr int T = kPrepSteps;
  __shared__ float red[T * (kTileN / 32)], gam[L], gs[L + 1];
  const NBlock b = n_block(S, D);
  const int n_jt = gridDim.x, c = threadIdx.x;
  const float* fp_s = gates + (size_t)b.bh * 4 * S;
  const float* rec_bh = rec + (size_t)b.bh * n_chunks * Rec::kSize;
  const float* rc = rec_bh + (size_t)b.c * Rec::kSize;
  float dN = b.live ? dn_in[(size_t)b.bh * D + b.col] : 0.f;
  for (int cc = n_chunks - 1; cc > b.c; --cc) {
    const float ge = rec_bh[(size_t)cc * Rec::kSize + Rec::kGE];
    const float start =
        b.live ? nvec_row(nvec, 2, BH, n_chunks, b.bh, cc, D)[b.col] : 0.f;
    dN = start + ge * dN;
  }
  if (b.c == 0 && b.live)
    dn0[(size_t)b.bh * D + b.col] =
        nvec_row(nvec, 2, BH, n_chunks, b.bh, 0, D)[b.col] + rc[Rec::kGE] * dN;
  if (c == 0) {   // gamma_t, from the chunk's end back
    float gm = 1.f;
    for (int tau = b.Lc - 1; tau >= 0; --tau) {
      gam[tau] = gm;
      gm *= fp_s[b.t0 + tau];
    }
  }
  for (int e = c; e <= L; e += kTileN)
    gs[e] = e == 0 ? 1.f : rc[Rec::kG + e - 1];
  const float n_c =
      b.live ? nvec_row(nvec, 1, BH, n_chunks, b.bh, b.c, D)[b.col] : 0.f;
  float* sf_out = part_row(parts, 3, BH, n_jt, b.bh, b.j, S);
  float* si_out = part_row(parts, 4, BH, n_jt, b.bh, b.j, S);
  __syncthreads();
  for (int u0 = b.t0; u0 < b.t0 + b.Lc; u0 += T) {
    const int nt = min(T, b.t0 + b.Lc - u0);
    float pa[T], pb[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const int t = u0 + u, tau = t - b.t0;
      const bool ok = b.live && u < nt;
      const size_t off = (b.seq + (ok ? t : b.t0)) * D + b.col;
      const float kv = ok ? k[off] : 0.f;
      const float np = ok && t > b.t0 ? nbuf[off - D] : 0.f;
      const float g = ok ? gam[tau] * dN : 0.f;
      if (ok) dk[off] += rc[Rec::kW + tau] * dN;
      pa[u] = g * (np + gs[tau] * n_c);
      pb[u] = g * kv;
    }
    const float sa = batch_sum(pa, red, nt);
    const float sb = batch_sum(pb, red, nt);
    if (c < nt) {
      sf_out[u0 + c] += sa;
      si_out[u0 + c] += sb;
    }
  }
}

// ---------------------------------------------------------------------------
// state passes: one block per (b, h, 64 x 128 tile), 8 warps of 32 x 32
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kStateThreads, kMinBlocks)
    mlstm_bwd_state_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dh,
                           const float* __restrict__ rec,
                           const float* __restrict__ stats,
                           const float* __restrict__ C0,
                           const float* __restrict__ dC,
                           float* __restrict__ cst, float* __restrict__ gst,
                           float* __restrict__ zpart, float* __restrict__ dC0,
                           int S, int D, int n_chunks) {
  constexpr int kA = L * kLdM;      // [L][72]: V or dh over the tile's rows
  constexpr int kB = L * kLdN;      // [L][136]: K or Q over its columns
  constexpr int kBuf = kA + kB + L; // + the k scale (w_e or g / d)
  extern __shared__ __align__(16) float smem[];
  __shared__ float zred[kStateThreads / 32];

  const int tiles_c = ceil_div(D, kTileN);
  const int r0 = (blockIdx.x / tiles_c) * kStateRows;
  const int c0 = (blockIdx.x % tiles_c) * kTileN;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mrow = 32 * (warp >> 2), ncol = 32 * (warp & 3);
  const size_t DD = (size_t)D * D, seq = (size_t)bh * S;
  const float* rec_bh = rec + (size_t)bh * n_chunks * Rec::kSize;
  const float* inv_d = stats + (size_t)bh * 7 * S;

  float acc[2][4][4];
  // the thread's pairs: row r0 + mrow + 16 mi + gid + 8 hh, columns
  // c0 + ncol + 8 ni + 2 tig (+1); D % 4 == 0, so a pair is in or out whole
  auto each = [&](auto&& fn) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + mrow + 16 * mi + gid + 8 * hh;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = c0 + ncol + 8 * ni + 2 * tig;
          fn(mi, ni, hh, row < D && col < D, (size_t)row * D + col);
        }
      }
  };
  auto load = [&](const float* src) {
    each([&](int mi, int ni, int hh, bool ok, size_t off) {
      const float2 x = ok ? *reinterpret_cast<const float2*>(src + off)
                          : make_float2(0.f, 0.f);
      acc[mi][ni][2 * hh] = x.x;
      acc[mi][ni][2 * hh + 1] = x.y;
    });
  };
  auto store = [&](float* dst) {
    each([&](int mi, int ni, int hh, bool ok, size_t off) {
      if (ok)
        *reinterpret_cast<float2*>(dst + off) =
            make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
    });
  };
  // chunk ch's rows of xa over the tile's rows and of xb over its columns
  // into buffer ch & 1, with the k scale: w_e (forward) or g / d (reverse)
  auto stage = [&](int ch, const float* xa, const float* xb, bool fwd) {
    float* a = smem + (ch & 1) * kBuf;
    float* b = a + kA;
    const int t0 = ch * L;
    for (int e = tid; e < L * (kStateRows / 4); e += kStateThreads) {
      const int t = e / (kStateRows / 4), c4 = 4 * (e % (kStateRows / 4));
      const bool ok = t0 + t < S && r0 + c4 < D;
      repro::cp_async16(a + t * kLdM + c4,
                        ok ? xa + (seq + t0 + t) * D + r0 + c4 : xa,
                        ok ? 16 : 0);
    }
    for (int e = tid; e < L * (kTileN / 4); e += kStateThreads) {
      const int t = e / (kTileN / 4), c4 = 4 * (e % (kTileN / 4));
      const bool ok = t0 + t < S && c0 + c4 < D;
      repro::cp_async16(b + t * kLdN + c4,
                        ok ? xb + (seq + t0 + t) * D + c0 + c4 : xb,
                        ok ? 16 : 0);
    }
    const float* r = rec_bh + (size_t)ch * Rec::kSize;
    for (int e = tid; e < L; e += kStateThreads)
      b[kB + e] = fwd ? r[Rec::kW + e]
                      : (t0 + e < S ? r[Rec::kG + e] * inv_d[t0 + e] : 0.f);
  };
  // acc <- g_e acc + A^T diag(scale) B over chunk ch's staged rows
  auto step = [&](int ch) {
    const float* a = smem + (ch & 1) * kBuf;
    const float ge = rec_bh[(size_t)ch * Rec::kSize + Rec::kGE];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] *= ge;
    block_mma<2, 4, L / 32, true>(acc, a, 1, kLdM, a + kA, kLdN, 1,
                                  a + kA + kB, mrow, ncol);
  };

  // forward: C_c for every chunk (the final state is not needed)
  load(C0 + bh * DD);
  if (n_chunks > 1) stage(0, v, k, true);
  repro::cp_async_commit();
#pragma unroll 1
  for (int ch = 0; ch < n_chunks; ++ch) {
    store(cst + ((size_t)bh * n_chunks + ch) * DD);
    if (ch == n_chunks - 1) break;
    if (ch + 1 < n_chunks - 1) stage(ch + 1, v, k, true);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();
    __syncthreads();
    step(ch);
    __syncthreads();   // the buffer may be refilled next
  }

  // reverse: G_c for every chunk, the tile's share of Z_c, then dC0
  load(dC + bh * DD);
  stage(n_chunks - 1, dh, q, false);
  repro::cp_async_commit();
#pragma unroll 1
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const size_t at = ((size_t)bh * n_chunks + ch) * DD;
    store(gst + at);
    float z = 0.f;
    each([&](int mi, int ni, int hh, bool ok, size_t off) {
      if (ok) {   // this thread wrote these entries of C_c above
        const float2 x = *reinterpret_cast<const float2*>(cst + at + off);
        z = fmaf(acc[mi][ni][2 * hh], x.x, z);
        z = fmaf(acc[mi][ni][2 * hh + 1], x.y, z);
      }
    });
    z = warp_sum(z);
    if (lane == 0) zred[warp] = z;
    if (ch > 0) stage(ch - 1, dh, q, false);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();
    __syncthreads();
    if (tid == 0) {
      float zs = 0.f;
      for (int w = 0; w < kStateThreads / 32; ++w) zs += zred[w];
      zpart[((size_t)bh * n_chunks + ch) * gridDim.x + blockIdx.x] = zs;
    }
    step(ch);
    __syncthreads();
  }
  store(dC0 + bh * DD);
}

// ---------------------------------------------------------------------------
// gradients: one block per (b, h, chunk, 128 columns), 4 L threads
// ---------------------------------------------------------------------------

struct GradSmem {
  static constexpr int kAt = L * kLdK;                 // [L][36]
  static constexpr int kBt = kTileN * kLdK;  // [128][36] >= [32][136]
  static constexpr int kStage = kAt + kBt;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kSmall = L * (L + 4) + L * kLdN;  // matrix, rows
  static constexpr int kMain = kRing > kSmall ? kRing : kSmall;
  static constexpr int kFloats = kMain + 7 * L;   // + g, 1 / d, w_e, red[4][L]
};

__global__ void __launch_bounds__(4 * L, kMinBlocks)
    mlstm_bwd_grad_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dh,
                          const float* __restrict__ rec,
                          const float* __restrict__ stats,
                          const float* __restrict__ cst,
                          const float* __restrict__ gst,
                          float* __restrict__ dq, float* __restrict__ dk,
                          float* __restrict__ dv, float* __restrict__ parts,
                          int BH, int S, int D, int n_chunks) {
  using SM = GradSmem;
  constexpr int kThreads = 4 * L;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* gs = smem + SM::kMain;    // [L] g
  float* ids = gs + L;             // [L] 1 / d
  float* wes = ids + L;            // [L] w_e
  float* red = wes + L;            // [4][L]

  const int n_jt = ceil_div(D, kTileN);
  const int j = blockIdx.x % n_jt, c = blockIdx.x / n_jt, bh = blockIdx.y;
  const int col0 = j * kTileN, t0 = c * L, Lc = min(L, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wn = warp & 3;
  const int mrow = 32 * (warp >> 2), ncol = 32 * wn;
  const size_t seq = (size_t)bh * S;
  const size_t DD = (size_t)D * D;
  const size_t at = ((size_t)bh * n_chunks + c) * DD;
  const float* rc = rec + ((size_t)bh * n_chunks + c) * Rec::kSize;

  for (int e = tid; e < L; e += kThreads) {
    gs[e] = rc[Rec::kG + e];
    ids[e] = e < Lc ? stats[(size_t)bh * 7 * S + t0 + e] : 0.f;
    wes[e] = rc[Rec::kW + e];
  }

  float acc[2][4][4] = {};   // each product zeroes it; this quiets nvcc
  // the thread's pairs: chunk row mrow + 16 mi + gid + 8 hh, column col0 +
  // ncol + 8 ni + 2 tig (+1)
  auto each = [&](auto&& fn) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = mrow + 16 * mi + gid + 8 * hh;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = col0 + ncol + 8 * ni + 2 * tig;
          fn(mi, ni, hh, row, row < Lc && col < D,
             (seq + t0 + row) * D + col);
        }
      }
  };
  auto scale_rows = [&](const float* x) {
    each([&](int mi, int ni, int hh, int row, bool, size_t) {
      acc[mi][ni][2 * hh] *= x[row];
      acc[mi][ni][2 * hh + 1] *= x[row];
    });
  };

  // acc = X[L x D] S[D x 128] over D: S = st[:, cols] (``rows`` false) or
  // st[cols, :]^T (true)
  auto product = [&](const float* xa, const float* st, bool rows) {
    auto issue = [&](int kt, int slot) {
      float* a = ring + slot * SM::kStage;
      float* b = a + SM::kAt;
      const int d0 = kt * kKT;
      for (int e = tid; e < L * (kKT / 4); e += kThreads) {
        const int t = e / (kKT / 4), c4 = 4 * (e % (kKT / 4));
        const bool ok = t < Lc && d0 + c4 < D;
        repro::cp_async16(a + t * kLdK + c4,
                          ok ? xa + (seq + t0 + t) * D + d0 + c4 : xa,
                          ok ? 16 : 0);
      }
      if (!rows) {
        for (int e = tid; e < kKT * (kTileN / 4); e += kThreads) {
          const int kk = e / (kTileN / 4), c4 = 4 * (e % (kTileN / 4));
          const bool ok = d0 + kk < D && col0 + c4 < D;
          repro::cp_async16(b + kk * kLdN + c4,
                            ok ? st + (size_t)(d0 + kk) * D + col0 + c4 : st,
                            ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < kTileN * (kKT / 4); e += kThreads) {
          const int r = e / (kKT / 4), c4 = 4 * (e % (kKT / 4));
          const bool ok = col0 + r < D && d0 + c4 < D;
          repro::cp_async16(b + r * kLdK + c4,
                            ok ? st + (size_t)(col0 + r) * D + d0 + c4 : st,
                            ok ? 16 : 0);
        }
      }
    };
    zero(acc);
    const int nk = ceil_div(D, kKT);
#pragma unroll 1
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) issue(s, s);
      repro::cp_async_commit();
    }
#pragma unroll 1
    for (int kt = 0; kt < nk; ++kt) {
      repro::cp_async_wait<kStages - 2>();
      __syncthreads();
      if (kt + kStages - 1 < nk)
        issue(kt + kStages - 1, (kt + kStages - 1) % kStages);
      repro::cp_async_commit();
      const float* a = ring + (kt % kStages) * SM::kStage;
      const float* b = a + SM::kAt;
      if (!rows)
        block_mma<2, 4, 1, false>(acc, a, kLdK, 1, b, kLdN, 1, nullptr, mrow,
                                  ncol);
      else
        block_mma<2, 4, 1, false>(acc, a, kLdK, 1, b, 1, kLdK, nullptr, mrow,
                                  ncol);
    }
    repro::cp_async_wait<0>();
    __syncthreads();   // the ring is free
  };

  // acc += M diag(bs) xb[chunk rows, cols], M the record's matrix at
  // ``mat`` (its transpose with ``trans``), bs 1 / d or none
  auto finish = [&](int mat, bool trans, const float* xb, bool over_d) {
    float* m = ring;                    // [L][L + 4]
    float* b = ring + L * (L + 4);      // [L][136]
    for (int e = tid; e < L * L / 4; e += kThreads) {
      const int u = e / (L / 4), c4 = 4 * (e % (L / 4));
      repro::cp_async16(m + u * (L + 4) + c4, rc + mat + u * L + c4);
    }
    for (int e = tid; e < L * (kTileN / 4); e += kThreads) {
      const int t = e / (kTileN / 4), c4 = 4 * (e % (kTileN / 4));
      const bool ok = t < Lc && col0 + c4 < D;
      repro::cp_async16(b + t * kLdN + c4,
                        ok ? xb + (seq + t0 + t) * D + col0 + c4 : xb,
                        ok ? 16 : 0);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();
    if (!trans)
      block_mma<2, 4, L / 32, false>(acc, m, L + 4, 1, b, kLdN, 1, nullptr,
                                     mrow, ncol);
    else if (over_d)
      block_mma<2, 4, L / 32, true>(acc, m, 1, L + 4, b, kLdN, 1, ids, mrow,
                                    ncol);
    else
      block_mma<2, 4, L / 32, false>(acc, m, 1, L + 4, b, kLdN, 1, nullptr,
                                     mrow, ncol);
    __syncthreads();   // the ring is free
  };

  // out[t] = sum over the tile's columns of acc[t] . x[t] (fixed order)
  auto row_dot = [&](const float* x, int part) {
    float* out = part_row(parts, part, BH, n_jt, bh, j, S) + t0;
    float rs[2][2] = {};
    each([&](int mi, int ni, int hh, int, bool ok, size_t off) {
      if (ok) {
        const float2 xv = *reinterpret_cast<const float2*>(x + off);
        rs[mi][hh] = fmaf(acc[mi][ni][2 * hh], xv.x, rs[mi][hh]);
        rs[mi][hh] = fmaf(acc[mi][ni][2 * hh + 1], xv.y, rs[mi][hh]);
      }
    });
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float s = rs[mi][hh];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (tig == 0) red[wn * L + mrow + 16 * mi + gid + 8 * hh] = s;
      }
    __syncthreads();
    for (int t = tid; t < Lc; t += kThreads)
      out[t] = ((red[t] + red[L + t]) + red[2 * L + t]) + red[3 * L + t];
    __syncthreads();
  };

  auto write = [&](float* dst, bool accumulate) {
    each([&](int mi, int ni, int hh, int, bool ok, size_t off) {
      if (ok) {
        float2* p = reinterpret_cast<float2*>(dst + off);
        float2 o = accumulate ? *p : make_float2(0.f, 0.f);
        o.x += acc[mi][ni][2 * hh];
        o.y += acc[mi][ni][2 * hh + 1];
        *p = o;
      }
    });
  };

  // dq = the n term + diag(1 / d) (diag(g) dh C_c + R K); X from dh C_c
  product(dh, cst + at, false);
  row_dot(q, 0);
  scale_rows(gs);
  finish(Rec::kR, false, k, false);
  scale_rows(ids);
  write(dq, true);
  // dk = the n term + diag(w_e) V G_c + R^T diag(1 / d) Q
  product(v, gst + at, false);
  scale_rows(wes);
  finish(Rec::kR, true, q, true);
  write(dk, true);
  // dv = diag(w_e) K G_c^T + P^T diag(1 / d) dh; Y from K G_c^T, then v . dv
  product(k, gst + at, true);
  row_dot(v, 1);
  scale_rows(wes);
  finish(Rec::kP, true, dh, true);
  write(dv, false);
  row_dot(v, 2);
}

// ---------------------------------------------------------------------------
// gates: one block per (b, h)
// ---------------------------------------------------------------------------

// stats [BH][7][S]: 1 / d_t (mlstm_bwd_nrev_kernel), then df' f' and di'
// i', X, Y, v . dv and Z_c (this kernel's sums).
__global__ void mlstm_bwd_gates_kernel(const float* __restrict__ gates,
                                       float* __restrict__ stats,
                                       const float* __restrict__ rec,
                                       const float* __restrict__ parts,
                                       const float* __restrict__ zpart,
                                       const float* __restrict__ dm_in,
                                       float* __restrict__ di,
                                       float* __restrict__ dlf,
                                       float* __restrict__ dm0, int BH, int S,
                                       int D, int n_chunks,
                                       int n_tiles) {
  const int bh = blockIdx.x;
  const int n_jt = ceil_div(D, kTileN);
  const float* fp_s = gates + (size_t)bh * 4 * S;
  const float* ip_s = fp_s + S;
  const float* wa_s = ip_s + S;
  float* inv_d = stats + (size_t)bh * 7 * S;
  float* gf_s = inv_d + S;
  float* gi_s = gf_s + S;
  float* X = gi_s + S;
  float* Y = X + S;
  float* VD = Y + S;
  float* Z = VD + S;
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    float x = 0.f, y = 0.f, vd = 0.f, sf = 0.f, si = 0.f;
    for (int jj = 0; jj < n_jt; ++jj) {
      const size_t o = ((size_t)bh * n_jt + jj) * S + t;
      const size_t row = (size_t)BH * n_jt * S;
      x += parts[o];
      y += parts[row + o];
      vd += parts[2 * row + o];
      sf += parts[3 * row + o];
      si += parts[4 * row + o];
    }
    X[t] = x * inv_d[t];
    Y[t] = y;
    VD[t] = vd;
    gf_s[t] = sf * fp_s[t];
    gi_s[t] = vd + si * ip_s[t];
  }
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    double z = 0.0;
    for (int p = 0; p < n_tiles; ++p)
      z += zpart[((size_t)bh * n_chunks + c) * n_tiles + p];
    Z[c] = (float)z;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    const int c = t / L, u0 = c * L, e = min(u0 + L, S), tau = t - u0;
    const float* r = rec + ((size_t)bh * n_chunks + c) * Rec::kSize;
    double a = (double)r[Rec::kGE] * Z[c];
    for (int u = t; u < e; ++u)
      a += (double)r[Rec::kG + u - u0] * X[u] +
           (double)inv_d[u] * r[Rec::kEC + (u - u0) * L + tau];
    for (int s = u0; s < t; ++s) a += (double)r[Rec::kW + s - u0] * Y[s];
    gf_s[t] = (float)(a + (double)gf_s[t]);   // only this thread reads it
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const size_t seq = (size_t)bh * S;
  float carry = dm_in[bh];
  for (int t = S - 1; t >= 0; --t) {
    const float gf = gf_s[t], gi = gi_s[t];
    const float wa = wa_s[t];
    const float dmt = carry - gf - gi;
    dlf[seq + t] = gf + dmt * wa;
    di[seq + t] = gi + dmt * (1.f - wa);
    carry = gf + dmt * wa;
  }
  dm0[bh] = carry;
}

struct Ptrs {
  const float *q, *k, *v, *ig, *lf, *C0, *n0, *m0, *h, *dh, *dC, *dn, *dm;
  float *gates, *stats, *nbuf, *nvec, *rec, *cst, *gst, *parts, *zpart;
  float *dq, *dk, *dv, *di, *dlf, *dC0, *dn0, *dm0;
};

cudaError_t launch(const Ptrs& p, int BH, int S, int D, cudaStream_t s) {
  const int n_chunks = ceil_div(S, L);
  const int n_jt = ceil_div(D, kTileN);
  const int n_tiles = ceil_div(D, kStateRows) * n_jt;
  const int rec_smem = (int)sizeof(float) * RecSmem::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_record_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rec_smem);
  if (err != cudaSuccess) return err;
  mlstm_bwd_record_kernel<<<dim3(n_chunks, BH), 4 * L, rec_smem, s>>>(
      p.q, p.k, p.v, p.dh, p.ig, p.lf, p.m0, p.gates, p.rec, S, D, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 ngrid(n_jt, n_chunks, BH);
  mlstm_bwd_nfwd_kernel<<<ngrid, kTileN, 0, s>>>(
      p.q, p.k, p.h, p.dh, p.gates, p.nbuf, p.nvec, p.parts, BH, S, D,
      n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_nfix_kernel<<<ngrid, kTileN, 0, s>>>(
      p.q, p.n0, p.rec, p.nvec, p.parts, BH, S, D, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_nrev_kernel<<<ngrid, kTileN, 0, s>>>(
      p.q, p.k, p.gates, p.rec, p.nbuf, p.nvec, p.stats, p.parts, p.dq, p.dk,
      BH, S, D, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_ncarry_kernel<<<ngrid, kTileN, 0, s>>>(
      p.k, p.dn, p.gates, p.rec, p.nbuf, p.nvec, p.parts, p.dk, p.dn0, BH,
      S, D, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int state_smem =
      (int)sizeof(float) * 2 * (L * kLdM + L * kLdN + L);
  err = cudaFuncSetAttribute(mlstm_bwd_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             state_smem);
  if (err != cudaSuccess) return err;
  mlstm_bwd_state_kernel<<<dim3(n_tiles, BH), kStateThreads, state_smem,
                              s>>>(p.q, p.k, p.v, p.dh, p.rec, p.stats, p.C0,
                                   p.dC, p.cst, p.gst, p.zpart, p.dC0, S, D,
                                   n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int grad_smem = (int)sizeof(float) * GradSmem::kFloats;
  err = cudaFuncSetAttribute(mlstm_bwd_grad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             grad_smem);
  if (err != cudaSuccess) return err;
  mlstm_bwd_grad_kernel<<<dim3(n_jt * n_chunks, BH), 4 * L, grad_smem,
                             s>>>(p.q, p.k, p.v, p.dh, p.rec, p.stats, p.cst,
                                  p.gst, p.dq, p.dk, p.dv, p.parts, BH, S, D,
                                  n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  mlstm_bwd_gates_kernel<<<BH, 512, 0, s>>>(
      p.gates, p.stats, p.rec, p.parts, p.zpart, p.dm, p.di, p.dlf, p.dm0,
      BH, S, D, n_chunks, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// f32, contiguous. Inputs: q/k/v/h/dh [BH,S,D], ig/lf [BH,S], C0/dC
// [BH,D,D], n0/dn [BH,D], m0/dm [BH] (h the forward's output; dC, dn, dm
// the gradients of the final state). Scratch (kernels/mlstm_scan
// backward_scratch, NC = ceil(S / L), NJ = ceil(D / 128)): gates
// [BH,4,S], stats [BH,7,S], nbuf [BH,S,D], nvec [3,BH,NC,D], rec
// [BH,NC,3L^2+2L+4], cst and gst [BH,NC,D,D], parts [7,BH,NJ,S], zpart
// [BH,NC,ceil(D/64) NJ]. Outputs: dq/dk/dv [BH,S,D], di/dlf [BH,S], dC0
// [BH,D,D], dn0 [BH,D], dm0 [BH]. 16-byte aligned.
extern "C" int repro_mlstm_scan_backward(
    const void* q, const void* k, const void* v, const void* ig,
    const void* lf, const void* C0, const void* n0, const void* m0,
    const void* h, const void* dh, const void* dC, const void* dn,
    const void* dm, void* gates, void* stats, void* nbuf, void* nvec,
    void* rec, void* cst, void* gst, void* parts, void* zpart, void* dq,
    void* dk, void* dv, void* di, void* dlf, void* dC0, void* dn0,
    void* dm0, int BH, int S, int D, void* stream) {
  if (BH <= 0 || S <= 0 || D <= 0 || D > kMaxD || D % 4 != 0 || BH > 65535)
    return cudaErrorInvalidValue;
  const auto F = [](const void* x) { return static_cast<const float*>(x); };
  const auto W = [](void* x) { return static_cast<float*>(x); };
  const Ptrs p{F(q),     F(k),      F(v),     F(ig),    F(lf),    F(C0),
               F(n0),    F(m0),     F(h),     F(dh),    F(dC),    F(dn),
               F(dm),    W(gates),  W(stats), W(nbuf),  W(nvec),  W(rec),
               W(cst),   W(gst),    W(parts), W(zpart), W(dq),    W(dk),
               W(dv),    W(di),     W(dlf),   W(dC0),   W(dn0),   W(dm0)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(p, BH, S, D, s);
}
