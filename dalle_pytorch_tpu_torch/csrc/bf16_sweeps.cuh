// The bfloat16 attention sweeps on bf16 mma.sync.m16n8k16 tiles with
// float32 accumulation (mma_tiles.cuh), the bf16 counterparts of
// tf32_sweeps.cuh's fwd_sweep, dq_sweep and dkdv_sweep, over the same
// walks (tf32::VisitRow, tf32::VisitColumn, and the pair grid's HalfRow
// and HalfColumn, which do no float arithmetic). The tiled flash kernels'
// bf16 forward, dq, dk/dv and single-block backward (flash_attention.cu)
// and the pair grid's bf16 forward, dq and dk/dv
// (block_sparse_attention.cu) run them.
//
// fwd_sweep: a block of 4 warps owns one 64-row query tile of one head, Q
// resident (its A fragments in registers at d <= 64), and streams the
// 32-key halves of its row that `walk` visits through the dq sweep's
// 3-stage cp.async ring. S = Q.K^T accumulates in float32 C fragments,
// is scaled after the product and masked as the dq sweep masks it; the
// online softmax runs on the C fragments (the row max over the quad, corr
// = exp(m_prev - m_new) rescaling l and the O accumulators, p = exp(s -
// m) only where s > 0.5 * NEG_INF, else 0, l the thread's partial sum,
// reduced over the quad at the end); p is rounded to bf16 as it is packed
// into the A fragments of O += P.V (V read as B by ldmatrix.trans). o =
// acc / l (l = 1 where l == 0, so a row with no allowed key writes exactly
// 0 and lse -1e30), lse = m + log(l) in float32; o rounds to bf16 once,
// at the store.
//
// dq_sweep: a block of 4 warps owns one 64-row query tile of one head, Q
// and dO resident (warp w rows 16w .. 16w + 15; at d <= 64 their A
// fragments stay in registers across the sweep), and streams the 32-key
// halves of its row that `walk` visits through a 3-stage cp.async ring
// (two halves in flight behind the one computing, one barrier a half).
// S = Q.K^T and dP = dO.V^T accumulate in float32 C fragments; the score
// is scaled after the product and masked (a class 1 half: its pattern
// tile, fetched by cp.async with the half, or the causal rule; the key
// mask's bits on top); p = exp(s - lse) only where s > 0.5 * NEG_INF,
// else 0; ds = p * (dp - delta) * scale in float32 is rounded to bf16
// straight into the A fragments of dQ += dS.K (K read as B by
// ldmatrix.trans). delta = rowsum(o * do) in float32 from the stored bf16
// o and do (row_delta), written to delta_out when it is not NULL.
//
// dkdv_sweep: a block owns one 64-key tile of one head, K and V resident,
// and streams the 32-row query halves that `walk` visits, key-major:
// S^T = K.Q^T and dP^T = V.dO^T (Q and dO rows read as B without
// transposition), so that P^T rounded to bf16 feeds dV += P^T.dO and dS^T
// rounded to bf16 feeds dK += dS^T.Q from registers, through the same
// 3-stage ring. lse and delta ride in it, loaded when their half is
// issued and stored after the products; with DELTA_FROM_O delta is
// derived per half from O rows streamed with Q and dO, summed by the dq
// sweep's row_delta, so that it is the dq pass's delta bit for bit.
//
// Numerics: every product accumulates in float32 (the running sums over
// keys or queries straight in the accumulators); p and ds are rounded to
// bf16 exactly where the plain version rounds them (dp - delta stays
// float32; the forward's p against the running max, as JAX's kernel
// rounds it); o, dq, dk and dv round to bf16 once, at the store. No float
// atomics: two runs are bitwise equal. Rows at or past n load as 0
// (cp.async zero fill), their lse and delta are 0, and they are never
// written; a row with no allowed key, and a key no query attends, give
// exactly 0. A key tile whose keys the key mask drops entirely writes
// dk = dv = 0 without loading anything; a key half it drops entirely is
// passed over by the row sweeps (it would add p = 0).
//
// Element e of C n-block j is row (or key) 16w + g + 8 * (e / 2) and
// column 8j + 2t + e % 2 of the streamed half (lane = 4g + t); masks are
// indexed at those positions, and two n-blocks side by side are the A
// fragment over their 16 columns (tc::c_to_a).

#pragma once

#include "mma_tiles.cuh"
#include "tf32_sweeps.cuh"

namespace bf16s {

using tc::bf16;
using tc::ROWS;  // rows of a resident tile: 4 warps of 16
using tf32::SROWS;  // rows of a streamed half: keys, or queries

constexpr int KEEP_A_MAX_D = 64;  // resident A fragments held in registers up to this d
// Stages of the ring: two halves in flight behind the one computing, so
// that one barrier a half both publishes the landed half and frees the
// stage the next issue overwrites
constexpr int STAGES = 3;

__device__ __forceinline__ int next_stage(int st) { return st + 1 == STAGES ? 0 : st + 1; }

// One head's operands: rows of D bf16 channels (row r at r * D) of q, k,
// v, o, do and the gradients, lse and delta of the head's n rows, and the
// batch row's (n) key mask; a pointer that a sweep does not take may be
// NULL
struct Head {
  const bf16 *q, *k, *v, *o, *dout;
  const float *lse, *delta_in;
  const uint8_t* km;
  bf16 *dq, *dk, *dv;
  float* delta_out;
  int n;
  float scale;
  bf16* out;  // the forward's
  float* lse_out;
};

// rowsum(o * do) of one row of D bf16 channels in float32, as a warp sums
// it: lane l's partial over channels l, l + 32, .. by rounded FMAs (each
// product is exact in float32), then a butterfly of shuffles; the same
// value on every lane. Both sweeps call it, so a derived delta is the dq
// pass's bit for bit.
template <int D>
__device__ __forceinline__ float row_delta(const bf16* o, const bf16* dout) {
  const int lane = threadIdx.x % 32;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < D / 32; ++c)
    sum = __fmaf_rn(__bfloat162float(o[lane + 32 * c]), __bfloat162float(dout[lane + 32 * c]),
                    sum);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
  return sum;
}

// The A fragments of a warp's 16 rows (from row0) of a resident tile
// over its D channels (D / 16 k-steps): held in registers from hold() on
// at d <= KEEP_A_MAX_D, else read by ldmatrix at each use (the registers
// go to the accumulators).
template <int D>
struct ResidentA {
  static constexpr bool KEEP = D <= KEEP_A_MAX_D;
  const bf16* tile;
  int row0;
  uint32_t f[KEEP ? D / 16 : 1][4];

  __device__ ResidentA(const bf16* t, int r0) : tile(t), row0(r0) {}
  // once the tile has landed
  __device__ void hold() {
    if constexpr (KEEP) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) tc::load_a<D>(f[kk], tile, row0, 16 * kk);
    }
  }
  __device__ void get(uint32_t (&a)[4], int kk) const {
    if constexpr (KEEP) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = f[kk][i];
    } else {
      tc::load_a<D>(a, tile, row0, 16 * kk);
    }
  }
};

// A warp's 16 x D accumulator rows (row0 + r, C layout) rounded to bf16
// into its padded shared rows `tile`, then 16-byte stores to global rows
// row0 + r < n of a head (rows D elements apart)
template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 8][4], bf16* __restrict__ tile,
                                          bf16* __restrict__ dst, int row0, int n) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(tile + (g + 8 * i) * tc::stride<D>() + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
  __syncwarp();
  tc::store_rows<D>(dst, D, tile, row0, n);
}

// Bytes of dynamic shared memory of each sweep at dim_head d
constexpr int fwd_sweep_smem_bytes(int d, bool pattern) {
  // Q, STAGES stages of K and V (bf16 rows padded to d + 8), of key bits
  // (16 bytes) and of the (64, 32) pattern tile
  return 2 * (ROWS + 2 * STAGES * SROWS) * (d + 8) + 16 + (pattern ? STAGES * ROWS * SROWS : 0);
}

constexpr int dq_sweep_smem_bytes(int d, bool pattern) {
  // Q, dO, STAGES stages of K and V (bf16 rows padded to d + 8), of key
  // bits (16 bytes) and of the (64, 32) pattern tile
  return 2 * (2 * ROWS + 2 * STAGES * SROWS) * (d + 8) + 16 +
         (pattern ? STAGES * ROWS * SROWS : 0);
}

constexpr int dkdv_sweep_smem_bytes(int d, bool pattern, bool delta_from_o) {
  // K, V, STAGES stages of Q and dO (and of O when delta is derived), of
  // lse and delta and of the (32, 64) mask tile
  return 2 * (2 * ROWS + (delta_from_o ? 3 : 2) * STAGES * SROWS) * (d + 8) +
         4 * 2 * STAGES * SROWS + (pattern ? STAGES * SROWS * ROWS : 0);
}

// o and lse of query tile walk.q0 of a head over the key halves of
// `walk` whose keys the key mask keeps. The thread's rows are r0 = q0 +
// 16w + g and r0 + 8; m, l and o live in registers, l as the thread's
// part of the row sum (its quad's columns), reduced over the quad at the
// end.
template <int D, class Walk>
__device__ __forceinline__ void fwd_sweep(const Head& a, const Walk& walk,
                                          unsigned char* smem_raw) {
  constexpr int TE = tc::tile_elems<D>(), DS = tc::stride<D>(), TS = SROWS * DS;
  constexpr int PM = ROWS * SROWS;  // bytes of a mask tile
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (64, D + 8)
  bf16* ks = qs + TE;                            // STAGES stages of (32, D + 8)
  bf16* vs = ks + STAGES * TS;                   // STAGES stages of (32, D + 8)
  uint32_t* kbits = reinterpret_cast<uint32_t*>(vs + STAGES * TS);  // a word a stage (4)
  int8_t* pms = reinterpret_cast<int8_t*>(kbits + 4);              // stages of (64, 32)
  static_assert(STAGES <= 4, "the key bits take 16 bytes");

  const int n = a.n, q0 = walk.q0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint8_t* km = a.km;
  const int r0 = q0 + 16 * warp + g;  // the thread's rows r0, r0 + 8

  auto issue = [&](int h, int st) {
    const int k0 = h * SROWS;
    tc::load_tile_async<D, D + 8, SROWS>(ks + st * TS, a.k, D, k0, n);
    tc::load_tile_async<D, D + 8, SROWS>(vs + st * TS, a.v, D, k0, n);
    walk.fetch_mask(h, pms + st * PM);
  };

  float o[D / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // a half of masked keys adds p = 0 and leaves m, l and o as they are:
  // not loaded, nor is Q while every half so far was such a half. The
  // first two live halves go into stages 0 and 1, one commit group each.
  ResidentA<D> qa(qs, 16 * warp);
  bool resident = false;
  int h = walk.next(0, km, kbits), st = 0;
  if (walk.live(h)) {
    tc::load_tile_async<D>(qs, a.q, D, q0, n);
    issue(h, 0);
  }
  tc::cp_async_commit();
  int h1 = walk.live(h) ? walk.next(h + 1, km, kbits + 1) : h;
  if (walk.live(h1)) issue(h1, 1);
  tc::cp_async_commit();
  while (walk.live(h)) {
    // the group of half h has landed (h1's may be in flight); after the
    // barrier every warp is done with the stage read two halves ago, and
    // the live half after h1 goes into it
    tc::cp_async_wait<1>();
    __syncthreads();
    const int st2 = next_stage(next_stage(st));
    const int h2 = walk.live(h1) ? walk.next(h1 + 1, km, kbits + st2) : h1;
    if (walk.live(h2)) issue(h2, st2);
    tc::cp_async_commit();
    if (!resident) {  // Q landed with the first half
      qa.hold();
      resident = true;
    }
    const int k0 = h * SROWS, cls = walk.cls(h);
    const bf16* k_s = ks + st * TS;
    const bf16* v_s = vs + st * TS;

    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4];
      qa.get(qf, kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t kb[4];
        tc::load_b_rows<D>(kb, k_s, 16 * np, 16 * kk);
        tc::mma(s[2 * np], qf, kb[0], kb[1]);
        tc::mma(s[2 * np + 1], qf, kb[2], kb[3]);
      }
    }

    // scale and mask: element e of n-block j is row r0 + 8 * (e / 2), key
    // column c = 8j + 2t + e % 2 of the half
    const uint64_t bits = tc::key_bits<SROWS>(km != nullptr, kbits + st, k0, n);
    const bool need_mask = cls == 1 || bits != tc::all_keys<SROWS>();
    const bool use_pattern = walk.use_pattern(cls);
    const int8_t* pm_t = pms + st * PM;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
        bool ok = true;
        if (need_mask) {
          ok = ((bits >> c) & 1) != 0;
          if (cls == 1)
            ok = ok && (use_pattern ? pm_t[(row - q0) * SROWS + c] != 0 : row >= k0 + c);
        }
        s[j][e] = ok ? s[j][e] * a.scale : NEG_INF;
      }

    // online softmax over the quad's 32 columns of rows r0 and r0 + 8
    float mx[2] = {NEG_INF, NEG_INF}, m2[2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float corr = expf(m[r] - m_new);
      m[r] = m_new;
      m2[r] = m_new * tc::LOG2E;
      l[r] *= corr;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = s[j][e];
        const float p = sv > 0.5f * NEG_INF ? tc::exp_diff(sv, m2[e >> 1]) : 0.f;
        l[e >> 1] += p;
        s[j][e] = p;
      }

    // O += P.V over the half's 32 keys: p rounded to bf16 in the packing
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[4];
      tc::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t vb[4];
        tc::load_b_cols<D>(vb, v_s, 16 * kk, 16 * c);
        tc::mma(o[2 * c], pa, vb[0], vb[1]);
        tc::mma(o[2 * c + 1], pa, vb[2], vb[3]);
      }
    }
    h = h1;
    h1 = h2;
    st = next_stage(st);
  }

  // o / l (l = 1 where l == 0: a row with no allowed key writes exactly
  // 0, lse -1e30) rounded to bf16 into the warp's own rows of the Q tile
  // (every load has landed: the last wait left only empty groups in
  // flight), then 16-byte stores
  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l_safe[r] = l[r] == 0.f ? 1.f : l[r];
  }
  bf16* ow = qs + 16 * warp * DS;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(ow + (g + 8 * r) * DS + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * r] / l_safe[r], o[j][2 * r + 1] / l_safe[r]);
  __syncwarp();
  tc::store_rows<D>(a.out, D, ow, q0 + 16 * warp, n);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < n) a.lse_out[row] = m[r] + logf(l_safe[r]);
    }
  }
}

// dq of query tile walk.q0 of a head over the key halves of `walk` whose
// keys the key mask keeps. The thread's rows are r0 = q0 + 16w + g and
// r0 + 8.
template <int D, class Walk>
__device__ __forceinline__ void dq_sweep(const Head& a, const Walk& walk,
                                         unsigned char* smem_raw) {
  constexpr int TE = tc::tile_elems<D>(), TS = SROWS * tc::stride<D>();
  constexpr int PM = ROWS * SROWS;  // bytes of a mask tile
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (64, D + 8)
  bf16* dos = qs + TE;                           // (64, D + 8)
  bf16* ks = dos + TE;                           // STAGES stages of (32, D + 8)
  bf16* vs = ks + STAGES * TS;                   // STAGES stages of (32, D + 8)
  uint32_t* kbits = reinterpret_cast<uint32_t*>(vs + STAGES * TS);  // a word a stage (4)
  int8_t* pms = reinterpret_cast<int8_t*>(kbits + 4);              // stages of (64, 32)
  static_assert(STAGES <= 4, "the key bits take 16 bytes");

  const int n = a.n, q0 = walk.q0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint8_t* km = a.km;
  const int r0 = q0 + 16 * warp + g;  // the thread's rows r0, r0 + 8

  // delta of the warp's 16 rows (row_delta), written when delta_out is
  // given; delta and lse (times log2(e), for exp_diff) of the thread's
  // rows kept in registers. Rows at or past n are not read: their delta
  // and lse are 0.
  float lse_r[2], del_r[2];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int64_t row = q0 + 16 * warp + i;  // the same on every lane
    const float sum = row < n ? row_delta<D>(a.o + row * D, a.dout + row * D) : 0.f;
    if (lane == 0 && a.delta_out != nullptr && row < n) a.delta_out[row] = sum;
    if (g == (i & 7)) del_r[i >> 3] = sum;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) lse_r[i] = r0 + 8 * i < n ? a.lse[r0 + 8 * i] * tc::LOG2E : 0.f;

  auto issue = [&](int h, int st) {
    const int k0 = h * SROWS;
    tc::load_tile_async<D, D + 8, SROWS>(ks + st * TS, a.k, D, k0, n);
    tc::load_tile_async<D, D + 8, SROWS>(vs + st * TS, a.v, D, k0, n);
    walk.fetch_mask(h, pms + st * PM);
  };

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  // a half of masked keys adds p = 0: not loaded, nor are Q and dO while
  // every half so far was such a half. The first two live halves go into
  // stages 0 and 1, one commit group each.
  ResidentA<D> qa(qs, 16 * warp), da(dos, 16 * warp);
  bool resident = false;
  int h = walk.next(0, km, kbits), st = 0;
  if (walk.live(h)) {
    tc::load_tile_async<D>(qs, a.q, D, q0, n);
    tc::load_tile_async<D>(dos, a.dout, D, q0, n);
    issue(h, 0);
  }
  tc::cp_async_commit();
  int h1 = walk.live(h) ? walk.next(h + 1, km, kbits + 1) : h;
  if (walk.live(h1)) issue(h1, 1);
  tc::cp_async_commit();
  while (walk.live(h)) {
    // the group of half h has landed (h1's may be in flight); after the
    // barrier every warp is done with the stage read two halves ago, and
    // the live half after h1 goes into it
    tc::cp_async_wait<1>();
    __syncthreads();
    const int st2 = next_stage(next_stage(st));
    const int h2 = walk.live(h1) ? walk.next(h1 + 1, km, kbits + st2) : h1;
    if (walk.live(h2)) issue(h2, st2);
    tc::cp_async_commit();
    if (!resident) {  // Q and dO landed with the first half
      qa.hold();
      da.hold();
      resident = true;
    }
    const int k0 = h * SROWS, cls = walk.cls(h);
    const bf16* k_s = ks + st * TS;
    const bf16* v_s = vs + st * TS;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4], df[4];
      qa.get(qf, kk);
      da.get(df, kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t kb[4], vb[4];
        tc::load_b_rows<D>(kb, k_s, 16 * np, 16 * kk);
        tc::load_b_rows<D>(vb, v_s, 16 * np, 16 * kk);
        tc::mma(s[2 * np], qf, kb[0], kb[1]);
        tc::mma(s[2 * np + 1], qf, kb[2], kb[3]);
        tc::mma(dp[2 * np], df, vb[0], vb[1]);
        tc::mma(dp[2 * np + 1], df, vb[2], vb[3]);
      }
    }

    // ds into s: element e of n-block j is row r0 + 8 * (e / 2), key
    // column c = 8j + 2t + e % 2 of the half
    const uint64_t bits = tc::key_bits<SROWS>(km != nullptr, kbits + st, k0, n);
    const bool need_mask = cls == 1 || bits != tc::all_keys<SROWS>();
    const bool use_pattern = walk.use_pattern(cls);
    const int8_t* pm_t = pms + st * PM;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, row = r0 + 8 * i, c = 8 * j + 2 * t + (e & 1);
        bool ok = true;
        if (need_mask) {
          ok = ((bits >> c) & 1) != 0;
          if (cls == 1)
            ok = ok && (use_pattern ? pm_t[(row - q0) * SROWS + c] != 0 : row >= k0 + c);
        }
        const float sv = ok ? s[j][e] * a.scale : NEG_INF;
        const float p = sv > 0.5f * NEG_INF ? tc::exp_diff(sv, lse_r[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - del_r[i]) * a.scale;
      }

    // dQ += dS.K over the half's 32 keys: ds rounded to bf16 in the packing
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t dsa[4];
      tc::c_to_a(dsa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t kb[4];
        tc::load_b_cols<D>(kb, k_s, 16 * kk, 16 * c);
        tc::mma(dq[2 * c], dsa, kb[0], kb[1]);
        tc::mma(dq[2 * c + 1], dsa, kb[2], kb[3]);
      }
    }
    h = h1;
    h1 = h2;
    st = next_stage(st);
  }

  // the warp's own rows of the Q tile hold its dq (every load has landed:
  // the last wait left only empty groups in flight)
  store_acc<D>(dq, qs + 16 * warp * tc::stride<D>(), a.dq, q0 + 16 * warp, n);
}

// dk and dv of the 64-key tile at k0 of a head over the query halves of
// `walk`; delta from a.delta_in, or derived from O and dO (DELTA_FROM_O)
template <int D, bool DELTA_FROM_O, class Walk>
__device__ __forceinline__ void dkdv_sweep(const Head& a, const Walk& walk, int k0,
                                           unsigned char* smem_raw) {
  constexpr int TE = tc::tile_elems<D>(), DS = tc::stride<D>(), TS = SROWS * DS;
  constexpr int PM = SROWS * ROWS;  // bytes of a mask tile
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // (64, D + 8)
  bf16* vs = ks + TE;                            // (64, D + 8)
  bf16* qs = vs + TE;                            // STAGES stages of (32, D + 8)
  bf16* dos = qs + STAGES * TS;                  // STAGES stages of (32, D + 8)
  bf16* os = dos + STAGES * TS;  // STAGES stages of (32, D + 8) with DELTA_FROM_O
  float* lse_s = reinterpret_cast<float*>(os + (DELTA_FROM_O ? STAGES * TS : 0));  // of 32
  float* del_s = lse_s + STAGES * SROWS;                                         // of 32
  int8_t* pms = reinterpret_cast<int8_t*>(del_s + STAGES * SROWS);  // of (32, 64)
  __shared__ uint32_t kbits[2];

  const int n = a.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint8_t* km = a.km;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // a tile of masked keys has p = 0 for every query: dk = dv = 0
  if (km == nullptr || tc::tile_keys(km, k0, n, kbits)) {
    const uint64_t bits = tc::key_bits(km != nullptr, kbits, k0, n);
    const int key0 = 16 * warp + g;  // the thread's keys key0, key0 + 8 of the tile
    const bool kok[2] = {((bits >> key0) & 1) != 0, ((bits >> (key0 + 8)) & 1) != 0};
    auto issue = [&](int h, int st) {
      const int q0 = walk.q0(h);
      tc::load_tile_async<D, D + 8, SROWS>(qs + st * TS, a.q, D, q0, n);
      tc::load_tile_async<D, D + 8, SROWS>(dos + st * TS, a.dout, D, q0, n);
      if constexpr (DELTA_FROM_O)
        tc::load_tile_async<D, D + 8, SROWS>(os + st * TS, a.o, D, q0, n);
      walk.fetch_mask(h, pms + st * PM);
    };
    // lse (times log2(e), for exp_diff) of query q0 + r by threads r < 32,
    // delta (when read) by threads 32 + r: loaded when the half is issued,
    // stored after the products so that the load's latency hides behind
    // them
    const int r = threadIdx.x % SROWS;
    const bool stat_thread = threadIdx.x < (DELTA_FROM_O ? 1 : 2) * SROWS;
    auto row_stat = [&](int h) {
      const int row = walk.q0(h) + r;
      if (row >= n) return 0.f;
      return threadIdx.x < SROWS ? a.lse[row] * tc::LOG2E : a.delta_in[row];
    };
    float* stat_s = threadIdx.x < SROWS ? lse_s : del_s;

    // the first two live halves go into stages 0 and 1, one commit group
    // each, their row statistics stored at once
    ResidentA<D> ka(ks, 16 * warp), va(vs, 16 * warp);
    bool resident = false;
    int h = walk.first(pms);
    if (walk.live(h)) {
      tc::load_tile_async<D>(ks, a.k, D, k0, n);
      tc::load_tile_async<D>(vs, a.v, D, k0, n);
      issue(h, 0);
      if (stat_thread) stat_s[r] = row_stat(h);
    }
    tc::cp_async_commit();
    int h1 = walk.live(h) ? walk.next(h, pms + PM) : h;
    if (walk.live(h1)) {
      issue(h1, 1);
      if (stat_thread) stat_s[SROWS + r] = row_stat(h1);
    }
    tc::cp_async_commit();
    for (int st = 0; walk.live(h); st = next_stage(st)) {
      // the group of half h has landed (h1's may be in flight); after the
      // barrier every warp is done with the stage read two halves ago,
      // and the live half after h1 goes into it
      tc::cp_async_wait<1>();
      __syncthreads();
      const int st2 = next_stage(next_stage(st));
      const int h2 = walk.live(h1) ? walk.next(h1, pms + st2 * PM) : h1;
      const float stat2 = stat_thread && walk.live(h2) ? row_stat(h2) : 0.f;
      if (walk.live(h2)) issue(h2, st2);
      tc::cp_async_commit();
      if (!resident) {  // K and V landed with the first half
        ka.hold();
        va.hold();
        resident = true;
      }
      const int q0 = walk.q0(h), cls = walk.cls(h);
      const bf16* q_s = qs + st * TS;
      const bf16* do_s = dos + st * TS;
      if constexpr (DELTA_FROM_O) {
        // the half's delta from its O and dO rows, 8 rows a warp
        constexpr int RW = SROWS / tc::WARPS;
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const int row = RW * warp + i;
          const float sum = row_delta<D>(os + st * TS + row * DS, do_s + row * DS);
          if (lane == 0) del_s[st * SROWS + row] = sum;
        }
        __syncthreads();  // the half's delta is written
      }

      const bool need_mask = cls == 1 || bits != ~0ull;
      const bool use_pattern = walk.use_pattern(cls);
      const int8_t* pm_t = pms + st * PM;
      float sT[4][4], dpT[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4], vf[4];
        ka.get(kf, kk);
        va.get(vf, kk);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t qb[4], db[4];
          tc::load_b_rows<D>(qb, q_s, 16 * np, 16 * kk);
          tc::load_b_rows<D>(db, do_s, 16 * np, 16 * kk);
          tc::mma(sT[2 * np], kf, qb[0], qb[1]);
          tc::mma(sT[2 * np + 1], kf, qb[2], qb[3]);
          tc::mma(dpT[2 * np], vf, db[0], db[1]);
          tc::mma(dpT[2 * np + 1], vf, db[2], db[3]);
        }
      }

      // p^T into sT, ds^T into dpT: element e of n-block j is key key0 +
      // 8 * (e / 2), query column c = 8j + 2t + e % 2 of the half
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
          bool ok = true;
          if (need_mask) {
            ok = kok[e >> 1];
            if (cls == 1)
              ok = ok && (use_pattern ? pm_t[c * ROWS + key] != 0 : q0 + c >= k0 + key);
          }
          const float sv = ok ? sT[j][e] * a.scale : NEG_INF;
          const float p =
              sv > 0.5f * NEG_INF ? tc::exp_diff(sv, lse_s[st * SROWS + c]) : 0.f;
          sT[j][e] = p;
          dpT[j][e] = p * (dpT[j][e] - del_s[st * SROWS + c]) * a.scale;
        }

      // dV += P^T.dO and dK += dS^T.Q over the half's 32 queries: p and ds
      // rounded to bf16 in the packing
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4], da[4];
        tc::c_to_a(pa, sT[2 * kk], sT[2 * kk + 1]);
        tc::c_to_a(da, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          uint32_t db[4], qb[4];
          tc::load_b_cols<D>(db, do_s, 16 * kk, 16 * c);
          tc::load_b_cols<D>(qb, q_s, 16 * kk, 16 * c);
          tc::mma(dv[2 * c], pa, db[0], db[1]);
          tc::mma(dv[2 * c + 1], pa, db[2], db[3]);
          tc::mma(dk[2 * c], da, qb[0], qb[1]);
          tc::mma(dk[2 * c + 1], da, qb[2], qb[3]);
        }
      }
      if (stat_thread) stat_s[st2 * SROWS + r] = stat2;
      h = h1;
      h1 = h2;
    }
  }

  // each warp's own rows of the K and V tiles hold its dk and dv (tiles
  // that were loaded have landed: the last wait left only empty groups in
  // flight)
  store_acc<D>(dk, ks + 16 * warp * DS, a.dk, k0 + 16 * warp, n);
  store_acc<D>(dv, vs + 16 * warp * DS, a.dv, k0 + 16 * warp, n);
}

}  // namespace bf16s
