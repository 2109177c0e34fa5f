// The float32 attention sweeps on split-3xTF32 tensor-core tiles
// (tf32_tiles.cuh), shared by the tiled flash kernels (flash_attention.cu:
// forward, dq, dk/dv and the single-block backward) and the pair grid's
// float32 kernels (block_sparse_attention.cu: forward, dq and dk/dv).
//
// The row sweeps, fwd_sweep and dq_sweep: a block owns one 64-row query
// tile of one head, Q (and dO for dq) resident (warp w rows 16w .. 16w +
// 15), and streams the 32-key halves of its row that `walk` visits
// through a 2-stage cp.async ring, each half split once when it lands.
//  - fwd_sweep: S = Q.K^T, the online softmax on the score accumulators
//    (m, l and o in registers), O = O * corr + P.V folded per half
//    (fold_product); o = acc / l (l = 1 where l == 0, so a row with no
//    allowed key writes exactly 0, lse -1e30), lse = m + log(l).
//  - dq_sweep: S = Q.K^T and dP = dO.V^T, dQ += dS.K folded per half.
//    delta = rowsum(o * do) of its rows by row_delta, written to
//    delta_out when it is not NULL.
// Two row walks, each a half's class (1: the mask decides, 2: dense; a
// key mask applies on top) and where its mask tile comes from:
//  - VisitRow: a row of the tiled kernels' 64-tile visit map (half h of
//    the class of its 64-tile); a class 1 half applies its (64, 32) tile
//    of the (n, n) pattern, fetched by cp.async with the half, or the
//    causal rule without a pattern.
//  - HalfRow: a row of the pair grid's per-half class map (0: passed
//    over, ops/block_sparse_attention.py:half_classes); a class 1 half's
//    (64, 32) tile of the (n_pad, n_pad) int8 mask is fetched by cp.async
//    with the half, so an empty half costs neither a load nor a barrier.
// Either walk passes over a half whose keys the key mask drops entirely
// (tested a half, a barrier). Rows at or past n (a ragged last tile of
// the pair grid) load as 0, their lse and delta are 0, and they are never
// written; keys past n drop out by tc::key_bits.
//
// dkdv_sweep: a block owns one 64-key tile of one head, K and V resident,
// and walks the 32-row query halves that may attend it, key-major: S^T =
// K.Q^T and dP^T = V.dO^T, so that P^T and dS^T feed dV += P^T.dO and
// dK += dS^T.Q from registers, folded per half. Two policies:
//  - the walk: which query halves, in what order, each half's class and
//    where its mask tile comes from. VisitColumn: a column of the tiled
//    kernels' visit map, the pattern tile fetched by cp.async with the
//    half. PairRun: a k-major run of the pair grid's 128-block pairs,
//    each q block's four halves below n; class 0 pairs and halves whose
//    (32, 64) tile of the int8 mask is empty are passed over (they would
//    add p = 0), so the mask tile is loaded and tested before the half is
//    issued. HalfColumn: a key tile's row of the pair grid's k-major
//    per-half class map (ops/block_sparse_attention.py:half_columns),
//    empty halves passed over by a ballot on the map and a class 1
//    half's mask tile fetched by cp.async with the half, as HalfRow does
//    for the row sweeps.
// The walks do no float arithmetic: bf16_sweeps.cuh's sweeps take them
// as they are.
//  - the delta source (DELTA_FROM_O): read with lse from delta_in (the dq
//    pass's), or derived per half from O rows streamed with Q and dO (a
//    half ahead, in the same ring, so the load hides behind the previous
//    half's products) and summed by row_delta, as the dq sweep sums it, so
//    that a launch that derives it gives the dq pass's delta bit for bit.
// Rows at or past n load as 0 (cp.async zero fill, nothing read), their lse
// and delta as 0, and are never written; a key tile whose keys the key
// mask drops entirely writes dk = dv = 0 without loading anything.

#pragma once

#include "attention_tiles.cuh"
#include "tf32_tiles.cuh"

namespace tf32 {

// One head's operands: rows of D floats (row r at r * D) of q, k, v, o,
// do, the outputs and the gradients, lse and delta of the head's n rows,
// and the batch row's (n) key mask; a pointer that a sweep does not take
// may be NULL
struct Head {
  const float *q, *k, *v, *o, *dout;
  const float *lse, *delta_in;
  const uint8_t* km;
  float *dq, *dk, *dv, *delta_out;
  int n;
  float scale;
  float *out, *lse_out;  // the forward's
};

// The first half tile h in [from, end) that is visited (class v[(h >>
// SHIFT) * step] not 0: SHIFT 1 for a 64-tile map, 0 for a per-half map),
// or end: 32 candidates a warp at a time, the same answer on every warp
template <int SHIFT = 1>
__device__ __forceinline__ int first_visited(const int8_t* __restrict__ v, int64_t step,
                                             int from, int end) {
  const int lane = threadIdx.x % 32;
  for (; from < end; from += 32) {
    const int h = from + lane;
    const unsigned live = __ballot_sync(0xffffffffu, h < end && v[(h >> SHIFT) * step] != 0);
    if (live != 0) return from + __ffs(live) - 1;
  }
  return end;
}

// The first visited key half at or after h of a row map (`halves` of
// them, SHIFT as first_visited's) with a key the key mask keeps (its bits
// into kbits), or `halves`; a barrier with a key mask
template <int SHIFT>
__device__ __forceinline__ int next_live_half(const int8_t* __restrict__ row,
                                              const uint8_t* __restrict__ km, uint32_t* kbits,
                                              int h, int halves, int n) {
  for (;; ++h) {
    h = first_visited<SHIFT>(row, 1, h, halves);
    if (h >= halves || km == nullptr || tc::tile_keys<SROWS>(km, h * SROWS, n, kbits))
      return h;
  }
}

// The key halves of row vrow of the tiled kernels' (n / 64, n / 64) visit
// map, query tile q0: half h is keys 32h .., of the class of its 64-tile
struct VisitRow {
  const int8_t* vrow;
  const int8_t* pattern;  // (n, n) or NULL
  int n, q0;

  __device__ int halves() const { return 2 * (n / ROWS); }
  __device__ int next(int h, const uint8_t* km, uint32_t* kbits) const {
    return next_live_half<1>(vrow, km, kbits, h, halves(), n);
  }
  __device__ bool live(int h) const { return h < halves(); }
  __device__ int cls(int h) const { return vrow[h >> 1]; }
  __device__ bool use_pattern(int cls) const { return cls == 1 && pattern != nullptr; }
  __device__ void fetch_mask(int h, int8_t* pm) const {
    if (pattern != nullptr && cls(h) == 1)
      tc::load_mask_tile<ROWS, SROWS>(pm, pattern, q0, h * SROWS, n);
  }
};

// The key halves of row hrow of the pair grid's (n_pad / 64, n_pad / 32)
// class map, query tile q0: half h is keys 32h .. of class hrow[h]; a
// class 1 half's (64, 32) tile of the (n_pad, n_pad) mask is fetched by
// cp.async with the half (rows n_pad bytes apart)
struct HalfRow {
  const int8_t* hrow;
  const int8_t* mask;
  int n, n_pad, q0;

  __device__ int next(int h, const uint8_t* km, uint32_t* kbits) const {
    return next_live_half<0>(hrow, km, kbits, h, n_pad / SROWS, n);
  }
  __device__ bool live(int h) const { return h < n_pad / SROWS; }
  __device__ int cls(int h) const { return hrow[h]; }
  __device__ bool use_pattern(int cls) const { return cls == 1; }
  __device__ void fetch_mask(int h, int8_t* pm) const {
    if (cls(h) == 1) tc::load_mask_tile<ROWS, SROWS>(pm, mask, q0, h * SROWS, n_pad);
  }
};

// rowsum(o * do) of one row of D channels in float32, as a warp sums it:
// lane l's partial over channels l, l + 32, .. by rounded FMAs, then a
// butterfly of shuffles; the same value on every lane. Both sweeps call
// it, so a derived delta is the dq pass's bit for bit.
template <int D>
__device__ __forceinline__ float row_delta(const float* o, const float* dout) {
  const int lane = threadIdx.x % 32;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < D / 32; ++c) sum = __fmaf_rn(o[lane + 32 * c], dout[lane + 32 * c], sum);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
  return sum;
}

// Bytes of dynamic shared memory of each sweep at dim_head d
constexpr int fwd_sweep_smem_bytes(int d, bool pattern) {
  // Q, two stages of K and V, the small parts of one K and V tile, two
  // stages of key bits (16 bytes), two of the (64, 32) pattern tile
  return 4 * (ROWS * (d + 4) + 6 * SROWS * (d + 4)) + 16 + (pattern ? 2 * ROWS * SROWS : 0);
}

constexpr int dq_sweep_smem_bytes(int d, bool pattern) {
  // Q, dO, two stages of K and V, the small parts of one K and V tile,
  // two stages of key bits (16 bytes), two of the (64, 32) pattern tile
  return 4 * (2 * ROWS * (d + 4) + 6 * SROWS * (d + 4)) + 16 + (pattern ? 2 * ROWS * SROWS : 0);
}

constexpr int dkdv_sweep_smem_bytes(int d, bool pattern, bool delta_from_o) {
  // K, V, two stages of Q and dO (and of O when delta is derived), the
  // small parts of one Q and dO tile, two stages of lse and delta, two of
  // the (32, 64) mask tile
  return 4 * (2 * ROWS * (d + 4) + (delta_from_o ? 8 : 6) * SROWS * (d + 4) + 4 * SROWS) +
         (pattern ? 2 * SROWS * ROWS : 0);
}

// o and lse of query tile walk.q0 of a head over the key halves of
// `walk`: S = Q.K^T and O = O * corr + P.V on the tensor cores. The
// thread's rows are r0 = q0 + 16w + g and r0 + 8; m, l and o live in
// registers, l as the thread's part of the row sum (its quad's columns),
// reduced over the quad at the end.
template <int D, class Walk>
__device__ __forceinline__ void fwd_sweep(const Head& a, const Walk& walk,
                                          unsigned char* smem_raw) {
  constexpr int TF = tile_floats<D>(), TS = tile_floats<D, SROWS>(), DS = stride<D>();
  constexpr int PM = ROWS * SROWS;  // bytes of a mask tile
  float* qs = reinterpret_cast<float*>(smem_raw);  // (64, D + 4)
  float* ks = qs + TF;                             // 2 stages of (32, D + 4)
  float* vs = ks + 2 * TS;                         // 2 stages of (32, D + 4)
  float* k_lo = vs + 2 * TS;                       // the small parts of the current K tile
  float* v_lo = k_lo + TS;                         // ... and of its V tile
  uint32_t* kbits = reinterpret_cast<uint32_t*>(v_lo + TS);  // 2 stages of 1 word (+ 2)
  int8_t* pms = reinterpret_cast<int8_t*>(kbits + 4);         // 2 stages of (64, 32)

  const int n = a.n, q0 = walk.q0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint8_t* km = a.km;
  const int r0 = q0 + 16 * warp + g;

  auto issue = [&](int h, int st) {
    const int k0 = h * SROWS;
    load_tile_async<D, SROWS>(ks + st * TS, a.k, D, k0, n);
    load_tile_async<D, SROWS>(vs + st * TS, a.v, D, k0, n);
    walk.fetch_mask(h, pms + st * PM);
  };

  float o[D / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // a half of masked keys adds p = 0 and leaves m, l and o as they are:
  // not loaded, nor is q while every half so far was such a half
  int h = walk.next(0, km, kbits), st = 0;
  if (walk.live(h)) {
    load_tile_async<D>(qs, a.q, D, q0, n);
    issue(h, 0);
  }
  tc::cp_async_commit();
  while (walk.live(h)) {
    // the next live half is in flight while this one computes
    const int nxt = walk.next(h + 1, km, kbits + (st ^ 1));
    if (walk.live(nxt)) issue(nxt, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int k0 = h * SROWS, cls = walk.cls(h);
    float* k_s = ks + st * TS;
    float* v_s = vs + st * TS;
    split_tiles<D, SROWS>(k_s, k_lo, v_s, v_lo, 0, n, nullptr, nullptr);
    __syncthreads();  // the tiles are split, once for every warp

    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      FragA qa;
      load_a<D>(qa, qs, 16 * warp, 8 * kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        FragB kb[2];
        load_b_rows<D>(kb, k_s, k_lo, 16 * np, 8 * kk);
        mma3(s[2 * np], qa, kb[0]);
        mma3(s[2 * np + 1], qa, kb[1]);
      }
    }

    // scale and mask: element e of n-block j is row r0 + 8 * (e / 2), key
    // column 8j + 2t + e % 2 of the half
    const uint64_t bits = tc::key_bits<SROWS>(km != nullptr, kbits + st, k0, n);
    const bool need_mask = cls == 1 || bits != tc::all_keys<SROWS>();
    const bool use_pattern = walk.use_pattern(cls);
    const int8_t* pm_t = pms + st * PM;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[j][e] * a.scale;
        if (need_mask) {
          const int row = r0 + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
          bool ok = ((bits >> c) & 1) != 0;
          if (cls == 1)
            ok = ok && (use_pattern ? pm_t[(row - q0) * SROWS + c] != 0 : row >= k0 + c);
          if (!ok) v = NEG_INF;
        }
        s[j][e] = v;
      }

    // online softmax over the quad's 32 columns of rows r0 and r0 + 8
    float mx[2] = {NEG_INF, NEG_INF}, corr[2], m2[2];
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
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      m2[r] = m_new * tc::LOG2E;
      l[r] *= corr[r];
    }
    FragA pa[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = s[j][e];
        const float p = sv > 0.5f * NEG_INF ? tc::exp_diff(sv, m2[e >> 1]) : 0.f;
        l[e >> 1] += p;
        s[j][e] = p;
      }
      c_to_a(pa[j], s[j]);
    }

    // O = O * corr + P.V over the half's 32 keys: a fresh partial folded
    // in by rounded FMAs (the sum runs over up to n keys)
    fold_product<D>(o, pa, v_s, v_lo, corr);
    __syncthreads();  // stage st is no longer read
    h = nxt;
    st ^= 1;
  }

  // o / l (l = 1 where l == 0: a row with no allowed key writes exactly
  // 0, lse -1e30) into the warp's own rows of the q tile, then 16-byte
  // stores
  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l_safe[r] = l[r] == 0.f ? 1.f : l[r];
  }
  float* ow = qs + 16 * warp * DS;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(ow + (g + 8 * r) * DS + 8 * j + 2 * t) =
          make_float2(o[j][2 * r] / l_safe[r], o[j][2 * r + 1] / l_safe[r]);
  __syncwarp();
  store_rows<D>(a.out, D, ow, q0 + 16 * warp, n);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < n) a.lse_out[row] = m[r] + logf(l_safe[r]);
    }
  }
}

// dq of query tile walk.q0 of a head over the key halves of `walk` whose
// keys the key mask keeps: S = Q.K^T and dP = dO.V^T on the tensor
// cores, dQ += dS.K folded per half. The thread's rows are r0 = q0 + 16w
// + g and r0 + 8.
template <int D, class Walk>
__device__ __forceinline__ void dq_sweep(const Head& a, const Walk& walk,
                                         unsigned char* smem_raw) {
  constexpr int TF = tile_floats<D>(), TS = tile_floats<D, SROWS>();
  constexpr int PM = ROWS * SROWS;  // bytes of a mask tile
  float* qs = reinterpret_cast<float*>(smem_raw);  // (64, D + 4)
  float* dos = qs + TF;                            // (64, D + 4)
  float* ks = dos + TF;                            // 2 stages of (32, D + 4)
  float* vs = ks + 2 * TS;                         // 2 stages of (32, D + 4)
  float* k_lo = vs + 2 * TS;                       // the small parts of the current K tile
  float* v_lo = k_lo + TS;                         // ... and of its V tile
  uint32_t* kbits = reinterpret_cast<uint32_t*>(v_lo + TS);  // 2 stages of 1 word (+ 2)
  int8_t* pms = reinterpret_cast<int8_t*>(kbits + 4);         // 2 stages of (64, 32)

  const int n = a.n, q0 = walk.q0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint8_t* km = a.km;
  const int r0 = q0 + 16 * warp + g;  // the thread's rows r0, r0 + 8

  // delta of the warp's 16 rows (row_delta), written when delta_out is
  // given; delta and lse (times log2(e), for exp_diff) of the thread's
  // rows kept in registers. Rows at or past n (a ragged last tile) are
  // not read: their delta and lse are 0.
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
    load_tile_async<D, SROWS>(ks + st * TS, a.k, D, k0, n);
    load_tile_async<D, SROWS>(vs + st * TS, a.v, D, k0, n);
    walk.fetch_mask(h, pms + st * PM);
  };

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  int h = walk.next(0, km, kbits), st = 0;
  if (walk.live(h)) {
    load_tile_async<D>(qs, a.q, D, q0, n);
    load_tile_async<D>(dos, a.dout, D, q0, n);
    issue(h, 0);
  }
  tc::cp_async_commit();
  while (walk.live(h)) {
    const int nxt = walk.next(h + 1, km, kbits + (st ^ 1));
    if (walk.live(nxt)) issue(nxt, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int k0 = h * SROWS, cls = walk.cls(h);
    float* k_s = ks + st * TS;
    float* v_s = vs + st * TS;
    split_tiles<D, SROWS>(k_s, k_lo, v_s, v_lo, 0, n, nullptr, nullptr);
    __syncthreads();  // the tiles are split, once for every warp

    const uint64_t bits = tc::key_bits<SROWS>(km != nullptr, kbits + st, k0, n);
    const bool need_mask = cls == 1 || bits != tc::all_keys<SROWS>();
    const bool use_pattern = walk.use_pattern(cls);
    const int8_t* pm_t = pms + st * PM;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      FragA qa, da;
      load_a<D>(qa, qs, 16 * warp, 8 * kk);
      load_a<D>(da, dos, 16 * warp, 8 * kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        FragB kb[2], vb[2];
        load_b_rows<D>(kb, k_s, k_lo, 16 * np, 8 * kk);
        load_b_rows<D>(vb, v_s, v_lo, 16 * np, 8 * kk);
        mma3(s[2 * np], qa, kb[0]);
        mma3(s[2 * np + 1], qa, kb[1]);
        mma3(dp[2 * np], da, vb[0]);
        mma3(dp[2 * np + 1], da, vb[1]);
      }
    }

    // ds, split into the A fragments of dS.K
    FragA dsa[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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
      c_to_a(dsa[j], s[j]);
    }

    // dQ += dS.K over the half's 32 keys
    const float one[2] = {1.f, 1.f};
    fold_product<D>(dq, dsa, k_s, k_lo, one);
    __syncthreads();  // stage st is no longer read
    h = nxt;
    st ^= 1;
  }

  store_inverse_rotated<D>(dq, qs + 16 * warp * stride<D>(), a.dq, D, q0 + 16 * warp, n,
                           nullptr, nullptr);
}

// The query halves of column kt of the tiled kernels' visit map (vcol =
// visit + kt, rows nt apart): half h is rows 32h .., of the class of its
// 64-tile; with a pattern, a class 1 half's (32, 64) pattern tile is
// fetched by cp.async with the half's Q and dO
struct VisitColumn {
  const int8_t* vcol;
  const int8_t* pattern;  // (n, n) or NULL
  int nt, n, k0;

  __device__ int first(int8_t*) const { return first_visited<1>(vcol, nt, 0, 2 * nt); }
  __device__ int next(int h, int8_t*) const { return first_visited<1>(vcol, nt, h + 1, 2 * nt); }
  __device__ bool live(int h) const { return h < 2 * nt; }
  __device__ int q0(int h) const { return h * SROWS; }
  __device__ int cls(int h) const { return vcol[(int64_t)(h >> 1) * nt]; }
  __device__ bool use_pattern(int cls) const { return cls == 1 && pattern != nullptr; }
  __device__ void fetch_mask(int h, int8_t* pm) const {
    if (pattern != nullptr && cls(h) == 1)
      tc::load_mask_tile<SROWS, ROWS>(pm, pattern, q0(h), k0, n);
  }
};

// The query halves of the k-major run of the pair grid's 128-block pairs
// of key tile k0: pairs [begin / 4, end / 4) of the (5, n_pairs) table
// (rows q block, k block, class, first, last); half h is query rows
// 128 * qb + 32 * (h % 4) .. of pair h / 4. next() passes over class 0
// pairs, halves at or past n, and class 1 halves whose (32, 64) tile of
// the (n_pad, n_pad) int8 mask is empty: it loads that tile into the
// stage given, where the half will run, and tests it (a barrier).
struct PairRun {
  static constexpr int BLOCK = 128;  // the layout's block edge
  const int* table;
  const int8_t* mask;
  int n_pairs, n, n_pad, k0, begin, end;

  __device__ int first(int8_t* pm) const { return next(begin - 1, pm); }
  __device__ int next(int h, int8_t* pm) const {
    for (++h; h < end; ++h) {
      const int p = h >> 2, c = cls(h), row0 = q0(h);
      if (c == 0 || row0 >= n) {
        h = 4 * p + 3;  // the pair's other halves: the next pair
        continue;
      }
      if (c == 2 || load_mask(pm, row0)) return h;
    }
    return end;
  }
  __device__ bool live(int h) const { return h < end; }
  __device__ int q0(int h) const { return table[h >> 2] * BLOCK + SROWS * (h & 3); }
  __device__ int cls(int h) const { return table[2 * n_pairs + (h >> 2)]; }
  __device__ bool use_pattern(int cls) const { return cls == 1; }
  __device__ void fetch_mask(int, int8_t*) const {}

  // the (32, 64) mask tile at (row0, k0), one 16-byte chunk a thread;
  // true on every thread when a bit is set
  __device__ bool load_mask(int8_t* pm, int row0) const {
    static_assert(SROWS * ROWS == 16 * THREADS, "one chunk a thread");
    const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;
    const int4 bits = *reinterpret_cast<const int4*>(mask + (int64_t)(row0 + r) * n_pad + k0 + c);
    *reinterpret_cast<int4*>(pm + r * ROWS + c) = bits;
    return __syncthreads_or((bits.x | bits.y | bits.z | bits.w) != 0) != 0;
  }
};

// The query halves of key tile k0 in the pair grid's k-major (n_pad /
// 64, n_pad / 32) class map (hcol = its row k0 / 64,
// ops/block_sparse_attention.py:half_columns): half h is query rows 32h
// .. of class hcol[h] (0: passed over by a ballot, with no load and no
// barrier); a class 1 half's (32, 64) tile of the (n_pad, n_pad) int8
// mask is fetched by cp.async with the half's Q and dO, into the stage
// where it will run. Halves are visited in ascending query order.
struct HalfColumn {
  const int8_t* hcol;
  const int8_t* mask;
  int n_pad, k0;

  __device__ int halves() const { return n_pad / SROWS; }
  __device__ int first(int8_t*) const { return first_visited<0>(hcol, 1, 0, halves()); }
  __device__ int next(int h, int8_t*) const { return first_visited<0>(hcol, 1, h + 1, halves()); }
  __device__ bool live(int h) const { return h < halves(); }
  __device__ int q0(int h) const { return h * SROWS; }
  __device__ int cls(int h) const { return hcol[h]; }
  __device__ bool use_pattern(int cls) const { return cls == 1; }
  __device__ void fetch_mask(int h, int8_t* pm) const {
    if (cls(h) == 1) tc::load_mask_tile<SROWS, ROWS>(pm, mask, q0(h), k0, n_pad);
  }
};

// dk and dv of the 64-key tile at k0 of a head over the query halves of
// `walk`; delta from a.delta_in, or derived from O and dO (DELTA_FROM_O)
template <int D, bool DELTA_FROM_O, class Walk>
__device__ __forceinline__ void dkdv_sweep(const Head& a, const Walk& walk, int k0,
                                           unsigned char* smem_raw) {
  constexpr int TF = tile_floats<D>(), TS = tile_floats<D, SROWS>(), DS = stride<D>();
  constexpr int PM = SROWS * ROWS;  // bytes of a mask tile
  float* ks = reinterpret_cast<float*>(smem_raw);  // (64, D + 4)
  float* vs = ks + TF;                             // (64, D + 4)
  float* qs = vs + TF;                             // 2 stages of (32, D + 4)
  float* dos = qs + 2 * TS;                        // 2 stages of (32, D + 4)
  float* q_lo = dos + 2 * TS;                      // the small parts of the current Q tile
  float* do_lo = q_lo + TS;                        // ... and of its dO tile
  float* os = do_lo + TS;                          // 2 stages of (32, D + 4) with DELTA_FROM_O
  float* lse_s = os + (DELTA_FROM_O ? 2 * TS : 0);  // 2 stages of 32
  float* del_s = lse_s + 2 * SROWS;                // 2 stages of 32
  int8_t* pms = reinterpret_cast<int8_t*>(del_s + 2 * SROWS);  // 2 stages of (32, 64)
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
      load_tile_async<D, SROWS>(qs + st * TS, a.q, D, q0, n);
      load_tile_async<D, SROWS>(dos + st * TS, a.dout, D, q0, n);
      if constexpr (DELTA_FROM_O) load_tile_async<D, SROWS>(os + st * TS, a.o, D, q0, n);
      walk.fetch_mask(h, pms + st * PM);
    };
    // lse (times log2(e), for exp_diff) of query q0 + r by threads r < 32,
    // delta (when read) by threads 32 + r: loaded a half ahead, stored
    // after the products so that the load's latency hides behind them
    const int r = threadIdx.x % SROWS;
    const bool stat_thread = threadIdx.x < (DELTA_FROM_O ? 1 : 2) * SROWS;
    auto row_stat = [&](int h) {
      const int row = walk.q0(h) + r;
      if (row >= n) return 0.f;
      return threadIdx.x < SROWS ? a.lse[row] * tc::LOG2E : a.delta_in[row];
    };
    float* stat_s = threadIdx.x < SROWS ? lse_s : del_s;

    int h = walk.first(pms);
    if (walk.live(h)) {
      load_tile_async<D>(ks, a.k, D, k0, n);
      load_tile_async<D>(vs, a.v, D, k0, n);
      issue(h, 0);
      if (stat_thread) stat_s[r] = row_stat(h);
    }
    tc::cp_async_commit();
    for (int st = 0; walk.live(h); st ^= 1) {
      const int nxt = walk.next(h, pms + (st ^ 1) * PM);
      const float next_stat = stat_thread && walk.live(nxt) ? row_stat(nxt) : 0.f;
      if (walk.live(nxt)) issue(nxt, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
      __syncthreads();
      const int q0 = walk.q0(h), cls = walk.cls(h);
      float* q_s = qs + st * TS;
      float* do_s = dos + st * TS;
      if constexpr (DELTA_FROM_O) {
        // the half's delta from its raw O and dO rows, 8 rows a warp
        constexpr int RW = SROWS / tc::WARPS;
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const int row = RW * warp + i;
          const float sum = row_delta<D>(os + st * TS + row * DS, do_s + row * DS);
          if (lane == 0) del_s[st * SROWS + row] = sum;
        }
        __syncthreads();  // dO is read before it is split
      }
      split_tiles<D, SROWS>(q_s, q_lo, do_s, do_lo, 0, n, nullptr, nullptr);
      __syncthreads();  // the tiles are split, once for every warp

      const bool need_mask = cls == 1 || bits != ~0ull;
      const bool use_pattern = walk.use_pattern(cls);
      const int8_t* pm_t = pms + st * PM;
      float sT[4][4], dpT[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        FragA ka, va;
        load_a<D>(ka, ks, 16 * warp, 8 * kk);
        load_a<D>(va, vs, 16 * warp, 8 * kk);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          FragB qb[2], db[2];
          load_b_rows<D>(qb, q_s, q_lo, 16 * np, 8 * kk);
          load_b_rows<D>(db, do_s, do_lo, 16 * np, 8 * kk);
          mma3(sT[2 * np], ka, qb[0]);
          mma3(sT[2 * np + 1], ka, qb[1]);
          mma3(dpT[2 * np], va, db[0]);
          mma3(dpT[2 * np + 1], va, db[1]);
        }
      }

      // p^T into sT, ds^T into dpT
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

      // dV += P^T.dO, then dK += dS^T.Q, over the half's 32 queries
      const float one[2] = {1.f, 1.f};
      FragA fa[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) c_to_a(fa[kk], sT[kk]);
      fold_product<D>(dv, fa, do_s, do_lo, one);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) c_to_a(fa[kk], dpT[kk]);
      fold_product<D>(dk, fa, q_s, q_lo, one);
      if (stat_thread) stat_s[(st ^ 1) * SROWS + r] = next_stat;
      __syncthreads();  // stage st is no longer read
      h = nxt;
    }
  }

  // each warp's own rows of the K and V tiles hold its dk and dv (tiles
  // that were loaded have landed: the last wait left only an empty group)
  store_inverse_rotated<D>(dk, ks + 16 * warp * DS, a.dk, D, k0 + 16 * warp, n, nullptr,
                           nullptr);
  store_inverse_rotated<D>(dv, vs + 16 * warp * DS, a.dv, D, k0 + 16 * warp, n, nullptr,
                           nullptr);
}

}  // namespace tf32
