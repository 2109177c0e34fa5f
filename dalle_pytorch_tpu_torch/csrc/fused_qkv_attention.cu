// Fused packed-qkv attention for Hopper (sm_90a), the forward.
//
// Replaces the Pallas TPU kernel `_fused_qkv_fwd_kernel` behind
// `fused_qkv_attention` in dalle_pytorch_tpu/ops/flash_attention.py (the
// backward, `_fused_qkv_bwd_kernel`, is fused_qkv_attention_bwd.cu).
// Python wrapper:
// dalle_pytorch_tpu_torch/ops/flash_attention.py:fused_qkv_attention.
//
// What it computes. qkv (b, n, 3*h*d) in the projection's layout: head j
// of q at columns [j*d, (j+1)*d), of k at h*d + j*d, of v at 2*h*d + j*d.
// Optional: a (b, n) uint8 key mask, causal masking, a static (n, n) int8
// pattern mask (which alone decides when given), and cos/sin tables (n, d)
// in the compute type for rotary on q, k AND v: t*cos + rotate_half(t)*sin
// with rotate_half(t)[2i] = -t[2i+1], [2i+1] = t[2i], rounded to the
// storage type after each product and after the sum, as the reference
// does. Scores q.k^T accumulate in float32 and are scaled afterwards;
// disallowed scores are NEG_INF = -1e30 and p = exp(s - m) only where
// s > 0.5 * NEG_INF, else 0 (online softmax over key tiles, float32 max,
// denominator and accumulator). p is rounded to the storage type before
// the value product. o = acc / l (l = 1 where l == 0, so a fully masked
// row writes exactly 0), lse = m + log(l) as (b, h, 1, n) float32.
//
// What bounds it. bf16, at DALL-E's shape (b 2, n 1280, 16 heads of 64,
// causal, rotary): 4*d operations per allowed (query, key) pair and head,
// ~6.7e9, 6.8 us at the tensor cores' 989 TFLOP/s, against ~2.6 us of
// bytes (q, k, v, o, lse and the tables once): operations bound it. At
// CLIP's text shape (b 8, n 256, 8 heads of 64, a key mask) bytes bound
// it (~1.75 us), and launch latency and the masked-row path dominate.
// float32, at the training shape (b 4): ~1.3e10 operations, run as split
// 3xTF32 (three TF32 products per float32 product): 0.081 ms at the
// tensor cores' 495 / 3 = 165 TFLOP/s, against ~0.2 ms at the CUDA
// cores' 67 TFLOP/s float32 rate and ~0.03 ms of bytes: operations bound
// it. In practice the float32 instance runs at ~5x that bound, held by
// shared memory bandwidth (each fragment of the streamed tiles read as
// two TF32 parts for 16 rows a warp) and then latency at two blocks an
// SM (tf32_tiles.cuh).
//
// Both instances run both products on the tensor cores, one block of 4
// warps per (64-row query tile, head, batch row), warp w owning query
// rows 16w .. 16w + 15, with float32 accumulation: bf16 as bf16
// mma.sync.m16n8k16 (fused_qkv_fwd_tc_kernel), float32 as split 3xTF32
// mma.sync.m16n8k8 (fused_qkv_fwd_tf32_kernel, csrc/tf32_tiles.cuh). K/V
// tiles come through a 2-stage cp.async ring so the loads of tile kt + 1
// overlap the products of tile kt; rotary is applied once per tile in
// shared memory; the scale, the masks and the online softmax run on the
// score accumulators (row max and sum over the 4 lanes of a quad), and
// the probabilities feed the value product from registers; the heaviest
// causal query tiles are scheduled first. Both keep every (n, n)
// intermediate on chip, read q/k/v in place from the projection's layout
// (no split, transpose or rotary pass through device memory), skip key
// tiles the key mask wholly masks (and q, when that is every tile), and
// write o straight into the projection's layout. Next, where the kernel
// table shows an instance below half its bound: wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"
#include "tf32_tiles.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------- bf16: the tensor-core design
//
// One block of 4 warps per (64-row query tile, head, batch row); warp w
// owns query rows 16w .. 16w + 15 of the tile. Per live 64-key tile:
// S = Q.K^T and O += P.V as bf16 mma.sync.m16n8k16 with float32
// accumulation, Q's A fragments in registers for the whole key loop
// (rotated there, once), K by ldmatrix, V by ldmatrix.trans; the scale,
// the masks and the online softmax on the S accumulators, row max and
// sum over the 4 lanes of a quad; p rounded to bf16 straight into P.V's A
// fragments. K/V tiles (with the cos/sin rows of their positions, and a
// pattern mask's int8 tile) come through a 2-stage cp.async ring, so tile
// kt + 1 is in flight while tile kt computes; K and V are rotated in
// shared memory once per tile, after the tile lands. The kernel is bound
// by latency more than by any one unit (4 warps a block, one dependent
// chain of loads, products and softmax a warp), so its register budget is
// capped where three blocks fit on an SM: at d 32 and 64 that is faster
// than wider tiles (two 16-row blocks a warp) or a fourth block, both of
// which spill or lose occupancy.

constexpr int fwd_tc_smem_bytes(int d, bool rot, bool pattern) {
  // Q, two stages of K and V, two of key bits, two of the pattern tile,
  // the cos/sin rows of one key tile
  return 2 * 5 * tc::ROWS * (d + 8) + 2 * 2 * 4 + (pattern ? 2 * tc::ROWS * tc::ROWS : 0) +
         (rot ? 2 * 2 * tc::ROWS * d : 0);
}

template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 3 : 1) fused_qkv_fwd_tc_kernel(
    const tc::bf16* __restrict__ qkv, const uint8_t* __restrict__ kmask,
    const int8_t* __restrict__ pmask, const tc::bf16* __restrict__ cos_t,
    const tc::bf16* __restrict__ sin_t, tc::bf16* __restrict__ out,
    float* __restrict__ lse, int n, int heads, int causal, float scale) {
  using tc::bf16;
  constexpr int TE = tc::tile_elems<D>(), DS = tc::stride<D>(), KS = D / 16;
  constexpr int PM = tc::ROWS * tc::ROWS;  // bytes of a pattern tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (64, DS)
  bf16* kv = qs + TE;  // stage s: K at kv + 2s * TE, V at kv + (2s + 1) * TE
  uint32_t* kbits = reinterpret_cast<uint32_t*>(kv + 4 * TE);  // 2 stages of 2 words
  int8_t* pms = reinterpret_cast<int8_t*>(kbits + 4);         // 2 stages of (64, 64)
  // cos/sin rows of the key tile being loaded (after the pattern tiles,
  // which take no room without a pattern)
  bf16* cs = reinterpret_cast<bf16*>(pms + (pmask != nullptr ? 2 * PM : 0));

  // causal without a pattern: the heaviest query tiles (the last) first
  const bool tri = causal && pmask == nullptr;
  const int qt = tri ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * tc::ROWS, h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t stride = 3LL * heads * D;
  const bf16* base = qkv + (int64_t)b * n * stride;
  const bf16* ksrc = base + (int64_t)(heads + h) * D;
  const bf16* vsrc = base + (int64_t)(2 * heads + h) * D;
  const uint8_t* kmask_b = kmask == nullptr ? nullptr : kmask + (int64_t)b * n;

  int n_tiles = (n + tc::ROWS - 1) / tc::ROWS;
  if (tri) n_tiles = min(n_tiles, qt + 1);
  // The first tile at or after kt with a key that exists and passes the
  // key mask (its bits into stage st), or n_tiles. A tile of masked keys
  // gives p = 0 everywhere and leaves m, l and o as they are, so it is not
  // loaded; nor is q while every tile so far was such a tile (a fully
  // masked batch row reads no q, k or v).
  auto next_live = [&](int kt, int st) {
    if (kmask_b != nullptr)
      while (kt < n_tiles && !tc::tile_keys(kmask_b, kt * tc::ROWS, n, kbits + 2 * st)) ++kt;
    return kt;
  };
  // K and V of tile kt (with the cos/sin of its rows, and the pattern
  // tile) into stage st
  auto issue = [&](int kt, int st) {
    tc::load_tile_async<D>(kv + 2 * st * TE, ksrc, stride, kt * tc::ROWS, n);
    tc::load_tile_async<D>(kv + (2 * st + 1) * TE, vsrc, stride, kt * tc::ROWS, n);
    if (cos_t != nullptr) tc::load_rot_rows_async<D>(cs, cos_t, sin_t, kt * tc::ROWS, n);
    if (pmask != nullptr) tc::load_mask_tile(pms + st * PM, pmask, q0, kt * tc::ROWS, n);
  };

  // the thread's rows: q0 + 16w + g + 8r, r < 2
  float o[D / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  uint32_t qf[KS][4];

  int kt = next_live(0, 0), st = 0;
  if (kt < n_tiles) {
    tc::load_tile_async<D>(qs, base + (int64_t)h * D, stride, q0, n);
    issue(kt, 0);
  }
  tc::cp_async_commit();
  bool first = true;
  while (kt < n_tiles) {
    tc::cp_async_wait<0>();  // tile kt (and q on the first) has landed
    __syncthreads();         // ... for every thread; stage st ^ 1 is no longer read
    const int k0 = kt * tc::ROWS;
    const bf16* kt_s = kv + 2 * st * TE;
    const bf16* vt_s = kt_s + TE;
    if (cos_t != nullptr) {
      tc::rotate_tiles<D>(kv + 2 * st * TE, kv + (2 * st + 1) * TE, k0, n, cs);
      __syncthreads();  // the tiles are rotated; cs and stage st ^ 1 are free
    }
    // the next live tile is in flight while this one computes
    const int nxt = next_live(kt + 1, st ^ 1);
    if (nxt < n_tiles) issue(nxt, st ^ 1);
    tc::cp_async_commit();
    if (first) {
      // q's fragments, rotated in registers: a fragment register holds a
      // channel pair 2c, 2c + 1 of one row
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        tc::load_a<D>(qf[kk], qs, 16 * warp, 16 * kk);
        if (cos_t != nullptr)
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int row = q0 + 16 * warp + g + 8 * (a & 1);
            const int col = 16 * kk + 8 * (a >> 1) + 2 * t;
            if (row < n)
              qf[kk][a] = tc::rotate2(qf[kk][a], cos_t + (int64_t)row * D + col,
                                      sin_t + (int64_t)row * D + col);
          }
      }
      first = false;
    }

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        tc::load_b_rows<D>(kb, kt_s, 16 * np, 16 * kk);
        tc::mma(s[2 * np], qf[kk], kb[0], kb[1]);
        tc::mma(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale and mask: element e of n-block j is row r0 + 8 * (e / 2), key
    // column 8j + 2t + e % 2 of the tile
    const uint64_t bits = tc::key_bits(kmask_b != nullptr, kbits + 2 * st, k0, n);
    const bool need_mask = bits != ~0ull || pmask != nullptr || (causal && k0 == q0);
    const int r0 = q0 + 16 * warp + g;
    const int8_t* pm_t = pms + st * PM;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[j][e] * scale;
        if (need_mask) {
          const int row = r0 + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
          bool ok = (bits >> c) & 1;
          if (pmask != nullptr) {
            ok = ok && pm_t[(row - q0) * tc::ROWS + c] != 0;
          } else if (causal) {
            ok = ok && row >= k0 + c;
          }
          if (!ok) v = NEG_INF;
        }
        s[j][e] = v;
      }

    // online softmax over the quad's 64 columns of rows r0 and r0 + 8
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float m2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float corr = expf(m[r] - m_new);
      m[r] = m_new;
      m2[r] = m_new * tc::LOG2E;
      l[r] *= corr;  // the thread's part of the row sum, reduced at the end
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = s[j][e];
        const float p = sv > 0.5f * NEG_INF ? tc::exp_diff(sv, m2[e >> 1]) : 0.f;
        l[e >> 1] += p;
        s[j][e] = p;
      }

    // O += P.V over the tile's 64 keys, 16 at a time
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      tc::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        tc::load_b_cols<D>(vb, vt_s, 16 * kk, 16 * dp);
        tc::mma(o[2 * dp], pa, vb[0], vb[1]);
        tc::mma(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    kt = nxt;
    st ^= 1;
  }

  // o / l (l = 1 where l == 0: a fully masked row writes exactly 0) into
  // the warp's own rows of the q tile, then 16-byte stores
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
  const int64_t hd = (int64_t)heads * D;
  tc::store_rows<D>(out + (int64_t)b * n * hd + (int64_t)h * D, hd, ow, q0 + 16 * warp, n);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      if (row < n) lse[((int64_t)b * heads + h) * n + row] = m[r] + logf(l_safe[r]);
    }
  }
}

// ------------------------------------ float32: the split-3xTF32 design
//
// The bf16 design's block (4 warps, 16 query rows each, 64-row query
// tiles), ring and schedule, with float32 tiles (rows of d floats padded
// to d + 4) and every product as split 3xTF32 mma.sync.m16n8k8
// (csrc/tf32_tiles.cuh). Three choices differ from bf16's:
//  - key tiles of 32 (tf32::SROWS), each rotated and split once when it
//    lands (tf32::split_tiles): a block holds Q, two stages of K and V,
//    the small parts of one K and V tile and the cos/sin rows of one key
//    tile, 84-88 KB at d 64, so two blocks share an SM;
//  - Q stays in shared memory (rotated there with the first live key
//    tile), its A fragments loaded and split per key tile: split in
//    registers for the whole loop they would take 2 * d of them;
//  - O += P.V runs channel block by channel block, each block's partial
//    over the tile's 32 keys fresh in registers (the P fragments, split,
//    held across blocks) and folded into O with one rounded FMA that also
//    applies the softmax's rescaling (tf32::fold_product).
// S = Q.K^T takes K's B fragments by ldmatrix; P.V takes p straight
// from the S accumulators (k permuted) and V's two values a fragment by
// 32-bit shared loads at rows 2t, 2t + 1. p stays float32 (split, not
// rounded), computed as tc::exp_diff (ex2.approx, ~1e-6 relative to
// expf; the float32 tolerances hold).

constexpr int fwd_tf32_smem_bytes(int d, bool rot, bool pattern) {
  // Q, two stages of K and V, the small parts of one K and V tile, the
  // cos/sin rows of one key tile, two stages of key bits (16 bytes,
  // keeping what follows aligned), two of the (64, 32) pattern tile
  return 4 * (tf32::ROWS * (d + 4) + 6 * tf32::SROWS * (d + 4) +
              (rot ? 2 * tf32::SROWS * d : 0)) +
         16 + (pattern ? 2 * tf32::ROWS * tf32::SROWS : 0);
}

template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 32 ? 3 : (D <= 64 ? 2 : 1))
    fused_qkv_fwd_tf32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ kmask,
                              const int8_t* __restrict__ pmask, const float* __restrict__ cos_t,
                              const float* __restrict__ sin_t, float* __restrict__ out,
                              float* __restrict__ lse, int n, int heads, int causal,
                              float scale) {
  using tf32::ROWS;
  using tf32::SROWS;
  constexpr int TS = tf32::tile_floats<D, SROWS>(), DS = tf32::stride<D>();
  constexpr int PM = ROWS * SROWS;  // bytes of a pattern tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // (64, DS)
  float* kv = qs + tf32::tile_floats<D>();  // stage s: K at kv + 2s * TS, V at kv + (2s + 1) * TS
  float* k_lo = kv + 4 * TS;  // the small parts of the current K tile
  float* v_lo = k_lo + TS;    // ... and of its V tile
  float* cs = v_lo + TS;  // cos/sin rows of the key tile being loaded (none without tables)
  uint32_t* kbits = reinterpret_cast<uint32_t*>(cs + (cos_t != nullptr ? 2 * SROWS * D : 0));
  int8_t* pms = reinterpret_cast<int8_t*>(kbits + 4);  // 2 stages of (64, 32)

  // causal without a pattern: the heaviest query tiles (the last) first
  const bool tri = causal && pmask == nullptr;
  const int qt = tri ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * ROWS, h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t stride = 3LL * heads * D;
  const float* base = qkv + (int64_t)b * n * stride;
  const float* ksrc = base + (int64_t)(heads + h) * D;
  const float* vsrc = base + (int64_t)(2 * heads + h) * D;
  const uint8_t* kmask_b = kmask == nullptr ? nullptr : kmask + (int64_t)b * n;

  int n_tiles = (n + SROWS - 1) / SROWS;
  if (tri) n_tiles = min(n_tiles, (q0 + ROWS - 1) / SROWS + 1);
  // as the bf16 kernel: the first live key tile at or after kt (its key
  // bits into stage st), or n_tiles
  auto next_live = [&](int kt, int st) {
    if (kmask_b != nullptr)
      while (kt < n_tiles && !tc::tile_keys<SROWS>(kmask_b, kt * SROWS, n, kbits + st))
        ++kt;
    return kt;
  };
  auto issue = [&](int kt, int st) {
    tf32::load_tile_async<D, SROWS>(kv + 2 * st * TS, ksrc, stride, kt * SROWS, n);
    tf32::load_tile_async<D, SROWS>(kv + (2 * st + 1) * TS, vsrc, stride, kt * SROWS, n);
    if (cos_t != nullptr) tf32::load_rot_rows_async<D, SROWS>(cs, cos_t, sin_t, kt * SROWS, n);
    if (pmask != nullptr)
      tc::load_mask_tile<ROWS, SROWS>(pms + st * PM, pmask, q0, kt * SROWS, n);
  };

  // the thread's rows: q0 + 16w + g + 8r, r < 2
  float o[D / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  int kt = next_live(0, 0), st = 0;
  if (kt < n_tiles) {
    tf32::load_tile_async<D>(qs, base + (int64_t)h * D, stride, q0, n);
    issue(kt, 0);
  }
  tc::cp_async_commit();
  bool first = true;
  while (kt < n_tiles) {
    tc::cp_async_wait<0>();  // tile kt (and q on the first) has landed
    __syncthreads();         // ... for every thread; stage st ^ 1 is no longer read
    const int k0 = kt * SROWS;
    float* k_s = kv + 2 * st * TS;
    float* v_s = k_s + TS;
    // K and V rotated and split (big in place), once for every warp
    tf32::split_tiles<D, SROWS>(k_s, k_lo, v_s, v_lo, k0, n, cos_t == nullptr ? nullptr : cs,
                                cs + SROWS * D);
    if (first && cos_t != nullptr)
      tf32::rotate_tile<D, ROWS>(qs, q0, n, cos_t + (int64_t)q0 * D, sin_t + (int64_t)q0 * D);
    first = false;
    __syncthreads();  // the tiles are ready; cs is free
    // the next live tile is in flight while this one computes
    const int nxt = next_live(kt + 1, st ^ 1);
    if (nxt < n_tiles) issue(nxt, st ^ 1);
    tc::cp_async_commit();

    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      tf32::FragA qa;
      tf32::load_a<D>(qa, qs, 16 * warp, 8 * kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        tf32::FragB kb[2];
        tf32::load_b_rows<D>(kb, k_s, k_lo, 16 * np, 8 * kk);
        tf32::mma3(s[2 * np], qa, kb[0]);
        tf32::mma3(s[2 * np + 1], qa, kb[1]);
      }
    }

    // scale and mask: element e of n-block j is row r0 + 8 * (e / 2), key
    // column 8j + 2t + e % 2 of the tile
    const uint64_t bits = tc::key_bits<SROWS>(kmask_b != nullptr, kbits + st, k0, n);
    const bool need_mask = bits != tc::all_keys<SROWS>() || pmask != nullptr ||
                           (causal && k0 + SROWS > q0 + 1);
    const int r0 = q0 + 16 * warp + g;
    const int8_t* pm_t = pms + st * PM;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[j][e] * scale;
        if (need_mask) {
          const int row = r0 + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
          bool ok = (bits >> c) & 1;
          if (pmask != nullptr) {
            ok = ok && pm_t[(row - q0) * SROWS + c] != 0;
          } else if (causal) {
            ok = ok && row >= k0 + c;
          }
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
      l[r] *= corr[r];  // the thread's part of the row sum, reduced at the end
    }
    tf32::FragA pa[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = s[j][e];
        const float p = sv > 0.5f * NEG_INF ? tc::exp_diff(sv, m2[e >> 1]) : 0.f;
        l[e >> 1] += p;
        s[j][e] = p;
      }
      tf32::c_to_a(pa[j], s[j]);
    }

    // O = O * corr + P.V over the tile's 32 keys
    tf32::fold_product<D>(o, pa, v_s, v_lo, corr);
    kt = nxt;
    st ^= 1;
  }

  // o / l (l = 1 where l == 0: a fully masked row writes exactly 0) into
  // the warp's own rows of the q tile, then 16-byte stores
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
  const int64_t hd = (int64_t)heads * D;
  tf32::store_rows<D>(out + (int64_t)b * n * hd + (int64_t)h * D, hd, ow, q0 + 16 * warp, n);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      if (row < n) lse[((int64_t)b * heads + h) * n + row] = m[r] + logf(l_safe[r]);
    }
  }
}

// T = float: the split-3xTF32 kernel; T = bf16: the bf16 one. Both need
// qkv, the tables and out 16-byte aligned (cp.async, vector stores).
template <typename T, int D>
int launch(const void* qkv, const void* kmask, const void* pmask, const void* cos_t,
           const void* sin_t, void* out, void* lse, int batch, int n, int heads, int causal,
           float scale, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  const int n_qt = (n + tc::ROWS - 1) / tc::ROWS;
  if (n_qt > 65535 || !tc::aligned16({qkv, cos_t, sin_t, out})) return -1;
  const int smem = f32 ? fwd_tf32_smem_bytes(D, cos_t != nullptr, pmask != nullptr)
                       : fwd_tc_smem_bytes(D, cos_t != nullptr, pmask != nullptr);
  void (*kernel)(const T*, const uint8_t*, const int8_t*, const T*, const T*, T*, float*, int,
                 int, int, float);
  if constexpr (f32) {
    kernel = fused_qkv_fwd_tf32_kernel<D>;
  } else {
    kernel = fused_qkv_fwd_tc_kernel<D>;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(heads, batch, n_qt);
  kernel<<<grid, tc::THREADS, smem, stream>>>(
      (const T*)qkv, (const uint8_t*)kmask, (const int8_t*)pmask, (const T*)cos_t,
      (const T*)sin_t, (T*)out, (float*)lse, n, heads, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* qkv, const void* kmask, const void* pmask, const void* cos_t,
               const void* sin_t, void* out, void* lse, int batch, int n, int heads,
               int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(qkv, kmask, pmask, cos_t, sin_t, out, lse, batch, n, heads, causal, scale, stream);
    case 64: return launch<T, 64>(qkv, kmask, pmask, cos_t, sin_t, out, lse, batch, n, heads, causal, scale, stream);
    case 128: return launch<T, 128>(qkv, kmask, pmask, cos_t, sin_t, out, lse, batch, n, heads, causal, scale, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kmask (b, n) uint8, pmask (n, n)
// int8, cos/sin (n, d) of qkv's type: each may be NULL. Returns
// cudaGetLastError() after the launch (0 on success), or -1 for what the
// kernel cannot take: a dim_head other than 32/64/128, a dtype code
// other than 0/1, an empty shape, more heads or batch rows than a grid
// dimension holds, or qkv, a table or out not 16-byte aligned.
extern "C" int fused_qkv_attention_fwd(
    const void* qkv, const void* kmask, const void* pmask, const void* cos_t,
    const void* sin_t, void* out, void* lse, int batch, int n, int heads,
    int dim_head, int causal, float scale, int dtype, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || batch > 65535 || heads > 65535) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(dim_head, qkv, kmask, pmask, cos_t, sin_t, out, lse, batch, n, heads, causal, scale, s);
  if (dtype == 1)
    return dispatch_d<tc::bf16>(dim_head, qkv, kmask, pmask, cos_t, sin_t, out, lse, batch, n, heads, causal, scale, s);
  return -1;
}
