// Ragged paged attention for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel `_ragged_kernel` behind `kernel_attend`
// in dalle_pytorch_tpu/ops/ragged_attention.py, both of its branches:
// unquantized pages (`ragged_attention_fwd`) and int8 pages with
// per-(token, head) float32 scale pages (`quant=True`,
// `ragged_attention_fwd_int8`). Python wrappers:
// dalle_pytorch_tpu_torch/ops/ragged_attention.py:kernel_attend and
// kernel_attend_int8.
//
// What it computes. q (B, W, h*d) pre-scaled; K/V pools viewed flat as
// (pages, page, h*d); table (B, n_pages) int32; start, length (B,) int32.
// The contracts of the TPU kernel, kept by every instance:
// - query column i of row b sits at position start[b] + i; key p (logical
//   page p / page, row p % page) is visible to it iff p <= start + i;
// - the frontier is last_pos = start + max(length, 1) - 1: keys past it
//   (and past the table's n_pages * page) are never read;
// - idle rows (length 0) compute one column and stay finite; the engine
//   issues them at start 0, where that costs one key row;
// - columns past a row's first max(length, 1) are written as zeros
//   (callers discard them); a zero denominator writes 0;
// - NEG_INF = -1e30, and p = 0 where s <= 0.5 * NEG_INF;
// - the table holds GLOBAL page ids into the flat pool view, and a page's
//   int8 scales (pools (pages, page, h) float32) come through the same
//   table entry as its bytes;
// - int8 is dequantized by exactly paged_kv.dequant's formula:
//   float(int8) * scale in float32, then rounded to the compute type;
// - probabilities are rounded to the compute type before the value
//   product, as the TPU kernel's p.astype(v.dtype) does.
//
// What bounds it. Bytes: a row reads its frontier's K and V once (at the
// serving shapes up to 1281 positions x 1024 channels x 2 tensors; int8
// halves that at bf16 and adds 4 bytes per (position, head) of scales),
// and does about 4 * valid_queries * frontier * h*d operations, far below
// the ~295 operations per byte at which the tensor cores would bound it.
// At the serving shapes the bytes take ~4 us of the card and the kernel
// is bound by latency: the longest row's page walk, one HBM round trip
// after another. The design therefore spreads every row's frontier over
// many SMs and keeps a load in flight behind each product.
//
// The frontier split. Every (head, row, query tile) is a cluster of CL = 4
// blocks. Keys are cut into tiles of 64 at fixed positions (0, 64, 128,
// ...), and block `rank` of the cluster takes the tiles rank, rank + CL,
// rank + 2 CL, ... up to the frontier: the row at 1279 spreads its 20
// tiles over 4 SMs. (On the H100, 4 beat 8, whose extra blocks the card
// could not hold at once at the serving shape, and 2; no split at all was
// 1.7x slower there.) Each block keeps float32 partials (m, l, acc) of
// its tiles; then, after a cluster barrier, the cluster's blocks merge the
// partials through distributed shared memory in rank order (each block
// one share of the tile's outputs: the merged max first, then l and acc
// scaled by exp(m - max)) and write the output. A block with no tile
// holds m = NEG_INF, l = 0, acc = 0, which the merge adds as exact zeros.
//
// Determinism and row independence. The tiles' positions, their
// assignment to blocks and to warps, the order of every sum and of the
// merge are fixed by positions alone: never by the batch, the other
// rows, or how much work there is. Keys past a query's position give
// exact identities (p = 0, corrections of exactly 1, zero terms), so a
// query column's output is a function of its own position, its row's K/V
// and the block's width class (W <= 16, or wider): bitwise the same in
// any batch, at any column of a block, run after run. No float atomics.
// The engine's replay of a preempted request rests on this.
//
// The bf16 instances (ragged_tc_kernel) run both products on the tensor
// cores, with csrc/mma_tiles.cuh's tiles: bf16 mma.sync.m16n8k16 with
// float32 accumulation, ldmatrix loaders, q's fragments in registers, the
// scores turned into P's A fragments in registers (rounded to bf16 there).
// A block of 4 warps has a query tile of QT = 16 columns (one m16 tile:
// a decode row is one valid row of it) when W <= 16, and then its 4 warps
// split each 64-key tile into 16-key slices, each warp an online softmax
// of its own (partials of 4 slices x 16 rows); for wider blocks (a whole
// prompt: 257 columns, five tiles) the query tile is 64 columns and each
// warp owns 16 of them over all 64 keys. K/V rows are staged by position
// through the table (a 64-key tile may span 16 pages of 4, a page of 128
// spans two tiles) by 16-byte cp.async into padded bf16 tiles, a ring of
// three stages, so the next two tiles load while this one computes (at the
// serving shape a block's whole share is in flight); rows past the frontier
// are zero-filled and masked by position. Int8 pages are staged as bytes
// with their scale rows (4-byte cp.async: a (token, head) scale is h * 4
// bytes from the next), then dequantized in shared memory into the same
// bf16 tiles.
//
// The float32 instances (ragged_f32_kernel) stay on CUDA-core FMAs
// (RAGGED_F32_ATOL is 1e-5, which TF32 cannot meet): one block of 128
// threads per (head, row, query tile of up to 64 columns, rank), pages
// staged in shared memory as float32 rows padded to d + 1, thread per key
// for the scores, and the same cluster split, by pages instead of tiles
// (block `rank` takes pages rank, rank + CL, ...), merged by the same code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using tc::bf16;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = tc::THREADS;  // 4 warps
constexpr int KT = tc::ROWS;          // keys of a tile
constexpr int CL = 4;                 // blocks of a cluster: the frontier's split
constexpr int STAGES = 3;             // K/V tiles of the bf16 ring
constexpr int SLOTS = 64;             // partial rows a block keeps
constexpr int MAX_W = 64;             // query columns of a wide tile

// ---------------------------------------------------------------- merge
//
// A block's partials sit at the start of its shared memory: m (SLOTS
// floats), l (SLOTS), then acc (SLOTS rows of D floats, D + 4 apart).
// Query column i of the tile has KSL of them per block, slots s * QT + i.

template <int D> __host__ __device__ constexpr int acc_stride() { return D + 4; }
template <int D> __host__ __device__ constexpr int partial_bytes() {
  return 4 * SLOTS * (2 + acc_stride<D>());
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(tc::pack(v.x, v.y), tc::pack(v.z, v.w));
}

// Columns i < tw of the tile's output (o_tile: column 0, this head; h*d
// apart), 4 channels per item, items spread over the cluster's threads:
// i < nq merged from every block's partials, in rank order and slice
// order, as acc / l (l = 0 writes 0); nq <= i < tw zeros. Reads other
// blocks' shared memory: call between two cluster barriers (with nq <= 0
// it reads nothing and needs none).
template <typename T, int D, int QT, int KSL>
__device__ __forceinline__ void merge_store(const cg::cluster_group& cluster, float* part,
                                            T* __restrict__ o_tile, int64_t hd, int tw,
                                            int nq) {
  constexpr int C4 = D / 4, AS = acc_stride<D>();
  for (int x = cluster.block_rank() * THREADS + threadIdx.x; x < tw * C4; x += CL * THREADS) {
    const int i = x / C4, c = 4 * (x % C4);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < nq) {
      float mx = NEG_INF;
#pragma unroll
      for (int rk = 0; rk < CL; ++rk) {
        const float* p = cluster.map_shared_rank(part, rk);
#pragma unroll
        for (int s = 0; s < KSL; ++s) mx = fmaxf(mx, p[s * QT + i]);
      }
      float l = 0.f;
#pragma unroll
      for (int rk = 0; rk < CL; ++rk) {
        const float* p = cluster.map_shared_rank(part, rk);
#pragma unroll
        for (int s = 0; s < KSL; ++s) {
          const int slot = s * QT + i;
          const float e = expf(p[slot] - mx);
          const float4 a = *reinterpret_cast<const float4*>(p + 2 * SLOTS + slot * AS + c);
          l += p[SLOTS + slot] * e;
          o.x += a.x * e;
          o.y += a.y * e;
          o.z += a.z * e;
          o.w += a.w * e;
        }
      }
      const float ls = l == 0.f ? 1.f : l;
      o = make_float4(o.x / ls, o.y / ls, o.z / ls, o.w / ls);
    }
    store4(o_tile + (int64_t)i * hd + c, o);
  }
}

// ------------------------------------------------ bf16: tensor cores

// 4 bytes from global to shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tc::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 8 int8 values times their row's scale, each rounded to bf16 (nearest
// even): paged_kv.dequant's formula
__device__ __forceinline__ uint4 dequant8(uint2 raw, float scale) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
  return make_uint4(tc::pack(static_cast<float>(v[0]) * scale, static_cast<float>(v[1]) * scale),
                    tc::pack(static_cast<float>(v[2]) * scale, static_cast<float>(v[3]) * scale),
                    tc::pack(static_cast<float>(v[4]) * scale, static_cast<float>(v[5]) * scale),
                    tc::pack(static_cast<float>(v[6]) * scale, static_cast<float>(v[7]) * scale));
}

// bytes of a ring stage of int8 pages: K and V bytes (KT rows of D), then
// K and V scales (KT floats each)
template <int D> __host__ __device__ constexpr int stage8_bytes() {
  return 2 * KT * D + 2 * KT * 4;
}

// shared bytes before the q tile: the ring (STAGES stages of bf16 K and V
// tiles; or of int8 bytes and scales, plus one dequantized bf16 K/V pair),
// which the partials reuse after the walk
template <int D, bool Q8> __host__ __device__ constexpr int ring_bytes() {
  constexpr int r = Q8 ? STAGES * stage8_bytes<D>() + 2 * tc::tile_elems<D>() * 2
                       : STAGES * 2 * tc::tile_elems<D>() * 2;
  return r > partial_bytes<D>() ? r : partial_bytes<D>();
}

template <int D, int QG, bool Q8> int tc_smem_bytes(int n_pages) {
  return ring_bytes<D, Q8>() + 16 * QG * tc::stride<D>() * 2 + 4 * n_pages;
}

// One block: head blockIdx.x, batch row blockIdx.y, query tile blockIdx.z
// / CL of QT = 16 * QG columns, rank blockIdx.z % CL of its cluster. Q8:
// int8 pools (k_pool / v_pool bytes) with their scale pools; else bf16.
template <int D, int QG, bool Q8>
__global__ void __cluster_dims__(1, 1, CL) __launch_bounds__(THREADS) ragged_tc_kernel(
    const bf16* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ table,
    const int32_t* __restrict__ start, const int32_t* __restrict__ length,
    bf16* __restrict__ out, int width, int heads, int page, int n_pages) {
  constexpr int QT = 16 * QG;      // query columns of the tile
  constexpr int KSL = 4 / QG;      // key slices of a 64-key tile, one per warp of a row group
  constexpr int KW = KT / KSL;     // keys of a slice
  constexpr int NB = KW / 8;       // score n-blocks of a warp
  constexpr int TE = tc::tile_elems<D>(), DS = tc::stride<D>(), KS = D / 16, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int h = blockIdx.x, b = blockIdx.y, tile = blockIdx.z / CL;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t hd = (int64_t)heads * D;
  const int t0 = tile * QT;                   // the tile's first column
  const int tw = min(width - t0, QT);         // its columns
  const int st = start[b] + t0;               // position of its column 0
  const int nq = min(max(length[b], 1) - t0, tw);  // its valid columns
  bf16* o_tile = out + ((int64_t)b * width + t0) * hd + (int64_t)h * D;
  float* part = reinterpret_cast<float*>(smem);
  if (nq <= 0) {  // past the row's valid columns: the same in every block of the cluster
    merge_store<bf16, D, QT, KSL>(cluster, part, o_tile, hd, tw, 0);
    return;
  }
  const int kend = min(st + nq, n_pages * page);  // keys 0 .. kend - 1: up to the frontier
  const int n_tiles = (kend + KT - 1) / KT;
  const int n_mine = rank < n_tiles ? (n_tiles - 1 - rank) / CL + 1 : 0;
  unsigned char* ring = smem;
  bf16* qs = reinterpret_cast<bf16*>(smem + ring_bytes<D, Q8>());  // (QT, DS)
  int32_t* pg = reinterpret_cast<int32_t*>(qs + QT * DS);          // the visited pages' ids

  if (n_mine > 0) {
    const int n_vis = (kend + page - 1) / page;
    for (int x = threadIdx.x; x < n_vis; x += THREADS) pg[x] = table[(int64_t)b * n_pages + x];
    const bf16* q_tile = q + ((int64_t)b * width + t0) * hd + (int64_t)h * D;
    for (int x = threadIdx.x; x < QT * CH; x += THREADS) {
      const int r = x / CH, c = (x % CH) * 8;
      tc::cp_async16(qs + r * DS + c, q_tile + (r < tw ? r * hd + c : 0), r < tw);
    }
  }
  __syncthreads();  // pg is read by every thread's copies

  // the rows of key tile kt into ring stage stg, by position through the
  // table; rows past the frontier zero-filled
  auto issue = [&](int kt, int stg) {
    const int k0 = kt * KT;
    if constexpr (Q8) {
      constexpr int C16 = D / 16;  // 16-byte chunks of an int8 row
      int8_t* kd = reinterpret_cast<int8_t*>(ring) + stg * stage8_bytes<D>();
      int8_t* vd = kd + KT * D;
      float* sd = reinterpret_cast<float*>(vd + KT * D);  // K scales, then V scales
      for (int x = threadIdx.x; x < KT * C16; x += THREADS) {
        const int r = x / C16, c = (x % C16) * 16, kp = k0 + r;
        const bool ok = kp < kend;
        const int64_t src = ok ? ((int64_t)pg[kp / page] * page + kp % page) * hd + h * D + c : 0;
        tc::cp_async16(kd + r * D + c, static_cast<const int8_t*>(k_pool) + src, ok);
        tc::cp_async16(vd + r * D + c, static_cast<const int8_t*>(v_pool) + src, ok);
      }
      for (int x = threadIdx.x; x < 2 * KT; x += THREADS) {
        const int r = x % KT, kp = k0 + r;
        const bool ok = kp < kend;
        const int64_t src = ok ? ((int64_t)pg[kp / page] * page + kp % page) * heads + h : 0;
        cp_async4(sd + x, (x < KT ? k_scale : v_scale) + src, ok);
      }
    } else {
      bf16* kd = reinterpret_cast<bf16*>(ring) + stg * 2 * TE;
      bf16* vd = kd + TE;
      for (int x = threadIdx.x; x < KT * CH; x += THREADS) {
        const int r = x / CH, c = (x % CH) * 8, kp = k0 + r;
        const bool ok = kp < kend;
        const int64_t src = ok ? ((int64_t)pg[kp / page] * page + kp % page) * hd + h * D + c : 0;
        tc::cp_async16(kd + r * DS + c, static_cast<const bf16*>(k_pool) + src, ok);
        tc::cp_async16(vd + r * DS + c, static_cast<const bf16*>(v_pool) + src, ok);
      }
    }
  };
  // the first STAGES - 1 tiles in flight, a commit group each (q rides
  // with the first)
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_mine) issue(rank + i * CL, i);
    tc::cp_async_commit();
  }

  // warp (qg, ks): query rows 16 qg .. 16 qg + 15, keys kb0 .. kb0 + KW - 1
  // of every tile
  const int qg = warp % QG, kb0 = (warp / QG) * KW;
  const bool live = 16 * qg < nq;  // the row group holds a valid column
  float o[D / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  uint32_t qf[KS][4];
  const int pos0 = st + 16 * qg + g;  // position of the thread's first row

  for (int i = 0; i < n_mine; ++i) {
    const int stg = i % STAGES, k0 = (rank + i * CL) * KT;
    tc::cp_async_wait<STAGES - 2>();  // tile i (and q with the first) has landed
    __syncthreads();  // ... for every thread; the stage of tile i - 1 is no longer read
    const int nxt = i + STAGES - 1;
    if (nxt < n_mine) issue(rank + nxt * CL, nxt % STAGES);
    tc::cp_async_commit();
    const bf16* kt_s;
    if constexpr (Q8) {
      const int8_t* kd = reinterpret_cast<const int8_t*>(smem) + stg * stage8_bytes<D>();
      const int8_t* vd = kd + KT * D;
      const float* sd = reinterpret_cast<const float*>(vd + KT * D);
      bf16* kb = reinterpret_cast<bf16*>(smem + STAGES * stage8_bytes<D>());
      for (int x = threadIdx.x; x < KT * CH; x += THREADS) {
        const int r = x / CH, c = (x % CH) * 8;
        *reinterpret_cast<uint4*>(kb + r * DS + c) =
            dequant8(*reinterpret_cast<const uint2*>(kd + r * D + c), sd[r]);
        *reinterpret_cast<uint4*>(kb + TE + r * DS + c) =
            dequant8(*reinterpret_cast<const uint2*>(vd + r * D + c), sd[KT + r]);
      }
      __syncthreads();  // the dequantized tiles are complete
      kt_s = kb;
    } else {
      kt_s = reinterpret_cast<const bf16*>(smem) + stg * 2 * TE;
    }
    const bf16* vt_s = kt_s + TE;
    if (!live) continue;
    if (i == 0)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) tc::load_a<D>(qf[kk], qs, 16 * qg, 16 * kk);

    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t kb[4];
        tc::load_b_rows<D>(kb, kt_s, kb0 + 16 * np, 16 * kk);
        tc::mma(s[2 * np], qf[kk], kb[0], kb[1]);
        tc::mma(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }

    // mask by position: element e of n-block j is row g + 8 (e / 2) of the
    // group, key k0 + kb0 + 8j + 2t + e % 2
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + kb0 + 8 * j + 2 * t + (e & 1);
        if (!(kp < kend && kp <= pos0 + 8 * (e >> 1))) s[j][e] = NEG_INF;
      }

    // online softmax over the quad's KW columns of rows g and g + 8
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float m2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float corr = expf(m[r] - m_new);  // exactly 1 when nothing new is visible
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
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = s[j][e];
        const float p = sv > 0.5f * NEG_INF ? tc::exp_diff(sv, m2[e >> 1]) : 0.f;
        l[e >> 1] += p;
        s[j][e] = p;
      }

    // O += P.V over the slice's keys, 16 at a time (P rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      uint32_t pa[4];
      tc::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        tc::load_b_cols<D>(vb, vt_s, kb0 + 16 * kk, 16 * dp);
        tc::mma(o[2 * dp], pa, vb[0], vb[1]);
        tc::mma(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // the warp's partials into slots 16 warp + g + 8r (= slice * QT + column)
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is no longer read: the partials take its place
  float* acc = part + 2 * SLOTS;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int slot = 16 * warp + g + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(acc + slot * acc_stride<D>() + 8 * j + 2 * t) =
          make_float2(o[j][2 * r], o[j][2 * r + 1]);
    if (t == 0) {
      part[slot] = m[r];
      part[SLOTS + slot] = l[r];
    }
  }
  cluster.sync();  // every block's partials are written and visible
  merge_store<bf16, D, QT, KSL>(cluster, part, o_tile, hd, tw, nq);
  cluster.sync();  // no block leaves while another reads its partials
}

// ------------------------------------------------ float32: CUDA cores

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One staged element of a page: a float32 value as is, or an int8 value
// times its (token, head) scale (paged_kv.dequant at float32)
__device__ __forceinline__ float load_elem(const float* p, int64_t i, const float*, int64_t) {
  return p[i];
}
__device__ __forceinline__ float load_elem(const int8_t* p, int64_t i, const float* scale,
                                           int64_t si) {
  return static_cast<float>(p[i]) * scale[si];
}

// floats of the float32 instance's shared memory: m and l (the partials'),
// then the page's correction, K and V pages (rows of d + 1), q and the
// scores; the partials' acc reuses everything after l
int f32_smem_bytes(int width, int d, int page) {
  const int wt = width < MAX_W ? width : MAX_W;
  const int walk = MAX_W + 2 * page * (d + 1) + wt * d + wt * page;
  const int merge = SLOTS * (d + 4);
  return 4 * (2 * SLOTS + (walk > merge ? walk : merge));
}

// S: the pools' storage type, float or int8_t (then k_scale / v_scale
// are the float32 scale pools; unused otherwise). One block: head
// blockIdx.x, row blockIdx.y, query tile blockIdx.z / CL of up to MAX_W
// columns, rank blockIdx.z % CL, which takes pages rank, rank + CL, ...
template <typename S, int D>
__global__ void __cluster_dims__(1, 1, CL) __launch_bounds__(THREADS) ragged_f32_kernel(
    const float* __restrict__ q, const S* __restrict__ k_pool,
    const S* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ table,
    const int32_t* __restrict__ start, const int32_t* __restrict__ length,
    float* __restrict__ out, int width, int heads, int page, int n_pages) {
  extern __shared__ __align__(16) float fsmem[];
  constexpr int DP = D + 1;           // padded page row
  constexpr int G = THREADS / D;      // query rows covered per pass
  constexpr int R = (MAX_W + G - 1) / G;

  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t hd = (int64_t)heads * D;
  const int t0 = (blockIdx.z / CL) * MAX_W;   // the tile's first column
  const int tw = min(width - t0, MAX_W);      // its columns
  const int wt = min(width, MAX_W);           // tile width of the smem layout
  const int st = start[b] + t0;               // position of the tile's column 0
  const int nq = min(max(length[b], 1) - t0, tw);  // valid columns of the tile
  const int last_pos = st + nq - 1;
  float* o_tile = out + ((int64_t)b * width + t0) * hd + (int64_t)h * D;
  if (nq <= 0) {  // the whole tile lies past the row's valid columns
    merge_store<float, D, MAX_W, 1>(cluster, fsmem, o_tile, hd, tw, 0);
    return;
  }

  float* m_s = fsmem;                 // (MAX_W) running max
  float* l_s = m_s + SLOTS;           // (MAX_W) running denominator
  float* c_s = l_s + SLOTS;           // (MAX_W) this page's correction
  float* ks = c_s + MAX_W;            // (page, DP)
  float* vs = ks + page * DP;         // (page, DP)
  float* qs = vs + page * DP;         // (wt, D)
  float* ps = qs + wt * D;            // (wt, page) scores, then probs

  const float* q_row = q + ((int64_t)b * width + t0) * hd + (int64_t)h * D;
  for (int x = tid; x < nq * D; x += THREADS) qs[x] = q_row[(int64_t)(x / D) * hd + x % D];
  for (int i = tid; i < nq; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  const int kc = tid % D, rg = tid / D;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  const int n_visit = min(n_pages, last_pos / page + 1);
  for (int j = rank; j < n_visit; j += CL) {
    const int64_t gp = table[(int64_t)b * n_pages + j];
    const int kn = min(page, last_pos - j * page + 1);  // rows to load
    __syncthreads();  // the previous page's tiles are no longer read
    const S* kp = k_pool + gp * page * hd + (int64_t)h * D;
    const S* vp = v_pool + gp * page * hd + (int64_t)h * D;
    const int64_t s0 = gp * page * heads + h;  // scale of the page's row 0, this head
    for (int x = tid; x < kn * D; x += THREADS) {
      const int r = x / D, c = x % D;
      const int64_t si = s0 + (int64_t)r * heads;
      ks[r * DP + c] = load_elem(kp, (int64_t)r * hd + c, k_scale, si);
      vs[r * DP + c] = load_elem(vp, (int64_t)r * hd + c, v_scale, si);
    }
    __syncthreads();

    // scores: thread c owns key c of the page
    for (int c = tid; c < page; c += THREADS) {
      const int kpos = j * page + c;
      for (int i = 0; i < nq; ++i) {
        float s = NEG_INF;
        if (c < kn && kpos <= st + i) {
          s = 0.f;
#pragma unroll 16
          for (int e = 0; e < D; ++e) s = fmaf(qs[i * D + e], ks[c * DP + e], s);
        }
        ps[i * page + c] = s;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int i = warp; i < nq; i += THREADS / 32) {
      float mx = NEG_INF;
      for (int c = lane; c < page; c += 32) mx = fmaxf(mx, ps[i * page + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < page; c += 32) {
        const float s = ps[i * page + c];
        const float p = s > 0.5f * NEG_INF ? expf(s - m_new) : 0.f;
        sum += p;
        ps[i * page + c] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[i] = l_s[i] * corr + sum;
        m_s[i] = m_new;
        c_s[i] = corr;
      }
    }
    __syncthreads();

    // acc[i, kc] = acc * corr + sum_c p[i, c] * v[c, kc]
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = rg + r * G;
      if (i < nq) {
        float a = acc[r] * c_s[i];
        for (int c = 0; c < kn; ++c) a = fmaf(ps[i * page + c], vs[c * DP + kc], a);
        acc[r] = a;
      }
    }
  }

  __syncthreads();  // every page is done: acc's partials take the pages' place
  float* pacc = fsmem + 2 * SLOTS;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = rg + r * G;
    if (i < nq) pacc[i * acc_stride<D>() + kc] = acc[r];
  }
  cluster.sync();  // every block's partials are written and visible
  merge_store<float, D, MAX_W, 1>(cluster, fsmem, o_tile, hd, tw, nq);
  cluster.sync();  // no block leaves while another reads its partials
}

// ------------------------------------------------------------- launch

int set_smem(const void* kernel, int smem) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > smem_max) return -1;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *table, *start, *length;
  void* out;
  int batch, width, heads, page, n_pages;
  cudaStream_t stream;
};

template <int D, int QG, bool Q8>
int launch_tc(const Args& a) {
  if (!tc::aligned16({a.q, a.k, a.v, a.out})) return -1;
  const int smem = tc_smem_bytes<D, QG, Q8>(a.n_pages);
  const int err = set_smem((const void*)ragged_tc_kernel<D, QG, Q8>, smem);
  if (err != 0) return err;
  const int tiles = (a.width + 16 * QG - 1) / (16 * QG);
  ragged_tc_kernel<D, QG, Q8><<<dim3(a.heads, a.batch, tiles * CL), THREADS, smem, a.stream>>>(
      (const bf16*)a.q, a.k, a.v, (const float*)a.k_scale, (const float*)a.v_scale,
      (const int32_t*)a.table, (const int32_t*)a.start, (const int32_t*)a.length,
      (bf16*)a.out, a.width, a.heads, a.page, a.n_pages);
  return (int)cudaGetLastError();
}

template <typename S, int D>
int launch_f32(const Args& a) {
  const int smem = f32_smem_bytes(a.width, D, a.page);
  const int err = set_smem((const void*)ragged_f32_kernel<S, D>, smem);
  if (err != 0) return err;
  const int tiles = (a.width + MAX_W - 1) / MAX_W;
  ragged_f32_kernel<S, D><<<dim3(a.heads, a.batch, tiles * CL), THREADS, smem, a.stream>>>(
      (const float*)a.q, (const S*)a.k, (const S*)a.v, (const float*)a.k_scale,
      (const float*)a.v_scale, (const int32_t*)a.table, (const int32_t*)a.start,
      (const int32_t*)a.length, (float*)a.out, a.width, a.heads, a.page, a.n_pages);
  return (int)cudaGetLastError();
}

// dtype 0: float32 q, output (and unquantized pools); 1: bfloat16
template <int D, bool Q8>
int launch_d(const Args& a, int dtype) {
  if (dtype == 0) return launch_f32<typename std::conditional<Q8, int8_t, float>::type, D>(a);
  if (dtype != 1) return -1;
  return a.width <= 16 ? launch_tc<D, 1, Q8>(a) : launch_tc<D, 4, Q8>(a);
}

template <bool Q8>
int dispatch(const Args& a, int dim_head, int dtype) {
  if (a.width < 1 || a.batch < 1 || a.heads < 1 || a.page < 1 || a.n_pages < 1) return -1;
  switch (dim_head) {
    case 32: return launch_d<32, Q8>(a, dtype);
    case 64: return launch_d<64, Q8>(a, dtype);
    case 128: return launch_d<128, Q8>(a, dtype);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the output and, unquantized, the
// pools). Returns cudaGetLastError() after the launch (0 on success), or
// -1 for a shape the kernel cannot take: a dim_head other than
// 32/64/128, a dtype code other than 0/1, bf16 tensors that are not
// 16-byte aligned, or tiles that exceed the card's shared memory per
// block (float32: a (dim_head, page) whose pages do not fit).
extern "C" int ragged_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* start, const void* length, void* out, int batch, int width,
    int heads, int dim_head, int page, int n_pages, int dtype, void* stream) {
  const Args a{q, k_pool, v_pool, nullptr, nullptr, table, start, length, out,
               batch, width, heads, page, n_pages, (cudaStream_t)stream};
  return dispatch<false>(a, dim_head, dtype);
}

// Int8 pools with float32 scale pools (pages, page, heads); dtype is the
// compute type of q and the output, as above. Same returns.
extern "C" int ragged_attention_fwd_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, const void* start,
    const void* length, void* out, int batch, int width, int heads,
    int dim_head, int page, int n_pages, int dtype, void* stream) {
  const Args a{q, k_pool, v_pool, k_scale, v_scale, table, start, length, out,
               batch, width, heads, page, n_pages, (cudaStream_t)stream};
  return dispatch<true>(a, dim_head, dtype);
}
