// Block-sparse pair-grid attention for Hopper (sm_90a): forward, dq and
// dk/dv.
//
// Replaces the Pallas TPU kernels `_fwd_kernel`, `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` behind `block_sparse_attention` (`_pair_attention`) in
// dalle_pytorch_tpu/ops/block_sparse_attention.py. Python wrappers:
// dalle_pytorch_tpu_torch/ops/block_sparse_attention.py
// (block_sparse_attention, block_sparse_dq, block_sparse_dkdv).
//
// What it computes. q, k, v, o, do contiguous (b, h, n, d); a layout of
// 128 x 128 blocks over n_pad = 128 * ceil(n / 128) rows: the int8
// (n_pad, n_pad) may-attend mask (zero past n), a (5, P) int32 pair table
// whose rows are q block, k block, class (0 synthetic, 1 partial,
// 2 dense), first, last, and the (blocks + 1) offsets of each block's
// contiguous run in it (q-major for the forward and dq, k-major for
// dk/dv); for the float32 forward and dq also the int8 (n_pad / 64,
// n_pad / 32) per-half class map of ops/block_sparse_attention.py:
// half_classes (0 pass over, 1 the mask decides, 2 dense) and an int32
// order of the 64-row query tiles (longest row first; NULL: in order).
// Optional (b, n) uint8 key mask. Scores q.k^T accumulate in
// float32 and are scaled afterwards; a class 2 pair skips the mask, a
// class 1 pair applies it, a class 0 pair masks everything, and the key
// mask applies on top. Disallowed scores are NEG_INF = -1e30 and
// p = exp(s - m) only where s > 0.5 * NEG_INF, else 0.
//   forward: online softmax over the run (float32 max, denominator and
//     accumulator), p rounded to the storage type before the value
//     product; o = acc / l (l = 1 where l == 0, so a row with no allowed
//     key writes exactly 0), lse = m + log(l) as (b, h, n) float32;
//   dq: delta = rowsum(do * o) in float32 (written for the dk/dv pass),
//     p = exp(s - lse), dp = do . v^T, ds = p * (dp - delta) * scale
//     rounded to the storage type, dq = ds . k;
//   dk/dv: dv = p (rounded to the storage type)^T . do, dk = ds^T . q.
// Every product accumulates in float32; rows past n are neither read
// (they load as 0) nor written.
//
// What bounds it. At the flagship training shape (b 4, 16 heads of 64,
// n 1280, float32) the axial_row and conv_like masks allow ~0.4 of the
// causal (query, key) pairs: the operations (2 products a pair forward,
// 3 dq, 4 dk/dv, 2*d each) take ~0.08, ~0.11 and ~0.15 ms at the card's 67
// TFLOP/s float32 rate on the CUDA cores, ~0.03, ~0.05 and ~0.06 ms at its
// tensor cores' 495 / 3 TFLOP/s as split 3xTF32, against ~0.03-0.05 ms of
// bytes (q, k, v, o, do and the gradients once each): operations bound
// it. The design keeps every score on chip and walks only the live block
// pairs; a sub-tile whose keys are all masked, or whose mask tile is
// empty, is skipped (it would add p = 0 and leave every sum as it is), so
// the work follows the mask, not the 128-block grid. There are no float
// atomics: the dk/dv pass owns its key rows and walks the k-major table,
// so two runs give bit-identical gradients.
//
// Two designs. The bfloat16 instances run float32 FMAs on the CUDA cores
// from shared memory: one block of 256 threads per (64-row half of a
// 128-block, b*h), the forward and dq walking the q block's run, dk/dv
// the k block's, in 64 x 64 sub-tiles of attention_tiles.cuh, shared
// with flash_attention.cu. The float32 instances run every product as
// split 3xTF32 mma.sync on the tensor cores, in the sweeps of
// tf32_sweeps.cuh that the tiled flash kernels run: blocks of 4 warps,
// grid (b*h, n_pad / 64).
//  - forward and dq (bs_fwd_tf32_kernel, bs_dq_tf32_kernel): a 64-row
//    query tile resident (Q, and dO for dq), the 32-key halves of its row
//    of the class map streamed through a 2-stage cp.async ring (keys past
//    n zero-filled, nothing read), a class 1 half's (64, 32) tile of the
//    int8 mask fetched by cp.async with it; empty halves are passed over
//    by a warp ballot on the map, with no load and no barrier. The
//    forward's online softmax runs on the score accumulators, O = O *
//    corr + P.V and dQ += dS.K fold a fresh partial per half
//    (tf32::fold_product), since the tensor cores truncate as they
//    accumulate; query tiles start longest row first.
//  - dk/dv (bs_dkdv_tf32_kernel): the 64-key half of a 128-key block
//    resident (K and V), the 32-row query halves of its k-major pair run
//    streamed, each class 1 half's (32, 64) tile of the int8 mask loaded
//    and tested before its half is issued, dV += P^T.dO and dK += dS^T.Q
//    folded per half.

#include <type_traits>

#include "attention_tiles.cuh"
#include "tf32_sweeps.cuh"

namespace {

constexpr int BLOCK = 128;        // the layout's block edge
constexpr int SUB = BLOCK / TILE; // sub-tiles per block edge

// lse and delta of query rows q0 .. q0 + TILE - 1 into shared memory
__device__ __forceinline__ void load_row_stats(float* __restrict__ lse_s,
                                               float* __restrict__ del_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int q0, int n) {
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const int row = q0 + r;
    lse_s[r] = row < n ? lse[row] : 0.f;
    del_s[r] = row < n ? delta[row] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) bs_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ kmask, const int8_t* __restrict__ mask,
    const int* __restrict__ table, const int* __restrict__ offsets,
    T* __restrict__ out, float* __restrict__ lse, int heads, int n, int n_pad,
    int n_pairs, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int CJ = D / 16;
  uint8_t* msk = smem_raw;                                   // (TILE, TILE)
  float* qs = reinterpret_cast<float*>(smem_raw + MASK_BYTES); // (TILE, DP)
  float* ks = qs + tile_floats<D>();                         // (TILE, DP)
  float* vs = ks + tile_floats<D>();                         // (TILE, DP)
  float* ps = vs + tile_floats<D>();                         // (TILE, SP)
  float* kok = ps + TILE * SP;                               // (TILE)

  const int q0 = blockIdx.x * TILE, bh = blockIdx.y;
  if (q0 >= n) return;  // padding rows only
  const int qb = q0 / BLOCK;
  const int64_t head = (int64_t)bh * n * D;
  const uint8_t* km = kmask == nullptr ? nullptr : kmask + (int64_t)(bh / heads) * n;

  float acc[4][CJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }

  bool q_loaded = false;
  const int p_end = offsets[qb + 1];
  for (int p = offsets[qb]; p < p_end; ++p) {
    const int cls = table[2 * n_pairs + p];
    if (cls == 0) continue;  // synthetic: every score masked, nothing changes
    const int kb = table[n_pairs + p];
    for (int sub = 0; sub < SUB; ++sub) {
      const int k0 = kb * BLOCK + sub * TILE;
      if (k0 >= n) break;
      __syncthreads();  // the previous tiles are no longer read
      // a sub-tile with no allowed pair adds p = 0 and leaves m, l and acc
      // exactly as they are: it is skipped
      if (!load_key_flags(kok, km, k0, n)) continue;
      if (cls == 1 && !load_mask_tile(msk, mask, q0, k0, n_pad)) continue;
      if (!q_loaded) {
        load_tile<T, D>(qs, q + head, q0, n);
        q_loaded = true;
      }
      load_tile<T, D>(ks, k + head, k0, n);
      load_tile<T, D>(vs, v + head, k0, n);
      __syncthreads();
      fwd_step<T, D>(qs, ks, vs, ps, kok, msk, true, cls, q0, k0, n, scale, acc, m, l);
    }
  }
  fwd_finish<T, D>(acc, m, l, out + head, lse + (int64_t)bh * n, q0, n);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) bs_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, const uint8_t* __restrict__ kmask,
    const int8_t* __restrict__ mask, const int* __restrict__ table,
    const int* __restrict__ offsets, T* __restrict__ dq,
    float* __restrict__ delta, int heads, int n, int n_pad, int n_pairs,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int CJ = D / 16;
  uint8_t* msk = smem_raw;                                   // (TILE, TILE)
  float* qs = reinterpret_cast<float*>(smem_raw + MASK_BYTES); // (TILE, DP)
  float* dos = qs + tile_floats<D>();                        // (TILE, DP)
  float* ks = dos + tile_floats<D>();                        // (TILE, DP)
  float* vs = ks + tile_floats<D>();                         // (TILE, DP)
  float* dss = vs + tile_floats<D>();                        // (TILE, SP)
  float* lse_s = dss + TILE * SP;                            // (TILE)
  float* del_s = lse_s + TILE;                               // (TILE)
  float* kok = del_s + TILE;                                 // (TILE)

  const int q0 = blockIdx.x * TILE, bh = blockIdx.y;
  if (q0 >= n) return;
  const int qb = q0 / BLOCK;
  const int64_t head = (int64_t)bh * n * D;
  const uint8_t* km = kmask == nullptr ? nullptr : kmask + (int64_t)(bh / heads) * n;

  // delta = rowsum(do * o) in float32 for this tile's rows, one warp a
  // row; the dk/dv pass reads it from `delta`
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < TILE; r += THREADS / 32) {
    const int row = q0 + r;
    float sum = 0.f;
    if (row < n) {
      for (int e = lane; e < D; e += 32)
        sum += to_f32<T>(o[head + (int64_t)row * D + e]) *
               to_f32<T>(dout[head + (int64_t)row * D + e]);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
    if (lane == 0) {
      del_s[r] = sum;
      lse_s[r] = row < n ? lse[(int64_t)bh * n + row] : 0.f;
      if (row < n) delta[(int64_t)bh * n + row] = sum;
    }
  }

  float acc[4][CJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[a][c] = 0.f;

  bool q_loaded = false;
  const int p_end = offsets[qb + 1];
  for (int p = offsets[qb]; p < p_end; ++p) {
    const int cls = table[2 * n_pairs + p];
    if (cls == 0) continue;
    const int kb = table[n_pairs + p];
    for (int sub = 0; sub < SUB; ++sub) {
      const int k0 = kb * BLOCK + sub * TILE;
      if (k0 >= n) break;
      __syncthreads();  // the previous tiles are no longer read
      if (!load_key_flags(kok, km, k0, n)) continue;
      if (cls == 1 && !load_mask_tile(msk, mask, q0, k0, n_pad)) continue;
      if (!q_loaded) {
        load_tile<T, D>(qs, q + head, q0, n);
        load_tile<T, D>(dos, dout + head, q0, n);
        q_loaded = true;
      }
      load_tile<T, D>(ks, k + head, k0, n);
      load_tile<T, D>(vs, v + head, k0, n);
      __syncthreads();
      scores_to_p_ds<T, D>(qs, ks, vs, dos, lse_s, del_s, kok, msk, true, cls, nullptr,
                           dss, q0, k0, n, scale);
      __syncthreads();
      dq_step<D>(dss, ks, acc);
    }
  }
  store_rows<T, D>(acc, dq + head, q0, n);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) bs_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ kmask,
    const int8_t* __restrict__ mask, const int* __restrict__ table,
    const int* __restrict__ offsets, T* __restrict__ dk, T* __restrict__ dv,
    int heads, int n, int n_pad, int n_pairs, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int CJ = D / 16;
  uint8_t* msk = smem_raw;                                   // (TILE, TILE)
  float* ks = reinterpret_cast<float*>(smem_raw + MASK_BYTES); // (TILE, DP)
  float* vs = ks + tile_floats<D>();                         // (TILE, DP)
  float* qs = vs + tile_floats<D>();                         // (TILE, DP)
  float* dos = qs + tile_floats<D>();                        // (TILE, DP)
  float* ps = dos + tile_floats<D>();                        // (TILE, SP)
  float* dss = ps + TILE * SP;                               // (TILE, SP)
  float* lse_s = dss + TILE * SP;                            // (TILE)
  float* del_s = lse_s + TILE;                               // (TILE)
  float* kok = del_s + TILE;                                 // (TILE)

  const int k0 = blockIdx.x * TILE, bh = blockIdx.y;
  if (k0 >= n) return;
  const int kb = k0 / BLOCK;
  const int64_t head = (int64_t)bh * n * D;
  const uint8_t* km = kmask == nullptr ? nullptr : kmask + (int64_t)(bh / heads) * n;

  float dk_acc[4][CJ], dv_acc[4][CJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  // keys that are all masked have p = 0 for every query: dk = dv = 0
  if (load_key_flags(kok, km, k0, n)) {
    load_tile<T, D>(ks, k + head, k0, n);
    load_tile<T, D>(vs, v + head, k0, n);
    const int p_end = offsets[kb + 1];
    for (int p = offsets[kb]; p < p_end; ++p) {
      const int cls = table[2 * n_pairs + p];
      if (cls == 0) continue;
      const int qb = table[p];
      for (int sub = 0; sub < SUB; ++sub) {
        const int q0 = qb * BLOCK + sub * TILE;
        if (q0 >= n) break;
        __syncthreads();  // the previous query tile is no longer read
        if (cls == 1 && !load_mask_tile(msk, mask, q0, k0, n_pad)) continue;
        load_tile<T, D>(qs, q + head, q0, n);
        load_tile<T, D>(dos, dout + head, q0, n);
        load_row_stats(lse_s, del_s, lse + (int64_t)bh * n, delta + (int64_t)bh * n, q0, n);
        __syncthreads();
        scores_to_p_ds<T, D>(qs, ks, vs, dos, lse_s, del_s, kok, msk, true, cls, ps, dss,
                             q0, k0, n, scale);
        __syncthreads();
        dkdv_step<D>(ps, dss, dos, qs, dk_acc, dv_acc);
      }
    }
  }
  store_rows<T, D>(dk_acc, dk + head, k0, n);
  store_rows<T, D>(dv_acc, dv + head, k0, n);
}

// The query tile of launch row y: order[y], or y without an order
__device__ __forceinline__ int tile_of(const int* __restrict__ order, int y) {
  return order == nullptr ? y : order[y];
}

// o and lse in float32 of query tile tile_of(order, blockIdx.y) of head
// blockIdx.x: tf32::fwd_sweep over its row of the class map
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 3 : 1) bs_fwd_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ kmask, const int8_t* __restrict__ mask,
    const int8_t* __restrict__ halves, const int* __restrict__ order, float* __restrict__ out,
    float* __restrict__ lse, int heads, int n, int n_pad, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, qt = tile_of(order, blockIdx.y), q0 = qt * TILE;
  if (q0 >= n) return;  // padding rows only
  const int64_t head = (int64_t)bh * n * D;
  tf32::Head a{};
  a.q = q + head, a.k = k + head, a.v = v + head;
  a.km = kmask == nullptr ? nullptr : kmask + (int64_t)(bh / heads) * n;
  a.out = out + head, a.lse_out = lse + (int64_t)bh * n;
  a.n = n, a.scale = scale;
  const tf32::HalfRow walk{halves + (int64_t)qt * (n_pad / tf32::SROWS), mask, n, n_pad, q0};
  tf32::fwd_sweep<D>(a, walk, smem_raw);
}

// dq in float32 of query tile tile_of(order, blockIdx.y) of head
// blockIdx.x: tf32::dq_sweep over its row of the class map; delta from do
// and o, written for the dk/dv pass
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 2 : 1) bs_dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ lse, const uint8_t* __restrict__ kmask,
    const int8_t* __restrict__ mask, const int8_t* __restrict__ halves,
    const int* __restrict__ order, float* __restrict__ dq, float* __restrict__ delta,
    int heads, int n, int n_pad, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, qt = tile_of(order, blockIdx.y), q0 = qt * TILE;
  if (q0 >= n) return;  // padding rows only
  const int64_t head = (int64_t)bh * n * D, rows = (int64_t)bh * n;
  tf32::Head a{};
  a.q = q + head, a.k = k + head, a.v = v + head, a.o = o + head, a.dout = dout + head;
  a.lse = lse + rows;
  a.km = kmask == nullptr ? nullptr : kmask + (int64_t)(bh / heads) * n;
  a.dq = dq + head, a.delta_out = delta + rows;
  a.n = n, a.scale = scale;
  const tf32::HalfRow walk{halves + (int64_t)qt * (n_pad / tf32::SROWS), mask, n, n_pad, q0};
  tf32::dq_sweep<D>(a, walk, smem_raw);
}

// dk and dv in float32 of the 64-key half blockIdx.y of a 128-key block
// of head blockIdx.x: tf32::dkdv_sweep over the block's k-major pair run,
// each q block's 32-row halves below n whose mask tile is not empty, on
// the dq pass's lse and delta
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 2 : 1) bs_dkdv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ kmask,
    const int8_t* __restrict__ mask, const int* __restrict__ table,
    const int* __restrict__ offsets, float* __restrict__ dk, float* __restrict__ dv,
    int heads, int n, int n_pad, int n_pairs, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, k0 = blockIdx.y * TILE;
  if (k0 >= n) return;  // padding keys only
  const int kb = k0 / BLOCK;
  const int64_t head = (int64_t)bh * n * D, rows = (int64_t)bh * n;
  const tf32::Head a{q + head,    k + head,     v + head,  nullptr, dout + head,
                     lse + rows,  delta + rows,
                     kmask == nullptr ? nullptr : kmask + (int64_t)(bh / heads) * n,
                     nullptr,     dk + head,    dv + head, nullptr, n,
                     scale};
  const tf32::PairRun walk{table, mask, n_pairs, n, n_pad, k0, 4 * offsets[kb],
                           4 * offsets[kb + 1]};
  tf32::dkdv_sweep<D, false>(a, walk, k0, smem_raw);
}

// shapes every entry point refuses (-1): an empty shape, a block other
// than 128, n_pad that is not ceil(n / 128) * 128, more rows of b*h than
// a grid dimension holds
bool refused(int batch, int heads, int n, int n_pad, int block, int n_pairs) {
  return batch < 1 || heads < 1 || n < 1 || n_pairs < 1 || block != BLOCK ||
         n_pad != (n + BLOCK - 1) / BLOCK * BLOCK ||
         (int64_t)batch * heads > 65535;
}

dim3 grid_of(int batch, int heads, int n_pad) {
  return dim3(n_pad / TILE, batch * heads);
}

// The float32 instances' grid: (b*h, n_pad / TILE), as the tiled kernels'
dim3 tf32_grid_of(int batch, int heads, int n_pad) {
  static_assert(TILE == tf32::ROWS && BLOCK == tf32::PairRun::BLOCK, "the sweeps' tiles");
  return dim3(batch * heads, n_pad / TILE);
}

// float32: the split-3xTF32 kernel on the class map (the table and
// offsets are the bf16 instance's); -1 without a class map or for an
// operand not 16-byte aligned
template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, const void* kmask,
        const void* mask, const void* table, const void* offsets, const void* halves,
        const void* order, void* out, void* lse, int batch, int heads, int n, int n_pad,
        int n_pairs, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (halves == nullptr || !tc::aligned16({q, k, v, mask, out})) return -1;
    constexpr int smem = tf32::fwd_sweep_smem_bytes(D, true);
    int err = allow_smem(bs_fwd_tf32_kernel<D>, smem);
    if (err != 0) return err;
    bs_fwd_tf32_kernel<D><<<tf32_grid_of(batch, heads, n_pad), tc::THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const uint8_t*)kmask,
        (const int8_t*)mask, (const int8_t*)halves, (const int*)order, (float*)out,
        (float*)lse, heads, n, n_pad, scale);
  } else {
    constexpr int smem = fwd_smem_bytes<D>();
    int err = allow_smem(bs_fwd_kernel<T, D>, smem);
    if (err != 0) return err;
    bs_fwd_kernel<T, D><<<grid_of(batch, heads, n_pad), THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)kmask,
        (const int8_t*)mask, (const int*)table, (const int*)offsets, (T*)out,
        (float*)lse, heads, n, n_pad, n_pairs, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const void* lse, const void* kmask, const void* mask,
       const void* table, const void* offsets, const void* halves, const void* order,
       void* dq_out, void* delta, int batch, int heads, int n, int n_pad, int n_pairs,
       float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (halves == nullptr || !tc::aligned16({q, k, v, o, dout, mask, dq_out})) return -1;
    constexpr int smem = tf32::dq_sweep_smem_bytes(D, true);
    int err = allow_smem(bs_dq_tf32_kernel<D>, smem);
    if (err != 0) return err;
    bs_dq_tf32_kernel<D><<<tf32_grid_of(batch, heads, n_pad), tc::THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)o,
        (const float*)dout, (const float*)lse, (const uint8_t*)kmask, (const int8_t*)mask,
        (const int8_t*)halves, (const int*)order, (float*)dq_out, (float*)delta, heads, n,
        n_pad, scale);
  } else {
    constexpr int smem = dq_smem_bytes<D>();
    int err = allow_smem(bs_dq_kernel<T, D>, smem);
    if (err != 0) return err;
    bs_dq_kernel<T, D><<<grid_of(batch, heads, n_pad), THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
        (const float*)lse, (const uint8_t*)kmask, (const int8_t*)mask,
        (const int*)table, (const int*)offsets, (T*)dq_out, (float*)delta,
        heads, n, n_pad, n_pairs, scale);
  }
  return (int)cudaGetLastError();
}

// float32: the split-3xTF32 kernel; -1 for an operand not 16-byte
// aligned
template <typename T, int D>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, const void* kmask, const void* mask,
         const void* table, const void* offsets, void* dk, void* dv, int batch,
         int heads, int n, int n_pad, int n_pairs, float scale,
         cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (!tc::aligned16({q, k, v, dout, mask, dk, dv})) return -1;
    constexpr int smem = tf32::dkdv_sweep_smem_bytes(D, true, false);
    int err = allow_smem(bs_dkdv_tf32_kernel<D>, smem);
    if (err != 0) return err;
    bs_dkdv_tf32_kernel<D><<<tf32_grid_of(batch, heads, n_pad), tc::THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (const uint8_t*)kmask, (const int8_t*)mask,
        (const int*)table, (const int*)offsets, (float*)dk, (float*)dv, heads, n, n_pad,
        n_pairs, scale);
  } else {
    constexpr int smem = dkdv_smem_bytes<D>();
    int err = allow_smem(bs_dkdv_kernel<T, D>, smem);
    if (err != 0) return err;
    bs_dkdv_kernel<T, D><<<grid_of(batch, heads, n_pad), THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
        (const float*)delta, (const uint8_t*)kmask, (const int8_t*)mask,
        (const int*)table, (const int*)offsets, (T*)dk, (T*)dv, heads, n,
        n_pad, n_pairs, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Instances: dtype 0 = float32, 1 = bfloat16; dim_head 32, 64, 128.
#define BS_DISPATCH(FN, ...)                                              \
  switch (dtype * 1000 + dim_head) {                                      \
    case 32: return FN<float, 32>(__VA_ARGS__);                           \
    case 64: return FN<float, 64>(__VA_ARGS__);                           \
    case 128: return FN<float, 128>(__VA_ARGS__);                         \
    case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);                 \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                 \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                \
    default: return -1;                                                   \
  }

// Every entry point: q, k, v (and o, do, dq, dk, dv) contiguous
// (b, h, n, dim_head) of one type; lse and delta (b, h, n) float32; kmask
// (b, n) uint8 or NULL; mask (n_pad, n_pad) int8; table (5, n_pairs) and
// offsets int32 (q-major with nq + 1 offsets for fwd and dq, k-major with
// nk + 1 for dkdv); for fwd and dq the (n_pad / 64, n_pad / 32) int8
// class map `halves` (read by the float32 instances) and the (n_pad / 64)
// int32 tile order or NULL. One launch on `stream`. Returns
// cudaGetLastError() after it (0 on success), or -1 for what the kernels
// cannot take: a dim_head other than 32/64/128, a dtype code other than
// 0/1, a block other than 128, an empty shape, more (batch, head) pairs
// than a grid dimension holds, or (float32) an operand not 16-byte
// aligned or no class map.
extern "C" int block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, const void* kmask,
    const void* mask, const void* table, const void* offsets, const void* halves,
    const void* order, void* out, void* lse, int batch, int heads, int n, int n_pad,
    int dim_head, int block, int n_pairs, float scale, int dtype, void* stream) {
  if (refused(batch, heads, n, n_pad, block, n_pairs)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  BS_DISPATCH(fwd, q, k, v, kmask, mask, table, offsets, halves, order, out, lse, batch,
              heads, n, n_pad, n_pairs, scale, s)
}

// delta is written here (rowsum(do * o) per row and head) for
// block_sparse_attention_dkdv.
extern "C" int block_sparse_attention_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* kmask, const void* mask,
    const void* table, const void* offsets, const void* halves, const void* order,
    void* dq_out, void* delta, int batch, int heads, int n, int n_pad, int dim_head,
    int block, int n_pairs, float scale, int dtype, void* stream) {
  if (refused(batch, heads, n, n_pad, block, n_pairs)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  BS_DISPATCH(dq, q, k, v, o, dout, lse, kmask, mask, table, offsets, halves, order,
              dq_out, delta, batch, heads, n, n_pad, n_pairs, scale, s)
}

extern "C" int block_sparse_attention_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kmask, const void* mask,
    const void* table, const void* offsets, void* dk, void* dv, int batch,
    int heads, int n, int n_pad, int dim_head, int block, int n_pairs,
    float scale, int dtype, void* stream) {
  if (refused(batch, heads, n, n_pad, block, n_pairs)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  BS_DISPATCH(dkdv, q, k, v, dout, lse, delta, kmask, mask, table, offsets,
              dk, dv, batch, heads, n, n_pad, n_pairs, scale, s)
}
