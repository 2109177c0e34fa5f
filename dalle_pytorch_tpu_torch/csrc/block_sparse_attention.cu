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
// dk/dv). Optional (b, n) uint8 key mask. Scores q.k^T accumulate in
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
// 5 backward, 2*d each) take ~0.08 ms forward and ~0.2 ms backward at the
// card's 67 TFLOP/s float32 rate, against ~0.03-0.05 ms of bytes (q, k,
// v, o, do and the gradients once each): operations bound it. The design
// keeps every score on chip and walks only the live block pairs, in
// 64 x 64 sub-tiles; a sub-tile whose keys are all masked, or whose
// mask block is empty, is skipped (it would add p = 0 and leave every
// sum as it is), so the work follows the mask, not the 128-block grid.
// There are no float atomics: the dk/dv pass owns its key rows and walks
// the k-major table, so two runs give bit-identical gradients. The
// products run as float32 FMAs on the CUDA cores from shared memory; the
// tensor cores (mma.sync / wgmma bf16 tiles) and cp.async/TMA double
// buffering are the known next steps.
//
// Layout: one block of 256 threads per (64-row half of a 128-block, b*h):
// the forward and dq walk the q block's run, dk/dv the k block's. Tiles
// are 64 x d floats in shared memory with a padded row stride of d + 1;
// thread (ty, tx), 16 x 16, owns rows ty + 16*a and columns tx + 16*j of
// a 64 x 64 score tile and rows ty + 16*a, channels tx + 16*c of its
// accumulators; a row's 16 owners share a half-warp, so the forward's row
// max and sum reduce with shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BLOCK = 128;        // the layout's block edge
constexpr int TILE = 64;          // query rows / keys per sub-tile
constexpr int SUB = BLOCK / TILE; // sub-tiles per block edge
constexpr int SP = TILE + 1;      // padded stride of the (TILE, TILE) p and ds tiles
constexpr int THREADS = 256;
constexpr int MASK_BYTES = TILE * TILE;
static_assert(THREADS == TILE * 4, "one 16-byte mask chunk per thread");

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round a float32 to the storage type and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// rows row0 .. row0 + TILE - 1 of one head's contiguous (n, D) rows into a
// (TILE, D + 1) float tile; rows past the sequence end are 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int row0,
                                          int n) {
  constexpr int DP = D + 1;
  for (int x = threadIdx.x; x < TILE * D; x += THREADS) {
    const int r = x / D, e = x % D;
    const int row = row0 + r;
    dst[r * DP + e] = row < n ? to_f32<T>(src[(int64_t)row * D + e]) : 0.f;
  }
}

// keys k0 .. k0 + TILE - 1 that exist and pass the key mask (kmask_b is
// the batch row's mask or NULL), into kok; true on every thread when any
// does
__device__ __forceinline__ bool load_key_flags(float* __restrict__ kok,
                                               const uint8_t* __restrict__ kmask_b,
                                               int k0, int n) {
  int any_key = 0;
  for (int c = threadIdx.x; c < TILE; c += THREADS) {
    const int col = k0 + c;
    kok[c] = (col < n && (kmask_b == nullptr || kmask_b[col] != 0)) ? 1.f : 0.f;
    any_key |= kok[c] != 0.f;
  }
  return __syncthreads_or(any_key) != 0;
}

// the (TILE, TILE) block of the (n_pad, n_pad) mask at (q0, k0) into
// shared bytes, 16 bytes a thread; true on every thread when any is set
__device__ __forceinline__ bool load_mask_tile(uint8_t* __restrict__ msk,
                                               const int8_t* __restrict__ mask,
                                               int q0, int k0, int n_pad) {
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  const int4 bits = *reinterpret_cast<const int4*>(
      mask + (int64_t)(q0 + r) * n_pad + k0 + part * 16);
  *reinterpret_cast<int4*>(msk + r * TILE + part * 16) = bits;
  return __syncthreads_or((bits.x | bits.y | bits.z | bits.w) != 0) != 0;
}

// whether query row r (of the tile at q0) may attend key column c
__device__ __forceinline__ bool allowed(const float* __restrict__ kok,
                                        const uint8_t* __restrict__ msk,
                                        bool dense, int r, int c, int q0, int n) {
  return kok[c] != 0.f && q0 + r < n && (dense || msk[r * TILE + c] != 0);
}

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

// Scores s and dp = do . v^T of the thread's 4 x 4 (query, key) pairs of
// the current tiles, then p and ds into the shared (TILE, SP) tiles: p
// rounded to the storage type into p_out (when given), ds rounded to the
// storage type into ds_out.
template <typename T, int D>
__device__ __forceinline__ void scores_to_p_ds(
    const float* __restrict__ qs, const float* __restrict__ ks,
    const float* __restrict__ vs, const float* __restrict__ dos,
    const float* __restrict__ lse_s, const float* __restrict__ del_s,
    const float* __restrict__ kok, const uint8_t* __restrict__ msk, bool dense,
    float* __restrict__ p_out, float* __restrict__ ds_out, int q0, int n,
    float scale) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < D; ++e) {
    float qv[4], kv[4], dov[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty + 16 * i) * DP + e];
      dov[i] = dos[(ty + 16 * i) * DP + e];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * DP + e];
      vv[j] = vs[(tx + 16 * j) * DP + e];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float sv = allowed(kok, msk, dense, r, c, q0, n) ? s[i][j] * scale : NEG_INF;
      const float p = sv > 0.5f * NEG_INF ? expf(sv - lse_s[r]) : 0.f;
      if (p_out != nullptr) p_out[r * SP + c] = round_to<T>(p);
      ds_out[r * SP + c] = round_to<T>(p * (dp[i][j] - del_s[r]) * scale);
    }
  }
}

// the thread's accumulator rows (4 x D/16 channels tx + 16*c) into rows
// row0 + ty + 16*a of a contiguous (n, D) head, rows past n skipped
template <typename T, int D>
__device__ __forceinline__ void store_rows(float (&acc)[4][D / 16],
                                           T* __restrict__ dst, int row0, int n) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty + 16 * a;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      dst[(int64_t)row * D + tx + 16 * c] = from_f32<T>(acc[a][c]);
  }
}

template <int D>
__host__ __device__ constexpr int tile_floats() { return TILE * (D + 1); }

template <int D>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return MASK_BYTES + 4 * (3 * tile_floats<D>() + TILE * SP + TILE);
}

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return MASK_BYTES + 4 * (4 * tile_floats<D>() + TILE * SP + 3 * TILE);
}

template <int D>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  return MASK_BYTES + 4 * (4 * tile_floats<D>() + 2 * TILE * SP + 3 * TILE);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) bs_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ kmask, const int8_t* __restrict__ mask,
    const int* __restrict__ table, const int* __restrict__ offsets,
    T* __restrict__ out, float* __restrict__ lse, int heads, int n, int n_pad,
    int n_pairs, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int DP = D + 1, CJ = D / 16;
  uint8_t* msk = smem_raw;                                   // (TILE, TILE)
  float* qs = reinterpret_cast<float*>(smem_raw + MASK_BYTES); // (TILE, DP)
  float* ks = qs + tile_floats<D>();                         // (TILE, DP)
  float* vs = ks + tile_floats<D>();                         // (TILE, DP)
  float* ps = vs + tile_floats<D>();                         // (TILE, SP)
  float* kok = ps + TILE * SP;                               // (TILE)

  const int q0 = blockIdx.x * TILE, bh = blockIdx.y;
  if (q0 >= n) return;  // padding rows only
  const int qb = q0 / BLOCK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DP + e];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * DP + e];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          s[i][j] = allowed(kok, msk, cls == 2, r, c, q0, n) ? s[i][j] * scale : NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pv = s[i][j] > 0.5f * NEG_INF ? expf(s[i][j] - m_new) : 0.f;
          sum += pv;
          ps[r * SP + tx + 16 * j] = round_to<T>(pv);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] *= corr;
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < TILE; ++kk) {
        float pv[4], vv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * SP + kk];
#pragma unroll
        for (int c = 0; c < CJ; ++c) vv[c] = vs[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] /= l_safe;
    if (tx == 0 && row < n) lse[(int64_t)bh * n + row] = m[i] + logf(l_safe);
  }
  store_rows<T, D>(acc, out + head, q0, n);
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
  constexpr int DP = D + 1, CJ = D / 16;
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
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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
      scores_to_p_ds<T, D>(qs, ks, vs, dos, lse_s, del_s, kok, msk, cls == 2,
                           nullptr, dss, q0, n, scale);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) {
        float dsv[4], kv[CJ];
#pragma unroll
        for (int a = 0; a < 4; ++a) dsv[a] = dss[(ty + 16 * a) * SP + j];
#pragma unroll
        for (int c = 0; c < CJ; ++c) kv[c] = ks[j * DP + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < CJ; ++c) acc[a][c] = fmaf(dsv[a], kv[c], acc[a][c]);
      }
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
  constexpr int DP = D + 1, CJ = D / 16;
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
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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
        scores_to_p_ds<T, D>(qs, ks, vs, dos, lse_s, del_s, kok, msk, cls == 2,
                             ps, dss, q0, n, scale);
        __syncthreads();
#pragma unroll 4
        for (int i = 0; i < TILE; ++i) {
          float pv[4], dsv[4], dov[CJ], qv[CJ];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            pv[a] = ps[i * SP + ty + 16 * a];
            dsv[a] = dss[i * SP + ty + 16 * a];
          }
#pragma unroll
          for (int c = 0; c < CJ; ++c) {
            dov[c] = dos[i * DP + tx + 16 * c];
            qv[c] = qs[i * DP + tx + 16 * c];
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < CJ; ++c) {
              dv_acc[a][c] = fmaf(pv[a], dov[c], dv_acc[a][c]);
              dk_acc[a][c] = fmaf(dsv[a], qv[c], dk_acc[a][c]);
            }
        }
      }
    }
  }
  store_rows<T, D>(dk_acc, dk + head, k0, n);
  store_rows<T, D>(dv_acc, dv + head, k0, n);
}

// 0 when the device can give `smem` bytes of shared memory to `kernel`,
// -1 when it cannot, else the CUDA error
template <typename K>
int allow_smem(K kernel, int smem) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > smem_max) return -1;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, const void* kmask,
        const void* mask, const void* table, const void* offsets, void* out,
        void* lse, int batch, int heads, int n, int n_pad, int n_pairs,
        float scale, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  int err = allow_smem(bs_fwd_kernel<T, D>, smem);
  if (err != 0) return err;
  bs_fwd_kernel<T, D><<<grid_of(batch, heads, n_pad), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)kmask,
      (const int8_t*)mask, (const int*)table, (const int*)offsets, (T*)out,
      (float*)lse, heads, n, n_pad, n_pairs, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const void* lse, const void* kmask, const void* mask,
       const void* table, const void* offsets, void* dq_out, void* delta,
       int batch, int heads, int n, int n_pad, int n_pairs, float scale,
       cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  int err = allow_smem(bs_dq_kernel<T, D>, smem);
  if (err != 0) return err;
  bs_dq_kernel<T, D><<<grid_of(batch, heads, n_pad), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
      (const float*)lse, (const uint8_t*)kmask, (const int8_t*)mask,
      (const int*)table, (const int*)offsets, (T*)dq_out, (float*)delta,
      heads, n, n_pad, n_pairs, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, const void* kmask, const void* mask,
         const void* table, const void* offsets, void* dk, void* dv, int batch,
         int heads, int n, int n_pad, int n_pairs, float scale,
         cudaStream_t stream) {
  constexpr int smem = dkdv_smem_bytes<D>();
  int err = allow_smem(bs_dkdv_kernel<T, D>, smem);
  if (err != 0) return err;
  bs_dkdv_kernel<T, D><<<grid_of(batch, heads, n_pad), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (const uint8_t*)kmask, (const int8_t*)mask,
      (const int*)table, (const int*)offsets, (T*)dk, (T*)dv, heads, n,
      n_pad, n_pairs, scale);
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
// nk + 1 for dkdv). One launch on `stream`. Returns cudaGetLastError()
// after it (0 on success), or -1 for what the kernels cannot take: a
// dim_head other than 32/64/128, a dtype code other than 0/1, a block
// other than 128, an empty shape, or more (batch, head) pairs than a grid
// dimension holds.
extern "C" int block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, const void* kmask,
    const void* mask, const void* table, const void* offsets, void* out,
    void* lse, int batch, int heads, int n, int n_pad, int dim_head,
    int block, int n_pairs, float scale, int dtype, void* stream) {
  if (refused(batch, heads, n, n_pad, block, n_pairs)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  BS_DISPATCH(fwd, q, k, v, kmask, mask, table, offsets, out, lse, batch,
              heads, n, n_pad, n_pairs, scale, s)
}

// delta is written here (rowsum(do * o) per row and head) for
// block_sparse_attention_dkdv.
extern "C" int block_sparse_attention_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* kmask, const void* mask,
    const void* table, const void* offsets, void* dq_out, void* delta,
    int batch, int heads, int n, int n_pad, int dim_head, int block,
    int n_pairs, float scale, int dtype, void* stream) {
  if (refused(batch, heads, n, n_pad, block, n_pairs)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  BS_DISPATCH(dq, q, k, v, o, dout, lse, kmask, mask, table, offsets, dq_out,
              delta, batch, heads, n, n_pad, n_pairs, scale, s)
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
