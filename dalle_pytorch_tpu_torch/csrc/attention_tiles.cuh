// Tile pieces of the pair grid's bf16 forward (block_sparse_attention.cu:
// bs_fwd_kernel), the last CUDA-core attention kernel: the tile geometry
// and shared-memory layout, tile loads and stores, the may-attend rule of
// a tile and the forward's per-tile step (online softmax). Every product
// is a float32 FMA from shared memory. Every other attention kernel runs
// on the tensor cores (tf32_sweeps.cuh, bf16_sweeps.cuh); NEG_INF, TILE
// and allow_smem serve them too (flash_attention.cu keeps only those).
//
// Layout: one block of THREADS = 256 threads per TILE-row tile. Tiles are
// TILE x d floats in shared memory with a padded row stride of d + 1;
// thread (ty, tx), 16 x 16, owns rows ty + 16*a and columns tx + 16*j of
// a TILE x TILE score tile and rows ty + 16*a, channels tx + 16*c of its
// accumulators; a row's 16 owners share a half-warp, so the forward's row
// max and sum reduce with shuffles. Rows past the sequence end n load as
// 0, attend nothing and are not stored.
//
// A tile's class: 0 no pair may attend (the callers skip it), 1 the mask
// decides (the int8 mask bits when there is a mask, else the causal rule
// query >= key), 2 every pair may attend; a (b, n) key mask applies on
// top. Disallowed scores are NEG_INF = -1e30 and p = exp(s - m) only
// where s > 0.5 * NEG_INF, else 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;      // query rows / keys per tile
constexpr int SP = TILE + 1;  // padded stride of the (TILE, TILE) p and ds tiles
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

template <int D>
__host__ __device__ constexpr int tile_floats() { return TILE * (D + 1); }

// shared memory of the forward (the layout its kernel carves)
template <int D>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return MASK_BYTES + 4 * (3 * tile_floats<D>() + TILE * SP + TILE);
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

// the (TILE, TILE) block at (q0, k0) of a row-major int8 mask whose rows
// are `stride` bytes into shared bytes, 16 bytes a thread; true on every
// thread when any is set
__device__ __forceinline__ bool load_mask_tile(uint8_t* __restrict__ msk,
                                               const int8_t* __restrict__ mask,
                                               int q0, int k0, int stride) {
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  const int4 bits = *reinterpret_cast<const int4*>(
      mask + (int64_t)(q0 + r) * stride + k0 + part * 16);
  *reinterpret_cast<int4*>(msk + r * TILE + part * 16) = bits;
  return __syncthreads_or((bits.x | bits.y | bits.z | bits.w) != 0) != 0;
}

// whether query q0 + r may attend key k0 + c in a tile of class cls (1 or
// 2); has_mask: the tile's mask bits are in msk
__device__ __forceinline__ bool allowed(const float* __restrict__ kok,
                                        const uint8_t* __restrict__ msk,
                                        bool has_mask, int cls, int r, int c, int q0,
                                        int k0, int n) {
  if (kok[c] == 0.f || q0 + r >= n) return false;
  if (cls == 2) return true;
  return has_mask ? msk[r * TILE + c] != 0 : q0 + r >= k0 + c;
}

// One key tile of the forward for the thread's rows: the scores of the
// q and k tiles, the online-softmax update of (m, l, acc) with p rounded
// to the storage type (through the shared (TILE, SP) tile ps), then
// acc += p . v. Ends with ps read: the caller syncs before overwriting.
template <typename T, int D>
__device__ __forceinline__ void fwd_step(
    const float* __restrict__ qs, const float* __restrict__ ks,
    const float* __restrict__ vs, float* __restrict__ ps,
    const float* __restrict__ kok, const uint8_t* __restrict__ msk, bool has_mask,
    int cls, int q0, int k0, int n, float scale, float (&acc)[4][D / 16],
    float (&m)[4], float (&l)[4]) {
  constexpr int DP = D + 1, CJ = D / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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
      s[i][j] = allowed(kok, msk, has_mask, cls, r, c, q0, k0, n) ? s[i][j] * scale : NEG_INF;
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

// The forward's end for the thread's rows: o = acc / l (l = 1 where
// l == 0, so a row with no allowed key writes exactly 0) into rows
// row0 .. of a contiguous (n, D) head, lse = m + log(l) into the head's
// (n) float32 row statistics
template <typename T, int D>
__device__ __forceinline__ void fwd_finish(float (&acc)[4][D / 16], const float (&m)[4],
                                           const float (&l)[4], T* __restrict__ out,
                                           float* __restrict__ lse, int row0, int n) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] /= l_safe;
    if (tx == 0 && row < n) lse[row] = m[i] + logf(l_safe);
  }
  store_rows<T, D>(acc, out, row0, n);
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

}  // namespace
