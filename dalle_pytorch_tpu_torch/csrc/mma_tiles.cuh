// Tensor-core tile pieces shared by the bf16 instances of the packed-qkv
// kernels (fused_qkv_attention.cu, fused_qkv_attention_bwd.cu): 16-byte
// cp.async copies with zero fill, ldmatrix (plain and transposed), the
// bf16 mma.sync.m16n8k16 with float32 accumulation, and the in-place
// rotary of a tile in shared memory. The copies, ldmatrix and the
// pattern / key-mask tiles serve the float32 instances too
// (tf32_tiles.cuh).
//
// Tiles are ROWS = 64 rows of d bf16 channels in shared memory, each row
// padded by 16 bytes (a stride of d + 8 elements, an odd number of 16-byte
// chunks), so the 8 row addresses of one ldmatrix phase fall in 8
// different bank groups and the copies and ldmatrix are free of bank
// conflicts.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), lane =
// 4 * g + t: A (16 x 16, row-major) holds a0 = (g, 2t..2t+1), a1 = (g + 8,
// 2t..), a2 = (g, 2t+8..), a3 = (g + 8, 2t+8..); B (16 x 8, k x n) holds
// b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g); C (16 x 8 float32)
// holds c0, c1 = (g, 2t), (g, 2t+1) and c2, c3 = (g + 8, 2t), (g + 8,
// 2t+1). Two n-blocks of C side by side, (16 rows, 16 columns), are the A
// fragment of a product whose k runs over those columns: a0 = pack(c0, c1)
// of the first block, a1 = pack(c2, c3), a2 and a3 the same of the second.
// So scores turn into the probabilities' A fragments in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;  // rows of a tile: query rows or keys
constexpr int WARPS = 4;  // each warp owns 16 rows of the block's tile
constexpr int THREADS = 32 * WARPS;

// bf16 elements per padded row, and per tile
template <int D> __host__ __device__ constexpr int stride() { return D + 8; }
template <int D> __host__ __device__ constexpr int tile_elems() { return ROWS * (D + 8); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; when !valid the 16
// bytes are zero-filled and src is not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows row0 .. row0 + ROWS - 1 of one head's d channels (rows
// `row_stride` elements apart in global memory) into a tile whose rows are
// DST elements apart (padded by default), rows past n zero
template <int D, int DST = D + 8>
__device__ __forceinline__ void load_tile_async(bf16* __restrict__ dst,
                                                const bf16* __restrict__ src,
                                                int64_t row_stride, int row0, int n) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CH % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int x = threadIdx.x + i * THREADS;
    const int r = x / CH, c = (x % CH) * 8, row = row0 + r;
    const bool ok = row < n;
    cp_async16(dst + r * DST + c, src + (ok ? (int64_t)row * row_stride + c : 0), ok);
  }
}

// the (R, C) block at (row0, col0) of a row-major (n, n) int8 mask into
// shared bytes (rows C apart), rows and columns past n zero; by 16-byte
// cp.async when n is a multiple of 16 (every row 16-byte aligned), else
// by bytes
template <int R = ROWS, int C = ROWS>
__device__ __forceinline__ void load_mask_tile(int8_t* __restrict__ dst,
                                               const int8_t* __restrict__ mask,
                                               int row0, int col0, int n) {
  if (n % 16 == 0) {
    constexpr int CC = C / 16;  // 16-byte chunks per row
    for (int x = threadIdx.x; x < R * CC; x += THREADS) {
      const int r = x / CC, c = (x % CC) * 16;
      const bool ok = row0 + r < n && col0 + c < n;
      cp_async16(dst + r * C + c,
                 mask + (ok ? (int64_t)(row0 + r) * n + col0 + c : 0), ok);
    }
  } else {
    for (int x = threadIdx.x; x < R * C; x += THREADS) {
      const int r = x / C, c = x % C;
      const bool ok = row0 + r < n && col0 + c < n;
      dst[x] = ok ? mask[(int64_t)(row0 + r) * n + col0 + c] : 0;
    }
  }
}

// The K (64 or 32) keys k0 .. k0 + K - 1 that pass the key mask
// (kmask_b, the batch row's (n) mask), as bits into bits[0] (keys 0-31)
// and bits[1] (32-63), written by warps 0 and 1; true on every thread
// when any does. A barrier: call it uniformly.
template <int K = ROWS>
__device__ __forceinline__ bool tile_keys(const uint8_t* __restrict__ kmask_b, int k0,
                                          int n, uint32_t* __restrict__ bits) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  bool ok = false;
  if (w < K / 32) {
    const int col = k0 + 32 * w + lane;
    ok = col < n && kmask_b[col] != 0;
    const uint32_t ballot = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) bits[w] = ballot;
  }
  return __syncthreads_or(ok) != 0;
}

// Every bit of a tile of K keys
template <int K = ROWS> __device__ __forceinline__ constexpr uint64_t all_keys() {
  return K == 64 ? ~0ull : (1ull << K) - 1;
}

// The bits of the K keys k0 .. k0 + K - 1 that may be attended: those of
// tile_keys (bits, with a key mask) or those that exist (without one)
template <int K = ROWS>
__device__ __forceinline__ uint64_t key_bits(bool masked, const uint32_t* bits, int k0,
                                             int n) {
  if (masked) return K == 64 ? bits[0] | ((uint64_t)bits[1] << 32) : bits[0];
  return n - k0 >= K ? all_keys<K>() : (1ull << (n - k0)) - 1;
}

// four 8 x 8 b16 matrices; lane i gives the row address of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of the 16 x 16 block at (row0, col0) of a row-major padded
// tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int col0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + (row0 + (lane & 15)) * stride<D>() + col0 + (lane >> 4) * 8);
}

// B fragments of two n-blocks when B(k, n) = tile[n][k] (keys as rows,
// the product runs over channels): rows n0 .. n0 + 15, channels k0 ..
// k0 + 15; b[0], b[1] for n-block n0, b[2], b[3] for n0 + 8
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* tile, int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride<D>() + k0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of two n-blocks when B(k, n) = tile[k][n] (the product runs
// over the tile's rows): rows k0 .. k0 + 15, channels n0 .. n0 + 15;
// b[0], b[1] for channels n0 .., b[2], b[3] for n0 + 8 ..
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(b, tile + (k0 + (lane & 15)) * stride<D>() + n0 + (lane >> 4) * 8);
}

// c += a . b on the tensor cores: bf16 operands, float32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// exp(x - y) as 2^(x * log2(e) - y2) with y2 = y * log2(e): one FFMA and
// the SFU's ex2.approx.ftz in place of expf's range reduction. Its error
// (~2 ulp, plus ~1e-6 relative from the FFMA at |x - y| ~ 10) is far below
// the bf16 rounding of p that follows; results below 2^-126 flush to 0.
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float exp_diff(float x, float y2) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(fmaf(x, LOG2E, -y2)));
  return r;
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment over the 16 columns of C n-blocks c[j], c[j + 1]
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Rotary of one channel pair (2c, 2c + 1) held as bf16x2 in t, with the
// pair's cos and sin: t*cos + rotate_half(t)*sin with rotate_half(t)[2c] =
// -t[2c+1], [2c+1] = t[2c], each product and the sum rounded to bf16, as
// bf16x2 operations that round once (mul.rn / add.rn.bf16x2). The plain
// version computes each in float32 and rounds to bf16: a product of two
// bf16 values and a sum of two are exact in float32 (or far below half a
// bf16 ulp), so the two agree bitwise.
__device__ __forceinline__ uint32_t rotate_pair(uint32_t t, uint32_t c, uint32_t s) {
  // (-t[2c+1], t[2c]): halves swapped, the low half's sign flipped
  const uint32_t half = __byte_perm(t, 0, 0x1032) ^ 0x8000u;
  const __nv_bfloat162 r = __hadd2_rn(
      __hmul2_rn(*reinterpret_cast<const __nv_bfloat162*>(&t),
                 *reinterpret_cast<const __nv_bfloat162*>(&c)),
      __hmul2_rn(*reinterpret_cast<const __nv_bfloat162*>(&half),
                 *reinterpret_cast<const __nv_bfloat162*>(&s)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// rotate_pair with the pair's cos and sin read from global memory
__device__ __forceinline__ uint32_t rotate2(uint32_t t, const bf16* cos_p, const bf16* sin_p) {
  return rotate_pair(t, __ldg(reinterpret_cast<const unsigned int*>(cos_p)),
                     __ldg(reinterpret_cast<const unsigned int*>(sin_p)));
}

// Rotary of 8 consecutive channels (4 pairs) from 16 bytes each of t,
// cos and sin
__device__ __forceinline__ uint4 rotate8(uint4 tv, uint4 cv, uint4 sv) {
  return make_uint4(rotate_pair(tv.x, cv.x, sv.x), rotate_pair(tv.y, cv.y, sv.y),
                    rotate_pair(tv.z, cv.z, sv.z), rotate_pair(tv.w, cv.w, sv.w));
}

// Rotary in place on the rows row0 + r < n of two padded tiles of the
// same positions (K and V), from the cos and sin of those rows in shared
// memory (cs: ROWS rows of D cos values, then ROWS rows of D sin values),
// 8 channels of both tiles a thread at a time
template <int D>
__device__ __forceinline__ void rotate_tiles(bf16* __restrict__ a, bf16* __restrict__ b,
                                             int row0, int n, const bf16* __restrict__ cs) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int x = threadIdx.x + i * THREADS;
    const int r = x / CH, c = (x % CH) * 8;
    if (row0 + r >= n) continue;
    const uint4 cv = *reinterpret_cast<const uint4*>(cs + r * D + c);
    const uint4 sv = *reinterpret_cast<const uint4*>(cs + (ROWS + r) * D + c);
    uint4* pa = reinterpret_cast<uint4*>(a + r * stride<D>() + c);
    uint4* pb = reinterpret_cast<uint4*>(b + r * stride<D>() + c);
    *pa = rotate8(*pa, cv, sv);
    *pb = rotate8(*pb, cv, sv);
  }
}

// cos and sin rows row0 .. row0 + ROWS - 1 of the (n, D) tables into cs
// (the layout rotate_tiles reads), asynchronously, rows past n zero
template <int D>
__device__ __forceinline__ void load_rot_rows_async(bf16* __restrict__ cs,
                                                    const bf16* __restrict__ cos_t,
                                                    const bf16* __restrict__ sin_t, int row0,
                                                    int n) {
  load_tile_async<D, D>(cs, cos_t, D, row0, n);
  load_tile_async<D, D>(cs + ROWS * D, sin_t, D, row0, n);
}

// 16 rows of a warp's bf16 tile in shared memory (padded rows) to global
// rows row0 + r < n, `row_stride` elements apart, as 16-byte vectors
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, int64_t row_stride,
                                           const bf16* __restrict__ src, int row0, int n) {
  constexpr int CH = D / 8;
  const int lane = threadIdx.x % 32;
  for (int x = lane; x < 16 * CH; x += 32) {
    const int r = x / CH, c = (x % CH) * 8;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (int64_t)(row0 + r) * row_stride + c) =
          *reinterpret_cast<const uint4*>(src + r * stride<D>() + c);
  }
}

// True when every pointer given is 16-byte aligned (the cp.async and
// vector accesses need it); NULL passes.
__host__ __forceinline__ bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace tc
