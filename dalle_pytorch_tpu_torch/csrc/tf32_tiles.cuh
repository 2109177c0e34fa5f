// Tensor-core tile pieces of the float32 instances of the packed-qkv
// kernels (fused_qkv_attention.cu, fused_qkv_attention_bwd.cu): every
// float32 product runs as split 3xTF32 on
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, which keeps
// float32's accuracy (the plain version's float32 products) where
// single-pass TF32 would keep about three decimal digits.
//
// The split. The tensor cores read the top 19 bits of a TF32 operand and
// ignore the low 13, which truncates. So each operand x is rounded,
// big = rna(x) (to nearest, ties away, as cvt.rna.tf32.f32), and the
// residue x - big (exact in float32) is rounded the same way into small;
// x is big + small within 2^-22 relative. A product is then
//   x*y ~ small*big' + big*small' + big*big',
// accumulated in float32 in that order (the two cross terms first, as
// CUTLASS's OpMultiplyAddFastF32 does); small*small' (2^-22 relative) is
// dropped. Sums over keys or queries fold fresh partials into the
// running sum with rounded FMAs (mma3 says why).
//
// Where the split happens. A streamed tile (the K/V, or Q/dO, tiles a
// block walks) is read by all 4 warps, so it is split once when it lands
// (split_tiles: big in place, small into a tile beside it) and its B
// fragments are loaded as they are. The block's resident tile is read by
// each warp in its own 16 rows only: its A fragments are split in
// registers after each load, which costs no shared memory (two copies of
// it would cut the blocks an SM holds). A fragments made from
// accumulators (p, ds) are split in registers too. Splitting the
// streamed tiles' fragments in registers as well (no small tiles, three
// blocks an SM) was slower in the backward and even in the forward
// (PERF.md, PR 10). What bounds both now is shared memory: a B fragment
// is 512 bytes (big and small) for 3 mmas of 16 rows, near the 128 bytes
// a cycle an SM reads, and two blocks an SM leave little to hide latency
// with.
//
// Tiles are rows of d float32 channels, each row padded by 16 bytes (a
// stride of d + 4 floats), so the 8 row addresses of one ldmatrix phase
// fall in 8 different 16-byte bank groups: ROWS = 64 rows for a block's
// resident tile (4 warps of 16 rows), SROWS = 32 for a streamed one.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k8" with
// .tf32), lane = 4 * g + t: A (16 x 8, row-major) a0 = (g, t), a1 =
// (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4); B (8 x 8, k x n)
// b0 = (k t, n g), b1 = (k t + 4, n g); C (16 x 8 float32) c0, c1 =
// (g, 2t), (g, 2t + 1), c2, c3 = (g + 8, 2t), (g + 8, 2t + 1).
//  - ldmatrix (b16, not transposed) loads a row-major 32-bit tile: an
//    8 x 8 b16 matrix is 8 rows of 4 floats, and lane (g, t) receives
//    float t of row g, which is a0 .. a3 of A and b0, b1 of a B whose n
//    runs over the tile's rows (B(k, n) = tile[n][k]).
//  - A B whose k runs over the tile's rows (B(k, n) = tile[k][n]) would
//    need ldmatrix.trans, which is 16-bit only: its two values are read
//    by 32-bit shared loads, conflict-free at the stride d + 4.
//  - The C fragment does not match A's: c0, c1 sit at columns 2t, 2t + 1
//    where A wants t, t + 4. A sum over k does not depend on the order
//    of its terms, so C n-block j feeds the next product's A over those
//    8 columns directly when k is permuted the same way in A and B:
//    k index t is column 2t, t + 4 is column 2t + 1, i.e. a0 = c0, a1 =
//    c2, a2 = c1, a3 = c3, and B's rows 2t (b0) and 2t + 1 (b1).

#pragma once

#include "mma_tiles.cuh"

namespace tf32 {

using tc::ROWS;  // rows of a resident tile: 4 warps of 16
using tc::THREADS;

constexpr int SROWS = 32;  // rows of a streamed tile (keys, or queries)

// floats per padded row, and per tile of R rows
template <int D> __host__ __device__ constexpr int stride() { return D + 4; }
template <int D, int R = ROWS> __host__ __device__ constexpr int tile_floats() {
  return R * (D + 4);
}

// rows row0 .. row0 + R - 1 of one head's d channels (rows `row_stride`
// floats apart in global memory) into a tile whose rows are DST floats
// apart (padded by default) by 16-byte cp.async, rows past n zero
template <int D, int R = ROWS, int DST = D + 4>
__device__ __forceinline__ void load_tile_async(float* __restrict__ dst,
                                                const float* __restrict__ src,
                                                int64_t row_stride, int row0, int n) {
  constexpr int CH = D / 4;  // 16-byte chunks per row
  static_assert(R * CH % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * CH / THREADS; ++i) {
    const int x = threadIdx.x + i * THREADS;
    const int r = x / CH, c = (x % CH) * 4, row = row0 + r;
    const bool ok = row < n;
    tc::cp_async16(dst + r * DST + c, src + (ok ? (int64_t)row * row_stride + c : 0), ok);
  }
}

// cos and sin rows row0 .. row0 + R - 1 of the (n, D) tables into cs (R
// rows of D cos values, then R rows of D sin values), asynchronously
template <int D, int R>
__device__ __forceinline__ void load_rot_rows_async(float* __restrict__ cs,
                                                    const float* __restrict__ cos_t,
                                                    const float* __restrict__ sin_t, int row0,
                                                    int n) {
  load_tile_async<D, R, D>(cs, cos_t, D, row0, n);
  load_tile_async<D, R, D>(cs + R * D, sin_t, D, row0, n);
}

// Rotary in place in float32 on the rows row0 + r < n of the padded
// R-row tile a: t*cos + rotate_half(t)*sin with rotate_half(t)[2i] =
// -t[2i+1], [2i+1] = t[2i], each product and the sum rounded once (no
// FMA contraction), as the plain version computes them. cos_r / sin_r:
// the cos / sin of the tile's row 0, rows D floats apart (the tables in
// global memory, or their rows staged by load_rot_rows_async). 4
// channels a thread at a time.
__device__ __forceinline__ float4 rotate4(float4 v, float4 c, float4 s) {
  return make_float4(__fadd_rn(__fmul_rn(v.x, c.x), __fmul_rn(-v.y, s.x)),
                     __fadd_rn(__fmul_rn(v.y, c.y), __fmul_rn(v.x, s.y)),
                     __fadd_rn(__fmul_rn(v.z, c.z), __fmul_rn(-v.w, s.z)),
                     __fadd_rn(__fmul_rn(v.w, c.w), __fmul_rn(v.z, s.w)));
}

template <int D, int R>
__device__ __forceinline__ void rotate_tile(float* __restrict__ a, int row0, int n,
                                            const float* __restrict__ cos_r,
                                            const float* __restrict__ sin_r) {
  constexpr int CH = D / 4;
#pragma unroll
  for (int i = 0; i < R * CH / THREADS; ++i) {
    const int x = threadIdx.x + i * THREADS;
    const int r = x / CH, c = (x % CH) * 4;
    if (row0 + r >= n) continue;
    float4* p = reinterpret_cast<float4*>(a + r * stride<D>() + c);
    *p = rotate4(*p, *reinterpret_cast<const float4*>(cos_r + r * D + c),
                 *reinterpret_cast<const float4*>(sin_r + r * D + c));
  }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: to nearest,
// ties away from zero (the magnitude's bits rounded at bit 13), low 13
// bits zero. Two integer operations; cvt.rna compiles to several times
// as many, which made the split the kernels' largest cost (PERF.md, PR
// 10).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An operand fragment as its TF32 parts: x = big + small
template <int N> struct Split {
  uint32_t big[N], small[N];
};
typedef Split<4> FragA;
typedef Split<2> FragB;

template <int N>
__device__ __forceinline__ void split(Split<N>& f, int i, float x) {
  f.big[i] = to_tf32(x);
  f.small[i] = to_tf32(x - __uint_as_float(f.big[i]));
}

// A fragment of the 16 x 8 block at (row0, col0) of a row-major padded
// tile (rows row0 .., channels col0 ..)
template <int D>
__device__ __forceinline__ void load_a(FragA& a, const float* tile, int row0, int col0) {
  const int lane = threadIdx.x % 32;
  uint32_t r[4];
  tc::ldsm_x4(r, reinterpret_cast<const tc::bf16*>(
                     tile + (row0 + (lane & 15)) * stride<D>() + col0 + (lane >> 4) * 4));
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a, i, __uint_as_float(r[i]));
}

// The rows r < R of the padded tile a (and of b when given, the same
// positions) split: big in place, small into a_small (b_small), tiles of
// the same layout. With cos_r (the cos / sin of the tile's row 0, rows D
// floats apart, as rotate_tile takes them) the rows row0 + r < n are
// rotated first, as rotate_tile rotates them. 4 channels a thread at a
// time.
template <int D, int R>
__device__ __forceinline__ void split_tiles(float* __restrict__ a, float* __restrict__ a_small,
                                            float* __restrict__ b, float* __restrict__ b_small,
                                            int row0, int n, const float* __restrict__ cos_r,
                                            const float* __restrict__ sin_r) {
  constexpr int CH = D / 4;
#pragma unroll
  for (int i = 0; i < R * CH / THREADS; ++i) {
    const int x = threadIdx.x + i * THREADS;
    const int r = x / CH, c = (x % CH) * 4, at = r * stride<D>() + c;
    const bool rot = cos_r != nullptr && row0 + r < n;
    float4 cv, sv;
    if (rot) {
      cv = *reinterpret_cast<const float4*>(cos_r + r * D + c);
      sv = *reinterpret_cast<const float4*>(sin_r + r * D + c);
    }
    float* big[2] = {a, b};
    float* small[2] = {a_small, b_small};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (big[k] == nullptr) continue;
      float4 v = *reinterpret_cast<const float4*>(big[k] + at);
      if (rot) v = rotate4(v, cv, sv);
      const uint4 hi = make_uint4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
      const uint4 lo = make_uint4(to_tf32(v.x - __uint_as_float(hi.x)),
                                  to_tf32(v.y - __uint_as_float(hi.y)),
                                  to_tf32(v.z - __uint_as_float(hi.z)),
                                  to_tf32(v.w - __uint_as_float(hi.w)));
      *reinterpret_cast<uint4*>(big[k] + at) = hi;
      *reinterpret_cast<uint4*>(small[k] + at) = lo;
    }
  }
}

// B fragments of two n-blocks when B(k, n) = tile[n][k] (the tile's rows
// are n, the product runs over channels), from a split tile (big, small):
// rows n0 .. n0 + 15, channels k0 .. k0 + 7; b[0] for n-block n0, b[1]
// for n0 + 8
template <int D>
__device__ __forceinline__ void load_b_rows(FragB (&b)[2], const float* big, const float* small,
                                            int n0, int k0) {
  const int lane = threadIdx.x % 32;
  const int at = (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride<D>() + k0 + ((lane >> 3) & 1) * 4;
  uint32_t hi[4], lo[4];
  tc::ldsm_x4(hi, reinterpret_cast<const tc::bf16*>(big + at));
  tc::ldsm_x4(lo, reinterpret_cast<const tc::bf16*>(small + at));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    b[i].big[0] = hi[2 * i];
    b[i].big[1] = hi[2 * i + 1];
    b[i].small[0] = lo[2 * i];
    b[i].small[1] = lo[2 * i + 1];
  }
}

// The B fragment of one n-block when B(k, n) = tile[k][n] (the product
// runs over the tile's rows), from a split tile (big, small), k permuted
// as c_to_a permutes it: rows k0 + 2t (b0) and k0 + 2t + 1 (b1), channel
// n0 + g
template <int D>
__device__ __forceinline__ void load_b_cols(FragB& b, const float* big, const float* small,
                                            int k0, int n0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int at = (k0 + 2 * t) * stride<D>() + n0 + g;
  b.big[0] = __float_as_uint(big[at]);
  b.big[1] = __float_as_uint(big[at + stride<D>()]);
  b.small[0] = __float_as_uint(small[at]);
  b.small[1] = __float_as_uint(small[at + stride<D>()]);
}

// The A fragment over the 8 columns of C n-block c, k permuted (above)
__device__ __forceinline__ void c_to_a(FragA& a, const float (&c)[4]) {
  split(a, 0, c[0]);
  split(a, 1, c[2]);
  split(a, 2, c[1]);
  split(a, 3, c[3]);
}

// c += a . b on the tensor cores, one TF32 pass
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in split 3xTF32: the cross terms, then big . big.
//
// The tensor cores align a product's terms to the largest of them and of
// the accumulator and truncate what falls below float32's precision, so
// every mma into c may lose up to an ulp of c, toward zero. That is
// harmless over a short sum that starts from zero (scores and dp over d
// channels: 3 * d / 8 mmas), but over ~1,280 keys or queries the loss
// adds up (dqkv 1.0-1.5e-5 from the plain version, relative L2, at n
// 1280, with every mma into the running sum: PERF.md, PR 10). Long sums
// therefore go through fold_product.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma(c, a.small, b.big);
  mma(c, a.big, b.small);
  mma(c, a.big, b.big);
}

// acc = acc * scale + a . tile over the 32 rows of a streamed split tile
// (big, small), a the A fragments of its 4 k-steps (from accumulators,
// c_to_a), scale per accumulator row (g, g + 8): one 8-channel block at
// a time, the block's partial fresh in registers over the 32 rows, then
// folded into acc by one FMA per element, rounded to nearest as the CUDA
// cores' FMAs round
template <int D>
__device__ __forceinline__ void fold_product(float (&acc)[D / 8][4], const FragA (&a)[4],
                                             const float* big, const float* small,
                                             const float (&scale)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragB b;
      load_b_cols<D>(b, big, small, 8 * kk, 8 * j);
      mma3(part, a[kk], b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(acc[j][e], scale[e >> 1], part[e]);
  }
}

// 16 rows of a warp's tile in shared memory (padded rows) to global rows
// row0 + r < n, `row_stride` floats apart, as 16-byte vectors
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int64_t row_stride,
                                           const float* __restrict__ src, int row0, int n) {
  constexpr int CH = D / 4;
  const int lane = threadIdx.x % 32;
  for (int x = lane; x < 16 * CH; x += 32) {
    const int r = x / CH, c = (x % CH) * 4;
    if (row0 + r < n)
      *reinterpret_cast<float4*>(dst + (int64_t)(row0 + r) * row_stride + c) =
          *reinterpret_cast<const float4*>(src + r * stride<D>() + c);
  }
}

// The inverse rotation t*cos - rotate_half(t)*sin in float32 (each
// product and the difference rounded once) of a warp's 16 x D
// accumulator rows (row0 + r, C layout: a channel pair 2i, 2i+1 lies in
// one thread) into the warp's padded shared rows `tile`, then 16-byte
// stores to global rows row0 + r < n, `row_stride` floats apart. Without
// tables the rows are stored as they are.
template <int D>
__device__ __forceinline__ void store_inverse_rotated(
    const float (&acc)[D / 8][4], float* __restrict__ tile, float* __restrict__ dst,
    int64_t row_stride, int row0, int n, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i, row = row0 + r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int e = 8 * j + 2 * t;
      float t0 = acc[j][2 * i], t1 = acc[j][2 * i + 1];
      if (cos_t != nullptr && row < n) {
        const float2 cs = *reinterpret_cast<const float2*>(cos_t + (int64_t)row * D + e);
        const float2 sn = *reinterpret_cast<const float2*>(sin_t + (int64_t)row * D + e);
        // rotate_half(t) is (-t1, t0) on the pair
        const float r0 = __fsub_rn(__fmul_rn(t0, cs.x), __fmul_rn(-t1, sn.x));
        const float r1 = __fsub_rn(__fmul_rn(t1, cs.y), __fmul_rn(t0, sn.y));
        t0 = r0;
        t1 = r1;
      }
      *reinterpret_cast<float2*>(tile + r * stride<D>() + e) = make_float2(t0, t1);
    }
  }
  __syncwarp();
  store_rows<D>(dst, row_stride, tile, row0, n);
}

}  // namespace tf32
