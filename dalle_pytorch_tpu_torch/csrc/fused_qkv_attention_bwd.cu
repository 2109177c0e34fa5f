// Fused packed-qkv attention for Hopper (sm_90a), backward.
//
// Replaces the Pallas TPU kernel `_fused_qkv_bwd_kernel` (vjp rule
// `_fused_bwd_rule`) behind `fused_qkv_attention` in
// dalle_pytorch_tpu/ops/flash_attention.py. Python wrapper:
// dalle_pytorch_tpu_torch/ops/flash_attention.py:fused_qkv_attention_bwd;
// the forward is csrc/fused_qkv_attention.cu.
//
// What it computes, from the forward's inputs (qkv (b, n, 3*h*d) in the
// projection's layout, the same masks and cos/sin tables), its outputs o
// (b, n, h*d) and lse (b, h, 1, n) float32, and do (b, n, h*d):
//   q, k, v rotated as the forward rotates them (rounded to the storage
//   type after each product and after the sum);
//   s = q.k^T in float32, times the scale, masked as the forward masks;
//   p = exp(s - lse) where s > 0.5 * NEG_INF, else 0;
//   dv = p (rounded to the storage type)^T . do;  dp = do . v^T;
//   delta = rowsum(do * o) in float32 from the STORED o;
//   ds = p * (dp - delta) * scale, rounded to the storage type;
//   dq = ds . k and dk = ds^T . q on the rotated q and k;
//   then the inverse rotation t*cos - rotate_half(t)*sin in float32 on
//   dq, dk AND dv (v is rotated in the forward, the reference's quirk;
//   the inverse equals the true VJP because the angle table is
//   pair-constant, which rotary.rot_tables checks), and the cast to the
//   storage type. Every product accumulates in float32. dqkv comes out
//   in qkv's packed layout. A fully masked query row has p = 0 and
//   contributes exactly 0 to every gradient.
//
// What bounds it. At the training shape (b 4, n 1280, 16 heads of 64,
// causal) the five (n, n, d) products over the causal pairs are ~3.4e10
// operations: 34 us at the tensor cores' bf16 rate, 0.5 ms at the
// CUDA cores' float32 rate, against ~0.3 ms of bytes in float32 (qkv, o,
// do, dqkv, lse, tables once each) and half that in bf16: operations
// bound it. The design keeps every (n, n) intermediate on chip and tiles
// FA-2 style, with no float atomics so that gradients are the same from
// run to run:
//   1. rotate_kernel rotates q, k and v once into a scratch copy of qkv
//      (skipped without tables), so no pass re-rotates a tile per visit;
//      delta_kernel computes delta once per (row, head);
//   2. dk/dv: one block per (64-key tile, head, batch row) holds its K
//      and V tiles and walks the query tiles that may attend them (from
//      the diagonal down when causal), recomputing p from the lse, and
//      accumulates dk and dv in registers;
//   3. dq: one block per (64-row query tile, head, batch row) walks the
//      key tiles up to the diagonal and accumulates dq.
// Key tiles whose keys are all masked are skipped in both passes.
//
// The bf16 instance (dkdv_tc_kernel, dq_tc_kernel) runs every product on
// the tensor cores: bf16 mma.sync tiles with float32 accumulation, the
// streamed Q/dO (dk/dv) or K/V (dq) tiles through 2-stage cp.async rings,
// the dk/dv pass key-major (S^T = K.Q^T) so that p^T and ds^T leave the
// accumulators as the A fragments of dV += P^T.dO and dK += dS^T.Q, p and
// ds rounded to bf16 in registers where the plain version rounds them,
// the inverse rotation in float32 on the accumulators (a channel pair
// lies in one thread) and 16-byte stores. The float32 instance
// (dkdv_kernel, dq_kernel) keeps the CUDA-core design below, bit for bit
// (tensor cores in float32 mean TF32 or 3xTF32: a decision ahead). Next:
// one fused pass, and wgmma/TMA where the bf16 instance stays below half
// its bound.
//
// float32 layout: tiles are 64 x d floats in shared memory with a padded
// row stride of d + 1, so a half-warp reading 16 different rows at one
// column hits 16 banks. Thread (ty, tx), 16 x 16, owns rows ty + 16*a and
// columns tx + 16*b of a 64 x 64 score tile, and rows ty + 16*a, channels
// tx + 16*c of the accumulators; channel pairs (2i, 2i+1) sit on lanes
// l and l ^ 1, so the inverse rotation exchanges partners by shuffle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int SP = BK + 1;    // padded stride of the (BQ, BK) p and ds tiles
constexpr int THREADS = 256;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// round a float32 to the storage type and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// qkv (rows of `width` = 3*h*d) -> the same with q, k and v rotated:
// t*cos + rotate_half(t)*sin, rotate_half(t)[2i] = -t[2i+1],
// [2i+1] = t[2i], rounded as the forward kernel rounds.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) rotate_kernel(
    const T* __restrict__ qkv, const T* __restrict__ cos_t,
    const T* __restrict__ sin_t, T* __restrict__ out, int64_t total, int n,
    int width) {
  for (int64_t x = (int64_t)blockIdx.x * THREADS + threadIdx.x; x < total;
       x += (int64_t)gridDim.x * THREADS) {
    const int64_t row_g = x / width;
    const int col = (int)(x % width);
    const int row = (int)(row_g % n);
    const int e = col % D;
    const T* head = qkv + row_g * width + (col - e);
    const float t = to_f32<T>(head[e]);
    const float partner = to_f32<T>(head[e ^ 1]);
    const float half = (e & 1) ? partner : -partner;
    const float c = to_f32<T>(cos_t[(int64_t)row * D + e]);
    const float s = to_f32<T>(sin_t[(int64_t)row * D + e]);
    const float a = round_to<T>(__fmul_rn(t, c));
    const float b = round_to<T>(__fmul_rn(half, s));
    out[x] = from_f32<T>(__fadd_rn(a, b));
  }
}

// delta (b, h, n) = rowsum over a head's d channels of do * o, one warp
// per (batch row, position, head)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, int64_t warps, int n, int heads) {
  const int64_t w = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= warps) return;  // uniform over the warp
  const int h = (int)(w % heads);
  const int64_t bn = w / heads;  // b * n + row
  const int64_t off = bn * heads * D + (int64_t)h * D;
  float acc = 0.f;
  for (int e = lane; e < D; e += 32)
    acc += to_f32<T>(o[off + e]) * to_f32<T>(dout[off + e]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    const int64_t b = bn / n, row = bn % n;
    delta[(b * heads + h) * n + row] = acc;
  }
}

// 64 rows of one head's d channels, from rows of `stride` elements, into
// a (64, D + 1) float tile; rows past the sequence end are 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int64_t stride, int row0, int n) {
  constexpr int DP = D + 1;
  for (int x = threadIdx.x; x < 64 * D; x += THREADS) {
    const int r = x / D, e = x % D;
    const int row = row0 + r;
    dst[r * DP + e] = row < n ? to_f32<T>(src[(int64_t)row * stride + e]) : 0.f;
  }
}

// keys k0 .. k0 + BK - 1 that exist and pass the key mask, into kok;
// true (on every thread) when any does
__device__ __forceinline__ bool load_key_flags(float* __restrict__ kok,
                                               const uint8_t* __restrict__ kmask,
                                               int b, int k0, int n) {
  int any_key = 0;
  for (int c = threadIdx.x; c < BK; c += THREADS) {
    const int col = k0 + c;
    kok[c] = (col < n && (kmask == nullptr || kmask[(int64_t)b * n + col] != 0)) ? 1.f : 0.f;
    any_key |= kok[c] != 0.f;
  }
  return __syncthreads_or(any_key) != 0;
}

// Scores s and dp = do . v^T of the thread's 4 x 4 (query, key) pairs of
// the current tiles, then p and ds into the shared (BQ, SP) tiles: p
// rounded to the storage type into p_out (when given), ds rounded to the
// storage type into ds_out.
template <typename T, int D>
__device__ __forceinline__ void scores_to_p_ds(
    const float* __restrict__ qs, const float* __restrict__ ks,
    const float* __restrict__ vs, const float* __restrict__ dos,
    const float* __restrict__ lse_s, const float* __restrict__ del_s,
    const float* __restrict__ kok, const int8_t* __restrict__ pmask,
    float* __restrict__ p_out, float* __restrict__ ds_out, int q0, int k0,
    int n, int causal, float scale) {
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
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, col = k0 + c;
      bool ok = kok[c] != 0.f && row < n;
      if (pmask != nullptr) {
        ok = ok && pmask[(int64_t)row * n + col] != 0;
      } else if (causal) {
        ok = ok && row >= col;
      }
      const float sv = ok ? s[i][j] * scale : NEG_INF;
      const float p = sv > 0.5f * NEG_INF ? expf(sv - lse_s[r]) : 0.f;
      if (p_out != nullptr) p_out[r * SP + c] = round_to<T>(p);
      ds_out[r * SP + c] = round_to<T>(p * (dp[i][j] - del_s[r]) * scale);
    }
  }
}

// The thread's accumulator rows (4 x CJ channels tx + 16*c) through the
// inverse rotation (when cos_t is given) into dst rows row0 + ty + 16*a,
// each of `stride` elements, cast to the storage type.
template <typename T, int D>
__device__ __forceinline__ void store_inverse_rotated(
    float (&acc)[4][D / 16], T* __restrict__ dst, int64_t stride, int row0,
    int n, const T* __restrict__ cos_t, const T* __restrict__ sin_t) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int e = tx + 16 * c;
      float t = acc[a][c];
      // channel e ^ 1 is held by lane ^ 1 (tx ^ 1, same ty and c); every
      // lane takes part in the shuffle, rows past the end included
      const float partner = __shfl_xor_sync(0xffffffffu, t, 1);
      if (row >= n) continue;
      if (cos_t != nullptr) {
        const float half = (e & 1) ? partner : -partner;
        const float cs = to_f32<T>(cos_t[(int64_t)row * D + e]);
        const float sn = to_f32<T>(sin_t[(int64_t)row * D + e]);
        t = __fsub_rn(__fmul_rn(t, cs), __fmul_rn(half, sn));
      }
      dst[(int64_t)row * stride + e] = from_f32<T>(t);
    }
  }
}

// lse and delta of query rows q0 .. q0 + BQ - 1 into shared memory
__device__ __forceinline__ void load_row_stats(float* __restrict__ lse_s,
                                               float* __restrict__ del_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int q0, int n) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int row = q0 + r;
    lse_s[r] = row < n ? lse[row] : 0.f;
    del_s[r] = row < n ? delta[row] : 0.f;
  }
}

template <int D>
__host__ __device__ constexpr int tile_floats() { return 64 * (D + 1); }

template <int D>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  return 4 * (4 * tile_floats<D>() + 2 * BQ * SP + 2 * BQ + BK);
}

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 4 * (4 * tile_floats<D>() + BQ * SP + 2 * BQ + BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ kmask, const int8_t* __restrict__ pmask,
    const T* __restrict__ cos_t, const T* __restrict__ sin_t,
    T* __restrict__ dqkv, int n, int heads, int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1, CJ = D / 16;
  float* ks = smem;                     // (BK, DP)
  float* vs = ks + tile_floats<D>();    // (BK, DP)
  float* qs = vs + tile_floats<D>();    // (BQ, DP)
  float* dos = qs + tile_floats<D>();   // (BQ, DP)
  float* ps = dos + tile_floats<D>();   // (BQ, SP)
  float* dss = ps + BQ * SP;            // (BQ, SP)
  float* lse_s = dss + BQ * SP;         // (BQ)
  float* del_s = lse_s + BQ;            // (BQ)
  float* kok = del_s + BQ;              // (BK)

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t stride = 3LL * heads * D, hd = (int64_t)heads * D;
  const T* base = qkv + (int64_t)b * n * stride;
  const T* dobase = dout + (int64_t)b * n * hd + (int64_t)h * D;
  const float* lse_bh = lse + ((int64_t)b * heads + h) * n;
  const float* del_bh = delta + ((int64_t)b * heads + h) * n;

  float dk[4][CJ], dv[4][CJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dk[a][c] = dv[a][c] = 0.f;

  // a tile of masked keys has p = 0 for every query: dk = dv = 0
  if (load_key_flags(kok, kmask, b, k0, n)) {
    load_tile<T, D>(ks, base + (int64_t)(heads + h) * D, stride, k0, n);
    load_tile<T, D>(vs, base + (int64_t)(2 * heads + h) * D, stride, k0, n);
    const int n_qt = (n + BQ - 1) / BQ;
    const int qt0 = (causal && pmask == nullptr) ? k0 / BQ : 0;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous query tile is no longer read
      load_tile<T, D>(qs, base + (int64_t)h * D, stride, q0, n);
      load_tile<T, D>(dos, dobase, hd, q0, n);
      load_row_stats(lse_s, del_s, lse_bh, del_bh, q0, n);
      __syncthreads();
      scores_to_p_ds<T, D>(qs, ks, vs, dos, lse_s, del_s, kok, pmask, ps, dss,
                           q0, k0, n, causal, scale);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
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
            dv[a][c] = fmaf(pv[a], dov[c], dv[a][c]);
            dk[a][c] = fmaf(dsv[a], qv[c], dk[a][c]);
          }
      }
    }
  }

  T* out = dqkv + (int64_t)b * n * stride;
  store_inverse_rotated<T, D>(dk, out + (int64_t)(heads + h) * D, stride, k0, n, cos_t, sin_t);
  store_inverse_rotated<T, D>(dv, out + (int64_t)(2 * heads + h) * D, stride, k0, n, cos_t, sin_t);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ kmask, const int8_t* __restrict__ pmask,
    const T* __restrict__ cos_t, const T* __restrict__ sin_t,
    T* __restrict__ dqkv, int n, int heads, int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1, CJ = D / 16;
  float* qs = smem;                     // (BQ, DP)
  float* dos = qs + tile_floats<D>();   // (BQ, DP)
  float* ks = dos + tile_floats<D>();   // (BK, DP)
  float* vs = ks + tile_floats<D>();    // (BK, DP)
  float* dss = vs + tile_floats<D>();   // (BQ, SP)
  float* lse_s = dss + BQ * SP;         // (BQ)
  float* del_s = lse_s + BQ;            // (BQ)
  float* kok = del_s + BQ;              // (BK)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t stride = 3LL * heads * D, hd = (int64_t)heads * D;
  const T* base = qkv + (int64_t)b * n * stride;

  float dq[4][CJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dq[a][c] = 0.f;

  int n_tiles = (n + BK - 1) / BK;
  if (causal && pmask == nullptr) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  bool q_loaded = false;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous key tile is no longer read
    if (!load_key_flags(kok, kmask, b, k0, n)) continue;
    if (!q_loaded) {
      load_tile<T, D>(qs, base + (int64_t)h * D, stride, q0, n);
      load_tile<T, D>(dos, dout + (int64_t)b * n * hd + (int64_t)h * D, hd, q0, n);
      load_row_stats(lse_s, del_s, lse + ((int64_t)b * heads + h) * n,
                     delta + ((int64_t)b * heads + h) * n, q0, n);
      q_loaded = true;
    }
    load_tile<T, D>(ks, base + (int64_t)(heads + h) * D, stride, k0, n);
    load_tile<T, D>(vs, base + (int64_t)(2 * heads + h) * D, stride, k0, n);
    __syncthreads();
    scores_to_p_ds<T, D>(qs, ks, vs, dos, lse_s, del_s, kok, pmask, nullptr,
                         dss, q0, k0, n, causal, scale);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[4], kv[CJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsv[a] = dss[(ty + 16 * a) * SP + j];
#pragma unroll
      for (int c = 0; c < CJ; ++c) kv[c] = ks[j * DP + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < CJ; ++c) dq[a][c] = fmaf(dsv[a], kv[c], dq[a][c]);
    }
  }

  T* out = dqkv + (int64_t)b * n * stride + (int64_t)h * D;
  store_inverse_rotated<T, D>(dq, out, stride, q0, n, cos_t, sin_t);
}

// ------------------------------------------- bf16: the tensor-core design
//
// Both passes read the rotated copy of qkv (rotate_tc_kernel) and delta
// (delta_tc_kernel). Blocks of 4 warps, each warp 16 rows of the block's
// tile; every product is a bf16 mma.sync.m16n8k16 with float32
// accumulation, operands by ldmatrix (.trans where the product runs over
// a tile's rows) from tiles that come through 2-stage cp.async rings. p
// and ds are rounded to bf16 where the plain version rounds them,
// straight from the accumulators into the A fragments of the next
// product. Per-thread element e of C n-block j is row 16w + g + 8 * (e /
// 2), column 8j + 2t + e % 2 of a warp's 16-row block. The streamed
// 64-row tile is taken in two halves of 32, so only 16 x 32 scores and
// their gradients are live at once: like the forward, the passes are
// bound by latency more than by any one unit, and the registers this
// saves let three (dk/dv) or four (dq) blocks share an SM at d 32 and 64.

// qkv rows (of `width` = 3*h*D) -> the same with q, k and v rotated as
// the forward rotates them, 8 channels a thread (tc::rotate8, 16-byte
// loads and stores)
template <int D>
__global__ void __launch_bounds__(THREADS) rotate_tc_kernel(
    const tc::bf16* __restrict__ qkv, const tc::bf16* __restrict__ cos_t,
    const tc::bf16* __restrict__ sin_t, tc::bf16* __restrict__ out, int64_t chunks, int n,
    int width) {
  const int per_row = width / 8;
  for (int64_t x = (int64_t)blockIdx.x * THREADS + threadIdx.x; x < chunks;
       x += (int64_t)gridDim.x * THREADS) {
    const int64_t row_g = x / per_row;
    const int col = (int)(x % per_row) * 8;
    const int64_t rot = (row_g % n) * D + col % D;
    const int64_t at = row_g * width + col;
    *reinterpret_cast<uint4*>(out + at) = tc::rotate8(
        *reinterpret_cast<const uint4*>(qkv + at),
        __ldg(reinterpret_cast<const uint4*>(cos_t + rot)),
        __ldg(reinterpret_cast<const uint4*>(sin_t + rot)));
  }
}

// delta (b, h, n) = rowsum over a head's D channels of do * o in float32,
// 8 channels a thread (16-byte loads), D / 8 neighbouring lanes per
// (batch row, position, head) reducing by shuffles
template <int D>
__global__ void __launch_bounds__(THREADS) delta_tc_kernel(
    const tc::bf16* __restrict__ o, const tc::bf16* __restrict__ dout,
    float* __restrict__ delta, int64_t chunks, int n, int heads) {
  constexpr int CH = D / 8;
  const int64_t x = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  float acc = 0.f;
  if (x < chunks) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + 8 * x);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + 8 * x);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]), c = __bfloat1622float2(d2[i]);
      acc = fmaf(a.x, c.x, fmaf(a.y, c.y, acc));
    }
  }
#pragma unroll
  for (int s = CH / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (x < chunks && x % CH == 0) {
    const int64_t w = x / CH;  // (b * n + row) * heads + h
    const int h = (int)(w % heads);
    const int64_t bn = w / heads;
    delta[(bn / n * heads + h) * n + bn % n] = acc;
  }
}

constexpr int dkdv_tc_smem_bytes(int d, bool pattern) {
  // K, V, two stages of Q and dO, two of lse and delta, two of the pattern
  return 2 * 6 * tc::ROWS * (d + 8) + 2 * 2 * tc::ROWS * 4 +
         (pattern ? 2 * tc::ROWS * tc::ROWS : 0);
}

constexpr int dq_tc_smem_bytes(int d, bool pattern) {
  // Q, dO, two stages of K and V, two of key bits, two of the pattern
  return 2 * 6 * tc::ROWS * (d + 8) + 2 * 2 * 4 + (pattern ? 2 * tc::ROWS * tc::ROWS : 0);
}

// The inverse rotation t*cos - rotate_half(t)*sin in float32 (as
// store_inverse_rotated) of a warp's 16 x D accumulator rows (row0 + r,
// C layout: a channel pair 2i, 2i+1 lies in one thread), rounded to bf16
// into the warp's padded shared rows `tile`, then stored to global rows
// row0 + r < n, `row_stride` elements apart.
template <int D>
__device__ __forceinline__ void store_inverse_rotated_tc(
    const float (&acc)[D / 8][4], tc::bf16* __restrict__ tile, tc::bf16* __restrict__ dst,
    int64_t row_stride, int row0, int n, const tc::bf16* __restrict__ cos_t,
    const tc::bf16* __restrict__ sin_t) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i, row = row0 + r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int e = 8 * j + 2 * t;
      float t0 = acc[j][2 * i], t1 = acc[j][2 * i + 1];
      if (cos_t != nullptr && row < n) {
        const float2 cs = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(cos_t + (int64_t)row * D + e));
        const float2 sn = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sin_t + (int64_t)row * D + e));
        // rotate_half(t) is (-t1, t0) on the pair
        const float r0 = __fsub_rn(__fmul_rn(t0, cs.x), __fmul_rn(-t1, sn.x));
        const float r1 = __fsub_rn(__fmul_rn(t1, cs.y), __fmul_rn(t0, sn.y));
        t0 = r0;
        t1 = r1;
      }
      *reinterpret_cast<__nv_bfloat162*>(tile + r * tc::stride<D>() + e) =
          __floats2bfloat162_rn(t0, t1);
    }
  }
  __syncwarp();
  tc::store_rows<D>(dst, row_stride, tile, row0, n);
}

// dk/dv: one block per (64-key tile, head, batch row); warp w owns keys
// 16w .. 16w + 15. K and V stay in shared memory; the query tiles that
// may attend them (from the diagonal down when causal without a pattern)
// stream Q and dO through the ring. Key-major: S^T = K.Q^T and
// dP^T = V.dO^T come out with a key per row, so P^T and dS^T feed
// dV += P^T.dO and dK += dS^T.Q from registers.
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 3 : 1) dkdv_tc_kernel(
    const tc::bf16* __restrict__ qkv, const tc::bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ kmask, const int8_t* __restrict__ pmask,
    const tc::bf16* __restrict__ cos_t, const tc::bf16* __restrict__ sin_t,
    tc::bf16* __restrict__ dqkv, int n, int heads, int causal, float scale) {
  using tc::bf16;
  constexpr int TE = tc::tile_elems<D>(), KS = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // (64, DS)
  bf16* vs = ks + TE;                            // (64, DS)
  bf16* qs = vs + TE;                            // 2 stages of (64, DS)
  bf16* dos = qs + 2 * TE;                       // 2 stages of (64, DS)
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TE);  // 2 stages of 64
  float* del_s = lse_s + 2 * tc::ROWS;                    // 2 stages of 64
  int8_t* pms = reinterpret_cast<int8_t*>(del_s + 2 * tc::ROWS);  // 2 stages of (64, 64)
  __shared__ uint32_t kbits[2];

  const int kt = blockIdx.z, k0 = kt * tc::ROWS, h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t stride = 3LL * heads * D, hd = (int64_t)heads * D;
  const bf16* base = qkv + (int64_t)b * n * stride;
  const bf16* dobase = dout + (int64_t)b * n * hd + (int64_t)h * D;
  const float* lse_bh = lse + ((int64_t)b * heads + h) * n;
  const float* del_bh = delta + ((int64_t)b * heads + h) * n;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // a tile of masked keys has p = 0 for every query: dk = dv = 0
  if (kmask == nullptr || tc::tile_keys(kmask + (int64_t)b * n, k0, n, kbits)) {
    const uint64_t bits = tc::key_bits(kmask != nullptr, kbits, k0, n);
    const int key0 = 16 * warp + g;  // the thread's keys key0, key0 + 8 of the tile
    const bool kok[2] = {((bits >> key0) & 1) != 0, ((bits >> (key0 + 8)) & 1) != 0};
    const int n_qt = (n + tc::ROWS - 1) / tc::ROWS;
    const bool tri = causal && pmask == nullptr;
    int qt = tri ? kt : 0;
    auto issue = [&](int q_t, int st) {
      const int q0 = q_t * tc::ROWS;
      tc::load_tile_async<D>(qs + st * TE, base + (int64_t)h * D, stride, q0, n);
      tc::load_tile_async<D>(dos + st * TE, dobase, hd, q0, n);
      if (pmask != nullptr) tc::load_mask_tile(pms + st * 4096, pmask, q0, k0, n);
    };
    // lse (times log2(e), for exp_diff) of query q0 + r by threads r < 64,
    // delta by threads 64 + r: loaded a tile ahead, stored after the
    // products so that the load's latency hides behind them
    const int r = threadIdx.x % tc::ROWS;
    auto row_stat = [&](int q_t) {
      const int row = q_t * tc::ROWS + r;
      if (row >= n) return 0.f;
      return threadIdx.x < tc::ROWS ? lse_bh[row] * tc::LOG2E : del_bh[row];
    };
    float* stat_s = threadIdx.x < tc::ROWS ? lse_s : del_s;
    tc::load_tile_async<D>(ks, base + (int64_t)(heads + h) * D, stride, k0, n);
    tc::load_tile_async<D>(vs, base + (int64_t)(2 * heads + h) * D, stride, k0, n);
    issue(qt, 0);
    tc::cp_async_commit();
    stat_s[r] = row_stat(qt);
    for (int st = 0; qt < n_qt; ++qt, st ^= 1) {
      const float next_stat = qt + 1 < n_qt ? row_stat(qt + 1) : 0.f;
      if (qt + 1 < n_qt) issue(qt + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
      __syncthreads();
      const int q0 = qt * tc::ROWS;
      const bf16* q_s = qs + st * TE;
      const bf16* do_s = dos + st * TE;

      const bool need_mask = bits != ~0ull || pmask != nullptr || (causal && q0 == k0) ||
                             q0 + tc::ROWS > n;
      const int8_t* pm_t = pms + st * 4096;
      // the tile's queries in two halves of 32 (fewer live accumulators)
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        float sT[4][4], dpT[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t ka[4], va[4];
          tc::load_a<D>(ka, ks, 16 * warp, 16 * kk);
          tc::load_a<D>(va, vs, 16 * warp, 16 * kk);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t qb[4], db[4];
            tc::load_b_rows<D>(qb, q_s, 32 * hq + 16 * np, 16 * kk);
            tc::load_b_rows<D>(db, do_s, 32 * hq + 16 * np, 16 * kk);
            tc::mma(sT[2 * np], ka, qb[0], qb[1]);
            tc::mma(sT[2 * np + 1], ka, qb[2], qb[3]);
            tc::mma(dpT[2 * np], va, db[0], db[1]);
            tc::mma(dpT[2 * np + 1], va, db[2], db[3]);
          }
        }

        // p^T into sT, ds^T into dpT
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * (e >> 1), c = 32 * hq + 8 * j + 2 * t + (e & 1);
            bool ok = true;
            if (need_mask) {
              ok = kok[e >> 1] && q0 + c < n;
              if (pmask != nullptr) {
                ok = ok && pm_t[c * tc::ROWS + key] != 0;
              } else if (causal) {
                ok = ok && q0 + c >= k0 + key;
              }
            }
            const float sv = ok ? sT[j][e] * scale : NEG_INF;
            const float p =
                sv > 0.5f * NEG_INF ? tc::exp_diff(sv, lse_s[st * tc::ROWS + c]) : 0.f;
            sT[j][e] = p;
            dpT[j][e] = p * (dpT[j][e] - del_s[st * tc::ROWS + c]) * scale;
          }

        // dV += P^T.dO and dK += dS^T.Q over the half's 32 queries
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t pa[4], da[4];
          tc::c_to_a(pa, sT[2 * kk], sT[2 * kk + 1]);
          tc::c_to_a(da, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t db[4], qb[4];
            tc::load_b_cols<D>(db, do_s, 32 * hq + 16 * kk, 16 * dp);
            tc::load_b_cols<D>(qb, q_s, 32 * hq + 16 * kk, 16 * dp);
            tc::mma(dv[2 * dp], pa, db[0], db[1]);
            tc::mma(dv[2 * dp + 1], pa, db[2], db[3]);
            tc::mma(dk[2 * dp], da, qb[0], qb[1]);
            tc::mma(dk[2 * dp + 1], da, qb[2], qb[3]);
          }
        }
      }
      stat_s[(st ^ 1) * tc::ROWS + r] = next_stat;
      __syncthreads();  // stage st is no longer read
    }
  }

  // each warp's own rows of the K and V tiles hold its dk and dv
  bf16* out = dqkv + (int64_t)b * n * stride;
  store_inverse_rotated_tc<D>(dk, ks + 16 * warp * tc::stride<D>(),
                              out + (int64_t)(heads + h) * D, stride, k0 + 16 * warp, n,
                              cos_t, sin_t);
  store_inverse_rotated_tc<D>(dv, vs + 16 * warp * tc::stride<D>(),
                              out + (int64_t)(2 * heads + h) * D, stride, k0 + 16 * warp, n,
                              cos_t, sin_t);
}

// dq: one block per (64-row query tile, head, batch row); warp w owns
// query rows 16w .. 16w + 15. Q and dO stay in shared memory; the key
// tiles up to the diagonal (when causal without a pattern) stream K and V
// through the ring, tiles of masked keys skipped. S = Q.K^T and
// dP = dO.V^T, ds rounded to bf16 into A fragments, dQ += dS.K.
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 4 : 1) dq_tc_kernel(
    const tc::bf16* __restrict__ qkv, const tc::bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ kmask, const int8_t* __restrict__ pmask,
    const tc::bf16* __restrict__ cos_t, const tc::bf16* __restrict__ sin_t,
    tc::bf16* __restrict__ dqkv, int n, int heads, int causal, float scale) {
  using tc::bf16;
  constexpr int TE = tc::tile_elems<D>(), KS = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (64, DS)
  bf16* dos = qs + TE;                           // (64, DS)
  bf16* ks = dos + TE;                           // 2 stages of (64, DS)
  bf16* vs = ks + 2 * TE;                        // 2 stages of (64, DS)
  uint32_t* kbits = reinterpret_cast<uint32_t*>(vs + 2 * TE);  // 2 stages of 2 words
  int8_t* pms = reinterpret_cast<int8_t*>(kbits + 4);         // 2 stages of (64, 64)

  const bool tri = causal && pmask == nullptr;
  const int qt = tri ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * tc::ROWS, h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t stride = 3LL * heads * D, hd = (int64_t)heads * D;
  const bf16* base = qkv + (int64_t)b * n * stride;
  const bf16* ksrc = base + (int64_t)(heads + h) * D;
  const bf16* vsrc = base + (int64_t)(2 * heads + h) * D;
  const uint8_t* kmask_b = kmask == nullptr ? nullptr : kmask + (int64_t)b * n;

  // lse (times log2(e), for exp_diff) and delta of the thread's rows r0
  // and r0 + 8
  const int r0 = q0 + 16 * warp + g;
  float lse_r[2], del_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lse_r[i] = row < n ? lse[((int64_t)b * heads + h) * n + row] * tc::LOG2E : 0.f;
    del_r[i] = row < n ? delta[((int64_t)b * heads + h) * n + row] : 0.f;
  }

  int n_tiles = (n + tc::ROWS - 1) / tc::ROWS;
  if (tri) n_tiles = min(n_tiles, qt + 1);
  auto next_live = [&](int kt, int st) {
    if (kmask_b != nullptr)
      while (kt < n_tiles && !tc::tile_keys(kmask_b, kt * tc::ROWS, n, kbits + 2 * st)) ++kt;
    return kt;
  };
  auto issue = [&](int kt, int st) {
    tc::load_tile_async<D>(ks + st * TE, ksrc, stride, kt * tc::ROWS, n);
    tc::load_tile_async<D>(vs + st * TE, vsrc, stride, kt * tc::ROWS, n);
    if (pmask != nullptr) tc::load_mask_tile(pms + st * 4096, pmask, q0, kt * tc::ROWS, n);
  };

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  int kt = next_live(0, 0), st = 0;
  if (kt < n_tiles) {
    tc::load_tile_async<D>(qs, base + (int64_t)h * D, stride, q0, n);
    tc::load_tile_async<D>(dos, dout + (int64_t)b * n * hd + (int64_t)h * D, hd, q0, n);
    issue(kt, 0);
  }
  tc::cp_async_commit();
  while (kt < n_tiles) {
    const int nxt = next_live(kt + 1, st ^ 1);
    if (nxt < n_tiles) issue(nxt, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * tc::ROWS;
    const bf16* k_s = ks + st * TE;
    const bf16* v_s = vs + st * TE;

    const uint64_t bits = tc::key_bits(kmask_b != nullptr, kbits + 2 * st, k0, n);
    const bool need_mask = bits != ~0ull || pmask != nullptr || (causal && k0 == q0);
    const int8_t* pm_t = pms + st * 4096;
    // the tile's keys in two halves of 32 (fewer live accumulators)
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], da[4];
        tc::load_a<D>(qa, qs, 16 * warp, 16 * kk);
        tc::load_a<D>(da, dos, 16 * warp, 16 * kk);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kb[4], vb[4];
          tc::load_b_rows<D>(kb, k_s, 32 * hk + 16 * np, 16 * kk);
          tc::load_b_rows<D>(vb, v_s, 32 * hk + 16 * np, 16 * kk);
          tc::mma(s[2 * np], qa, kb[0], kb[1]);
          tc::mma(s[2 * np + 1], qa, kb[2], kb[3]);
          tc::mma(dp[2 * np], da, vb[0], vb[1]);
          tc::mma(dp[2 * np + 1], da, vb[2], vb[3]);
        }
      }

      // ds into s
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, row = r0 + 8 * i, c = 32 * hk + 8 * j + 2 * t + (e & 1);
          bool ok = true;
          if (need_mask) {
            ok = ((bits >> c) & 1) && row < n;
            if (pmask != nullptr) {
              ok = ok && pm_t[(row - q0) * tc::ROWS + c] != 0;
            } else if (causal) {
              ok = ok && row >= k0 + c;
            }
          }
          const float sv = ok ? s[j][e] * scale : NEG_INF;
          const float p = sv > 0.5f * NEG_INF ? tc::exp_diff(sv, lse_r[i]) : 0.f;
          s[j][e] = p * (dp[j][e] - del_r[i]) * scale;
        }

      // dQ += dS.K over the half's 32 keys
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t da[4];
        tc::c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp2 = 0; dp2 < D / 16; ++dp2) {
          uint32_t kb[4];
          tc::load_b_cols<D>(kb, k_s, 32 * hk + 16 * kk, 16 * dp2);
          tc::mma(dq[2 * dp2], da, kb[0], kb[1]);
          tc::mma(dq[2 * dp2 + 1], da, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // stage st is no longer read
    kt = nxt;
    st ^= 1;
  }

  store_inverse_rotated_tc<D>(dq, qs + 16 * warp * tc::stride<D>(),
                              dqkv + (int64_t)b * n * stride + (int64_t)h * D, stride,
                              q0 + 16 * warp, n, cos_t, sin_t);
}

template <int D>
int launch_tc(const void* qkv, const void* o, const void* lse, const void* dout,
              const void* kmask, const void* pmask, const void* cos_t, const void* sin_t,
              void* rot_scratch, void* delta, void* dqkv, int batch, int n, int heads,
              int causal, float scale, cudaStream_t stream) {
  typedef __nv_bfloat16 T;
  const int n_t = (n + tc::ROWS - 1) / tc::ROWS;
  if (n_t > 65535 || !tc::aligned16({qkv, o, dout, cos_t, sin_t, rot_scratch, dqkv})) return -1;
  const bool pattern = pmask != nullptr;
  const int smem_kv = dkdv_tc_smem_bytes(D, pattern), smem_q = dq_tc_smem_bytes(D, pattern);
  cudaError_t err = cudaFuncSetAttribute(dkdv_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return (int)err;

  const int width = 3 * heads * D;
  const T* src = (const T*)qkv;
  if (cos_t != nullptr) {
    const int64_t chunks = (int64_t)batch * n * width / 8;
    const int64_t blocks = (chunks + THREADS - 1) / THREADS;
    rotate_tc_kernel<D><<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0, stream>>>(
        (const T*)qkv, (const T*)cos_t, (const T*)sin_t, (T*)rot_scratch, chunks, n, width);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = (const T*)rot_scratch;
  }
  const int64_t chunks = (int64_t)batch * n * heads * D / 8;
  delta_tc_kernel<D><<<(unsigned)((chunks + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      (const T*)o, (const T*)dout, (float*)delta, chunks, n, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid(heads, batch, n_t);
  dkdv_tc_kernel<D><<<grid, tc::THREADS, smem_kv, stream>>>(
      src, (const T*)dout, (const float*)lse, (const float*)delta, (const uint8_t*)kmask,
      (const int8_t*)pmask, (const T*)cos_t, (const T*)sin_t, (T*)dqkv, n, heads, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_tc_kernel<D><<<grid, tc::THREADS, smem_q, stream>>>(
      src, (const T*)dout, (const float*)lse, (const float*)delta, (const uint8_t*)kmask,
      (const int8_t*)pmask, (const T*)cos_t, (const T*)sin_t, (T*)dqkv, n, heads, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* qkv, const void* o, const void* lse, const void* dout,
           const void* kmask, const void* pmask, const void* cos_t,
           const void* sin_t, void* rot_scratch, void* delta, void* dqkv,
           int batch, int n, int heads, int causal, float scale,
           cudaStream_t stream) {
  constexpr int smem_kv = dkdv_smem_bytes<D>();
  constexpr int smem_q = dq_smem_bytes<D>();
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem_kv > smem_max || smem_q > smem_max) return -1;
  err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;

  const int width = 3 * heads * D;
  const T* src = (const T*)qkv;
  if (cos_t != nullptr) {
    const int64_t total = (int64_t)batch * n * width;
    const int64_t blocks = (total + THREADS - 1) / THREADS;
    rotate_kernel<T, D><<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0, stream>>>(
        (const T*)qkv, (const T*)cos_t, (const T*)sin_t, (T*)rot_scratch, total, n, width);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = (const T*)rot_scratch;
  }
  const int64_t warps = (int64_t)batch * n * heads;
  delta_kernel<T, D><<<(unsigned)((warps * 32 + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      (const T*)o, (const T*)dout, (float*)delta, warps, n, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((n + 63) / 64, heads, batch);
  dkdv_kernel<T, D><<<grid, THREADS, smem_kv, stream>>>(
      src, (const T*)dout, (const float*)lse, (const float*)delta,
      (const uint8_t*)kmask, (const int8_t*)pmask, (const T*)cos_t,
      (const T*)sin_t, (T*)dqkv, n, heads, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, D><<<grid, THREADS, smem_q, stream>>>(
      src, (const T*)dout, (const float*)lse, (const float*)delta,
      (const uint8_t*)kmask, (const int8_t*)pmask, (const T*)cos_t,
      (const T*)sin_t, (T*)dqkv, n, heads, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* qkv, const void* o, const void* lse,
               const void* dout, const void* kmask, const void* pmask,
               const void* cos_t, const void* sin_t, void* rot_scratch,
               void* delta, void* dqkv, int batch, int n, int heads,
               int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(qkv, o, lse, dout, kmask, pmask, cos_t, sin_t, rot_scratch, delta, dqkv, batch, n, heads, causal, scale, stream);
    case 64: return launch<T, 64>(qkv, o, lse, dout, kmask, pmask, cos_t, sin_t, rot_scratch, delta, dqkv, batch, n, heads, causal, scale, stream);
    case 128: return launch<T, 128>(qkv, o, lse, dout, kmask, pmask, cos_t, sin_t, rot_scratch, delta, dqkv, batch, n, heads, causal, scale, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. qkv and dqkv (b, n, 3*h*d), o and
// dout (b, n, h*d), all of one type; lse (b, h, 1, n) and delta scratch
// (b, h, n) float32; kmask (b, n) uint8, pmask (n, n) int8, cos/sin (n, d)
// of qkv's type, each may be NULL; rot_scratch (b, n, 3*h*d) of qkv's type,
// needed only with cos/sin. Four launches on `stream` (rotate when tables
// are given, delta, dk/dv, dq). Returns cudaGetLastError() after them (0
// on success), or -1 for what the kernels cannot take: a dim_head other
// than 32/64/128, a dtype code other than 0/1, an empty shape, or more
// heads or batch rows than a grid dimension holds.
extern "C" int fused_qkv_attention_bwd(
    const void* qkv, const void* o, const void* lse, const void* dout,
    const void* kmask, const void* pmask, const void* cos_t, const void* sin_t,
    void* rot_scratch, void* delta, void* dqkv, int batch, int n, int heads,
    int dim_head, int causal, float scale, int dtype, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || batch > 65535 || heads > 65535) return -1;
  if (cos_t != nullptr && rot_scratch == nullptr) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(dim_head, qkv, o, lse, dout, kmask, pmask, cos_t, sin_t, rot_scratch, delta, dqkv, batch, n, heads, causal, scale, s);
  if (dtype == 1) {
    switch (dim_head) {
      case 32: return launch_tc<32>(qkv, o, lse, dout, kmask, pmask, cos_t, sin_t, rot_scratch, delta, dqkv, batch, n, heads, causal, scale, s);
      case 64: return launch_tc<64>(qkv, o, lse, dout, kmask, pmask, cos_t, sin_t, rot_scratch, delta, dqkv, batch, n, heads, causal, scale, s);
      case 128: return launch_tc<128>(qkv, o, lse, dout, kmask, pmask, cos_t, sin_t, rot_scratch, delta, dqkv, batch, n, heads, causal, scale, s);
      default: return -1;
    }
  }
  return -1;
}
