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
// causal, float32) the five (n, n, d) products over the causal pairs are
// ~3.4e10 operations, 0.5 ms at the card's 67 TFLOP/s float32 rate,
// against ~0.3 ms of bytes (qkv, o, do, dqkv, lse, tables once each):
// operations bound it. The design keeps every (n, n) intermediate on
// chip and tiles FA-2 style, with no float atomics so that gradients are
// the same from run to run:
//   1. rotate_kernel rotates q, k and v once into a scratch copy of qkv
//      (skipped without tables), so no pass re-rotates a tile per visit;
//      delta_kernel computes delta once per (row, head);
//   2. dkdv_kernel: one block per (64-key tile, head, batch row) holds
//      its K and V tiles and walks the query tiles that may attend them
//      (from the diagonal down when causal), recomputing p from the lse,
//      and accumulates dk and dv in registers;
//   3. dq_kernel: one block per (64-row query tile, head, batch row)
//      walks the key tiles up to the diagonal and accumulates dq.
// Key tiles whose keys are all masked are skipped in both passes. The
// products run as float32 FMAs on the CUDA cores from shared memory; the
// tensor cores (mma.sync / wgmma bf16 tiles), cp.async/TMA double
// buffering and one fused pass are the known next steps.
//
// Tiles are 64 x d floats in shared memory with a padded row stride of
// d + 1, so a half-warp reading 16 different rows at one column hits 16
// banks. Thread (ty, tx), 16 x 16, owns rows ty + 16*a and columns
// tx + 16*b of a 64 x 64 score tile, and rows ty + 16*a, channels
// tx + 16*c of the accumulators; channel pairs (2i, 2i+1) sit on lanes
// l and l ^ 1, so the inverse rotation exchanges partners by shuffle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int SP = BK + 1;    // padded stride of the (BQ, BK) p and ds tiles
constexpr int THREADS = 256;

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
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(dim_head, qkv, o, lse, dout, kmask, pmask, cos_t, sin_t, rot_scratch, delta, dqkv, batch, n, heads, causal, scale, s);
  return -1;
}
