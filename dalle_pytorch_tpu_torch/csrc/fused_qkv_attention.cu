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
// What bounds it. At CLIP's text shapes (b = 8, n = 256, 8 heads of 64,
// bf16, zero-padded prompts) the card needs to read q of the batch rows
// that attend any key, K and V at the unmasked keys only, and write o and
// the lse once: with chip_smoke.py's key mask (909 of 2048 keys valid, one
// row fully masked) ~5.9 MB, ~1.75 us at 3.35 TB/s, against ~0.5 us for
// the 4*d operations per valid (query, key) pair and head at the tensor
// cores' bf16 rate: bytes bound it, and nothing but q, k, v, the masks
// and o touches device memory. The design keeps every (n, n)
// intermediate on chip, reads each q/k/v element once per block that
// needs it (rotating it on load) and skips key tiles the key mask wholly
// masks (and q, when that is every tile), and writes o straight into the
// projection's layout, so no split, transpose or rotary pass goes through
// device memory. It does not reach that bound: the products run on
// CUDA-core float32 FMAs from shared memory, not on the tensor cores.
// wgmma/mma.sync bf16 tiles, vectorised 16-byte loads and cp.async/TMA
// double buffering of the K/V tiles are the known next steps.
//
// Layout: one block of 256 threads per (64-row q tile, head, batch row).
// The q tile is rotated once into shared memory, transposed (d, 64 + 1),
// before the first key tile that has a valid key; each 64-key K tile
// (transposed) and V tile (row-major) is rotated on load; tiles wholly
// above the diagonal are skipped when causal without a pattern, and so
// are tiles of masked keys. Thread (ty, tx), 16 x 16, owns query rows
// ty + 16*i and key columns tx + 16*j (i, j < 4) of a score tile and
// output columns tx + 16*c (c < d / 16); a row's 16 owners share one
// half-warp, so its max and sum reduce with shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int TP = BQ + 1;   // padded stride of the transposed tiles
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

// element e of row `row` (global) of one head's q, k or v, rotated when
// cos_t is given; 0 past the sequence end
template <typename T, int D>
__device__ __forceinline__ float load_rotated(
    const T* __restrict__ src, int64_t stride, int row, int e, int n,
    const T* __restrict__ cos_t, const T* __restrict__ sin_t) {
  if (row >= n) return 0.f;
  const T* r = src + (int64_t)row * stride;
  const float t = to_f32<T>(r[e]);
  if (cos_t == nullptr) return t;
  const float partner = to_f32<T>(r[e ^ 1]);
  const float half = (e & 1) ? partner : -partner;  // rotate_half(t)[e]
  const float c = to_f32<T>(cos_t[(int64_t)row * D + e]);
  const float s = to_f32<T>(sin_t[(int64_t)row * D + e]);
  const float a = round_to<T>(__fmul_rn(t, c));
  const float b = round_to<T>(__fmul_rn(half, s));
  return round_to<T>(__fadd_rn(a, b));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) fused_qkv_fwd_kernel(
    const T* __restrict__ qkv, const uint8_t* __restrict__ kmask,
    const int8_t* __restrict__ pmask, const T* __restrict__ cos_t,
    const T* __restrict__ sin_t, T* __restrict__ out, float* __restrict__ lse,
    int n, int heads, int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int CJ = D / 16;  // output columns per thread
  float* qT = smem;           // (D, TP): q tile, transposed
  float* kT = qT + D * TP;    // (D, TP): key tile, transposed
  float* vs = kT + D * TP;    // (BK, D): value tile
  float* pT = vs + BK * D;    // (BK, TP): probabilities, key-major
  float* kok = pT + BK * TP;  // (BK): key exists and passes the key mask

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t stride = 3LL * heads * D;
  const T* base = qkv + (int64_t)b * n * stride;
  const T* qsrc = base + (int64_t)h * D;
  const T* ksrc = base + (int64_t)(heads + h) * D;
  const T* vsrc = base + (int64_t)(2 * heads + h) * D;

  float acc[4][CJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (n + BK - 1) / BK;
  if (causal && pmask == nullptr) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  bool q_loaded = false;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is no longer read
    int any_key = 0;
    for (int c = tid; c < BK; c += THREADS) {
      const int col = k0 + c;
      kok[c] = (col < n && (kmask == nullptr || kmask[(int64_t)b * n + col] != 0)) ? 1.f : 0.f;
      any_key |= kok[c] != 0.f;
    }
    // A tile of masked keys gives p = 0 everywhere and leaves m, l and acc
    // exactly as they are, so it is not loaded; nor is q while every tile
    // so far was such a tile (a fully masked batch row reads no q, k or v).
    if (!__syncthreads_or(any_key)) continue;
    if (!q_loaded) {
      for (int x = tid; x < BQ * D; x += THREADS) {
        const int r = x / D, e = x % D;
        qT[e * TP + r] = load_rotated<T, D>(qsrc, stride, q0 + r, e, n, cos_t, sin_t);
      }
      q_loaded = true;
    }
    for (int x = tid; x < BK * D; x += THREADS) {
      const int r = x / D, e = x % D;
      kT[e * TP + r] = load_rotated<T, D>(ksrc, stride, k0 + r, e, n, cos_t, sin_t);
      vs[r * D + e] = load_rotated<T, D>(vsrc, stride, k0 + r, e, n, cos_t, sin_t);
    }
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
      for (int i = 0; i < 4; ++i) qv[i] = qT[e * TP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kT[e * TP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = kok[tx + 16 * j] != 0.f && row < n;
        if (pmask != nullptr) {
          ok = ok && pmask[(int64_t)row * n + col] != 0;
        } else if (causal) {
          ok = ok && row >= col;
        }
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > 0.5f * NEG_INF ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        pT[(tx + 16 * j) * TP + ty + 16 * i] = round_to<T>(p);
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
    for (int k = 0; k < BK; ++k) {
      float pv[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = pT[k * TP + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CJ; ++c) vv[c] = vs[k * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  const int64_t hd = (int64_t)heads * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* o_row = out + ((int64_t)b * n + row) * hd + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < CJ; ++c) o_row[tx + 16 * c] = from_f32<T>(acc[i][c] / l_safe);
    if (tx == 0) lse[((int64_t)b * heads + h) * n + row] = m[i] + logf(l_safe);
  }
}

constexpr int smem_bytes(int d) {
  return 4 * (2 * d * TP + BK * d + BK * TP + BK);
}

template <typename T, int D>
int launch(const void* qkv, const void* kmask, const void* pmask,
           const void* cos_t, const void* sin_t, void* out, void* lse,
           int batch, int n, int heads, int causal, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes(D);
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > smem_max) return -1;
  err = cudaFuncSetAttribute(
      fused_qkv_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BQ - 1) / BQ, heads, batch);
  fused_qkv_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)qkv, (const uint8_t*)kmask, (const int8_t*)pmask,
      (const T*)cos_t, (const T*)sin_t, (T*)out, (float*)lse, n, heads,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* qkv, const void* kmask, const void* pmask,
               const void* cos_t, const void* sin_t, void* out, void* lse,
               int batch, int n, int heads, int causal, float scale,
               cudaStream_t stream) {
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
// other than 0/1, an empty shape, or more heads or batch rows than a grid
// dimension holds.
extern "C" int fused_qkv_attention_fwd(
    const void* qkv, const void* kmask, const void* pmask, const void* cos_t,
    const void* sin_t, void* out, void* lse, int batch, int n, int heads,
    int dim_head, int causal, float scale, int dtype, void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || batch > 65535 || heads > 65535) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(dim_head, qkv, kmask, pmask, cos_t, sin_t, out, lse, batch, n, heads, causal, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(dim_head, qkv, kmask, pmask, cos_t, sin_t, out, lse, batch, n, heads, causal, scale, s);
  return -1;
}
