// Fused single-token decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel behind `fused_decode_attention` in
// dalle_pytorch_tpu/ops/decode_attention.py (`_kernel`, `_kernel_nomask`).
// Python wrapper: dalle_pytorch_tpu_torch/ops/decode_attention.py:
// fused_decode_attention; plain version: reference_fused_decode there.
//
// What it computes, for each batch row b and head hh, from the packed
// projection row qkv (B, 1, 3*h*d) ([q | k | v], each (h, d)-major):
//   1. q, k, v of the head in float32, rotated at position idx when cos/sin
//      (T, d) tables are given: t * cos + rotate_half(t) * sin, where
//      rotate_half pairs channels (2i, 2i+1) -> (-t[2i+1], t[2i]). The
//      products and the sum are rounded one by one (__fmul_rn, __fadd_rn):
//      no FMA contraction, so the rows equal eager PyTorch's bit for bit.
//      Rotation applies to v too (the DALL-E quirk).
//   2. k_row / v_row = the rotated k / v rounded to the cache type, stored
//      for the caller to write into the caches at idx; the fresh key and
//      value enter the softmax as those rounded values.
//   3. scores of q * d**-0.5 against the cache rows [0, idx) (STRICT: the
//      stale row at idx is never read) and against the fresh key, where a
//      key is live unless the optional int32 (B, L) key mask is 0 there
//      (the mask applies to the fresh key at idx too; a masked fresh key
//      never enters the max); softmax over the live keys; out = P V in
//      float32, rounded to qkv's type. A row with no live key gives 0.
// The caches are read only.
//
// What bounds it. Bytes: one decode step reads the K and V rows [0, idx)
// of its head once (2 * idx * d elements) plus one qkv row, and does
// about 4 * idx * d flops, far below the card's ~295 flops per byte: the
// kernel is memory- or latency-bound, so it uses no tensor cores. The TPU
// kernel DMAs all L rows of the cache block; this one reads only the live
// rows [0, idx).
//
// Layout: one block of 4 warps per (head, batch row). A cache row of one
// head is d * sizeof(T) bytes, read as 16-byte vectors by C = d * sizeof(T)
// / 16 lanes (a row under 16 bytes by one lane, in one load), so a warp
// covers G = 32 / C rows at a time and each lane
// group of C lanes reduces its row's dot product with xor shuffles. Each
// group takes U rows a pass (their K and V loads issued together) and keeps
// its own online softmax (max, denominator, accumulator over its lanes'
// channels); the block then merges the 4 * G partial softmaxes and the
// fresh token in shared memory. At batch 1 this is 16 blocks for the
// flagship's 16 heads on 132 SMs, so the sweep is latency-bound; splitting
// a long cache over several blocks (flash-decoding) is the known next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;  // rows per lane group and pass

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

// One lane's slice of a cache row, E channels of type T, loaded as one
// vector of E * sizeof(T) bytes (16 for every head of 16 bytes or more).
template <int BYTES> struct RawVec;
template <> struct RawVec<16> { using type = uint4; };
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<4> { using type = unsigned int; };
template <> struct RawVec<2> { using type = unsigned short; };

template <typename T, int E, typename R>
__device__ __forceinline__ void unpack(const R& raw, float* x) {
  const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < E; ++i) x[i] = to_f32<T>(t[i]);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_kernel(
    const T* __restrict__ qkv, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const T* __restrict__ cos_t,
    const T* __restrict__ sin_t, const int32_t* __restrict__ key_mask,
    T* __restrict__ out, T* __restrict__ k_row, T* __restrict__ v_row,
    int heads, int L, int idx, float scale) {
  constexpr int E = (D * (int)sizeof(T) < 16) ? D : 16 / (int)sizeof(T);  // channels a lane loads
  constexpr int C = D / E;           // lanes per cache row
  constexpr int G = 32 / C;          // rows per warp
  constexpr int P = WARPS * G;       // partial softmaxes per block
  static_assert(C >= 1 && C <= 32 && 32 % C == 0, "unsupported head width");
  using Raw = typename RawVec<E * sizeof(T)>::type;

  __shared__ float q_s[D], k_s[D], v_s[D];
  __shared__ float m_s[P], l_s[P], w_s[P];
  __shared__ float acc_s[P * D];
  __shared__ float red_s[WARPS];

  const int hh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t hd = (int64_t)heads * D;

  // 1-2. load, rotate, round the fresh row; thread c owns channel c
  const T* row = qkv + (int64_t)b * 3 * hd + (int64_t)hh * D;
  const int c = tid;
  const bool own = c < D;
  float q = own ? to_f32<T>(row[c]) : 0.f;
  float k = own ? to_f32<T>(row[hd + c]) : 0.f;
  float v = own ? to_f32<T>(row[2 * hd + c]) : 0.f;
  if (cos_t != nullptr) {  // uniform over the block: every lane shuffles
    const float cs = own ? to_f32<T>(cos_t[(int64_t)idx * D + c]) : 0.f;
    const float sn = own ? to_f32<T>(sin_t[(int64_t)idx * D + c]) : 0.f;
    const float sign = (c & 1) ? 1.f : -1.f;
    const float qp = sign * __shfl_xor_sync(0xffffffffu, q, 1);
    const float kp = sign * __shfl_xor_sync(0xffffffffu, k, 1);
    const float vp = sign * __shfl_xor_sync(0xffffffffu, v, 1);
    q = __fadd_rn(__fmul_rn(q, cs), __fmul_rn(qp, sn));
    k = __fadd_rn(__fmul_rn(k, cs), __fmul_rn(kp, sn));
    v = __fadd_rn(__fmul_rn(v, cs), __fmul_rn(vp, sn));
  }
  float s_part = 0.f;
  if (own) {
    const T ks = from_f32<T>(k), vs = from_f32<T>(v);
    k_row[(int64_t)b * hd + (int64_t)hh * D + c] = ks;
    v_row[(int64_t)b * hd + (int64_t)hh * D + c] = vs;
    q_s[c] = __fmul_rn(q, scale);
    k_s[c] = to_f32<T>(ks);
    v_s[c] = to_f32<T>(vs);
    s_part = q_s[c] * k_s[c];
  }
  for (int o = 16; o > 0; o >>= 1) s_part += __shfl_xor_sync(0xffffffffu, s_part, o);
  if (lane == 0) red_s[warp] = s_part;
  __syncthreads();

  // 3. sweep rows [0, idx): lane group g of the warp, lanes [sub * E, +E)
  const int g = lane / C, sub = lane % C, e0 = sub * E;
  float qr[E];
#pragma unroll
  for (int i = 0; i < E; ++i) qr[i] = q_s[e0 + i];
  const float minus_inf = __int_as_float(0xff800000u);
  float m = minus_inf, l = 0.f, acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;

  const T* kb = k_cache + (int64_t)b * L * hd + (int64_t)hh * D + e0;
  const T* vb = v_cache + (int64_t)b * L * hd + (int64_t)hh * D + e0;
  const int32_t* mb = key_mask == nullptr ? nullptr : key_mask + (int64_t)b * L;
  for (int base = warp * U * G; base < idx; base += WARPS * U * G) {
    Raw kraw[U], vraw[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * G + g;
      live[u] = r < idx;
      if (live[u]) {
        kraw[u] = __ldg(reinterpret_cast<const Raw*>(kb + (int64_t)r * hd));
        vraw[u] = __ldg(reinterpret_cast<const Raw*>(vb + (int64_t)r * hd));
        if (mb != nullptr) live[u] = mb[r] > 0;
      } else {
        kraw[u] = Raw{};
        vraw[u] = kraw[u];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[E];
      unpack<T, E>(kraw[u], x);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) s = fmaf(qr[i], x[i], s);
#pragma unroll
      for (int o = C / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (live[u]) {
        const float m_new = fmaxf(m, s);
        const float corr = expf(m - m_new);
        const float p = expf(s - m_new);
        unpack<T, E>(vraw[u], x);
        l = l * corr + p;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[i] = fmaf(p, x[i], acc[i] * corr);
        m = m_new;
      }
    }
  }
  const int part = warp * G + g;
  if (sub == 0) {
    m_s[part] = m;
    l_s[part] = l;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) acc_s[part * D + e0 + i] = acc[i];
  __syncthreads();

  // 4. merge the partials and the fresh token
  float s_new = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s_new += red_s[w];
  const bool new_live = mb == nullptr || mb[idx] > 0;
  float M = new_live ? s_new : minus_inf;
  for (int j = 0; j < P; ++j) M = l_s[j] > 0.f ? fmaxf(M, m_s[j]) : M;
  if (tid < P) w_s[tid] = l_s[tid] > 0.f ? expf(m_s[tid] - M) : 0.f;
  __syncthreads();
  if (own) {
    const float p_new = new_live ? expf(s_new - M) : 0.f;
    float num = p_new * v_s[c], den = p_new;
    for (int j = 0; j < P; ++j) {
      num = fmaf(w_s[j], acc_s[j * D + c], num);
      den = fmaf(w_s[j], l_s[j], den);
    }
    out[(int64_t)b * hd + (int64_t)hh * D + c] = from_f32<T>(num / (den == 0.f ? 1.f : den));
  }
}

template <typename T, int D>
int launch(const void* qkv, const void* k_cache, const void* v_cache,
           const void* cos_t, const void* sin_t, const void* key_mask, void* out,
           void* k_row, void* v_row, int batch, int heads, int L, int idx,
           float scale, cudaStream_t stream) {
  decode_kernel<T, D><<<dim3(heads, batch), THREADS, 0, stream>>>(
      (const T*)qkv, (const T*)k_cache, (const T*)v_cache, (const T*)cos_t,
      (const T*)sin_t, (const int32_t*)key_mask, (T*)out, (T*)k_row, (T*)v_row,
      heads, L, idx, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* qkv, const void* k_cache, const void* v_cache,
               const void* cos_t, const void* sin_t, const void* key_mask,
               void* out, void* k_row, void* v_row, int batch, int heads, int L,
               int idx, float scale, cudaStream_t s) {
  switch (d) {
    case 1: return launch<T, 1>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, s);
    case 2: return launch<T, 2>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, s);
    case 4: return launch<T, 4>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, s);
    case 8: return launch<T, 8>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, s);
    case 16: return launch<T, 16>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, s);
    case 32: return launch<T, 32>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, s);
    case 64: return launch<T, 64>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, s);
    case 128: return launch<T, 128>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, s);
    default: return -1;
  }
}

}  // namespace

// qkv (batch, 1, 3*heads*dim_head); k_cache, v_cache (batch, L, heads*dim_head)
// of qkv's type, 16-byte aligned; cos_t, sin_t (> idx rows, dim_head) of
// qkv's type, or both null (no rotary); key_mask (batch, L) int32 or null;
// out, k_row, v_row (batch, 1, heads*dim_head). dtype: 0 = float32, 1 =
// bfloat16. Returns cudaGetLastError() after the launch (0 on success), or
// -1 for what the kernel cannot take: a dim_head other than 1/2/4/.../128 (the
// divisors of 128 that JAX's `fused_decode_supported` admits), a
// dtype code other than 0/1, idx outside [0, L), or an empty batch.
extern "C" int decode_attention_fwd(
    const void* qkv, const void* k_cache, const void* v_cache, const void* cos_t,
    const void* sin_t, const void* key_mask, void* out, void* k_row, void* v_row,
    int batch, int heads, int dim_head, int L, int idx, float scale, int dtype,
    void* stream) {
  if (batch < 1 || heads < 1 || idx < 0 || idx >= L) return -1;
  if ((cos_t == nullptr) != (sin_t == nullptr)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(dim_head, qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(dim_head, qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, s);
  return -1;
}
