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
// Layout: each (head, batch row) is a thread-block cluster of S blocks of
// 8 warps (S = 1, 2, 4 or 8, chosen by the wrapper,
// ops/decode_attention.py:decode_splits, and given at launch as the
// cluster's dimension). Block `rank` sweeps one contiguous slice of the
// rows, [rank * idx / S, (rank + 1) * idx / S): one block per head left
// the sweep of a long cache bound by the latency of 16 SMs' loads at
// batch 1 (flash-decoding). A cache row of one head is d * sizeof(T)
// bytes, read as 16-byte vectors by C = d * sizeof(T) / 16 lanes (a row
// under 16 bytes by one lane, in one load), so a warp covers G = 32 / C
// rows at a time and each lane group of C lanes reduces its row's dot
// product with xor shuffles. Each group takes U rows a pass, their K and
// V loads issued together one pass ahead (the first pass's while the
// fresh row is prepared), and keeps its own online softmax (max,
// denominator, accumulator over its lanes' channels), updated once a
// pass. The block merges its 8 * G partials into one (m, l, acc) in
// shared memory; after a cluster barrier, block 0 merges the S blocks'
// partials, read through distributed shared memory in rank order, with
// the fresh token and writes out; a second barrier keeps every block's
// shared memory alive until then. A partial with l = 0 (an empty slice,
// or one whose keys are all masked) has weight 0. One launch a layer and
// step; the merge order is fixed, so two runs give identical results.
// Timed at the flagship's decode shape (bf16, 16 x 64, L 1281, on an
// H100): 8 warps a block beat 4, one update a pass beat one a row, loads
// one pass ahead beat none, and at batch 1 four blocks of 8 warps a head
// beat eight; the merge and its barriers cost more as S grows.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;           // rows per lane group and pass
constexpr int MAX_SPLITS = 8;  // the largest portable cluster

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
  static_assert(P <= THREADS, "one thread per partial");
  using Raw = typename RawVec<E * sizeof(T)>::type;

  __shared__ float q_s[D], v_s[D];
  __shared__ float m_s[P], l_s[P], w_s[P];
  __shared__ float acc_s[P * D];
  __shared__ float red_s[WARPS];
  __shared__ float part_s[2 + D];  // the block's (m, l, acc[D]), read by rank 0

  const cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int hh = blockIdx.x / S, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t hd = (int64_t)heads * D;

  // 3a. the block's slice [lo, hi) of rows [0, idx): lane group g of the
  // warp, lanes [sub * E, +E), U rows a pass; the first pass's K and V
  // rows are in flight while the fresh row is prepared
  const int lo = (int)((int64_t)rank * idx / S), hi = (int)((int64_t)(rank + 1) * idx / S);
  const int g = lane / C, sub = lane % C, e0 = sub * E;
  constexpr int STEP = WARPS * U * G;  // rows a pass of the block
  const T* kb = k_cache + (int64_t)b * L * hd + (int64_t)hh * D + e0;
  const T* vb = v_cache + (int64_t)b * L * hd + (int64_t)hh * D + e0;
  const int32_t* mb = key_mask == nullptr ? nullptr : key_mask + (int64_t)b * L;
  Raw kraw[U], vraw[U];
  bool live[U];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * G + g;
      live[u] = r < hi;
      if (live[u]) {
        kraw[u] = __ldg(reinterpret_cast<const Raw*>(kb + (int64_t)r * hd));
        vraw[u] = __ldg(reinterpret_cast<const Raw*>(vb + (int64_t)r * hd));
        if (mb != nullptr) live[u] = mb[r] > 0;
      } else {
        kraw[u] = Raw{};
        vraw[u] = kraw[u];
      }
    }
  };
  int base = lo + warp * U * G;
  load(base);

  // 1-2. load, rotate, round the fresh row; thread c owns channel c.
  // Every block needs q; rank 0 writes the rows and scores the fresh key.
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
    q_s[c] = __fmul_rn(q, scale);
    if (rank == 0) {
      const T ks = from_f32<T>(k), vs = from_f32<T>(v);
      k_row[(int64_t)b * hd + (int64_t)hh * D + c] = ks;
      v_row[(int64_t)b * hd + (int64_t)hh * D + c] = vs;
      v_s[c] = to_f32<T>(vs);
      s_part = q_s[c] * to_f32<T>(ks);
    }
  }
  for (int o = 16; o > 0; o >>= 1) s_part += __shfl_xor_sync(0xffffffffu, s_part, o);
  if (lane == 0) red_s[warp] = s_part;
  __syncthreads();

  // 3b. the sweep: each lane group's online softmax over its rows
  float qr[E];
#pragma unroll
  for (int i = 0; i < E; ++i) qr[i] = q_s[e0 + i];
  const float minus_inf = __int_as_float(0xff800000u);
  float m = minus_inf, l = 0.f, acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;
  for (; base < hi; base += STEP) {  // uniform over the warp
    Raw kcur[U], vcur[U];
    bool lcur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kcur[u] = kraw[u];
      vcur[u] = vraw[u];
      lcur[u] = live[u];
    }
    if (base + STEP < hi) load(base + STEP);  // the next pass in flight
    // the pass's U scores, then one max, one rescale and U weights: the
    // online softmax's serial chain is one step a pass, not one a row
    float sc[U], mx = minus_inf;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[E];
      unpack<T, E>(kcur[u], x);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) s = fmaf(qr[i], x[i], s);
#pragma unroll
      for (int o = C / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      sc[u] = s;
      if (lcur[u]) mx = fmaxf(mx, s);
    }
    if (mx != minus_inf) {  // the same on every lane of the group
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (lcur[u]) {
          const float p = expf(sc[u] - m_new);
          float x[E];
          unpack<T, E>(vcur[u], x);
          l += p;
#pragma unroll
          for (int i = 0; i < E; ++i) acc[i] = fmaf(p, x[i], acc[i]);
        }
      }
      m = m_new;
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

  // 4. the block's partials into one: weight 0 where l = 0
  float M = minus_inf;
  for (int j = 0; j < P; ++j) M = l_s[j] > 0.f ? fmaxf(M, m_s[j]) : M;
  if (tid < P) w_s[tid] = l_s[tid] > 0.f ? expf(m_s[tid] - M) : 0.f;
  __syncthreads();
  if (own) {
    float a = 0.f;
    for (int j = 0; j < P; ++j) a = fmaf(w_s[j], acc_s[j * D + c], a);
    part_s[2 + c] = a;
  }
  if (tid == 0) {
    float sum = 0.f;
    for (int j = 0; j < P; ++j) sum = fmaf(w_s[j], l_s[j], sum);
    part_s[0] = M;
    part_s[1] = sum;
  }
  cluster.sync();  // every block's partial is written and visible

  // 5. rank 0: the S partials in rank order and the fresh token
  if (rank == 0) {
    float pm[MAX_SPLITS], pl[MAX_SPLITS];
    const float* peer[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < S) {
        peer[r] = cluster.map_shared_rank(part_s, r);
        pm[r] = peer[r][0];
        pl[r] = peer[r][1];
      }
    }
    float s_new = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s_new += red_s[w];
    const bool new_live = mb == nullptr || mb[idx] > 0;
    float Mc = new_live ? s_new : minus_inf;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < S && pl[r] > 0.f) Mc = fmaxf(Mc, pm[r]);
    if (own) {
      const float p_new = new_live ? expf(s_new - Mc) : 0.f;
      float num = p_new * v_s[c], den = p_new;
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        if (r < S) {
          const float w = pl[r] > 0.f ? expf(pm[r] - Mc) : 0.f;
          num = fmaf(w, peer[r][2 + c], num);
          den = fmaf(w, pl[r], den);
        }
      }
      out[(int64_t)b * hd + (int64_t)hh * D + c] = from_f32<T>(num / (den == 0.f ? 1.f : den));
    }
  }
  cluster.sync();  // no block leaves while rank 0 reads its partial
}

template <typename T, int D>
int launch(const void* qkv, const void* k_cache, const void* v_cache,
           const void* cos_t, const void* sin_t, const void* key_mask, void* out,
           void* k_row, void* v_row, int batch, int heads, int L, int idx,
           float scale, int splits, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads * splits, batch);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_kernel<T, D>, (const T*)qkv, (const T*)k_cache, (const T*)v_cache,
      (const T*)cos_t, (const T*)sin_t, (const int32_t*)key_mask, (T*)out, (T*)k_row,
      (T*)v_row, heads, L, idx, scale);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* qkv, const void* k_cache, const void* v_cache,
               const void* cos_t, const void* sin_t, const void* key_mask,
               void* out, void* k_row, void* v_row, int batch, int heads, int L,
               int idx, float scale, int splits, cudaStream_t s) {
  switch (d) {
    case 1: return launch<T, 1>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, splits, s);
    case 2: return launch<T, 2>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, splits, s);
    case 4: return launch<T, 4>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, splits, s);
    case 8: return launch<T, 8>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, splits, s);
    case 16: return launch<T, 16>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, splits, s);
    case 32: return launch<T, 32>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, splits, s);
    case 64: return launch<T, 64>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, splits, s);
    case 128: return launch<T, 128>(qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, splits, s);
    default: return -1;
  }
}

}  // namespace

// qkv (batch, 1, 3*heads*dim_head); k_cache, v_cache (batch, L, heads*dim_head)
// of qkv's type, 16-byte aligned; cos_t, sin_t (> idx rows, dim_head) of
// qkv's type, or both null (no rotary); key_mask (batch, L) int32 or null;
// out, k_row, v_row (batch, 1, heads*dim_head); splits: the blocks a
// (head, batch row) is split over, 1, 2, 4 or 8. dtype: 0 = float32, 1 =
// bfloat16. Returns the launch's error (0 on success), or -1 for what the
// kernel cannot take: a dim_head other than 1/2/4/.../128 (the divisors
// of 128 that JAX's `fused_decode_supported` admits), a dtype code other
// than 0/1, idx outside [0, L), an empty batch, more batch rows than a
// grid dimension holds, or another split.
extern "C" int decode_attention_fwd(
    const void* qkv, const void* k_cache, const void* v_cache, const void* cos_t,
    const void* sin_t, const void* key_mask, void* out, void* k_row, void* v_row,
    int batch, int heads, int dim_head, int L, int idx, float scale, int splits,
    int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || idx < 0 || idx >= L) return -1;
  if (splits != 1 && splits != 2 && splits != 4 && splits != MAX_SPLITS) return -1;
  if ((int64_t)heads * splits > 0x7fffffff) return -1;
  if ((cos_t == nullptr) != (sin_t == nullptr)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(dim_head, qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, splits, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(dim_head, qkv, k_cache, v_cache, cos_t, sin_t, key_mask, out, k_row, v_row, batch, heads, L, idx, scale, splits, s);
  return -1;
}
