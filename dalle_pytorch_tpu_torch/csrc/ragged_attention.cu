// Ragged paged attention for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel `_ragged_kernel` behind `kernel_attend`
// in dalle_pytorch_tpu/ops/ragged_attention.py, both of its branches:
// unquantized pages (`ragged_attention_fwd`) and int8 pages with
// per-(token, head) float32 scale pages (`quant=True`,
// `ragged_attention_fwd_int8`). Python wrappers:
// dalle_pytorch_tpu_torch/ops/ragged_attention.py:kernel_attend and
// kernel_attend_int8.
//
// What it computes. q (B, W, h*d) pre-scaled; K/V pools viewed flat as
// (pages, page, h*d); table (B, n_pages) int32 GLOBAL page ids; start,
// length (B,) int32. Query column i of row b sits at position
// start[b] + i; key p = j*page + c (logical page j) is visible iff
// p <= start + i. Each row walks its table's pages in order with an
// online softmax (float32 max, denominator and accumulator), stopping at
// the frontier last_pos = start + max(length, 1) - 1. Idle rows
// (length 0) compute one column and still visit page 0, so their output
// (which callers discard) stays finite; the engine issues them at start 0,
// where that costs one key row. A row whose denominator is 0 writes 0.
// NEG_INF = -1e30 and p = 0 where s <= 0.5 * NEG_INF, as on the TPU.
// Probabilities are rounded to the compute type before the value
// product, as the TPU kernel's p.astype(v.dtype) does.
//
// Int8 pages. The scale pools are (pages, page, h) float32 and a page's
// scales are reached through the SAME table entry as its bytes. Each
// element is dequantized as it is staged: float(int8) * scale[token,
// head] in float32, then rounded to the compute type T — exactly
// paged_kv.dequant, whose final cast matters at bf16 (an uncast float32
// product would differ from the plain version in low bits). The rest of
// the kernel is the unquantized one: the staging tiles were float32
// already, so only the page load changes.
//
// What bounds it. Bytes: a row reads its frontier's K and V once (at the
// serving shapes up to 1281 positions x 1024 channels x 2 tensors; int8
// halves that at bf16 and adds 4 bytes per (position, head) of scales)
// and does about 2 * valid_queries * frontier * h*d * 2 flops, far below
// the ~295 flops per byte at which H100's tensor cores would become the
// limit. The design therefore spends nothing on tensor cores: CUDA-core
// float32 FMAs from shared memory, and it reads only what the frontier
// needs — pages past it are never loaded (the TPU kernel still streams
// them), rows past the frontier inside its page are not loaded, and only
// the max(length, 1) valid query columns are computed; columns past them
// are written as zeros (callers discard them).
//
// Wide blocks (a whole prompt in one step, up to the sequence length) are
// cut into tiles of MAX_W query columns: the grid's third axis, each block
// one (head, row, tile) that walks the row's pages up to its own tile's
// frontier; a tile past a row's valid columns writes zeros.
//
// Layout: one block of 128 threads per (head, row, tile); the K/V page tile is
// staged in shared memory as float32 with rows padded to d + 1 so that
// thread-per-key dot products are bank-conflict free. Single-buffered:
// overlapping the next page's load with this page's math (cp.async or
// TMA), splitting a long frontier over several blocks, and vectorised
// 16-byte loads are the known next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int MAX_W = 64;

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One staged element of a page: a value of the compute type T as is, or
// an int8 value dequantized with its (token, head) scale and rounded to T.
template <typename T>
__device__ __forceinline__ float load_elem(const T* p, int64_t i, const float*, int64_t) {
  return to_f32<T>(p[i]);
}
template <typename T>
__device__ __forceinline__ float load_elem(const int8_t* p, int64_t i, const float* scale,
                                           int64_t si) {
  return round_to<T>(static_cast<float>(p[i]) * scale[si]);
}

// S: the pools' storage type, T or int8_t (then k_scale / v_scale are the
// float32 scale pools; unused otherwise).
template <typename T, typename S, int D>
__global__ void __launch_bounds__(THREADS) ragged_kernel(
    const T* __restrict__ q, const S* __restrict__ k_pool,
    const S* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ table,
    const int32_t* __restrict__ start, const int32_t* __restrict__ length,
    T* __restrict__ out, int width, int heads, int page, int n_pages) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;           // padded tile row
  constexpr int G = THREADS / D;      // query rows covered per pass
  constexpr int R = (MAX_W + G - 1) / G;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t hd = (int64_t)heads * D;
  const int t0 = blockIdx.z * MAX_W;          // the tile's first column
  const int tw = min(width - t0, MAX_W);      // its columns
  const int wt = min(width, MAX_W);           // tile width of the smem layout
  const int st = start[b] + t0;               // position of the tile's column 0
  const int nq = min(max(length[b], 1) - t0, tw);  // valid columns of the tile
  const int last_pos = st + nq - 1;
  const int64_t row0 = (int64_t)b * width * hd + (int64_t)t0 * hd + (int64_t)h * D;

  if (nq <= 0) {  // the whole tile lies past the row's valid columns
    for (int x = tid; x < tw * D; x += THREADS) {
      out[row0 + (int64_t)(x / D) * hd + x % D] = from_f32<T>(0.f);
    }
    return;
  }

  float* ks = smem;                   // (page, DP)
  float* vs = ks + page * DP;         // (page, DP)
  float* qs = vs + page * DP;         // (wt, D)
  float* ps = qs + wt * D;            // (wt, page) scores, then probs
  float* m_s = ps + wt * page;        // (wt) running max
  float* l_s = m_s + wt;              // (wt) running denominator
  float* c_s = l_s + wt;              // (wt) this page's correction

  const T* q_row = q + row0;
  for (int x = tid; x < nq * D; x += THREADS) {
    qs[x] = to_f32<T>(q_row[(int64_t)(x / D) * hd + x % D]);
  }
  for (int i = tid; i < nq; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  const int kc = tid % D, rg = tid / D;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  const int n_visit = min(n_pages, last_pos / page + 1);
  for (int j = 0; j < n_visit; ++j) {
    const int64_t g = table[(int64_t)b * n_pages + j];
    const int kn = min(page, last_pos - j * page + 1);  // rows to load
    __syncthreads();  // the previous page's tiles are no longer read
    const S* kp = k_pool + g * page * hd + (int64_t)h * D;
    const S* vp = v_pool + g * page * hd + (int64_t)h * D;
    const int64_t s0 = g * page * heads + h;  // scale of the page's row 0, this head
    for (int x = tid; x < kn * D; x += THREADS) {
      const int r = x / D, c = x % D;
      const int64_t si = s0 + (int64_t)r * heads;
      ks[r * DP + c] = load_elem<T>(kp, (int64_t)r * hd + c, k_scale, si);
      vs[r * DP + c] = load_elem<T>(vp, (int64_t)r * hd + c, v_scale, si);
    }
    __syncthreads();

    // scores: thread c owns key c of the page
    for (int c = tid; c < page; c += THREADS) {
      const int kpos = j * page + c;
      for (int i = 0; i < nq; ++i) {
        float s = NEG_INF;
        if (c < kn && kpos <= st + i) {
          s = 0.f;
#pragma unroll 16
          for (int e = 0; e < D; ++e) s = fmaf(qs[i * D + e], ks[c * DP + e], s);
        }
        ps[i * page + c] = s;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int i = warp; i < nq; i += THREADS / 32) {
      float mx = NEG_INF;
      for (int c = lane; c < page; c += 32) mx = fmaxf(mx, ps[i * page + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < page; c += 32) {
        const float s = ps[i * page + c];
        const float p = s > 0.5f * NEG_INF ? expf(s - m_new) : 0.f;
        sum += p;
        ps[i * page + c] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[i] = l_s[i] * corr + sum;
        m_s[i] = m_new;
        c_s[i] = corr;
      }
    }
    __syncthreads();

    // acc[i, kc] = acc * corr + sum_c p[i, c] * v[c, kc]
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = rg + r * G;
      if (i < nq) {
        float a = acc[r] * c_s[i];
        for (int c = 0; c < kn; ++c) a = fmaf(ps[i * page + c], vs[c * DP + kc], a);
        acc[r] = a;
      }
    }
  }

  T* o_row = out + row0 + kc;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = rg + r * G;
    if (i < tw) {
      float o = 0.f;
      if (i < nq) {
        const float l = l_s[i];
        o = acc[r] / (l == 0.f ? 1.f : l);
      }
      o_row[(int64_t)i * hd] = from_f32<T>(o);
    }
  }
}

int smem_bytes(int width, int d, int page) {
  const int wt = width < MAX_W ? width : MAX_W;
  return 4 * (2 * page * (d + 1) + wt * d + wt * page + 3 * wt);
}

template <typename T, typename S, int D>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* table, const void* start,
           const void* length, void* out, int batch, int width, int heads,
           int page, int n_pages, cudaStream_t stream) {
  const int smem = smem_bytes(width, D, page);
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > smem_max) return -1;
  err = cudaFuncSetAttribute(
      ragged_kernel<T, S, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (width + MAX_W - 1) / MAX_W;
  ragged_kernel<T, S, D><<<dim3(heads, batch, tiles), THREADS, smem, stream>>>(
      (const T*)q, (const S*)k, (const S*)v, (const float*)k_scale,
      (const float*)v_scale, (const int32_t*)table, (const int32_t*)start,
      (const int32_t*)length, (T*)out, width, heads, page, n_pages);
  return (int)cudaGetLastError();
}

// S = T for the unquantized pools, int8_t for int8 ones.
template <typename T, typename S>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* k_scale, const void* v_scale, const void* table,
               const void* start, const void* length, void* out, int batch,
               int width, int heads, int page, int n_pages, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, S, 32>(q, k, v, k_scale, v_scale, table, start, length, out, batch, width, heads, page, n_pages, stream);
    case 64: return launch<T, S, 64>(q, k, v, k_scale, v_scale, table, start, length, out, batch, width, heads, page, n_pages, stream);
    case 128: return launch<T, S, 128>(q, k, v, k_scale, v_scale, table, start, length, out, batch, width, heads, page, n_pages, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the output and, unquantized, the
// pools). Returns cudaGetLastError() after the launch (0 on success), or
// -1 for a shape the kernel cannot take: a dim_head other than
// 32/64/128, a dtype code other than 0/1, or a (dim_head, page) whose
// tiles exceed the card's shared memory per block.
extern "C" int ragged_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* start, const void* length, void* out, int batch, int width,
    int heads, int dim_head, int page, int n_pages, int dtype, void* stream) {
  if (width < 1 || batch < 1 || heads < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float, float>(dim_head, q, k_pool, v_pool, nullptr, nullptr, table, start, length, out, batch, width, heads, page, n_pages, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(dim_head, q, k_pool, v_pool, nullptr, nullptr, table, start, length, out, batch, width, heads, page, n_pages, s);
  return -1;
}

// Int8 pools with float32 scale pools (pages, page, heads); dtype is the
// compute type of q and the output, as above. Same returns.
extern "C" int ragged_attention_fwd_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, const void* start,
    const void* length, void* out, int batch, int width, int heads,
    int dim_head, int page, int n_pages, int dtype, void* stream) {
  if (width < 1 || batch < 1 || heads < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float, int8_t>(dim_head, q, k_pool, v_pool, k_scale, v_scale, table, start, length, out, batch, width, heads, page, n_pages, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, int8_t>(dim_head, q, k_pool, v_pool, k_scale, v_scale, table, start, length, out, batch, width, heads, page, n_pages, s);
  return -1;
}
