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
// operations: 34 us at the tensor cores' bf16 rate; in float32, run as
// split 3xTF32 (three TF32 products per float32 product), 0.20 ms at the
// tensor cores' 495 / 3 = 165 TFLOP/s (0.5 ms at the CUDA cores' 67
// TFLOP/s float32 rate), against ~0.05 ms of bytes in float32 (qkv, o,
// do, dqkv, lse, tables once each) and half that in bf16: operations
// bound it. The float32 passes run at ~5x that bound, held by shared
// memory bandwidth and latency (tf32_tiles.cuh). The design keeps every
// (n, n) intermediate on chip and tiles FA-2 style, with no float
// atomics so that gradients are the same from run to run:
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
// Both instances run every product on the tensor cores with float32
// accumulation: bf16 as bf16 mma.sync.m16n8k16 (dkdv_tc_kernel,
// dq_tc_kernel, csrc/mma_tiles.cuh), float32 as split 3xTF32
// mma.sync.m16n8k8 (dkdv_tf32_kernel, dq_tf32_kernel,
// csrc/tf32_tiles.cuh), which holds float32's accuracy. Blocks of 4
// warps, each warp 16 rows of the block's tile; the streamed Q/dO (dk/dv)
// or K/V (dq) tiles come through 2-stage cp.async rings; the dk/dv pass is
// key-major (S^T = K.Q^T) so that p^T and ds^T leave the accumulators as
// the A fragments of dV += P^T.dO and dK += dS^T.Q; the inverse rotation
// runs in float32 on the accumulators (a channel pair lies in one
// thread), and the gradients leave by 16-byte stores. Next: one fused
// pass, and wgmma/TMA where an instance stays below half its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"
#include "tf32_tiles.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;  // of the rotate and delta kernels

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// round a float32 to the storage type and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// The float32 instance's first two launches. qkv (rows of `width` =
// 3*h*d) -> the same with q, k and v rotated: t*cos + rotate_half(t)*sin,
// rotate_half(t)[2i] = -t[2i+1], [2i+1] = t[2i], rounded as the forward
// kernel rounds.
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


// ------------------------------------ float32: the split-3xTF32 design
//
// The bf16 passes' blocks (4 warps, 16 rows of the resident 64-row tile
// each), rings and schedule, on the rotated copy of qkv (rotate_kernel)
// and delta (delta_kernel), with float32 tiles (rows of d floats padded
// to d + 4) and every product as split 3xTF32 mma.sync.m16n8k8
// (csrc/tf32_tiles.cuh): A fragments of the resident tile by ldmatrix,
// split in registers; the streamed tiles, 32 rows (tf32::SROWS, the bf16
// passes' halves), split once when they land (tf32::split_tiles), their
// B fragments by ldmatrix where the product runs over channels and by
// 32-bit shared loads (rows 2t, 2t + 1) where it runs over the tile's
// rows; p^T, ds^T and ds feed the next product from the accumulators,
// split, not rounded; p = tc::exp_diff(s, lse * log2(e)). A block holds
// 86-90 KB at d 64, so two blocks share an SM. Sums over keys or queries
// fold a fresh partial per streamed tile and 8-channel block in with
// rounded adds (tf32::fold_product).

constexpr int dkdv_tf32_smem_bytes(int d, bool pattern) {
  // K, V, two stages of Q and dO, the small parts of one Q and dO tile,
  // two stages of lse and delta, two of the (32, 64) pattern tile
  return 4 * (2 * tf32::ROWS * (d + 4) + 6 * tf32::SROWS * (d + 4) + 4 * tf32::SROWS) +
         (pattern ? 2 * tf32::SROWS * tf32::ROWS : 0);
}

constexpr int dq_tf32_smem_bytes(int d, bool pattern) {
  // Q, dO, two stages of K and V, the small parts of one K and V tile,
  // two stages of key bits (16 bytes), two of the (64, 32) pattern tile
  return 4 * (2 * tf32::ROWS * (d + 4) + 6 * tf32::SROWS * (d + 4)) + 16 +
         (pattern ? 2 * tf32::ROWS * tf32::SROWS : 0);
}

// dk/dv: one block per (64-key tile, head, batch row); warp w owns keys
// 16w .. 16w + 15, as dkdv_tc_kernel, over streamed tiles of 32 queries.
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 32 ? 3 : (D <= 64 ? 2 : 1))
    dkdv_tf32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const uint8_t* __restrict__ kmask, const int8_t* __restrict__ pmask,
                     const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                     float* __restrict__ dqkv, int n, int heads, int causal, float scale) {
  using tf32::ROWS;
  using tf32::SROWS;
  constexpr int TF = tf32::tile_floats<D>(), TS = tf32::tile_floats<D, SROWS>();
  constexpr int PM = SROWS * ROWS;  // bytes of a pattern tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // (64, DS)
  float* vs = ks + TF;                             // (64, DS)
  float* qs = vs + TF;                             // 2 stages of (32, DS)
  float* dos = qs + 2 * TS;                        // 2 stages of (32, DS)
  float* q_lo = dos + 2 * TS;                      // the small parts of the current Q tile
  float* do_lo = q_lo + TS;                        // ... and of its dO tile
  float* lse_s = do_lo + TS;                       // 2 stages of 32
  float* del_s = lse_s + 2 * SROWS;                // 2 stages of 32
  int8_t* pms = reinterpret_cast<int8_t*>(del_s + 2 * SROWS);  // 2 stages of (32, 64)
  __shared__ uint32_t kbits[2];

  const int kt = blockIdx.z, k0 = kt * ROWS, h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t stride = 3LL * heads * D, hd = (int64_t)heads * D;
  const float* base = qkv + (int64_t)b * n * stride;
  const float* dobase = dout + (int64_t)b * n * hd + (int64_t)h * D;
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
    const int n_qt = (n + SROWS - 1) / SROWS;
    const bool tri = causal && pmask == nullptr;
    int qt = tri ? k0 / SROWS : 0;
    auto issue = [&](int q_t, int st) {
      const int q0 = q_t * SROWS;
      tf32::load_tile_async<D, SROWS>(qs + st * TS, base + (int64_t)h * D, stride, q0, n);
      tf32::load_tile_async<D, SROWS>(dos + st * TS, dobase, hd, q0, n);
      if (pmask != nullptr) tc::load_mask_tile<SROWS, ROWS>(pms + st * PM, pmask, q0, k0, n);
    };
    // lse (times log2(e), for exp_diff) of query q0 + r by threads r < 32,
    // delta by threads 32 + r: loaded a tile ahead, stored after the
    // products so that the load's latency hides behind them
    const int r = threadIdx.x % SROWS;
    const bool stat_thread = threadIdx.x < 2 * SROWS;
    auto row_stat = [&](int q_t) {
      const int row = q_t * SROWS + r;
      if (!stat_thread || row >= n) return 0.f;
      return threadIdx.x < SROWS ? lse_bh[row] * tc::LOG2E : del_bh[row];
    };
    float* stat_s = threadIdx.x < SROWS ? lse_s : del_s;
    tf32::load_tile_async<D>(ks, base + (int64_t)(heads + h) * D, stride, k0, n);
    tf32::load_tile_async<D>(vs, base + (int64_t)(2 * heads + h) * D, stride, k0, n);
    issue(qt, 0);
    tc::cp_async_commit();
    if (stat_thread) stat_s[r] = row_stat(qt);
    for (int st = 0; qt < n_qt; ++qt, st ^= 1) {
      const float next_stat = qt + 1 < n_qt ? row_stat(qt + 1) : 0.f;
      if (qt + 1 < n_qt) issue(qt + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
      __syncthreads();
      const int q0 = qt * SROWS;
      float* q_s = qs + st * TS;
      float* do_s = dos + st * TS;
      tf32::split_tiles<D, SROWS>(q_s, q_lo, do_s, do_lo, 0, n, nullptr, nullptr);
      __syncthreads();  // the tiles are split, once for every warp

      const bool need_mask = bits != ~0ull || pmask != nullptr ||
                             (causal && q0 < k0 + ROWS) || q0 + SROWS > n;
      const int8_t* pm_t = pms + st * PM;
      float sT[4][4], dpT[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        tf32::FragA ka, va;
        tf32::load_a<D>(ka, ks, 16 * warp, 8 * kk);
        tf32::load_a<D>(va, vs, 16 * warp, 8 * kk);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          tf32::FragB qb[2], db[2];
          tf32::load_b_rows<D>(qb, q_s, q_lo, 16 * np, 8 * kk);
          tf32::load_b_rows<D>(db, do_s, do_lo, 16 * np, 8 * kk);
          tf32::mma3(sT[2 * np], ka, qb[0]);
          tf32::mma3(sT[2 * np + 1], ka, qb[1]);
          tf32::mma3(dpT[2 * np], va, db[0]);
          tf32::mma3(dpT[2 * np + 1], va, db[1]);
        }
      }

      // p^T into sT, ds^T into dpT
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
          bool ok = true;
          if (need_mask) {
            ok = kok[e >> 1] && q0 + c < n;
            if (pmask != nullptr) {
              ok = ok && pm_t[c * ROWS + key] != 0;
            } else if (causal) {
              ok = ok && q0 + c >= k0 + key;
            }
          }
          const float sv = ok ? sT[j][e] * scale : NEG_INF;
          const float p =
              sv > 0.5f * NEG_INF ? tc::exp_diff(sv, lse_s[st * SROWS + c]) : 0.f;
          sT[j][e] = p;
          dpT[j][e] = p * (dpT[j][e] - del_s[st * SROWS + c]) * scale;
        }

      // dV += P^T.dO, then dK += dS^T.Q, over the tile's 32 queries
      const float one[2] = {1.f, 1.f};
      tf32::FragA fa[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) tf32::c_to_a(fa[kk], sT[kk]);
      tf32::fold_product<D>(dv, fa, do_s, do_lo, one);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) tf32::c_to_a(fa[kk], dpT[kk]);
      tf32::fold_product<D>(dk, fa, q_s, q_lo, one);
      if (stat_thread) stat_s[(st ^ 1) * SROWS + r] = next_stat;
      __syncthreads();  // stage st is no longer read
    }
  }

  // each warp's own rows of the K and V tiles hold its dk and dv
  float* out = dqkv + (int64_t)b * n * stride;
  tf32::store_inverse_rotated<D>(dk, ks + 16 * warp * tf32::stride<D>(),
                                 out + (int64_t)(heads + h) * D, stride, k0 + 16 * warp, n,
                                 cos_t, sin_t);
  tf32::store_inverse_rotated<D>(dv, vs + 16 * warp * tf32::stride<D>(),
                                 out + (int64_t)(2 * heads + h) * D, stride, k0 + 16 * warp,
                                 n, cos_t, sin_t);
}

// dq: one block per (64-row query tile, head, batch row); warp w owns
// query rows 16w .. 16w + 15, as dq_tc_kernel, over streamed tiles of 32
// keys.
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 32 ? 3 : (D <= 64 ? 2 : 1))
    dq_tf32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const uint8_t* __restrict__ kmask, const int8_t* __restrict__ pmask,
                   const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                   float* __restrict__ dqkv, int n, int heads, int causal, float scale) {
  using tf32::ROWS;
  using tf32::SROWS;
  constexpr int TF = tf32::tile_floats<D>(), TS = tf32::tile_floats<D, SROWS>();
  constexpr int PM = ROWS * SROWS;  // bytes of a pattern tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // (64, DS)
  float* dos = qs + TF;                            // (64, DS)
  float* ks = dos + TF;                            // 2 stages of (32, DS)
  float* vs = ks + 2 * TS;                         // 2 stages of (32, DS)
  float* k_lo = vs + 2 * TS;                       // the small parts of the current K tile
  float* v_lo = k_lo + TS;                         // ... and of its V tile
  uint32_t* kbits = reinterpret_cast<uint32_t*>(v_lo + TS);  // 2 stages of 1 word (+ 2)
  int8_t* pms = reinterpret_cast<int8_t*>(kbits + 4);         // 2 stages of (64, 32)

  const bool tri = causal && pmask == nullptr;
  const int qt = tri ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * ROWS, h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t stride = 3LL * heads * D, hd = (int64_t)heads * D;
  const float* base = qkv + (int64_t)b * n * stride;
  const float* ksrc = base + (int64_t)(heads + h) * D;
  const float* vsrc = base + (int64_t)(2 * heads + h) * D;
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

  int n_tiles = (n + SROWS - 1) / SROWS;
  if (tri) n_tiles = min(n_tiles, (q0 + ROWS - 1) / SROWS + 1);
  auto next_live = [&](int kt, int st) {
    if (kmask_b != nullptr)
      while (kt < n_tiles && !tc::tile_keys<SROWS>(kmask_b, kt * SROWS, n, kbits + st))
        ++kt;
    return kt;
  };
  auto issue = [&](int kt, int st) {
    tf32::load_tile_async<D, SROWS>(ks + st * TS, ksrc, stride, kt * SROWS, n);
    tf32::load_tile_async<D, SROWS>(vs + st * TS, vsrc, stride, kt * SROWS, n);
    if (pmask != nullptr)
      tc::load_mask_tile<ROWS, SROWS>(pms + st * PM, pmask, q0, kt * SROWS, n);
  };

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  int kt = next_live(0, 0), st = 0;
  if (kt < n_tiles) {
    tf32::load_tile_async<D>(qs, base + (int64_t)h * D, stride, q0, n);
    tf32::load_tile_async<D>(dos, dout + (int64_t)b * n * hd + (int64_t)h * D, hd, q0, n);
    issue(kt, 0);
  }
  tc::cp_async_commit();
  while (kt < n_tiles) {
    const int nxt = next_live(kt + 1, st ^ 1);
    if (nxt < n_tiles) issue(nxt, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * SROWS;
    float* k_s = ks + st * TS;
    float* v_s = vs + st * TS;
    tf32::split_tiles<D, SROWS>(k_s, k_lo, v_s, v_lo, 0, n, nullptr, nullptr);
    __syncthreads();  // the tiles are split, once for every warp

    const uint64_t bits = tc::key_bits<SROWS>(kmask_b != nullptr, kbits + st, k0, n);
    const bool need_mask = bits != tc::all_keys<SROWS>() || pmask != nullptr ||
                           (causal && k0 + SROWS > q0 + 1);
    const int8_t* pm_t = pms + st * PM;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      tf32::FragA qa, da;
      tf32::load_a<D>(qa, qs, 16 * warp, 8 * kk);
      tf32::load_a<D>(da, dos, 16 * warp, 8 * kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        tf32::FragB kb[2], vb[2];
        tf32::load_b_rows<D>(kb, k_s, k_lo, 16 * np, 8 * kk);
        tf32::load_b_rows<D>(vb, v_s, v_lo, 16 * np, 8 * kk);
        tf32::mma3(s[2 * np], qa, kb[0]);
        tf32::mma3(s[2 * np + 1], qa, kb[1]);
        tf32::mma3(dp[2 * np], da, vb[0]);
        tf32::mma3(dp[2 * np + 1], da, vb[1]);
      }
    }

    // ds, split into the A fragments of dS.K
    tf32::FragA dsa[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, row = r0 + 8 * i, c = 8 * j + 2 * t + (e & 1);
        bool ok = true;
        if (need_mask) {
          ok = ((bits >> c) & 1) && row < n;
          if (pmask != nullptr) {
            ok = ok && pm_t[(row - q0) * SROWS + c] != 0;
          } else if (causal) {
            ok = ok && row >= k0 + c;
          }
        }
        const float sv = ok ? s[j][e] * scale : NEG_INF;
        const float p = sv > 0.5f * NEG_INF ? tc::exp_diff(sv, lse_r[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - del_r[i]) * scale;
      }
      tf32::c_to_a(dsa[j], s[j]);
    }

    // dQ += dS.K over the tile's 32 keys
    const float one[2] = {1.f, 1.f};
    tf32::fold_product<D>(dq, dsa, k_s, k_lo, one);
    __syncthreads();  // stage st is no longer read
    kt = nxt;
    st ^= 1;
  }

  tf32::store_inverse_rotated<D>(dq, qs + 16 * warp * tf32::stride<D>(),
                                 dqkv + (int64_t)b * n * stride + (int64_t)h * D, stride,
                                 q0 + 16 * warp, n, cos_t, sin_t);
}

// The four launches of one backward: rotate (when tables are given),
// delta, dk/dv, dq. T = float: the split-3xTF32 passes; T = bf16: the
// bf16 ones. Every operand of T and the scratch must be 16-byte aligned
// (cp.async, vector accesses).
template <typename T, int D>
int launch(const void* qkv, const void* o, const void* lse, const void* dout,
           const void* kmask, const void* pmask, const void* cos_t, const void* sin_t,
           void* rot_scratch, void* delta, void* dqkv, int batch, int n, int heads,
           int causal, float scale, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  const int n_t = (n + tc::ROWS - 1) / tc::ROWS;
  if (n_t > 65535 || !tc::aligned16({qkv, o, dout, cos_t, sin_t, rot_scratch, dqkv})) return -1;
  const bool pattern = pmask != nullptr;
  const int smem_kv = f32 ? dkdv_tf32_smem_bytes(D, pattern) : dkdv_tc_smem_bytes(D, pattern);
  const int smem_q = f32 ? dq_tf32_smem_bytes(D, pattern) : dq_tc_smem_bytes(D, pattern);
  void (*dkdv)(const T*, const T*, const float*, const float*, const uint8_t*, const int8_t*,
               const T*, const T*, T*, int, int, int, float);
  void (*dq)(const T*, const T*, const float*, const float*, const uint8_t*, const int8_t*,
             const T*, const T*, T*, int, int, int, float);
  if constexpr (f32) {
    dkdv = dkdv_tf32_kernel<D>;
    dq = dq_tf32_kernel<D>;
  } else {
    dkdv = dkdv_tc_kernel<D>;
    dq = dq_tc_kernel<D>;
  }
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;

  const int width = 3 * heads * D;
  const T* src = (const T*)qkv;
  if (cos_t != nullptr) {
    if constexpr (f32) {
      const int64_t total = (int64_t)batch * n * width;
      const int64_t blocks = (total + THREADS - 1) / THREADS;
      rotate_kernel<float, D><<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0, stream>>>(
          (const T*)qkv, (const T*)cos_t, (const T*)sin_t, (T*)rot_scratch, total, n, width);
    } else {
      const int64_t chunks = (int64_t)batch * n * width / 8;
      const int64_t blocks = (chunks + THREADS - 1) / THREADS;
      rotate_tc_kernel<D><<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0, stream>>>(
          (const T*)qkv, (const T*)cos_t, (const T*)sin_t, (T*)rot_scratch, chunks, n, width);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = (const T*)rot_scratch;
  }
  if constexpr (f32) {
    const int64_t warps = (int64_t)batch * n * heads;
    delta_kernel<float, D><<<(unsigned)((warps * 32 + THREADS - 1) / THREADS), THREADS, 0,
                             stream>>>((const T*)o, (const T*)dout, (float*)delta, warps, n,
                                       heads);
  } else {
    const int64_t chunks = (int64_t)batch * n * heads * D / 8;
    delta_tc_kernel<D><<<(unsigned)((chunks + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        (const T*)o, (const T*)dout, (float*)delta, chunks, n, heads);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid(heads, batch, n_t);
  dkdv<<<grid, tc::THREADS, smem_kv, stream>>>(
      src, (const T*)dout, (const float*)lse, (const float*)delta, (const uint8_t*)kmask,
      (const int8_t*)pmask, (const T*)cos_t, (const T*)sin_t, (T*)dqkv, n, heads, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq<<<grid, tc::THREADS, smem_q, stream>>>(
      src, (const T*)dout, (const float*)lse, (const float*)delta, (const uint8_t*)kmask,
      (const int8_t*)pmask, (const T*)cos_t, (const T*)sin_t, (T*)dqkv, n, heads, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* qkv, const void* o, const void* lse, const void* dout,
               const void* kmask, const void* pmask, const void* cos_t, const void* sin_t,
               void* rot_scratch, void* delta, void* dqkv, int batch, int n, int heads,
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
// than 32/64/128, a dtype code other than 0/1, an empty shape, more
// heads or batch rows than a grid dimension holds, or an operand of
// qkv's type (or the scratch) not 16-byte aligned.
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
    return dispatch_d<tc::bf16>(dim_head, qkv, o, lse, dout, kmask, pmask, cos_t, sin_t, rot_scratch, delta, dqkv, batch, n, heads, causal, scale, s);
  return -1;
}
