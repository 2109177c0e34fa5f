// Block-sparse pair-grid attention for Hopper (sm_90a): forward, dq and
// dk/dv.
//
// Replaces the Pallas TPU kernels `_fwd_kernel`, `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` behind `block_sparse_attention` (`_pair_attention`) in
// dalle_pytorch_tpu/ops/block_sparse_attention.py. Python wrappers:
// dalle_pytorch_tpu_torch/ops/block_sparse_attention.py
// (block_sparse_attention, block_sparse_dq, block_sparse_dkdv).
//
// What it computes. q, k, v, o, do contiguous (b, h, n, d); a layout of
// 128 x 128 blocks over n_pad = 128 * ceil(n / 128) rows: the int8
// (n_pad, n_pad) may-attend mask (zero past n), the k-major (5, P) int32
// pair table of the float32 dk/dv, whose rows are q block, k block,
// class (0 synthetic, 1 partial, 2 dense), first, last, and the (nk + 1)
// offsets of each key block's contiguous run in it; the int8
// (n_pad / 64, n_pad / 32) per-half class maps of
// ops/block_sparse_attention.py, q-major for the forward and dq
// (half_classes: a 64-row query tile against 32-key halves) and k-major
// for dk/dv (half_columns: a 64-key tile against 32-row query halves),
// each entry 0 pass over, 1 the mask decides, 2 dense; and an int32
// order of the 64-row query tiles (longest row first; NULL: in order).
// Optional (b, n) uint8 key mask. Scores q.k^T accumulate in
// float32 and are scaled afterwards; a class 2 pair skips the mask, a
// class 1 pair applies it, a class 0 pair masks everything, and the key
// mask applies on top. Disallowed scores are NEG_INF = -1e30 and
// p = exp(s - m) only where s > 0.5 * NEG_INF, else 0.
//   forward: online softmax over the run (float32 max, denominator and
//     accumulator), p rounded to the storage type before the value
//     product; o = acc / l (l = 1 where l == 0, so a row with no allowed
//     key writes exactly 0), lse = m + log(l) as (b, h, n) float32;
//   dq: delta = rowsum(do * o) in float32 (written for the dk/dv pass),
//     p = exp(s - lse), dp = do . v^T, ds = p * (dp - delta) * scale
//     rounded to the storage type, dq = ds . k;
//   dk/dv: dv = p (rounded to the storage type)^T . do, dk = ds^T . q.
// Every product accumulates in float32; rows past n are neither read
// (they load as 0) nor written.
//
// What bounds it. At the flagship training shape (b 4, 16 heads of 64,
// n 1280) the axial_row and conv_like masks allow ~0.4 of the causal
// (query, key) pairs: the operations (2 products a pair forward, 3 dq, 4
// dk/dv, 2*d each) take ~0.03, ~0.05 and ~0.06 ms at the tensor cores'
// 495 / 3 TFLOP/s as split 3xTF32 (float32), ~0.005, ~0.008 and ~0.010 ms
// at their 989 TFLOP/s bf16 rate, against ~0.01-0.05 ms of bytes (q, k,
// v, o, do and the gradients once each). The design keeps every score
// on chip and walks only the live 32-row or 32-key halves of the
// 128-block pairs; a half whose keys are all masked, or whose mask tile
// is empty, is passed over (it would add p = 0 and leave every sum as
// it is), so the work follows the mask, not the 128-block grid. There
// are no float atomics: the dk/dv pass owns its key rows, so two runs
// give bit-identical gradients.
//
// Every kernel runs on the tensor cores: blocks of 4 warps, grid (b*h,
// n_pad / 64), their bodies the sweeps that the tiled flash kernels run.
//  - forward and dq, float32 (bs_fwd_tf32_kernel, bs_dq_tf32_kernel:
//    tf32_sweeps.cuh, every product split 3xTF32) and bf16
//    (bs_fwd_tc_kernel, bs_dq_tc_kernel: bf16_sweeps.cuh, bf16
//    mma.sync.m16n8k16 with float32 accumulation): a 64-row query tile
//    resident (Q, and dO for dq), the 32-key halves of its row of the
//    q-major class map (HalfRow) streamed through a cp.async ring (2
//    stages float32, 3 bf16; keys past n zero-filled, nothing read), a
//    class 1 half's (64, 32) tile of the int8 mask fetched by cp.async
//    with it; empty halves are passed over by a warp ballot on the map,
//    with no load and no barrier. The forward's online softmax rescales
//    once a half. Float32 folds a fresh partial per half into O and dQ
//    (tf32::fold_product), since the tensor cores truncate as they
//    accumulate; bf16 rounds p (forward) and ds (dq) to bf16 as it packs
//    them into the A fragments of O += P.V and dQ += dS.K. Query tiles
//    start longest row first.
//  - dk/dv (bs_dkdv_tf32_kernel, bs_dkdv_tc_kernel): the 64-key tile
//    resident (K and V), its 32-row query halves streamed, key-major.
//    Float32 walks the k-major pair run (PairRun: each class 1 half's
//    (32, 64) mask tile loaded and tested before its half is issued, a
//    barrier) and folds dV += P^T.dO and dK += dS^T.Q per half; bf16
//    walks the key tile's row of the k-major class map (HalfColumn: empty
//    halves passed over by a ballot, a class 1 half's mask tile fetched
//    by cp.async with its Q and dO, the 3-stage ring), p and ds rounded to
//    bf16 as they are packed into the A fragments.

#include <type_traits>

#include "attention_tiles.cuh"
#include "bf16_sweeps.cuh"
#include "tf32_sweeps.cuh"

namespace {

constexpr int BLOCK = 128;  // the layout's block edge

// The query tile of launch row y: order[y], or y without an order
__device__ __forceinline__ int tile_of(const int* __restrict__ order, int y) {
  return order == nullptr ? y : order[y];
}

// o and lse in float32 of query tile tile_of(order, blockIdx.y) of head
// blockIdx.x: tf32::fwd_sweep over its row of the class map
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 3 : 1) bs_fwd_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ kmask, const int8_t* __restrict__ mask,
    const int8_t* __restrict__ halves, const int* __restrict__ order, float* __restrict__ out,
    float* __restrict__ lse, int heads, int n, int n_pad, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, qt = tile_of(order, blockIdx.y), q0 = qt * TILE;
  if (q0 >= n) return;  // padding rows only
  const int64_t head = (int64_t)bh * n * D;
  tf32::Head a{};
  a.q = q + head, a.k = k + head, a.v = v + head;
  a.km = kmask == nullptr ? nullptr : kmask + (int64_t)(bh / heads) * n;
  a.out = out + head, a.lse_out = lse + (int64_t)bh * n;
  a.n = n, a.scale = scale;
  const tf32::HalfRow walk{halves + (int64_t)qt * (n_pad / tf32::SROWS), mask, n, n_pad, q0};
  tf32::fwd_sweep<D>(a, walk, smem_raw);
}

// o and lse in bf16 of query tile tile_of(order, blockIdx.y) of head
// blockIdx.x: bf16s::fwd_sweep over its row of the q-major class map. At
// d <= 64 four blocks share an SM (128 registers and 43,024 bytes of
// shared memory a block at d 64, no spills): at the training shape they
// took 0.86-0.91 of three's time and 0.86-0.90 of two's, with bitwise
// equal results (PERF.md, section 6).
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 4 : 2) bs_fwd_tc_kernel(
    const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
    const tc::bf16* __restrict__ v, const uint8_t* __restrict__ kmask,
    const int8_t* __restrict__ mask, const int8_t* __restrict__ halves,
    const int* __restrict__ order, tc::bf16* __restrict__ out, float* __restrict__ lse,
    int heads, int n, int n_pad, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, qt = tile_of(order, blockIdx.y), q0 = qt * TILE;
  if (q0 >= n) return;  // padding rows only
  const int64_t head = (int64_t)bh * n * D;
  bf16s::Head a{};
  a.q = q + head, a.k = k + head, a.v = v + head;
  a.km = kmask == nullptr ? nullptr : kmask + (int64_t)(bh / heads) * n;
  a.out = out + head, a.lse_out = lse + (int64_t)bh * n;
  a.n = n, a.scale = scale;
  const tf32::HalfRow walk{halves + (int64_t)qt * (n_pad / tf32::SROWS), mask, n, n_pad, q0};
  bf16s::fwd_sweep<D>(a, walk, smem_raw);
}

// dq in float32 of query tile tile_of(order, blockIdx.y) of head
// blockIdx.x: tf32::dq_sweep over its row of the class map; delta from do
// and o, written for the dk/dv pass
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 2 : 1) bs_dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ lse, const uint8_t* __restrict__ kmask,
    const int8_t* __restrict__ mask, const int8_t* __restrict__ halves,
    const int* __restrict__ order, float* __restrict__ dq, float* __restrict__ delta,
    int heads, int n, int n_pad, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, qt = tile_of(order, blockIdx.y), q0 = qt * TILE;
  if (q0 >= n) return;  // padding rows only
  const int64_t head = (int64_t)bh * n * D, rows = (int64_t)bh * n;
  tf32::Head a{};
  a.q = q + head, a.k = k + head, a.v = v + head, a.o = o + head, a.dout = dout + head;
  a.lse = lse + rows;
  a.km = kmask == nullptr ? nullptr : kmask + (int64_t)(bh / heads) * n;
  a.dq = dq + head, a.delta_out = delta + rows;
  a.n = n, a.scale = scale;
  const tf32::HalfRow walk{halves + (int64_t)qt * (n_pad / tf32::SROWS), mask, n, n_pad, q0};
  tf32::dq_sweep<D>(a, walk, smem_raw);
}

// dk and dv in float32 of the 64-key half blockIdx.y of a 128-key block
// of head blockIdx.x: tf32::dkdv_sweep over the block's k-major pair run,
// each q block's 32-row halves below n whose mask tile is not empty, on
// the dq pass's lse and delta
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 2 : 1) bs_dkdv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ kmask,
    const int8_t* __restrict__ mask, const int* __restrict__ table,
    const int* __restrict__ offsets, float* __restrict__ dk, float* __restrict__ dv,
    int heads, int n, int n_pad, int n_pairs, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, k0 = blockIdx.y * TILE;
  if (k0 >= n) return;  // padding keys only
  const int kb = k0 / BLOCK;
  const int64_t head = (int64_t)bh * n * D, rows = (int64_t)bh * n;
  const tf32::Head a{q + head,    k + head,     v + head,  nullptr, dout + head,
                     lse + rows,  delta + rows,
                     kmask == nullptr ? nullptr : kmask + (int64_t)(bh / heads) * n,
                     nullptr,     dk + head,    dv + head, nullptr, n,
                     scale};
  const tf32::PairRun walk{table, mask, n_pairs, n, n_pad, k0, 4 * offsets[kb],
                           4 * offsets[kb + 1]};
  tf32::dkdv_sweep<D, false>(a, walk, k0, smem_raw);
}

// dq in bf16 of query tile tile_of(order, blockIdx.y) of head
// blockIdx.x: bf16s::dq_sweep over its row of the q-major class map;
// delta from do and o, written for the dk/dv pass. At d <= 64 four blocks
// share an SM (128 registers at d 64, no spills): at the training shape
// they took 0.88-0.89 of three's time and 0.67-0.68 of two's (PERF.md,
// section 6).
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 4 : 2) bs_dq_tc_kernel(
    const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
    const tc::bf16* __restrict__ v, const tc::bf16* __restrict__ o,
    const tc::bf16* __restrict__ dout, const float* __restrict__ lse,
    const uint8_t* __restrict__ kmask, const int8_t* __restrict__ mask,
    const int8_t* __restrict__ halves, const int* __restrict__ order,
    tc::bf16* __restrict__ dq, float* __restrict__ delta, int heads, int n, int n_pad,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, qt = tile_of(order, blockIdx.y), q0 = qt * TILE;
  if (q0 >= n) return;  // padding rows only
  const int64_t head = (int64_t)bh * n * D, rows = (int64_t)bh * n;
  bf16s::Head a{};
  a.q = q + head, a.k = k + head, a.v = v + head, a.o = o + head, a.dout = dout + head;
  a.lse = lse + rows;
  a.km = kmask == nullptr ? nullptr : kmask + (int64_t)(bh / heads) * n;
  a.dq = dq + head, a.delta_out = delta + rows;
  a.n = n, a.scale = scale;
  const tf32::HalfRow walk{halves + (int64_t)qt * (n_pad / tf32::SROWS), mask, n, n_pad, q0};
  bf16s::dq_sweep<D>(a, walk, smem_raw);
}

// dk and dv in bf16 of key tile blockIdx.y of head blockIdx.x:
// bf16s::dkdv_sweep over the tile's row of the k-major class map, on the
// forward's lse and the dq pass's delta. At d <= 64 three blocks share an
// SM (168 registers at d 64, no spills): they took 0.69-0.77 of two's
// time and 0.56-0.62 of four's; the walk took 0.93 of the float32 dk/dv's
// PairRun on the same sweep, with bitwise equal results (PERF.md,
// section 6).
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 3 : 2) bs_dkdv_tc_kernel(
    const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
    const tc::bf16* __restrict__ v, const tc::bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ kmask, const int8_t* __restrict__ mask,
    const int8_t* __restrict__ columns, tc::bf16* __restrict__ dk, tc::bf16* __restrict__ dv,
    int heads, int n, int n_pad, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, kt = blockIdx.y, k0 = kt * TILE;
  if (k0 >= n) return;  // padding keys only
  const int64_t head = (int64_t)bh * n * D, rows = (int64_t)bh * n;
  bf16s::Head a{};
  a.q = q + head, a.k = k + head, a.v = v + head, a.dout = dout + head;
  a.lse = lse + rows, a.delta_in = delta + rows;
  a.km = kmask == nullptr ? nullptr : kmask + (int64_t)(bh / heads) * n;
  a.dk = dk + head, a.dv = dv + head;
  a.n = n, a.scale = scale;
  const tf32::HalfColumn walk{columns + (int64_t)kt * (n_pad / tf32::SROWS), mask, n_pad, k0};
  bf16s::dkdv_sweep<D, false>(a, walk, k0, smem_raw);
}

// shapes every entry point refuses (-1): an empty shape, a block other
// than 128, n_pad that is not ceil(n / 128) * 128, more (batch, head)
// pairs than grid x holds
bool refused(int batch, int heads, int n, int n_pad, int block, int n_pairs) {
  return batch < 1 || heads < 1 || n < 1 || n_pairs < 1 || block != BLOCK ||
         n_pad != (n + BLOCK - 1) / BLOCK * BLOCK ||
         (int64_t)batch * heads > 0x7fffffff;
}

// The tensor-core instances' grid: (b*h, n_pad / TILE), as the tiled
// kernels'
dim3 tc_grid_of(int batch, int heads, int n_pad) {
  static_assert(TILE == tf32::ROWS && TILE == bf16s::ROWS && BLOCK == tf32::PairRun::BLOCK,
                "the sweeps' tiles");
  return dim3(batch * heads, n_pad / TILE);
}

// What the tensor-core instances refuse (-1): a class map that is
// missing, more query or key tiles than a grid dimension holds, or an
// operand not 16-byte aligned (cp.async, ldmatrix, vector stores)
bool tc_refused(const void* map, int n_pad, std::initializer_list<const void*> operands) {
  return map == nullptr || n_pad / TILE > 65535 || !tc::aligned16(operands);
}

// both types on the q-major class map: float32 split 3xTF32, bf16
// bf16 mma.sync
template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, const void* kmask,
        const void* mask, const void* halves, const void* order, void* out, void* lse,
        int batch, int heads, int n, int n_pad, float scale, cudaStream_t stream) {
  if (tc_refused(halves, n_pad, {q, k, v, mask, out})) return -1;
  const dim3 grid = tc_grid_of(batch, heads, n_pad);
  if constexpr (std::is_same<T, float>::value) {
    constexpr int smem = tf32::fwd_sweep_smem_bytes(D, true);
    int err = allow_smem(bs_fwd_tf32_kernel<D>, smem);
    if (err != 0) return err;
    bs_fwd_tf32_kernel<D><<<grid, tc::THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const uint8_t*)kmask,
        (const int8_t*)mask, (const int8_t*)halves, (const int*)order, (float*)out,
        (float*)lse, heads, n, n_pad, scale);
  } else {
    constexpr int smem = bf16s::fwd_sweep_smem_bytes(D, true);
    int err = allow_smem(bs_fwd_tc_kernel<D>, smem);
    if (err != 0) return err;
    bs_fwd_tc_kernel<D><<<grid, tc::THREADS, smem, stream>>>(
        (const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v, (const uint8_t*)kmask,
        (const int8_t*)mask, (const int8_t*)halves, (const int*)order, (tc::bf16*)out,
        (float*)lse, heads, n, n_pad, scale);
  }
  return (int)cudaGetLastError();
}

// both types on the q-major class map: float32 split 3xTF32, bf16
// bf16 mma.sync
template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const void* lse, const void* kmask, const void* mask,
       const void* halves, const void* order, void* dq_out, void* delta, int batch, int heads,
       int n, int n_pad, float scale, cudaStream_t stream) {
  if (tc_refused(halves, n_pad, {q, k, v, o, dout, mask, dq_out})) return -1;
  const dim3 grid = tc_grid_of(batch, heads, n_pad);
  if constexpr (std::is_same<T, float>::value) {
    constexpr int smem = tf32::dq_sweep_smem_bytes(D, true);
    int err = allow_smem(bs_dq_tf32_kernel<D>, smem);
    if (err != 0) return err;
    bs_dq_tf32_kernel<D><<<grid, tc::THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)o,
        (const float*)dout, (const float*)lse, (const uint8_t*)kmask, (const int8_t*)mask,
        (const int8_t*)halves, (const int*)order, (float*)dq_out, (float*)delta, heads, n,
        n_pad, scale);
  } else {
    constexpr int smem = bf16s::dq_sweep_smem_bytes(D, true);
    int err = allow_smem(bs_dq_tc_kernel<D>, smem);
    if (err != 0) return err;
    bs_dq_tc_kernel<D><<<grid, tc::THREADS, smem, stream>>>(
        (const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v, (const tc::bf16*)o,
        (const tc::bf16*)dout, (const float*)lse, (const uint8_t*)kmask, (const int8_t*)mask,
        (const int8_t*)halves, (const int*)order, (tc::bf16*)dq_out, (float*)delta, heads, n,
        n_pad, scale);
  }
  return (int)cudaGetLastError();
}

// float32: the split-3xTF32 kernel on the k-major table and offsets;
// bf16: bf16 mma.sync on the k-major class map
template <typename T, int D>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, const void* kmask, const void* mask,
         const void* table, const void* offsets, const void* columns, void* dk, void* dv,
         int batch, int heads, int n, int n_pad, int n_pairs, float scale,
         cudaStream_t stream) {
  const dim3 grid = tc_grid_of(batch, heads, n_pad);
  if constexpr (std::is_same<T, float>::value) {
    if (tc_refused(table, n_pad, {q, k, v, dout, mask, dk, dv})) return -1;
    constexpr int smem = tf32::dkdv_sweep_smem_bytes(D, true, false);
    int err = allow_smem(bs_dkdv_tf32_kernel<D>, smem);
    if (err != 0) return err;
    bs_dkdv_tf32_kernel<D><<<grid, tc::THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (const uint8_t*)kmask, (const int8_t*)mask,
        (const int*)table, (const int*)offsets, (float*)dk, (float*)dv, heads, n, n_pad,
        n_pairs, scale);
  } else {
    if (tc_refused(columns, n_pad, {q, k, v, dout, mask, dk, dv})) return -1;
    constexpr int smem = bf16s::dkdv_sweep_smem_bytes(D, true, false);
    int err = allow_smem(bs_dkdv_tc_kernel<D>, smem);
    if (err != 0) return err;
    bs_dkdv_tc_kernel<D><<<grid, tc::THREADS, smem, stream>>>(
        (const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v, (const tc::bf16*)dout,
        (const float*)lse, (const float*)delta, (const uint8_t*)kmask, (const int8_t*)mask,
        (const int8_t*)columns, (tc::bf16*)dk, (tc::bf16*)dv, heads, n, n_pad, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Instances: dtype 0 = float32, 1 = bfloat16; dim_head 32, 64, 128.
#define BS_DISPATCH(FN, ...)                                              \
  switch (dtype * 1000 + dim_head) {                                      \
    case 32: return FN<float, 32>(__VA_ARGS__);                           \
    case 64: return FN<float, 64>(__VA_ARGS__);                           \
    case 128: return FN<float, 128>(__VA_ARGS__);                         \
    case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);                 \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                 \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                \
    default: return -1;                                                   \
  }

// Every entry point: q, k, v (and o, do, dq, dk, dv) contiguous
// (b, h, n, dim_head) of one type; lse and delta (b, h, n) float32; kmask
// (b, n) uint8 or NULL; mask (n_pad, n_pad) int8; for fwd and dq the
// q-major (n_pad / 64, n_pad / 32) int8 class map `halves`
// (half_classes) and the (n_pad / 64) int32 tile order or NULL; for dkdv
// the k-major table (5, n_pairs) and its nk + 1 offsets, int32, read by
// the float32 instance, and the k-major class map `columns`
// (half_columns), read by the bf16 instance. n_pairs is the layout's
// pair count (q-major for fwd and dq, where only the refusal reads it).
// One launch on `stream`. Returns cudaGetLastError() after it (0 on
// success), or -1 for what the kernels cannot take: a dim_head other
// than 32/64/128, a dtype code other than 0/1, a block other than 128,
// an empty shape, more (batch, head) pairs or tiles than a grid
// dimension holds, an operand not 16-byte aligned, or no class map.
extern "C" int block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, const void* kmask,
    const void* mask, const void* halves, const void* order, void* out, void* lse,
    int batch, int heads, int n, int n_pad, int dim_head, int block, int n_pairs,
    float scale, int dtype, void* stream) {
  if (refused(batch, heads, n, n_pad, block, n_pairs)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  BS_DISPATCH(fwd, q, k, v, kmask, mask, halves, order, out, lse, batch, heads, n, n_pad,
              scale, s)
}

// delta is written here (rowsum(do * o) per row and head) for
// block_sparse_attention_dkdv.
extern "C" int block_sparse_attention_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* kmask, const void* mask,
    const void* halves, const void* order, void* dq_out, void* delta, int batch, int heads,
    int n, int n_pad, int dim_head, int block, int n_pairs, float scale, int dtype,
    void* stream) {
  if (refused(batch, heads, n, n_pad, block, n_pairs)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  BS_DISPATCH(dq, q, k, v, o, dout, lse, kmask, mask, halves, order, dq_out, delta, batch,
              heads, n, n_pad, scale, s)
}

extern "C" int block_sparse_attention_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kmask, const void* mask,
    const void* table, const void* offsets, const void* columns, void* dk, void* dv,
    int batch, int heads, int n, int n_pad, int dim_head, int block, int n_pairs,
    float scale, int dtype, void* stream) {
  if (refused(batch, heads, n, n_pad, block, n_pairs)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  BS_DISPATCH(dkdv, q, k, v, dout, lse, delta, kmask, mask, table, offsets, columns,
              dk, dv, batch, heads, n, n_pad, n_pairs, scale, s)
}
