// Tiled flash attention for Hopper (sm_90a): forward, dq, dk/dv and the
// single-block backward.
//
// Replaces the Pallas TPU kernels `_fwd_kernel`, `_bwd_dq_kernel`,
// `_bwd_dkv_kernel` and `_bwd_fused_kernel` behind `flash_attention` in
// dalle_pytorch_tpu/ops/flash_attention.py. Python wrappers:
// dalle_pytorch_tpu_torch/ops/flash_attention.py (flash_attention_fwd,
// flash_attention_dq, flash_attention_dkdv, flash_attention_bwd_fused).
//
// What it computes. q, k, v, o, do contiguous (b, h, n, d), n a multiple
// of TILE; an int8 (n / TILE, n / TILE) visit map of JAX's classes at
// this kernel's tile (0 skip, 1 masked, 2 dense); an optional int8
// (n, n) pattern (nonzero = attend) and an optional (b, n) uint8 key
// mask. Scores q.k^T accumulate in float32 and are scaled afterwards. A
// class 2 tile attends every pair; a class 1 tile applies the pattern,
// or the causal rule row >= col when there is none; the key mask applies
// on top. Disallowed scores are NEG_INF = -1e30 and p = exp(s - m) only
// where s > 0.5 * NEG_INF, else 0.
//   forward: online softmax over the row's live tiles (float32 max,
//     denominator and accumulator), p rounded to the storage type before
//     the value product; o = acc / l (l = 1 where l == 0, so a row with
//     no allowed key writes exactly 0), lse = m + log(l), (b, h, n)
//     float32;
//   dq: delta = rowsum(do * o) in float32, written for the dk/dv pass;
//     p = exp(s - lse), dp = do . v^T, ds = p * (dp - delta) * scale
//     rounded to the storage type, dq = ds . k;
//   dk/dv: dv = p (rounded to the storage type)^T . do, dk = ds^T . q on
//     the dq pass's delta;
//   single-block backward: one launch of both roles, query-tile blocks
//     computing dq and key-tile blocks dk and dv, each deriving delta
//     from its own rows of do and o; delta is never written.
// Every product accumulates in float32.
//
// What bounds it. At the 512 px training shape (b 4, 16 heads of 64,
// n 4352, causal, float32) the products (2 per allowed pair forward, 3
// dq, 4 dk/dv, 2*d operations each) take ~2.3, ~3.5 and ~4.6 ms at an
// H100 SXM's 67 TFLOP/s float32 rate on the CUDA cores, ~0.9, ~1.4 and
// ~1.9 ms at its tensor cores' 495 / 3 TFLOP/s as split 3xTF32 (data
// sheet rates, 700 W), against ~0.1 ms of bytes at its 3.35 TB/s (q, k,
// v, o, do and the gradients once each): operations bound it. The
// design keeps every score on chip and, unlike the TPU kernel, neither
// loads nor computes a class 0 tile; a streamed half whose keys the key
// mask drops entirely is skipped too (it would add p = 0 and leave every
// sum as it is). The query tiles of the causal forward and
// dq are launched longest row first. There are no float atomics: dq
// accumulates over key tiles inside one block and dk/dv over query tiles
// inside one block, so two runs give bit-identical results. The
// single-block backward's main path (b 2, 3 heads of 64, n 1280, causal)
// has ~0.02 ms of 3xTF32 operations spread over one wave of 240 blocks
// whose longest streams 40 halves against the shortest's 2: latency and
// that imbalance bound it, not the rate.
//
// Two designs, both on the tensor cores with blocks of 4 warps, each warp
// 16 rows of a resident 64-row tile (Q for the forward, Q and dO for dq,
// K and V for dk/dv), the other operands streamed in 32-row halves of the
// visit map through a cp.async ring; the forward's online softmax runs on
// the score accumulators and P feeds O += P.V from registers; the dk/dv
// pass is key-major (S^T = K.Q^T, dP^T = V.dO^T) so that P^T and dS^T
// feed dV += P^T.dO and dK += dS^T.Q from registers; the single-block
// backward runs the dq and dk/dv bodies in one launch, its key blocks
// deriving each streamed half's delta from O and dO rows streamed with
// it, so its gradients are the dq + dk/dv chain's bit for bit.
//  - float32 (flash_fwd_tf32_kernel, flash_dq_tf32_kernel,
//    flash_dkdv_tf32_kernel, flash_bwd_fused_tf32_kernel): every product
//    as split 3xTF32 mma.sync.m16n8k8 (csrc/tf32_tiles.cuh, whose
//    numerics keep float32's tolerances), a 2-stage ring whose tiles are
//    split into TF32 big and small parts once when they land; the sums
//    over keys (o, dq) and queries (dk/dv) fold a fresh partial per
//    streamed half in with rounded FMAs, since the tensor cores truncate
//    as they accumulate (tf32::fold_product). The bodies are
//    csrc/tf32_sweeps.cuh's, which the pair grid's float32 kernels share.
//  - bfloat16 (flash_fwd_tc_kernel, flash_dq_tc_kernel,
//    flash_dkdv_tc_kernel, flash_bwd_fused_tc_kernel): bf16
//    mma.sync.m16n8k16 products with float32 accumulation
//    (csrc/mma_tiles.cuh) through a 3-stage ring, one barrier a half; the
//    bodies are csrc/bf16_sweeps.cuh's, p and ds rounded to bf16 as they
//    are packed into the next product's A fragments. At the 512 px shape
//    the forward's, dq's and dk/dv's products take ~0.16, ~0.24 and ~0.31
//    ms at the tensor cores' 989 TFLOP/s bf16 rate.

#include <algorithm>
#include <type_traits>

#include "attention_tiles.cuh"
#include "bf16_sweeps.cuh"
#include "tf32_sweeps.cuh"

namespace {

// The operands of every entry point (unused ones NULL).
template <typename T>
struct Operands {
  const T *q, *k, *v, *o, *dout;
  const float *lse, *delta_in;
  const uint8_t* kmask;   // (b, n) or NULL
  const int8_t* pattern;  // (n, n) or NULL
  const int8_t* visit;    // (n / TILE, n / TILE)
  T *out, *dq, *dk, *dv;
  float *lse_out, *delta_out;
  int heads, n;
  float scale;
};

enum class Pass { kFwd, kDq, kDkdv, kFused };

// ------------ float32 forward, dq, dk/dv and single-block backward: 3xTF32
//
// The query or key tile a block owns is resident (tf32::ROWS = TILE rows,
// warp w rows 16w .. 16w + 15); the other side streams in halves of a
// TILE (tf32::SROWS = 32 rows), each half of the class of its 64-tile in
// the visit map. Float32 tiles are rows of d floats padded to d + 4; A
// fragments of the resident tile come by ldmatrix and are split in
// registers, the streamed tiles are split in shared memory once (big in
// place, small beside), p = tc::exp_diff(s, m * log2(e)) forward and
// exp_diff(s, lse * log2(e)) backward. The forward, dq and dk/dv bodies
// are the sweeps of tf32_sweeps.cuh, shared with the pair grid. At d 64 a
// forward block holds 70-74 KB of shared memory (three fit an H100 SM's
// 228 KB), a dq or dk/dv block 87-91 KB and a single-block backward block
// 105-109 KB (two fit).

static_assert(TILE == tf32::ROWS, "the visit map's tile is the resident tile");

// One head's operands of the entry point's (b*h, n, d) tensors, as the
// sweeps take them (H: tf32::Head or bf16s::Head)
template <class H, int D, typename T>
__device__ __forceinline__ H head_of(const Operands<T>& a, int bh) {
  const int64_t head = (int64_t)bh * a.n * D, rows = (int64_t)bh * a.n;
  auto at = [](auto* p, int64_t off) { return p == nullptr ? nullptr : p + off; };
  return {at(a.q, head),       at(a.k, head),       at(a.v, head),
          at(a.o, head),       at(a.dout, head),    at(a.lse, rows),
          at(a.delta_in, rows),
          a.kmask == nullptr ? nullptr : a.kmask + (int64_t)(bh / a.heads) * a.n,
          at(a.dq, head),      at(a.dk, head),      at(a.dv, head),
          at(a.delta_out, rows), a.n,               a.scale};
}

// The key halves of visit-map row qt
template <typename T>
__device__ __forceinline__ tf32::VisitRow row_of(const Operands<T>& a, int qt) {
  return {a.visit + (int64_t)qt * (a.n / TILE), a.pattern, a.n, qt * TILE};
}

// o and lse of query tile nt - 1 - blockIdx.y (longest causal rows
// first) of head blockIdx.x: the online softmax over its visited key
// halves (tf32::fwd_sweep). At d <= 64 three blocks share an SM
// (registers capped for it, no spills), which timed faster than two.
// The head's pointers are offsets of the launch's operands, without
// head_of's NULL tests, so that the compiler can rederive them rather
// than hold them in registers under that cap (PERF.md, section 6).
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 3 : 1)
    flash_fwd_tf32_kernel(const Operands<float> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x;
  const int64_t head = (int64_t)bh * a.n * D;
  tf32::Head h{};
  h.q = a.q + head, h.k = a.k + head, h.v = a.v + head;
  h.km = a.kmask == nullptr ? nullptr : a.kmask + (int64_t)(bh / a.heads) * a.n;
  h.out = a.out + head, h.lse_out = a.lse_out + (int64_t)bh * a.n;
  h.n = a.n, h.scale = a.scale;
  tf32::fwd_sweep<D>(h, row_of(a, a.n / TILE - 1 - (int)blockIdx.y), smem_raw);
}

// The query halves of visit-map column kt
template <typename T>
__device__ __forceinline__ tf32::VisitColumn column_of(const Operands<T>& a, int kt) {
  return {a.visit + kt, a.pattern, a.n / TILE, a.n, kt * TILE};
}

// dq of query tile nt - 1 - blockIdx.y (longest causal rows first) of
// head blockIdx.x, over its visited key halves; delta from do and o,
// written to a.delta_out
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 2 : 1)
    flash_dq_tf32_kernel(const Operands<float> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tf32::dq_sweep<D>(head_of<tf32::Head, D>(a, blockIdx.x),
                    row_of(a, a.n / TILE - 1 - (int)blockIdx.y), smem_raw);
}

// dk and dv of key tile blockIdx.y (longest causal columns first) of
// head blockIdx.x, over its visited query halves, on a.delta_in
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 2 : 1)
    flash_dkdv_tf32_kernel(const Operands<float> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kt = blockIdx.y;
  tf32::dkdv_sweep<D, false>(head_of<tf32::Head, D>(a, blockIdx.x), column_of(a, kt), kt * TILE,
                             smem_raw);
}

// The single-block backward of head blockIdx.x in one launch: even
// blocks y compute dq of query tile nt - 1 - y / 2 (longest causal rows
// first) as flash_dq_tf32_kernel, odd blocks dk and dv of key tile y / 2
// (longest causal columns first) as flash_dkdv_tf32_kernel, deriving each
// half's delta from its O and dO rows in the dq pass's order; delta is
// never written. So dq, dk and dv are those of the two-launch chain bit
// for bit. Interleaved, both roles' longest tiles start in the first wave
// (timed faster than the dq role's blocks all first); at d 32 three
// blocks share an SM (registers capped for it, no spills), which timed
// faster than two.
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 32 ? 3 : D <= 64 ? 2 : 1)
    flash_bwd_fused_tf32_kernel(const Operands<float> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = a.n / TILE, y = blockIdx.y;
  const tf32::Head head = head_of<tf32::Head, D>(a, blockIdx.x);
  if ((y & 1) == 0) {
    tf32::dq_sweep<D>(head, row_of(a, nt - 1 - (y >> 1)), smem_raw);
  } else {
    const int kt = y >> 1;
    tf32::dkdv_sweep<D, true>(head, column_of(a, kt), kt * TILE, smem_raw);
  }
}

// The float32 launches: grid (b*h, n / TILE), or (b*h, 2 n / TILE) for the
// single-block backward, so that the scheduler starts every head's longest
// tiles first. -1 for more tiles than a grid dimension holds or an operand
// not 16-byte aligned (cp.async, vector stores).
template <int D>
int launch_tf32(Pass pass, const Operands<float>& a, int batch, cudaStream_t stream) {
  const int nt = a.n / TILE, tiles = pass == Pass::kFused ? 2 * nt : nt;
  if (tiles > 65535 ||
      !tc::aligned16({a.q, a.k, a.v, a.o, a.dout, a.pattern, a.out, a.dq, a.dk, a.dv}))
    return -1;
  const dim3 grid(batch * a.heads, tiles);
  const bool pattern = a.pattern != nullptr;
  int err = 0;
  if (pass == Pass::kFwd) {
    const int smem = tf32::fwd_sweep_smem_bytes(D, pattern);
    if ((err = allow_smem(flash_fwd_tf32_kernel<D>, smem)) != 0) return err;
    flash_fwd_tf32_kernel<D><<<grid, tc::THREADS, smem, stream>>>(a);
  } else if (pass == Pass::kDq) {
    const int smem = tf32::dq_sweep_smem_bytes(D, pattern);
    if ((err = allow_smem(flash_dq_tf32_kernel<D>, smem)) != 0) return err;
    flash_dq_tf32_kernel<D><<<grid, tc::THREADS, smem, stream>>>(a);
  } else if (pass == Pass::kDkdv) {
    const int smem = tf32::dkdv_sweep_smem_bytes(D, pattern, false);
    if ((err = allow_smem(flash_dkdv_tf32_kernel<D>, smem)) != 0) return err;
    flash_dkdv_tf32_kernel<D><<<grid, tc::THREADS, smem, stream>>>(a);
  } else {  // the larger of the two roles
    const int smem = std::max(tf32::dq_sweep_smem_bytes(D, pattern),
                              tf32::dkdv_sweep_smem_bytes(D, pattern, true));
    if ((err = allow_smem(flash_bwd_fused_tf32_kernel<D>, smem)) != 0) return err;
    flash_bwd_fused_tf32_kernel<D><<<grid, tc::THREADS, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// ----- bfloat16 forward, dq, dk/dv and single-block backward: bf16 mma.sync
//
// The float32 design (a resident 64-row tile, 4 warps of 16 rows, 32-row
// halves of the visit map streamed through a cp.async ring, here of 3
// stages so that one barrier a half serves) on bf16 mma.sync.m16n8k16
// with float32 accumulation: the bodies are csrc/bf16_sweeps.cuh's, over
// the same walks. Tiles are bf16 rows padded to d + 8; nothing is split,
// and p and ds are rounded to bf16 as they are packed into the next
// product's A fragments. At d 64 a forward block holds 37-43 KB of shared
// memory, a dq or dk/dv block 46-52 KB and a single-block backward block
// 60-66 KB; registers, not shared memory, set the blocks an SM holds.
// The forward runs the softmax's exponentials on the SFU beside the
// products: at d 64 a warp's half takes 32 mma.sync and 512 ex2.approx,
// about as many SM cycles each at their peak rates.

// o and lse of query tile nt - 1 - blockIdx.y (longest causal rows
// first) of head blockIdx.x: the online softmax over its visited key
// halves (bf16s::fwd_sweep). At d <= 64 four blocks share an SM
// (registers capped at 128 for it, no spills), which timed 2% faster
// than three and 5% faster than two (PERF.md, section 6).
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 4 : 2)
    flash_fwd_tc_kernel(const Operands<tc::bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16s::Head h = head_of<bf16s::Head, D>(a, blockIdx.x);
  h.out = a.out + (int64_t)blockIdx.x * a.n * D;
  h.lse_out = a.lse_out + (int64_t)blockIdx.x * a.n;
  bf16s::fwd_sweep<D>(h, row_of(a, a.n / TILE - 1 - (int)blockIdx.y), smem_raw);
}

// dq of query tile nt - 1 - blockIdx.y (longest causal rows first) of
// head blockIdx.x, over its visited key halves; delta from do and o,
// written to a.delta_out
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 3 : 2)
    flash_dq_tc_kernel(const Operands<tc::bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16s::dq_sweep<D>(head_of<bf16s::Head, D>(a, blockIdx.x),
                     row_of(a, a.n / TILE - 1 - (int)blockIdx.y), smem_raw);
}

// dk and dv of key tile blockIdx.y (longest causal columns first) of
// head blockIdx.x, over its visited query halves, on a.delta_in
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 3 : 2)
    flash_dkdv_tc_kernel(const Operands<tc::bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kt = blockIdx.y;
  bf16s::dkdv_sweep<D, false>(head_of<bf16s::Head, D>(a, blockIdx.x), column_of(a, kt), kt * TILE,
                              smem_raw);
}

// The bf16 single-block backward of head blockIdx.x in one launch, as
// flash_bwd_fused_tf32_kernel: even blocks y compute dq of query tile nt
// - 1 - y / 2 as flash_dq_tc_kernel, odd blocks dk and dv of key tile y /
// 2 as flash_dkdv_tc_kernel, deriving each half's delta from its O and dO
// rows in the dq pass's order (bf16s::row_delta); delta is never
// written. So dq, dk and dv are those of the two-launch chain bit for
// bit. At d 64 two blocks share an SM (214 registers, no spills), which
// timed 4% faster than three (168 registers, a few bytes spilled); at d
// 32 three and two timed alike.
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 32 ? 3 : 2)
    flash_bwd_fused_tc_kernel(const Operands<tc::bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = a.n / TILE, y = blockIdx.y;
  const bf16s::Head head = head_of<bf16s::Head, D>(a, blockIdx.x);
  if ((y & 1) == 0) {
    bf16s::dq_sweep<D>(head, row_of(a, nt - 1 - (y >> 1)), smem_raw);
  } else {
    const int kt = y >> 1;
    bf16s::dkdv_sweep<D, true>(head, column_of(a, kt), kt * TILE, smem_raw);
  }
}

// The bf16 launches: grid (b*h, n / TILE), or (b*h, 2 n / TILE) for the
// single-block backward, so that the scheduler starts every head's
// longest tiles first. -1 for more tiles than a grid dimension holds or
// an operand not 16-byte aligned (cp.async, ldmatrix, vector stores).
template <int D>
int launch_bf16(Pass pass, const Operands<tc::bf16>& a, int batch, cudaStream_t stream) {
  const int nt = a.n / TILE, tiles = pass == Pass::kFused ? 2 * nt : nt;
  if (tiles > 65535 ||
      !tc::aligned16({a.q, a.k, a.v, a.o, a.dout, a.pattern, a.out, a.dq, a.dk, a.dv}))
    return -1;
  const dim3 grid(batch * a.heads, tiles);
  const bool pattern = a.pattern != nullptr;
  int err = 0;
  if (pass == Pass::kFwd) {
    const int smem = bf16s::fwd_sweep_smem_bytes(D, pattern);
    if ((err = allow_smem(flash_fwd_tc_kernel<D>, smem)) != 0) return err;
    flash_fwd_tc_kernel<D><<<grid, tc::THREADS, smem, stream>>>(a);
  } else if (pass == Pass::kDq) {
    const int smem = bf16s::dq_sweep_smem_bytes(D, pattern);
    if ((err = allow_smem(flash_dq_tc_kernel<D>, smem)) != 0) return err;
    flash_dq_tc_kernel<D><<<grid, tc::THREADS, smem, stream>>>(a);
  } else if (pass == Pass::kDkdv) {
    const int smem = bf16s::dkdv_sweep_smem_bytes(D, pattern, false);
    if ((err = allow_smem(flash_dkdv_tc_kernel<D>, smem)) != 0) return err;
    flash_dkdv_tc_kernel<D><<<grid, tc::THREADS, smem, stream>>>(a);
  } else {  // the larger of the two roles
    const int smem = std::max(bf16s::dq_sweep_smem_bytes(D, pattern),
                              bf16s::dkdv_sweep_smem_bytes(D, pattern, true));
    if ((err = allow_smem(flash_bwd_fused_tc_kernel<D>, smem)) != 0) return err;
    flash_bwd_fused_tc_kernel<D><<<grid, tc::THREADS, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// shapes every entry point refuses (-1): an empty shape, n not a multiple
// of TILE, more (batch, head) pairs than a grid dimension holds
bool refused(int batch, int heads, int n) {
  return batch < 1 || heads < 1 || n < TILE || n % TILE != 0 ||
         (int64_t)batch * heads > 65535;
}

struct Pointers {
  const void *q, *k, *v, *o, *dout, *lse, *delta_in, *kmask, *pattern, *visit;
  void *out, *dq, *dk, *dv, *lse_out, *delta_out;
};

template <typename T, int D>
int run(Pass pass, const Pointers& p, int batch, int heads, int n, float scale,
        cudaStream_t stream) {
  const Operands<T> a{(const T*)p.q,         (const T*)p.k,        (const T*)p.v,
                      (const T*)p.o,         (const T*)p.dout,     (const float*)p.lse,
                      (const float*)p.delta_in, (const uint8_t*)p.kmask,
                      (const int8_t*)p.pattern, (const int8_t*)p.visit,
                      (T*)p.out,             (T*)p.dq,             (T*)p.dk,
                      (T*)p.dv,              (float*)p.lse_out,    (float*)p.delta_out,
                      heads,                 n,                    scale};
  if constexpr (std::is_same<T, float>::value)
    return launch_tf32<D>(pass, a, batch, stream);
  else
    return launch_bf16<D>(pass, a, batch, stream);
}

// Instances: dtype 0 = float32, 1 = bfloat16; dim_head 32, 64, 96, 128.
int dispatch(Pass pass, const Pointers& p, int batch, int heads, int n, int dim_head,
             float scale, int dtype, void* stream) {
  if (refused(batch, heads, n)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype * 1000 + dim_head) {
    case 32: return run<float, 32>(pass, p, batch, heads, n, scale, s);
    case 64: return run<float, 64>(pass, p, batch, heads, n, scale, s);
    case 96: return run<float, 96>(pass, p, batch, heads, n, scale, s);
    case 128: return run<float, 128>(pass, p, batch, heads, n, scale, s);
    case 1032: return run<__nv_bfloat16, 32>(pass, p, batch, heads, n, scale, s);
    case 1064: return run<__nv_bfloat16, 64>(pass, p, batch, heads, n, scale, s);
    case 1096: return run<__nv_bfloat16, 96>(pass, p, batch, heads, n, scale, s);
    case 1128: return run<__nv_bfloat16, 128>(pass, p, batch, heads, n, scale, s);
    default: return -1;
  }
}

}  // namespace

// Every entry point: q, k, v (and o, do, dq, dk, dv) contiguous
// (b, h, n, dim_head) of one type; lse and delta (b, h, n) float32; kmask
// (b, n) uint8 or NULL; pattern (n, n) int8 or NULL; visit
// (n / 64, n / 64) int8. One launch on `stream`. Returns
// cudaGetLastError() after it (0 on success), or -1 for what the kernels
// cannot take: a dim_head other than 32/64/96/128, a dtype code other
// than 0/1, n not a positive multiple of 64, more (batch, head) pairs
// than a grid dimension holds, more than 65535 tiles of a grid or an
// operand not 16-byte aligned.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kmask, const void* pattern,
                                   const void* visit, void* out, void* lse, int batch,
                                   int heads, int n, int dim_head, float scale, int dtype,
                                   void* stream) {
  Pointers p{};
  p.q = q, p.k = k, p.v = v, p.kmask = kmask, p.pattern = pattern, p.visit = visit;
  p.out = out, p.lse_out = lse;
  return dispatch(Pass::kFwd, p, batch, heads, n, dim_head, scale, dtype, stream);
}

// delta is written here (rowsum(do * o) per row and head) for
// flash_attention_dkdv.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, const void* lse,
                                  const void* kmask, const void* pattern,
                                  const void* visit, void* dq, void* delta, int batch,
                                  int heads, int n, int dim_head, float scale, int dtype,
                                  void* stream) {
  Pointers p{};
  p.q = q, p.k = k, p.v = v, p.o = o, p.dout = dout, p.lse = lse, p.kmask = kmask;
  p.pattern = pattern, p.visit = visit, p.dq = dq, p.delta_out = delta;
  return dispatch(Pass::kDq, p, batch, heads, n, dim_head, scale, dtype, stream);
}

extern "C" int flash_attention_dkdv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* kmask, const void* pattern,
                                    const void* visit, void* dk, void* dv, int batch,
                                    int heads, int n, int dim_head, float scale,
                                    int dtype, void* stream) {
  Pointers p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.lse = lse, p.delta_in = delta;
  p.kmask = kmask, p.pattern = pattern, p.visit = visit, p.dk = dk, p.dv = dv;
  return dispatch(Pass::kDkdv, p, batch, heads, n, dim_head, scale, dtype, stream);
}

// dq, dk and dv from one launch; delta is derived per block, never stored.
extern "C" int flash_attention_bwd_fused(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         const void* kmask, const void* pattern,
                                         const void* visit, void* dq, void* dk, void* dv,
                                         int batch, int heads, int n, int dim_head,
                                         float scale, int dtype, void* stream) {
  Pointers p{};
  p.q = q, p.k = k, p.v = v, p.o = o, p.dout = dout, p.lse = lse, p.kmask = kmask;
  p.pattern = pattern, p.visit = visit, p.dq = dq, p.dk = dk, p.dv = dv;
  return dispatch(Pass::kFused, p, batch, heads, n, dim_head, scale, dtype, stream);
}
