// Paged decode attention (K5) and paged chunked-prefill attention (K6) for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernels in src/repro/kernels/paged_attention/kernel.py:
//   paged_decode_attention  <- paged_attention_kernel          (body _pa_kernel)
//   paged_prefill_attention <- paged_prefill_attention_kernel  (body _pp_kernel)
//
// What they compute (as the Pallas bodies do): each (slot, kv head) walks its
// block-table pages tables[b, j] with an online softmax in f32. Scores of
// masked keys are set to -1e30 and p is chosen by a select (never by a
// multiply with the mask), so masked keys add exact zeros; the denominator
// is clamped at 1e-30. Decode row g sits at position L-1; prefill row (t, g)
// is flattened as r = t*G + g and sits at start + t, with kpos <= qpos and,
// with a window, kpos > qpos - window. Keys at or past the extent (and past
// P*page) are never read, nor are keys wholly below the window: both are
// exact skips (they would add zeros and leave m unchanged).
//
// What bounds them on the H100: bytes, and at serving sizes latency. Decode
// does 4*G flops per pair of K/V bytes (G <= 8 rows a block) against the card's ~295
// flop/byte ridge in bf16; granite-8b's 128-row prefill chunk does ~220
// flops per byte it must move (q, out and K/V), still below it. At these sizes (~10 MB of K/V a decode
// step, ~4 MB a chunk) the chain of dependent loads in one block decides as
// much as the bytes do. So both designs read each cached byte once per
// block, compute a block's row offsets before any K/V row (no row waits on
// its own table load or division), keep every row of a block in flight at
// once, and spread the keys over enough blocks to fill the card.
//
// Split plan, shared by both: the keys of a query position (K5, f32 K6) or
// of a row tile (bf16 K6) are cut into ranges of kDecodeSplit = 64 or
// kPrefillSplit = 128 keys, constants of the kernel, from the range that
// holds the row's first key. The grid holds S = min(ceil(P*page / split),
// max_splits) columns of ranges (kDecodeMaxSplits = 32, kPrefillMaxSplits =
// 16), so that the workspace is bounded whatever the table's width: a row
// whose keys meet more than max_splits ranges takes longer ones, split *
// ceil(n / max_splits) keys for its n, walked in steps of `split` keys by
// one block (plan_of). A row that fits keeps ranges of `split` keys, each in
// its own column wherever the grid is not capped, so that a block loads its
// row offsets before its row's length is known. A block whose column holds
// no range of its rows exits before any K/V load. Each block writes the
// partial (m, l, f32 acc) of its rows to a workspace the wrapper allocates,
// and a combine kernel (launched as a programmatic dependent launch, so that
// its prologue overlaps the split kernel's end) merges a row's ranges in
// order. Every row goes through the combine, and a row's ranges and order of
// summation depend only on its own slot (length; start and q_len): batched
// == alone, bitwise. An inactive slot's ranges stop at P*page keys, so no
// table entry at or past P is read.
//
// K5 (paged_decode_split_kernel, paged_decode_combine_kernel): grid (S, Kv,
// B), 128 threads in groups of kL lanes (16 at hd 128 bf16); a group holds
// one token row of one kv head, hd contiguous elements, as one or two 16-byte
// loads a lane, straight into registers (no shared-memory copy of the page,
// one barrier before the rows and one merge at the end). All of a group's
// rows are loaded before any is used (8 at hd 128 bf16). A block holds a
// chunk of at most 8 of the G query rows of its kv head (kChunkRows; the
// grid's y holds Kv x ceil(G / 8) chunks, so any G runs on the bodies
// templated for MG 4 and 8): they stay in registers in f32; dots on the
// CUDA cores in f32, reduced across the group by shuffles; each group keeps
// its own online softmax; the groups merge in group order through shared
// memory. A row's sums depend on its own slot and chunk only. Tensor cores
// would gain nothing at 8 rows. Granite-8b's
// decode (B 4, Kv 8, lengths 561-633, P 40): 10 x 8 x 4 = 320 blocks, 312
// with work (32 before); gemma3-1b's (Kv 1, hd 256, window 512, P 90): 92
// blocks, 36 with work (4 before). ptxas: 128 registers, 16,848 B static
// shared memory at hd 128 bf16, no spills.
//
// K6 bf16 (paged_prefill_mma_kernel, paged_prefill_combine_kernel): one block
// holds kMmaRows = 64 flattened (t, g) rows of one (slot, kv head), 16
// positions x G 4 at granite (any G: a tile edge may fall inside a
// position's rows), four warps of 16 rows; the G heads of a
// position share every K/V tile, and the row tiles of a kv head share its
// K/V from L2. q lives in registers as mma A fragments at hd <= 128 (read
// once from global memory), in shared memory at hd 256. Keys come in 64-key
// tiles gathered through the row offsets by cp.async 16-byte copies into a
// two-stage ring of bf16 tiles (a split is two tiles: the second tile's
// copies fly while the first is multiplied), rows padded by 16 bytes so that
// ldmatrix is free of bank conflicts; keys past the extent are zero-filled.
// S = Q K^T and O += P V by mma.sync.m16n8k16 bf16 -> f32, the softmax in the
// accumulator registers (FlashAttention-2); a row that sees a whole tile
// skips the per-key mask. P is split into a bf16 high part and a bf16 low
// part (two MMAs, the second pass after all the first) so that P V keeps p
// to ~2^-16 relative, as the plain version's f32 p does. Key tiles wholly
// above a row tile's last valid row or below its first row's window are
// never visited. Granite-8b's chunk (T 128, start 384, P 40): grid 5 splits
// x 8 row tiles x 8 kv heads = 320 blocks, 256 with work (128 before, each
// of 16 row tiles reading every page); each K/V byte is read from HBM once
// and by the 8 row tiles of its kv head from L2. ptxas at hd 128: 224
// registers, 69,632 B of dynamic shared memory, no spills (hd 256: 255
// registers, 120 B of stack, 168,960 B).
//
// f32 inputs: the tensor cores would run TF32 (~1e-3 relative), which fails
// the f32 gate of 2e-5, so f32 takes its products on the CUDA cores: K5 as
// above, and K6 through the same split body, one block per (range, kv head
// and row chunk, slot, position) with a chunk of that position's G rows
// (paged_prefill_rows_kernel),
// merged by the same combine. The choice is by dtype alone.
//
// hd: 16, 32, 64, 96, 128 and 256 are built (the configs use 64, 96, 128,
// 256; the JAX suite 16, 32, 64, 128).
//
// Quantized pools (the JAX kernels' k_scale / v_scale operands): the pool
// holds int8 or fp8-e4m3 codes and one f32 scale per (page slot, kv head),
// scales (N, page, Kv) contiguous, so key k's scale sits at off[k] + kv,
// beside its row offset. The kernels compute what JAX's bodies compute: each
// key's and value's row dequantized in f32 as code * scale, scores, online
// softmax and P V in f32, one rounding of the output to q's type; no
// dequantized pool or tile is ever written. The bytes a key costs fall from
// 2*hd*2 (bf16) to 2*(hd + 4).
//   K5 and f32 K6 (split_body, templated on the pool's element type KT): a
//   lane loads 8 codes (8 bytes) where it loaded 8 bf16 (16 bytes), so the
//   lane layout, group sizes, shuffle trees and registers of the bf16 body
//   are kept (16 codes a lane would double q's and acc's registers and
//   spill at 8 rows); each key's two scales are loaded with its row, and
//   each code is converted to f32 (int8 directly, fp8 through the exact
//   fp8x2 -> half2 conversion) and multiplied by its scale before the dot
//   and before P V, in JAX's order.
//   bf16 K6 (paged_prefill_mma_kernel<HD, KT>): the cp.async ring carries
//   1-byte code tiles (half a bf16 stage) and each key's two scales. The
//   thread that copied a 16-code chunk converts it, after its own wait, into
//   one bf16 tile of the codes themselves (exact: every int8 code and every
//   e4m3 value is a bf16 value; a barrier before and after), which the bf16
//   body's ldmatrix and mma.sync read unchanged. The scales go to the f32
//   side: column j of S = Q C^T is multiplied by ks[j] before the mask and
//   the softmax, and p_j by vs[j] (after it joins l) before p is split high +
//   low for P V. Every product is then exact or one f32 rounding, as in the
//   plain version; only the f32 summation order differs. Rounding code *
//   scale to bf16 in shared memory would be a second rounding that JAX does
//   not have, so it is never done.
//   The null page's scales start at zero and are never read unmasked: keys
//   at or past a row's extent are neither loaded nor scaled.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/mma_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kDecodeSplit = 64;   // keys per K5 split (4 pages of 16)
constexpr int kPrefillSplit = 128; // keys per K6 split (2 key tiles)
constexpr int kDecodeMaxSplits = 32;   // split columns of a K5 / f32 K6 grid, at most
constexpr int kPrefillMaxSplits = 16;  // split columns of a bf16 K6 grid, at most
constexpr int kMmaRows = 64;       // flattened rows per K6 block
constexpr int kKeyTile = 64;       // keys per K6 ring stage
constexpr int kChunkRows = 8;      // query rows of a group a K5 / f32 K6 block holds

using fp8 = __nv_fp8_e4m3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// A pool's element type: the native one (q's type: f32, bf16) or a 1-byte
// code (int8, fp8-e4m3) that comes with scales. A lane's vector of a row is
// 16 bytes of a native pool and 8 codes of a quantized one.
template <typename KT>
struct Pool {
  static constexpr bool kCodes = false;
  static constexpr int kVecBytes = 16;
};
template <>
struct Pool<int8_t> {
  static constexpr bool kCodes = true;
  static constexpr int kVecBytes = 8;
};
template <>
struct Pool<fp8> {
  static constexpr bool kCodes = true;
  static constexpr int kVecBytes = 8;
};

// The N elements of a loaded vector in f32 (exact for every type here).
template <typename KT, int N, typename V>
__device__ __forceinline__ void vec_to_f32(const V& v, float (&out)[N]) {
  if constexpr (std::is_same_v<KT, fp8>) {
    const __nv_fp8x2_storage_t* p = reinterpret_cast<const __nv_fp8x2_storage_t*>(&v);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(p[e], __NV_E4M3)));
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else if constexpr (std::is_same_v<KT, int8_t>) {
    const int8_t* p = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = static_cast<float>(p[e]);
  } else {
    const KT* p = reinterpret_cast<const KT*>(&v);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f32(p[e]);
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int window) {
  return kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

// Programmatic dependent launch: a split kernel lets the combine after it
// start early; the combine waits in griddep_wait() until the split kernel
// has finished and its writes are visible.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The row offsets of keys [k0, k1) into shared memory: off[k - k0] =
// (page id * page + kpos % page) * Kv, the page id from the block table.
// A block computes them before any K/V row, all at once (one table load and
// one division a key), so that no row's load waits on a table load or a
// division of its own. The caller synchronizes before reading them. Every
// key < P*page, so no table entry at or past P is read.
__device__ __forceinline__ void load_row_offsets(const int* __restrict__ table_row, int k0,
                                                 int k1, int page, int Kv, long* off) {
  for (int k = k0 + (int)threadIdx.x; k < k1; k += blockDim.x) {
    const int j = k / page;
    off[k - k0] = ((long)table_row[j] * page + (k - j * page)) * Kv;
  }
}

// The address of key `k`'s row of kv head `kv` (pool (N, page, Kv, hd)
// contiguous), from the block's row offsets.
template <typename T>
__device__ __forceinline__ const T* kv_row(const T* pool, const long* off, int k, int kv,
                                           int hd) {
  return pool + (off[k] + kv) * hd;
}

// ------------------------------------------------------------ split plan
// Keys [lo, hi) that query position qpos needs (at most P*page of them).
struct KeyRange {
  int lo, hi;
};

__device__ __forceinline__ KeyRange keys_of(int qpos, int window, int cap) {
  KeyRange r;
  r.hi = min(qpos + 1, cap);
  r.lo = window > 0 ? max(0, qpos - window + 1) : 0;
  return r;
}

// A row's splits: `count` ranges of `len` keys (a multiple of `split`) from
// key `key0` = lo rounded down to `split`, which cover its keys [lo, hi);
// range i sits in column col0 + i of the grid's S columns. A row whose keys
// meet at most max_splits ranges of `split` keys has len = split and them as
// its ranges; a longer row has len = split * ceil(n / max_splits) for its n
// ranges of `split` keys, so that count <= max_splits. The plan depends on
// the row's own keys alone (and col0 on S). S = min(ceil(P*page / split),
// max_splits) >= count, so col0 >= 0; in a grid of ceil(P*page / split)
// columns, col0 = lo / split: range i at its own column, key0 + i * split.
struct Plan {
  int key0, len, count, col0;
};

__device__ __forceinline__ Plan plan_of(KeyRange r, int split, int max_splits, int S) {
  Plan p{0, split, 0, 0};
  if (r.lo >= r.hi) return p;
  const int first = r.lo / split;
  const int n = (r.hi + split - 1) / split - first;
  const int k = (n + max_splits - 1) / max_splits;
  p.key0 = first * split;
  p.len = k * split;
  p.count = (n + k - 1) / k;
  p.col0 = min(first, S - p.count);
  return p;
}

// K6's row tile `tile` of one slot: keys from the lowest row's window start
// to the last valid row's position (rows t >= q_len are garbage by contract).
__device__ __forceinline__ KeyRange tile_keys(int tile, int T, int G, int start, int qlen,
                                              int window, int cap) {
  const int t_lo = tile * kMmaRows / G;
  const int t_hi = min((tile * kMmaRows + kMmaRows - 1) / G, T - 1);
  KeyRange r;
  r.hi = min(start + min(qlen, t_hi + 1), cap);
  r.lo = window > 0 ? max(0, start + t_lo - window + 1) : 0;
  return r;
}

// Position of prefill row t of slot b: start + t; a garbage row (t >=
// q_len) is computed as the last valid one, so that its work stays within
// the slot's extent. (A decode row sits at L-1.)
__device__ __forceinline__ int prefill_qpos(const int* start, const int* q_len, int b, int t) {
  return start[b] + min(t, q_len[b] - 1);
}

// ------------------------------------------------ K5 (and f32 K6) split body
constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// KT: the pool's element type (its vectors); q's type is the body's T.
template <typename KT, int HD, int MG>
struct SplitShape {
  static constexpr int kVecBytes = Pool<KT>::kVecBytes;
  static constexpr int kVecElems = kVecBytes / (int)sizeof(KT);
  static constexpr int kRowVecs = HD / kVecElems;                    // vectors a row
  static constexpr int kL = pow2_at_least(kRowVecs) < 32 ? pow2_at_least(kRowVecs) : 32;
  static constexpr int kVecs = (kRowVecs + kL - 1) / kL;             // vector loads a lane
  static constexpr int kGroups = kThreads / kL;                      // token rows at once
  static constexpr int kTokens = kDecodeSplit / kGroups;            // tokens a group
  // token rows in flight a lane: all of a group's where registers allow
  static constexpr int kBatchMax = (MG <= 4 ? 8 : 4) / kVecs;
  static constexpr int kBatch = kBatchMax < kTokens ? kBatchMax : kTokens;
  using Vec = std::conditional_t<kVecBytes == 16, uint4, uint2>;
  static_assert(kTokens * kGroups == kDecodeSplit, "split not a multiple of the groups");
  static_assert(kTokens % kBatch == 0, "batch does not divide a group's tokens");
};

template <typename V>
__device__ __forceinline__ V zero_vec() {
  V v;
  if constexpr (std::is_same_v<V, uint4>) v = make_uint4(0, 0, 0, 0);
  else v = make_uint2(0, 0);
  return v;
}

// A group's next kBatch token rows (kpos0, kpos0 + kGroups, ...) of K and V,
// this lane's vectors of each, into registers, and (codes) each row's K and
// V scale; every load is issued before any is used. Keys outside [r.lo,
// r.hi) are not read (ok false, scale 0).
template <typename KT, int HD, int MG>
__device__ __forceinline__ void load_rows(
    const KT* __restrict__ kp, const KT* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const long* off, int base, int kpos0, KeyRange r, int kv,
    int lane,
    typename SplitShape<KT, HD, MG>::Vec (&kr)[SplitShape<KT, HD, MG>::kBatch]
                                              [SplitShape<KT, HD, MG>::kVecs],
    typename SplitShape<KT, HD, MG>::Vec (&vr)[SplitShape<KT, HD, MG>::kBatch]
                                              [SplitShape<KT, HD, MG>::kVecs],
    float (&ksc)[SplitShape<KT, HD, MG>::kBatch], float (&vsc)[SplitShape<KT, HD, MG>::kBatch],
    bool (&ok)[SplitShape<KT, HD, MG>::kBatch]) {
  using Sh = SplitShape<KT, HD, MG>;
  using Vec = typename Sh::Vec;
#pragma unroll
  for (int j = 0; j < Sh::kBatch; ++j) {
    const int kpos = kpos0 + j * Sh::kGroups;
    ok[j] = kpos >= r.lo && kpos < r.hi;
    ksc[j] = vsc[j] = 0.f;
#pragma unroll
    for (int v = 0; v < Sh::kVecs; ++v) {
      kr[j][v] = zero_vec<Vec>();
      vr[j][v] = zero_vec<Vec>();
    }
    if (ok[j]) {
      const KT* krow = kv_row(kp, off, kpos - base, kv, HD);
      const KT* vrow = kv_row(vp, off, kpos - base, kv, HD);
      if constexpr (Pool<KT>::kCodes) {
        ksc[j] = __ldg(ks + off[kpos - base] + kv);
        vsc[j] = __ldg(vs + off[kpos - base] + kv);
      }
#pragma unroll
      for (int v = 0; v < Sh::kVecs; ++v) {
        const int vec = lane + v * Sh::kL;
        if (vec < Sh::kRowVecs) {
          kr[j][v] = __ldg(reinterpret_cast<const Vec*>(krow + vec * Sh::kVecElems));
          vr[j][v] = __ldg(reinterpret_cast<const Vec*>(vrow + vec * Sh::kVecElems));
        }
      }
    }
  }
}

// One block: the G (<= MG) rows row0 .. row0+G-1 of one query position
// against the keys of their range in column s; writes the range's partial
// (m, l, acc) of each row to the workspace. T: q's type; KT: the pool's (T,
// or a code type whose scales ks, vs multiply each converted row, as JAX
// dequantizes). kLong: the grid is capped (ceil(P*page / kDecodeSplit) >
// S), so a row's range may be longer than a split and sit in another column
// than its own; else every range is the split of its own column, and the
// body is one straight pass over it (a loop over ranges there would take
// ~210 registers where the pass takes 128, halving the blocks an SM holds).
template <typename T, typename KT, int HD, int MG, bool kLong>
__device__ void split_body(const T* __restrict__ q, const KT* __restrict__ kp,
                           const KT* __restrict__ vp, const float* __restrict__ ks,
                           const float* __restrict__ vs, const int* __restrict__ table_row,
                           float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                           long row0, int S, int s, int qpos, int kv, int Kv, int G,
                           int page, int P, int window) {
  using Sh = SplitShape<KT, HD, MG>;
  constexpr int kVE = Sh::kVecElems, kL = Sh::kL, kV = Sh::kVecs;
  constexpr int kE = kV * kVE;  // elements a lane holds of a row
  constexpr int kQVecs = kVE * (int)sizeof(T) / 16;  // 16-byte q loads a vector
  static_assert(kQVecs >= 1, "a lane's q vector is a whole number of 16-byte loads");
  __shared__ float sm_acc[Sh::kGroups * MG * HD];
  __shared__ float sm_m[Sh::kGroups * MG];
  __shared__ float sm_l[Sh::kGroups * MG];
  __shared__ float sm_w[Sh::kGroups * MG];
  __shared__ long sm_off[kDecodeSplit];

  griddep_launch_dependents();  // the combine may start its prologue
  // the row offsets of the keys at this column's own split, not waiting for
  // the length: the block's keys wherever the grid is not capped
  const int guess = s * kDecodeSplit;
  load_row_offsets(table_row, guess, min(guess + kDecodeSplit, P * page), page, Kv, sm_off);
  const KeyRange r = keys_of(qpos, window, P * page);
  Plan plan{0, kDecodeSplit, 0, 0};
  int range0 = guess;  // keys [range0, range0 + plan.len)
  if constexpr (kLong) {
    plan = plan_of(r, kDecodeSplit, kDecodeMaxSplits, S);
    const int split_i = s - plan.col0;
    if (split_i < 0 || split_i >= plan.count) return;  // whole block: no range of its row
    range0 = plan.key0 + split_i * plan.len;
  } else if (r.lo >= r.hi || s < r.lo / kDecodeSplit || guess >= r.hi) {
    return;  // whole block: no key of this split
  }

  const int tid = threadIdx.x;
  const int grp = tid / kL;
  const int lane = tid % kL;

  // q rows in f32 registers: lane holds vectors lane, lane + kL, ...
  float qr[MG][kE];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int vec = lane + v * kL;
#pragma unroll
      for (int e = 0; e < kVE; ++e) qr[g][v * kVE + e] = 0.f;
      if (g < G && vec < Sh::kRowVecs) {
        alignas(16) T vals[kVE];
#pragma unroll
        for (int i = 0; i < kQVecs; ++i)
          reinterpret_cast<uint4*>(vals)[i] =
              reinterpret_cast<const uint4*>(q + (row0 + g) * HD + vec * kVE)[i];
#pragma unroll
        for (int e = 0; e < kVE; ++e) qr[g][v * kVE + e] = to_f32(vals[e]);
      }
    }
  }

  float m[MG], l[MG], acc[MG][kE];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  }

  // one split's keys [base, base + kDecodeSplit), their row offsets in
  // sm_off; each group's online softmax runs on across calls
  auto split_keys = [&](int base) {
#pragma unroll 1
    for (int i0 = 0; i0 < Sh::kTokens; i0 += Sh::kBatch) {
      typename Sh::Vec kr[Sh::kBatch][kV], vr[Sh::kBatch][kV];
      float ksc[Sh::kBatch], vsc[Sh::kBatch];
      bool ok[Sh::kBatch];
      load_rows<KT, HD, MG>(kp, vp, ks, vs, sm_off, base, base + grp + i0 * Sh::kGroups, r, kv,
                            lane, kr, vr, ksc, vsc, ok);
      // scores of the batch, reduced across the group's lanes
      float sc[Sh::kBatch][MG];
#pragma unroll
      for (int j = 0; j < Sh::kBatch; ++j) {
        float kf[kE];
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          float f[kVE];
          vec_to_f32<KT>(kr[j][v], f);
#pragma unroll
          for (int e = 0; e < kVE; ++e)
            kf[v * kVE + e] = Pool<KT>::kCodes ? f[e] * ksc[j] : f[e];
        }
        // every one of the MG rows (rows past G hold q = 0): no branch, so
        // that the MG x kBatch shuffle chains interleave
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < kE; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
          for (int o = kL / 2; o > 0; o /= 2) d += __shfl_xor_sync(0xffffffffu, d, o, kL);
          sc[j][g] = ok[j] ? d : kNegInf;
        }
      }
      // online softmax over the batch, per row
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < Sh::kBatch; ++j) mx = fmaxf(mx, sc[j][g]);
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int j = 0; j < Sh::kBatch; ++j) {
          const float p = ok[j] ? expf(sc[j][g] - m_new) : 0.f;
          sum += p;
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            float f[kVE];
            vec_to_f32<KT>(vr[j][v], f);
#pragma unroll
            for (int e = 0; e < kVE; ++e)
              acc[g][v * kVE + e] =
                  fmaf(p, Pool<KT>::kCodes ? f[e] * vsc[j] : f[e], acc[g][v * kVE + e]);
          }
        }
        l[g] = l[g] * alpha + sum;
        m[g] = m_new;
      }
    }
  };
  if constexpr (kLong) {  // the range in steps of kDecodeSplit keys
    int loaded = guess;
#pragma unroll 1
    for (int base = range0; base < min(range0 + plan.len, r.hi); base += kDecodeSplit) {
      if (base != loaded) {
        if (base != range0) __syncthreads();  // every group is done with the last offsets
        load_row_offsets(table_row, base, min(base + kDecodeSplit, P * page), page, Kv, sm_off);
        loaded = base;
      }
      __syncthreads();  // the row offsets
      split_keys(base);
    }
  } else {
    __syncthreads();  // the row offsets
    split_keys(range0);
  }

  // merge the groups in group order
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      sm_m[grp * MG + g] = m[g];
      sm_l[grp * MG + g] = l[g];
    }
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int vec = lane + v * kL;
      if (vec < Sh::kRowVecs) {
#pragma unroll
        for (int e = 0; e < kVE; ++e)
          sm_acc[(grp * MG + g) * HD + vec * kVE + e] = acc[g][v * kVE + e];
      }
    }
  }
  __syncthreads();
  if (tid < G) {
    float mx = kNegInf;
    for (int k = 0; k < Sh::kGroups; ++k) mx = fmaxf(mx, sm_m[k * MG + tid]);
    float lsum = 0.f;
    for (int k = 0; k < Sh::kGroups; ++k) {
      const float w = expf(sm_m[k * MG + tid] - mx);
      sm_w[k * MG + tid] = w;
      lsum += w * sm_l[k * MG + tid];
    }
    float* ml = ws_ml + ((row0 + tid) * S + s) * 2;
    ml[0] = mx;
    ml[1] = lsum;
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float a = 0.f;
    for (int k = 0; k < Sh::kGroups; ++k)
      a = fmaf(sm_w[k * MG + g], sm_acc[(k * MG + g) * HD + d], a);
    ws_acc[((row0 + g) * S + s) * HD + d] = a;
  }
}

// Row chunks of a group: blockIdx.y = kv * chunks + c holds rows c * 8 ..
// of kv head kv's G rows.
__host__ __device__ __forceinline__ int row_chunks(int G) {
  return (G + kChunkRows - 1) / kChunkRows;
}

// K5: grid (S, Kv * row_chunks(G), B); q and out (B, Kv, G, hd).
template <typename T, typename KT, int HD, int MG, bool kLong>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q, const KT* __restrict__ kp,
                          const KT* __restrict__ vp, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ tables,
                          const int* __restrict__ lengths, float* __restrict__ ws_acc,
                          float* __restrict__ ws_ml, int Kv, int G, int page, int P,
                          int window) {
  const int s = blockIdx.x, b = blockIdx.z;
  const int kv = blockIdx.y / row_chunks(G), g0 = blockIdx.y % row_chunks(G) * kChunkRows;
  const long row0 = ((long)b * Kv + kv) * G + g0;
  split_body<T, KT, HD, MG, kLong>(q, kp, vp, ks, vs, tables + (long)b * P, ws_acc, ws_ml,
                                   row0, gridDim.x, s, lengths[b] - 1, kv, Kv,
                                   min(kChunkRows, G - g0), page, P, window);
}

// f32 K6: grid (S, Kv * row_chunks(G), B*T); q and out (B, T, Kv, G, hd).
template <typename T, typename KT, int HD, int MG, bool kLong>
__global__ void __launch_bounds__(kThreads)
paged_prefill_rows_kernel(const T* __restrict__ q, const KT* __restrict__ kp,
                          const KT* __restrict__ vp, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ tables,
                          const int* __restrict__ start, const int* __restrict__ q_len,
                          float* __restrict__ ws_acc, float* __restrict__ ws_ml, int Tq,
                          int Kv, int G, int page, int P, int window) {
  const int s = blockIdx.x;
  const int kv = blockIdx.y / row_chunks(G), g0 = blockIdx.y % row_chunks(G) * kChunkRows;
  const int b = blockIdx.z / Tq, t = blockIdx.z % Tq;
  const long row0 = (((long)b * Tq + t) * Kv + kv) * G + g0;
  split_body<T, KT, HD, MG, kLong>(q, kp, vp, ks, vs, tables + (long)b * P, ws_acc, ws_ml,
                                   row0, gridDim.x, s, prefill_qpos(start, q_len, b, t), kv, Kv,
                                   min(kChunkRows, G - g0), page, P, window);
}

// ------------------------------------------------ K6 tensor-core prefill
using bf16 = __nv_bfloat16;

// KT: the pool's element type, bf16 or a 1-byte code type.
template <int HD, typename KT>
struct MmaShape {
  static constexpr bool kCodes = Pool<KT>::kCodes;
  static constexpr int kStride = HD + 8;  // bf16 a shared-memory row: +16 B, no conflicts
  static constexpr int kStages = 2;
  static constexpr int kTileElems = kKeyTile * kStride;
  static constexpr bool kQRegs = HD <= 128;  // else q is read from shared memory
  static constexpr int kCodeTile = kKeyTile * HD;  // bytes of a code tile (unpadded)
  // native: kStages bf16 K and V tiles [+ q]; codes: kStages code K and V
  // tiles, one bf16 K and V tile of the codes [+ q], kStages K and V scale rows
  static constexpr int kSmemBytes =
      kCodes ? 2 * kStages * kCodeTile + (2 * kTileElems + (kQRegs ? 0 : kMmaRows * kStride)) * 2 +
                   2 * kStages * kKeyTile * 4
             : (2 * kStages * kTileElems + (kQRegs ? 0 : kMmaRows * kStride)) * 2;
};

// The K and V tiles of keys key0 .. key0+63 of kv head kv into shared memory:
// each token row (HD contiguous bf16) found through the block's row offsets and
// copied as 16-byte cp.async chunks; keys at or past `hi` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_kv_tile(const bf16* kp, const bf16* vp, const long* off,
                                             int base, int key0, int hi, int kv, bf16* sk,
                                             bf16* sv) {
  constexpr int kChunks = HD / 8;
  constexpr int kStride = MmaShape<HD, bf16>::kStride;
#pragma unroll 4
  for (int i = threadIdx.x; i < kKeyTile * kChunks; i += kThreads) {
    const int row = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int kpos = key0 + row;
    const bool ok = kpos < hi;
    const bf16* krow = ok ? kv_row(kp, off, kpos - base, kv, HD) + c : kp;
    const bf16* vrow = ok ? kv_row(vp, off, kpos - base, kv, HD) + c : vp;
    cp_async16(smem_u32(sk + row * kStride + c), krow, ok ? 16 : 0);
    cp_async16(smem_u32(sv + row * kStride + c), vrow, ok ? 16 : 0);
  }
}

// The code tiles of keys key0 .. key0+63 (HD codes a row, 16 a cp.async
// chunk, rows unpadded: only the copying thread reads its chunk back) and
// each key's K and V scale (thread t < 64: K scale of key t; t >= 64: V
// scale of key t - 64); keys at or past `hi` are zero-filled, codes and
// scales. convert_kv_tile walks the same chunks in the same threads.
template <int HD, typename KT>
__device__ __forceinline__ void load_code_tile(const KT* kp, const KT* vp, const float* ks,
                                               const float* vs, const long* off, int base,
                                               int key0, int hi, int kv, KT* kc, KT* vc,
                                               float* ksm, float* vsm) {
  constexpr int kChunks = HD / 16;
  static_assert(kThreads == 2 * kKeyTile, "a thread a key's K or V scale");
#pragma unroll 4
  for (int i = threadIdx.x; i < kKeyTile * kChunks; i += kThreads) {
    const int row = i / kChunks;
    const int c = (i % kChunks) * 16;
    const int kpos = key0 + row;
    const bool ok = kpos < hi;
    const KT* krow = ok ? kv_row(kp, off, kpos - base, kv, HD) + c : kp;
    const KT* vrow = ok ? kv_row(vp, off, kpos - base, kv, HD) + c : vp;
    cp_async16(smem_u32(kc + row * HD + c), krow, ok ? 16 : 0);
    cp_async16(smem_u32(vc + row * HD + c), vrow, ok ? 16 : 0);
  }
  const int row = threadIdx.x % kKeyTile;
  const int kpos = key0 + row;
  const bool ok = kpos < hi;
  const float* sc = threadIdx.x < kKeyTile ? ks : vs;
  float* dst = (threadIdx.x < kKeyTile ? ksm : vsm) + row;
  cp_async4(smem_u32(dst), ok ? sc + off[kpos - base] + kv : sc, ok ? 4 : 0);
}

// This thread's chunks of a landed code tile (load_code_tile's chunks) as
// bf16 values of the codes themselves, exact, into the bf16 K and V tiles.
template <int HD, typename KT>
__device__ __forceinline__ void convert_kv_tile(const KT* kc, const KT* vc, bf16* kb,
                                                bf16* vb) {
  constexpr int kChunks = HD / 16;
  constexpr int kStride = MmaShape<HD, KT>::kStride;
#pragma unroll 4
  for (int i = threadIdx.x; i < kKeyTile * kChunks; i += kThreads) {
    const int row = i / kChunks;
    const int c = (i % kChunks) * 16;
#pragma unroll
    for (int kvi = 0; kvi < 2; ++kvi) {
      const uint4 raw = *reinterpret_cast<const uint4*>((kvi ? vc : kc) + row * HD + c);
      float f[16];
      vec_to_f32<KT>(raw, f);
      uint4 w[2];
      uint32_t* wp = reinterpret_cast<uint32_t*>(w);
#pragma unroll
      for (int e = 0; e < 8; ++e) wp[e] = pack_bf16(f[2 * e], f[2 * e + 1]);
      uint4* dst = reinterpret_cast<uint4*>((kvi ? vb : kb) + row * kStride + c);
      dst[0] = w[0];
      dst[1] = w[1];
    }
  }
}

// Grid (S * row tiles, Kv, B); q (B, T, Kv, G, HD) bf16; pools of KT (bf16,
// or codes with scales ks, vs). Block: row tile `tile` of slot b, kv head
// kv, keys of split s; writes the partials.
template <int HD, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_prefill_mma_kernel(const bf16* __restrict__ q, const KT* __restrict__ kp,
                         const KT* __restrict__ vp, const float* __restrict__ ks,
                         const float* __restrict__ vs, const int* __restrict__ tables,
                         const int* __restrict__ start, const int* __restrict__ q_len,
                         float* __restrict__ ws_acc, float* __restrict__ ws_ml, int Tq,
                         int Kv, int G, int page, int P, int window, int S) {
  using Sh = MmaShape<HD, KT>;
  constexpr int kKC = HD / 16;  // 16-wide k chunks of a q row
  constexpr int kDN = HD / 8;   // 8-wide n tiles of an output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long sm_off[kPrefillSplit];
  // native: sk, sv are kStages x (64, kStride) bf16 stages. codes: kc8, vc8
  // are kStages x (64, HD) code stages, sk, sv the one bf16 tile of the
  // codes, ksm, vsm kStages x 64 scales.
  KT* kc8 = reinterpret_cast<KT*>(smem_raw);
  KT* vc8 = kc8 + Sh::kStages * Sh::kCodeTile;
  bf16* sk = Sh::kCodes ? reinterpret_cast<bf16*>(vc8 + Sh::kStages * Sh::kCodeTile)
                        : reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + (Sh::kCodes ? 1 : Sh::kStages) * Sh::kTileElems;
  bf16* sq = sv + (Sh::kCodes ? 1 : Sh::kStages) * Sh::kTileElems;  // (64, kStride) when !kQRegs
  float* ksm = reinterpret_cast<float*>(sq + (Sh::kQRegs ? 0 : kMmaRows * Sh::kStride));
  float* vsm = ksm + Sh::kStages * kKeyTile;

  const int s = blockIdx.x % S, tile = blockIdx.x / S;
  const int kv = blockIdx.y, b = blockIdx.z;
  griddep_launch_dependents();  // the combine may start its prologue
  // the row offsets of the keys at this column's own split, not waiting for
  // start, q_len: the block's keys wherever the grid is not capped
  const int guess = s * kPrefillSplit;
  const int* table_row = tables + (long)b * P;
  load_row_offsets(table_row, guess, min(guess + kPrefillSplit, P * page), page, Kv, sm_off);
  const int st = start[b];
  const int rows_total = Tq * G;
  const KeyRange r = tile_keys(tile, Tq, G, st, q_len[b], window, P * page);
  const Plan plan = plan_of(r, kPrefillSplit, kPrefillMaxSplits, S);
  const int split_i = s - plan.col0;
  if (split_i < 0 || split_i >= plan.count) return;  // no range of its row tile
  const int range0 = plan.key0 + split_i * plan.len;   // keys [range0, range0 + len)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int row_base = tile * kMmaRows;
  auto q_row = [&](int fr) {  // flattened row -> its q row
    return q + ((((long)b * Tq + fr / G) * Kv + kv) * G + fr % G) * HD;
  };

  // q: mma A fragments straight from global memory (rows g8, g8+8 of the
  // warp's 16; zeros past T*G), or the tile's rows into shared memory
  uint32_t qa[Sh::kQRegs ? kKC : 1][4];
  if constexpr (Sh::kQRegs) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int fr = row_base + warp * 16 + g8 + 8 * h;
      const uint32_t* src = fr < rows_total
                                ? reinterpret_cast<const uint32_t*>(q_row(fr)) : nullptr;
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        qa[kc][h] = src ? src[kc * 8 + t4] : 0u;
        qa[kc][h + 2] = src ? src[kc * 8 + 4 + t4] : 0u;
      }
    }
  } else {
    for (int i = tid; i < kMmaRows * (HD / 8); i += kThreads) {
      const int rr = i / (HD / 8);
      const int c = (i % (HD / 8)) * 8;
      const int fr = row_base + rr;
      const bool ok = fr < rows_total;
      cp_async16(smem_u32(sq + rr * Sh::kStride + c), ok ? q_row(fr) + c : q, ok ? 16 : 0);
    }
  }
  // stage `stg` of the ring: keys key0 .. key0+63 below k_hi, from the row
  // offsets of the keys from `base`
  int base = range0, k_hi = 0;
  auto load_stage = [&](int stg, int key0) {
    if constexpr (Sh::kCodes)
      load_code_tile<HD, KT>(kp, vp, ks, vs, sm_off, base, key0, k_hi, kv,
                             kc8 + stg * Sh::kCodeTile, vc8 + stg * Sh::kCodeTile,
                             ksm + stg * kKeyTile, vsm + stg * kKeyTile);
    else
      load_kv_tile<HD>(kp, vp, sm_off, base, key0, k_hi, kv, sk + stg * Sh::kTileElems,
                       sv + stg * Sh::kTileElems);
  };
  // ldmatrix lane offsets: A (q rows), B from K (non-trans), B from V (trans)
  const int a_row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const int k_row = (lane / 16) * 8 + lane % 8, k_col = ((lane / 8) % 2) * 8;
  const int v_row = ((lane / 8) % 2) * 8 + lane % 8, v_col = (lane / 16) * 8;

  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = st + (row_base + warp * 16 + g8 + 8 * h) / G;
  float o[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  // the range in steps of kPrefillSplit keys (one step unless the row tile
  // is longer than kPrefillMaxSplits steps); the ring drains between steps
  int loaded = guess;
#pragma unroll 1
  for (; base < min(range0 + plan.len, r.hi); base += kPrefillSplit) {
    if (base != loaded) {
      if (base != range0) __syncthreads();  // every warp is done with the last stages
      load_row_offsets(table_row, base, min(base + kPrefillSplit, P * page), page, Kv,
                       sm_off);
      loaded = base;
    }
    __syncthreads();  // the row offsets
    const int k_lo = max(r.lo, base) / kKeyTile * kKeyTile;
    k_hi = min(r.hi, base + kPrefillSplit);
    const int n_tiles = (k_hi - k_lo + kKeyTile - 1) / kKeyTile;
#pragma unroll
    for (int i = 0; i < Sh::kStages - 1; ++i) {
      if (i < n_tiles) load_stage(i, k_lo + i * kKeyTile);
      cp_async_commit();  // the first step's first group carries q's copies
    }

#pragma unroll 1
    for (int it = 0; it < n_tiles; ++it) {
      const int cur = it % Sh::kStages;
      cp_async_wait<Sh::kStages - 2>();  // tile `it` has landed (this thread's part)
      __syncthreads();                   // ... everyone's; and tile it-1 is consumed
      if constexpr (Sh::kCodes)          // this thread's chunks, as bf16 of the codes
        convert_kv_tile<HD, KT>(kc8 + cur * Sh::kCodeTile, vc8 + cur * Sh::kCodeTile, sk, sv);
      {
        const int nt = it + Sh::kStages - 1;
        if (nt < n_tiles) load_stage(nt % Sh::kStages, k_lo + nt * kKeyTile);
        cp_async_commit();
      }
      if constexpr (Sh::kCodes) __syncthreads();  // the bf16 tile of tile `it`
      const bf16* ck = Sh::kCodes ? sk : sk + cur * Sh::kTileElems;
      const bf16* cv = Sh::kCodes ? sv : sv + cur * Sh::kTileElems;
      const int key0 = k_lo + it * kKeyTile;

      // S = Q K^T: (16 rows, 64 keys) a warp, eight 8-key n tiles
      float sc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        uint32_t a[4];
        if constexpr (Sh::kQRegs) {
          a[0] = qa[kc][0]; a[1] = qa[kc][1]; a[2] = qa[kc][2]; a[3] = qa[kc][3];
        } else {
          ldmatrix_x4(a, smem_u32(sq + a_row * Sh::kStride + kc * 16 + a_col));
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_u32(ck + (np * 16 + k_row) * Sh::kStride + kc * 16 + k_col));
          mma_bf16(sc[2 * np], a, bk[0], bk[1]);
          mma_bf16(sc[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // codes: column j of S = Q C^T times key j's scale, before mask and softmax
      if constexpr (Sh::kCodes) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 k2 = *reinterpret_cast<const float2*>(ksm + cur * kKeyTile + n * 8 + 2 * t4);
          sc[n][0] *= k2.x;
          sc[n][1] *= k2.y;
          sc[n][2] *= k2.x;
          sc[n][3] *= k2.y;
        }
      }

      // online softmax in the accumulator registers: rows g8 (h 0), g8+8 (h 1);
      // a row that sees every key of the tile skips the per-key mask
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool all = key0 + kKeyTile <= k_hi && key0 + kKeyTile - 1 <= qpos[h] &&
                         (window <= 0 || key0 > qpos[h] - window);
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = key0 + n * 8 + 2 * t4 + e;
            float& x = sc[n][2 * h + e];
            if (!all) x = kpos < k_hi && visible(kpos, qpos[h], window) ? x : kNegInf;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[h], mx);
        const float alpha = expf(m_r[h] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = key0 + n * 8 + 2 * t4 + e;
            float& x = sc[n][2 * h + e];
            x = all || (kpos < k_hi && visible(kpos, qpos[h], window)) ? expf(x - m_new) : 0.f;
            sum += x;
          }
        }
        l_r[h] = l_r[h] * alpha + sum;
        m_r[h] = m_new;
#pragma unroll
        for (int n = 0; n < kDN; ++n) {
          o[n][2 * h] *= alpha;
          o[n][2 * h + 1] *= alpha;
        }
      }

      // codes: p_j times key j's V scale, after p joined l (P V then multiplies
      // the V codes themselves)
      if constexpr (Sh::kCodes) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 v2 = *reinterpret_cast<const float2*>(vsm + cur * kKeyTile + n * 8 + 2 * t4);
          sc[n][0] *= v2.x;
          sc[n][1] *= v2.y;
          sc[n][2] *= v2.x;
          sc[n][3] *= v2.y;
        }
      }

      // O += P V, P as a bf16 high part, then its bf16 low part (the second
      // pass reloads V, so that no MMA waits on the one before it)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t ph[4], pl[4];
        split_bf16(sc[2 * kc][0], sc[2 * kc][1], &ph[0], &pl[0]);
        split_bf16(sc[2 * kc][2], sc[2 * kc][3], &ph[1], &pl[1]);
        split_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1], &ph[2], &pl[2]);
        split_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3], &ph[3], &pl[3]);
#pragma unroll
        for (int part = 0; part < 2; ++part) {
#pragma unroll
          for (int dp = 0; dp < HD / 16; ++dp) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, smem_u32(cv + (kc * 16 + v_row) * Sh::kStride + dp * 16 +
                                           v_col));
            mma_bf16(o[2 * dp], part ? pl : ph, bv[0], bv[1]);
            mma_bf16(o[2 * dp + 1], part ? pl : ph, bv[2], bv[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
  }

  // the split's partials of the tile's real rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lsum = l_r[h];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int fr = row_base + warp * 16 + g8 + 8 * h;
    if (fr < rows_total) {
      const long orow = (((long)b * Tq + fr / G) * Kv + kv) * G + fr % G;
      if (t4 == 0) {
        ws_ml[(orow * S + s) * 2] = m_r[h];
        ws_ml[(orow * S + s) * 2 + 1] = lsum;
      }
      float* dst = ws_acc + (orow * S + s) * HD + 2 * t4;
#pragma unroll
      for (int n = 0; n < kDN; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------ combine
// Row `row`'s splits in columns first .. first+count-1, merged in a fixed order:
// out = sum_k w_k acc_k / max(sum_k w_k l_k, 1e-30), w_k = exp(m_k - max m).
// One warp a row: lane j reads splits j, j+32, ... for m and l (a fixed
// shuffle tree sums them), and HD/32 columns of every split's acc, kLoads
// splits' columns loaded before the first of them is summed (a loop that
// leaves this to the compiler kept fewer in flight when its registers
// changed); each column sums its splits in order.
template <typename T, int HD>
__device__ __forceinline__ void combine_row(const float* __restrict__ ws_acc,
                                            const float* __restrict__ ws_ml,
                                            T* __restrict__ out, long row, int S, int first,
                                            int count) {
  constexpr int kC = HD >= 32 ? HD / 32 : 1;  // columns a lane
  const int lane = threadIdx.x % 32;
  const int col = lane * kC;
  const bool has_col = col < HD;              // lanes past hd 16 hold none
  const float* ml = ws_ml + (row * S + first) * 2;
  const float* acc = ws_acc + (row * S + first) * HD + col;
  griddep_wait();  // the split kernel's partials are written
  float mx = kNegInf;
  for (int k = lane; k < count; k += 32) mx = fmaxf(mx, ml[2 * k]);
#pragma unroll
  for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float l = 0.f;
  for (int k = lane; k < count; k += 32) l = fmaf(expf(ml[2 * k] - mx), ml[2 * k + 1], l);
#pragma unroll
  for (int o = 16; o > 0; o /= 2) l += __shfl_xor_sync(0xffffffffu, l, o);
  float a[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) a[c] = 0.f;
  constexpr int kLoads = 8;
  for (int k0 = 0; k0 < count; k0 += 32) {
    const float w_lane = k0 + lane < count ? expf(ml[2 * (k0 + lane)] - mx) : 0.f;
    const int n = min(32, count - k0);
#pragma unroll 1
    for (int k = 0; k < n; k += kLoads) {
      float v[kLoads][kC];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
#pragma unroll
        for (int c = 0; c < kC; ++c)
          v[j][c] = has_col && k + j < n ? acc[(long)(k0 + k + j) * HD + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const float w = __shfl_sync(0xffffffffu, w_lane, (k + j) % 32);
        if (k + j < n) {
#pragma unroll
          for (int c = 0; c < kC; ++c) a[c] = fmaf(w, v[j][c], a[c]);
        }
      }
    }
  }
  if (has_col) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < kC; ++c) out[row * HD + col + c] = from_f32<T>(a[c] / denom);
  }
}

constexpr int kCombineRows = kThreads / 32;

// K5's combine: rows (B, Kv, G).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                            const int* __restrict__ lengths, T* __restrict__ out, int R,
                            int Kv, int G, int page, int P, int window, int S) {
  const long row = (long)blockIdx.x * kCombineRows + threadIdx.x / 32;
  if (row >= R) return;
  const int b = row / (Kv * G);
  const Plan plan =
      plan_of(keys_of(lengths[b] - 1, window, P * page), kDecodeSplit, kDecodeMaxSplits, S);
  combine_row<T, HD>(ws_acc, ws_ml, out, row, S, plan.col0, plan.count);
}

// K6's combine: rows (B, T, Kv, G); the splits of the row's own position (f32,
// `mma` 0) or of its row tile (bf16, `mma` 1).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_prefill_combine_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                             const int* __restrict__ start, const int* __restrict__ q_len,
                             T* __restrict__ out, int R, int Tq, int Kv, int G, int page,
                             int P, int window, int S, int mma) {
  const long row = (long)blockIdx.x * kCombineRows + threadIdx.x / 32;
  if (row >= R) return;
  const int g = row % G;
  const int t = (row / ((long)G * Kv)) % Tq;
  const int b = row / ((long)G * Kv * Tq);
  const Plan plan =
      mma ? plan_of(tile_keys((t * G + g) / kMmaRows, Tq, G, start[b], q_len[b], window,
                              P * page),
                    kPrefillSplit, kPrefillMaxSplits, S)
          : plan_of(keys_of(prefill_qpos(start, q_len, b, t), window, P * page), kDecodeSplit,
                    kDecodeMaxSplits, S);
  combine_row<T, HD>(ws_acc, ws_ml, out, row, S, plan.col0, plan.count);
}

// ------------------------------------------------------------ launchers
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The combine, launched so that it may start while the split kernel ends.
template <typename... Params, typename... Args>
int launch_combine(void (*kernel)(Params...), long rows, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + kCombineRows - 1) / kCombineRows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <typename T, typename KT, int HD>
int decode_hd(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
              const void* tables, const void* lengths, void* out, float* ws, int B, int Kv,
              int G, int page, int P, int window, int S, cudaStream_t stream) {
  const long R = (long)B * Kv * G;
  float* ws_acc = ws;
  float* ws_ml = ws + R * S * HD;
  const dim3 grid(S, Kv * row_chunks(G), B);
  const T* qt = static_cast<const T*>(q);
  const KT* kt = static_cast<const KT*>(kp);
  const KT* vt = static_cast<const KT*>(vp);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const bool capped = (P * page + kDecodeSplit - 1) / kDecodeSplit > S;
  auto kernel = G <= 4 ? (capped ? paged_decode_split_kernel<T, KT, HD, 4, true>
                                 : paged_decode_split_kernel<T, KT, HD, 4, false>)
                       : (capped ? paged_decode_split_kernel<T, KT, HD, 8, true>
                                 : paged_decode_split_kernel<T, KT, HD, 8, false>);
  kernel<<<grid, kThreads, 0, stream>>>(qt, kt, vt, ks, vs, tb, ln, ws_acc, ws_ml, Kv, G, page,
                                        P, window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int err = launch_combine(paged_decode_combine_kernel<T, HD>, R, stream, ws_acc,
                                 ws_ml, ln, static_cast<T*>(out), (int)R, Kv, G, page, P,
                                 window, S);
  return err ? err : (int)cudaGetLastError();
}

template <typename T, typename KT, int HD>
int prefill_hd(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
               const void* tables, const void* start, const void* q_len, void* out, float* ws,
               int B, int Tq, int Kv, int G, int page, int P, int window, int S,
               cudaStream_t stream) {
  const long R = (long)B * Tq * Kv * G;
  float* ws_acc = ws;
  float* ws_ml = ws + R * S * HD;
  const T* qt = static_cast<const T*>(q);
  const KT* kt = static_cast<const KT*>(kp);
  const KT* vt = static_cast<const KT*>(vp);
  const int* tb = static_cast<const int*>(tables);
  const int* st = static_cast<const int*>(start);
  const int* ql = static_cast<const int*>(q_len);
  int mma = 0;
  if constexpr (sizeof(T) == 2) {  // bf16 q: tensor cores
    mma = 1;
    const int bytes = MmaShape<HD, KT>::kSmemBytes;
    const int err = allow_smem(paged_prefill_mma_kernel<HD, KT>, bytes);
    if (err) return err;
    const int tiles = (Tq * G + kMmaRows - 1) / kMmaRows;
    paged_prefill_mma_kernel<HD, KT><<<dim3(S * tiles, Kv, B), kThreads, bytes, stream>>>(
        qt, kt, vt, ks, vs, tb, st, ql, ws_acc, ws_ml, Tq, Kv, G, page, P, window, S);
  } else {  // f32 q: the CUDA cores, one block a position
    const dim3 grid(S, Kv * row_chunks(G), B * Tq);
    const bool capped = (P * page + kDecodeSplit - 1) / kDecodeSplit > S;
    auto kernel = G <= 4 ? (capped ? paged_prefill_rows_kernel<T, KT, HD, 4, true>
                                   : paged_prefill_rows_kernel<T, KT, HD, 4, false>)
                         : (capped ? paged_prefill_rows_kernel<T, KT, HD, 8, true>
                                   : paged_prefill_rows_kernel<T, KT, HD, 8, false>);
    kernel<<<grid, kThreads, 0, stream>>>(qt, kt, vt, ks, vs, tb, st, ql, ws_acc, ws_ml, Tq,
                                          Kv, G, page, P, window);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int err = launch_combine(paged_prefill_combine_kernel<T, HD>, R, stream, ws_acc,
                                 ws_ml, st, ql, static_cast<T*>(out), (int)R, Tq, Kv, G, page,
                                 P, window, S, mma);
  return err ? err : (int)cudaGetLastError();
}

// q's type T and the pool's code: 0 = the pool at T, 1 = int8, 2 = fp8-e4m3.
template <typename T, int HD>
int decode_pool(int code, const void* q, const void* kp, const void* vp, const float* ks,
                const float* vs, const void* tables, const void* lengths, void* out, float* ws,
                int B, int Kv, int G, int page, int P, int window, int S, cudaStream_t st) {
  switch (code) {
    case 0: return decode_hd<T, T, HD>(q, kp, vp, nullptr, nullptr, tables, lengths, out, ws,
                                       B, Kv, G, page, P, window, S, st);
    case 1: return decode_hd<T, int8_t, HD>(q, kp, vp, ks, vs, tables, lengths, out, ws, B,
                                            Kv, G, page, P, window, S, st);
    case 2: return decode_hd<T, fp8, HD>(q, kp, vp, ks, vs, tables, lengths, out, ws, B, Kv,
                                         G, page, P, window, S, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int HD>
int prefill_pool(int code, const void* q, const void* kp, const void* vp, const float* ks,
                 const float* vs, const void* tables, const void* start, const void* q_len,
                 void* out, float* ws, int B, int Tq, int Kv, int G, int page, int P,
                 int window, int S, cudaStream_t st) {
  switch (code) {
    case 0: return prefill_hd<T, T, HD>(q, kp, vp, nullptr, nullptr, tables, start, q_len, out,
                                        ws, B, Tq, Kv, G, page, P, window, S, st);
    case 1: return prefill_hd<T, int8_t, HD>(q, kp, vp, ks, vs, tables, start, q_len, out, ws,
                                             B, Tq, Kv, G, page, P, window, S, st);
    case 2: return prefill_hd<T, fp8, HD>(q, kp, vp, ks, vs, tables, start, q_len, out, ws, B,
                                          Tq, Kv, G, page, P, window, S, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// the head sizes built (each a template instance of every kernel)
#define PAGED_HD_CASES(X) X(16) X(32) X(64) X(96) X(128) X(256)

extern "C" {

// The kernel's constants, which the wrapper's split plan must match:
// 0 keys per K5 split, 1 keys per bf16 K6 split, 2 rows per K6 block,
// 3 split columns of a K5 / f32 K6 grid at most, 4 of a bf16 K6 grid.
int paged_attention_constant(int which) {
  switch (which) {
    case 0: return kDecodeSplit;
    case 1: return kPrefillSplit;
    case 2: return kMmaRows;
    case 3: return kDecodeMaxSplits;
    case 4: return kPrefillMaxSplits;
  }
  return -1;
}

// dtype (q's and the output's): 0 = float32, 1 = bfloat16. code (the pool's):
// 0 = q's dtype (ks, vs null), 1 = int8, 2 = fp8-e4m3, with ks, vs the f32
// scales (N, page, Kv). ws: the wrapper's f32 workspace of B*Kv*G*S*(hd+2)
// floats, S = min(ceil(P*page / 64), 32). Returns cudaGetLastError().
int paged_decode_attention(const void* q, const void* kp, const void* vp, const void* ks,
                           const void* vs, const void* tables, const void* lengths, void* out,
                           void* ws, int B, int Kv, int G, int hd, int page, int P, int window,
                           int S, int dtype, int code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const float* k_s = static_cast<const float*>(ks);
  const float* v_s = static_cast<const float*>(vs);
  switch (hd) {
#define PAGED_CASE(H)                                                                        \
  case H:                                                                                    \
    return dtype == 1 ? decode_pool<bf16, H>(code, q, kp, vp, k_s, v_s, tables, lengths, out, \
                                             w, B, Kv, G, page, P, window, S, st)            \
                      : decode_pool<float, H>(code, q, kp, vp, k_s, v_s, tables, lengths,    \
                                              out, w, B, Kv, G, page, P, window, S, st);
    PAGED_HD_CASES(PAGED_CASE)
#undef PAGED_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// ws: B*T*Kv*G*S*(hd+2) floats, S = min(ceil(P*page / 128), 16) for bf16 q
// and min(ceil(P*page / 64), 32) for f32 q; pool code and scales as for decode.
int paged_prefill_attention(const void* q, const void* kp, const void* vp, const void* ks,
                            const void* vs, const void* tables, const void* start,
                            const void* q_len, void* out, void* ws, int B, int Tq, int Kv,
                            int G, int hd, int page, int P, int window, int S, int dtype,
                            int code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const float* k_s = static_cast<const float*>(ks);
  const float* v_s = static_cast<const float*>(vs);
  switch (hd) {
#define PAGED_CASE(H)                                                                       \
  case H:                                                                                   \
    return dtype == 1 ? prefill_pool<bf16, H>(code, q, kp, vp, k_s, v_s, tables, start,     \
                                              q_len, out, w, B, Tq, Kv, G, page, P, window, \
                                              S, st)                                        \
                      : prefill_pool<float, H>(code, q, kp, vp, k_s, v_s, tables, start,    \
                                               q_len, out, w, B, Tq, Kv, G, page, P, window, \
                                               S, st);
    PAGED_HD_CASES(PAGED_CASE)
#undef PAGED_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
