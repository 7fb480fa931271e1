// Flash attention forward (K1) and backward (K2: delta, dq and dk/dv passes)
// for Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernels in src/repro/kernels/flash_attention/:
//   flash_attention_fwd     <- kernel.py::flash_attention_fwd_flat (body _fa_fwd_kernel)
//   flash_attention_bwd_*   <- kernel_bwd.py::flash_attention_bwd_flat
//                              (_fa_bwd_delta_kernel, _fa_bwd_dq_kernel,
//                               _fa_bwd_dkv_kernel)
//
// Layout (as the Pallas kernels take it): q, o, do (BH, S, hd) with q
// pre-scaled by hd^-0.5; k, v (BKv, Sk, hd); query head h reads kv head
// h / G; lse and delta (BH, S) f32. Query row i sits at position i and key
// row j at position j. A key is visible to a query when j < Sk, and j <= i
// if causal, and i - j < window if window > 0: make_mask of kernel.py.
//
// Masking is JAX's exactly: masked scores are set to -1e30, p is chosen by
// a select (never by exp underflow), and the softmax denominator is clamped
// at 1e-30, so a fully masked row gives zeros and a finite lse. The TPU's
// sequential k-block grid axis becomes a loop inside a block over one
// (head, q block); a block visits only the k blocks that can hold a visible
// key (none wholly above its causal diagonal or wholly below the window of
// its lowest row). The skip is exact: such blocks would add zeros and leave
// m unchanged. The ragged edges of S and Sk are masked here (tiles past the
// end are zero-filled); nothing is padded or copied in device memory.
//
// Backward (FlashAttention's scheme, as the Pallas kernels run it):
//   delta = rowsum(dO * O);  p = select(mask, exp(q k^T - lse), 0)
//   ds = p * (dO v^T - delta);  dq += ds k;  dv += p^T dO;  dk += ds^T q
// The dq pass is one block per (head, q block) looping over k blocks. The
// dk/dv pass keeps the walk of kernel_bwd.py: one block per (kv head,
// k block), looping over the G query heads of the group times the q blocks
// and summing into registers, so dk and dv need no atomics and are the same
// bits from run to run. Sums are in f32; dq is cast to q's type, dk and dv to
// k's.
//
// What bounds them on the H100: operations. At gemma3-1b's training shape
// (batch 4 x 4 query heads over 1 kv head, S 2048, hd 256) a causal layer's
// forward does ~34 GFLOP on ~34 MB, far above the ~295 flop/byte ridge of
// bf16: its bound is the tensor cores' 989 TFLOP/s.
//
// bf16, the training path (fa_fwd_mma_kernel, fa_bwd_dq_mma_kernel,
// fa_bwd_dkv_mma_kernel): every tile product runs on the tensor cores as
// mma.sync.m16n8k16 bf16 -> f32, its operands read from bf16 tiles in shared
// memory by ldmatrix (rows padded by 16 bytes, so that ldmatrix is free of
// bank conflicts). A block is four warps of 16 rows. The tiles that stream
// past a block's fixed tile come through a two-stage cp.async ring: the next
// tile's 16-byte copies fly while the current one is multiplied; rows past
// the end are zero-filled by the copy.
//   K1: a block holds 64 query rows of one head (q as mma A fragments in
//   registers at hd <= 128, in shared memory at hd 256) and streams the live
//   K/V tiles of 64 keys. S = Q K^T lands in the accumulator
//   registers and the online softmax (FlashAttention-2) runs there: the row
//   max and sum over the four lanes that share a row by shuffles, no round
//   trip of S or P through shared memory, and a row that sees a whole tile
//   skips the per-key mask. p is split into a bf16 high and a bf16 low part
//   (two MMAs on each V fragment, the high ones of two fragments before
//   their low ones, so that no MMA waits on the one before it), so that P V
//   keeps p to ~2^-16 relative, as the plain version's and the Pallas
//   kernel's f32 p do: one bf16 rounding of p (2^-9) moves an output near 1
//   by ~1e-3, a bf16 ulp across the 4e-3 gate. q blocks run longest first.
//   K2 dq: a block holds 64 query rows of one head (q and dO in shared
//   memory, lse and delta in registers) and streams K/V tiles (64 keys; 32
//   at hd 256). S = Q K^T and dP = dO V^T on the tensor cores; p and
//   ds = p (dP - delta) in their accumulators become the A fragments of
//   dq += ds K.
//   K2 dk/dv: a block holds 64 keys of one kv head (K and V in shared
//   memory, 16 keys a warp) and walks the G query heads times the live q
//   tiles of 32 rows, streamed with their lse and delta. It computes
//   S^T = K Q^T and dP^T = V dO^T, so that p^T and ds^T are already the A
//   fragments of dv += p^T dO and dk += ds^T Q: no transpose, no round trip
//   through shared memory, no atomics.
//   At hd 256 whole output rows would need 128 accumulator registers a
//   thread in K1 and 256 in dk/dv: there a block of K1 or dk/dv has two
//   column groups of four warps, each keeping 128 of the output columns and
//   computing its own S (S^T and dP^T) from the tiles both share.
//   The backward splits p and ds the same way for dv += p^T dO, dq += ds K
//   and dk += ds^T Q: one bf16 rounding of them used most of the 1% of
//   max|ref| that the bf16 gradient gate allows; split, what is left is
//   mostly the delta's (it reads the kernel's own bf16 O where the plain
//   version recomputes O). chip_smoke.py reports the error on the card.
//   The tile sizes per hd (MmaTiles) keep every accumulator in registers:
//   chip_smoke.py's build phase prints ptxas's registers and spills.
//
// f32 (the parity phases, and tests at 2e-5 / 1e-4): TF32 tensor-core
// products (~1e-3 relative) would fail those gates, so f32 keeps the
// CUDA-core kernels (fa_fwd_kernel, fa_bwd_dq_kernel, fa_bwd_dkv_kernel):
// f32 tiles in shared memory (K and V tiles read across the lanes of a warp
// by row keep a row stride of hd + 1, free of bank conflicts), each thread a
// register tile of the block's output. At hd 256 a block asks for up to
// ~207 KB of the 227 KB one H100 block may use; the launcher sets
// cudaFuncAttributeMaxDynamicSharedMemorySize. The choice is by dtype alone.
//
// hd: 16, 32, 64, 96, 128 and 256 are built.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Tile sizes per head dim: rows of the q tile and of the k tile of each pass.
template <int HD> struct Tiles {
  static constexpr int kFwdQ = 64;
  static constexpr int kFwdK = HD >= 256 ? 32 : 64;
  static constexpr int kDqQ = 64;
  static constexpr int kDqK = HD >= 256 ? 32 : 64;
  static constexpr int kDkvQ = HD >= 256 ? 32 : 64;
  static constexpr int kDkvK = HD >= 256 ? 32 : 64;
};

// How the 256 threads of a block share an (M, N) register tile: LC lanes
// across the columns, RG = 32 / LC row groups in a warp, each thread holding
// RT rows by CL columns. Lanes of one row group hold the same rows, so a
// per-row value reduces over the LC lanes of the group with shuffles.
template <int M, int N> struct Frag {
  static constexpr int LC = N < 32 ? N : 32;
  static constexpr int RG = 32 / LC;
  static constexpr int RT = M / (kWarps * RG);
  static constexpr int CL = N / LC;
  static_assert(RT * kWarps * RG == M, "tile rows must fill the block");
  static_assert(CL * LC == N, "tile columns must fill the lanes");
  __device__ static __forceinline__ int row(int i) {
    return i * (kWarps * RG) + (threadIdx.x / 32) * RG + (threadIdx.x % 32) / LC;
  }
  __device__ static __forceinline__ int col(int j) {
    return j * LC + (threadIdx.x % 32) % LC;
  }
};

template <int LC> __device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = LC / 2; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int LC> __device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LC / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The three tile products, each C[i][j] += sum over k of X * Y with the
// thread's rows r_i and columns c_j. X is read at a row shared by the lanes
// of a row group (a broadcast); Y at a column that varies across lanes.
//   nt: X[r][k] * Y[c][k]   (Y's row stride must be odd: hd + 1)
//   nn: X[r][k] * Y[k][c]
//   tn: X[k][r] * Y[k][c]
template <class F, int K>
__device__ __forceinline__ void mm_nt(float (&c)[F::RT][F::CL], const float* X, int ldx,
                                      const float* Y, int ldy) {
  int xo[F::RT], yo[F::CL];
#pragma unroll
  for (int i = 0; i < F::RT; ++i) xo[i] = F::row(i) * ldx;
#pragma unroll
  for (int j = 0; j < F::CL; ++j) yo[j] = F::col(j) * ldy;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float xv[F::RT], yv[F::CL];
#pragma unroll
    for (int i = 0; i < F::RT; ++i) xv[i] = X[xo[i] + k];
#pragma unroll
    for (int j = 0; j < F::CL; ++j) yv[j] = Y[yo[j] + k];
#pragma unroll
    for (int i = 0; i < F::RT; ++i)
#pragma unroll
      for (int j = 0; j < F::CL; ++j) c[i][j] = fmaf(xv[i], yv[j], c[i][j]);
  }
}

template <class F, int K>
__device__ __forceinline__ void mm_nn(float (&c)[F::RT][F::CL], const float* X, int ldx,
                                      const float* Y, int ldy) {
  int xo[F::RT], yo[F::CL];
#pragma unroll
  for (int i = 0; i < F::RT; ++i) xo[i] = F::row(i) * ldx;
#pragma unroll
  for (int j = 0; j < F::CL; ++j) yo[j] = F::col(j);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float xv[F::RT], yv[F::CL];
#pragma unroll
    for (int i = 0; i < F::RT; ++i) xv[i] = X[xo[i] + k];
#pragma unroll
    for (int j = 0; j < F::CL; ++j) yv[j] = Y[k * ldy + yo[j]];
#pragma unroll
    for (int i = 0; i < F::RT; ++i)
#pragma unroll
      for (int j = 0; j < F::CL; ++j) c[i][j] = fmaf(xv[i], yv[j], c[i][j]);
  }
}

template <class F, int K>
__device__ __forceinline__ void mm_tn(float (&c)[F::RT][F::CL], const float* X, int ldx,
                                      const float* Y, int ldy) {
  int xo[F::RT], yo[F::CL];
#pragma unroll
  for (int i = 0; i < F::RT; ++i) xo[i] = F::row(i);
#pragma unroll
  for (int j = 0; j < F::CL; ++j) yo[j] = F::col(j);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float xv[F::RT], yv[F::CL];
#pragma unroll
    for (int i = 0; i < F::RT; ++i) xv[i] = X[k * ldx + xo[i]];
#pragma unroll
    for (int j = 0; j < F::CL; ++j) yv[j] = Y[k * ldy + yo[j]];
#pragma unroll
    for (int i = 0; i < F::RT; ++i)
#pragma unroll
      for (int j = 0; j < F::CL; ++j) c[i][j] = fmaf(xv[i], yv[j], c[i][j]);
  }
}

template <class F> __device__ __forceinline__ void zero(float (&c)[F::RT][F::CL]) {
#pragma unroll
  for (int i = 0; i < F::RT; ++i)
#pragma unroll
    for (int j = 0; j < F::CL; ++j) c[i][j] = 0.f;
}

// Rows r0 .. r0+n-1 of a (rows, HD) matrix into shared memory as f32 with row
// stride ld; rows at or past `rows` are zero-filled. Neighbouring threads read
// neighbouring elements.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* __restrict__ src,
                                          int r0, int n, int rows) {
  for (int i = threadIdx.x; i < n * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int gr = r0 + r;
    dst[r * ld + d] = gr < rows ? to_f32(src[(long)gr * HD + d]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk, int causal,
                                        int window) {
  bool ok = kpos < Sk;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && (qpos - kpos < window);
  return ok;
}

// Whether keys k0..k1 can be visible to some query in q0..q1 (inclusive).
__device__ __forceinline__ bool live(int q0, int q1, int k0, int k1, int causal,
                                     int window) {
  if (causal && k0 > q1) return false;
  if (window > 0 && q0 - k1 >= window) return false;
  return true;
}

// ------------------------------------------------------------------ forward
template <int HD> constexpr size_t fwd_smem_floats() {
  using Tl = Tiles<HD>;
  return (size_t)Tl::kFwdQ * HD + (size_t)Tl::kFwdK * (HD + 1) +
         (size_t)Tl::kFwdK * HD + (size_t)Tl::kFwdQ * Tl::kFwdK + 2 * Tl::kFwdQ;
}

// K1: grid (q blocks, BH).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ lse, int S, int Sk, int G,
              int causal, int window) {
  constexpr int BQ = Tiles<HD>::kFwdQ;
  constexpr int BK = Tiles<HD>::kFwdK;
  using SF = Frag<BQ, BK>;
  using OF = Frag<BQ, HD>;
  extern __shared__ float smem[];
  float* qs = smem;                      // (BQ, HD)
  float* ks = qs + BQ * HD;              // (BK, HD + 1)
  float* vs = ks + BK * (HD + 1);        // (BK, HD)
  float* ps = vs + BK * HD;              // (BQ, BK)
  float* row_alpha = ps + BQ * BK;       // (BQ,)
  float* row_l = row_alpha + BQ;         // (BQ,)

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int q1 = min(q0 + BQ, S) - 1;
  const T* qh = q + (long)h * S * HD;
  const T* kh = k + (long)(h / G) * Sk * HD;
  const T* vh = v + (long)(h / G) * Sk * HD;

  load_rows<T, HD>(qs, HD, qh, q0, BQ, S);
  float acc[OF::RT][OF::CL];
  zero<OF>(acc);
  float m[SF::RT], l[SF::RT];
#pragma unroll
  for (int i = 0; i < SF::RT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    if (!live(q0, q1, k0, min(k0 + BK, Sk) - 1, causal, window)) continue;
    __syncthreads();  // the previous tiles are no longer read
    load_rows<T, HD>(ks, HD + 1, kh, k0, BK, Sk);
    load_rows<T, HD>(vs, HD, vh, k0, BK, Sk);
    __syncthreads();

    float s[SF::RT][SF::CL];
    zero<SF>(s);
    mm_nt<SF, HD>(s, qs, HD, ks, HD + 1);
#pragma unroll
    for (int i = 0; i < SF::RT; ++i) {
      const int r = SF::row(i);
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < SF::CL; ++j) {
        if (!visible(q0 + r, k0 + SF::col(j), Sk, causal, window)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max<SF::LC>(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SF::CL; ++j) {
        const int c = SF::col(j);
        const float p = visible(q0 + r, k0 + c, Sk, causal, window)
                            ? expf(s[i][j] - m_new) : 0.f;
        ps[r * BK + c] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + group_sum<SF::LC>(sum);
      m[i] = m_new;
      if (SF::col(0) == 0) row_alpha[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < OF::RT; ++i) {
      const float a = row_alpha[OF::row(i)];
#pragma unroll
      for (int j = 0; j < OF::CL; ++j) acc[i][j] *= a;
    }
    mm_nn<OF, BK>(acc, ps, BK, vs, HD);
  }

#pragma unroll
  for (int i = 0; i < SF::RT; ++i) {
    const int r = SF::row(i);
    if (SF::col(0) == 0) {
      const float denom = fmaxf(l[i], 1e-30f);
      row_l[r] = denom;
      if (q0 + r < S) lse[(long)h * S + q0 + r] = m[i] + logf(denom);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < OF::RT; ++i) {
    const int r = OF::row(i);
    if (q0 + r >= S) continue;
    const float denom = row_l[r];
#pragma unroll
    for (int j = 0; j < OF::CL; ++j)
      o[((long)h * S + q0 + r) * HD + OF::col(j)] = from_f32<T>(acc[i][j] / denom);
  }
}

// ------------------------------------------------------- backward: delta pass
// delta[row] = sum over hd of dO * O in f32, over the BH * S rows: a
// streaming reduction, bound by its bytes (each byte of o and dO read once).
// A row is kRowVecs 16-byte vectors (8 bf16 or 4 f32); a group of kL lanes
// (a power of two, at most 32) holds one row, a lane its vectors gl, gl + kL,
// .... A warp takes kRows consecutive rows, kBatch a group, and issues every
// load of o and dO for all of them before the first product: each lane has
// 2 * kV * kBatch 16-byte loads in flight and no loop that waits on a load.
// A row's products are summed in its lanes in element order, then across the
// group by an xor-shuffle tree; the warp's kRows sums are gathered into lanes
// 0 .. kRows-1 by shuffles and written as one coalesced f32 store.
constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

template <typename T, int HD>
struct DeltaShape {
  static constexpr int kElems = 16 / (int)sizeof(T);            // elements a vector
  static constexpr int kRowVecs = HD / kElems;                  // vectors a row
  static constexpr int kL = pow2_at_least(kRowVecs) < 32 ? pow2_at_least(kRowVecs) : 32;
  static constexpr int kV = (kRowVecs + kL - 1) / kL;           // vectors a lane
  static constexpr int kGroups = 32 / kL;                       // rows a warp at once
  static constexpr int kBatch = 4 / kV < kL ? 4 / kV : kL;      // rows a group
  static constexpr int kRows = kGroups * kBatch;                // rows a warp, <= 32
  static_assert(HD % kElems == 0, "a row is a whole number of 16-byte vectors");
  static_assert(kV >= 1 && kV <= 4 && kRows <= 32, "delta's lane plan");
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, long rows) {
  using Sh = DeltaShape<T, HD>;
  const int lane = threadIdx.x % 32, grp = lane / Sh::kL, gl = lane % Sh::kL;
  const long row0 = ((long)blockIdx.x * kWarps + threadIdx.x / 32) * Sh::kRows;
  uint4 ov[Sh::kBatch][Sh::kV], dv[Sh::kBatch][Sh::kV];
#pragma unroll
  for (int r = 0; r < Sh::kBatch; ++r) {
    const long row = row0 + r * Sh::kGroups + grp;
#pragma unroll
    for (int v = 0; v < Sh::kV; ++v) {
      const int vec = gl + v * Sh::kL;
      const bool ok = row < rows && vec < Sh::kRowVecs;
      ov[r][v] = ok ? __ldcs(reinterpret_cast<const uint4*>(o + row * HD) + vec)
                    : make_uint4(0, 0, 0, 0);
      dv[r][v] = ok ? __ldcs(reinterpret_cast<const uint4*>(dout + row * HD) + vec)
                    : make_uint4(0, 0, 0, 0);
    }
  }
  float s[Sh::kBatch];
#pragma unroll
  for (int r = 0; r < Sh::kBatch; ++r) {
    s[r] = 0.f;
#pragma unroll
    for (int v = 0; v < Sh::kV; ++v) {
      const T* a = reinterpret_cast<const T*>(&ov[r][v]);
      const T* b = reinterpret_cast<const T*>(&dv[r][v]);
#pragma unroll
      for (int e = 0; e < Sh::kElems; ++e) s[r] = fmaf(to_f32(a[e]), to_f32(b[e]), s[r]);
    }
#pragma unroll
    for (int off = Sh::kL / 2; off > 0; off /= 2)
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
  }
  // lane j < kRows takes row row0 + j: batch j / kGroups of group j % kGroups
  float out = 0.f;
#pragma unroll
  for (int r = 0; r < Sh::kBatch; ++r) {
    const float x = __shfl_sync(0xffffffffu, s[r], (lane % Sh::kGroups) * Sh::kL);
    if (lane / Sh::kGroups == r) out = x;
  }
  if (lane < Sh::kRows && row0 + lane < rows) delta[row0 + lane] = out;
}

template <typename T, int HD>
int delta_hd(const void* o, const void* dout, void* delta, long rows, cudaStream_t s) {
  constexpr int kBlockRows = kWarps * DeltaShape<T, HD>::kRows;
  const long blocks = (rows + kBlockRows - 1) / kBlockRows;
  fa_bwd_delta_kernel<T, HD><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta),
      rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- backward: dq pass
template <int HD> constexpr size_t dq_smem_floats() {
  using Tl = Tiles<HD>;
  return 2 * (size_t)Tl::kDqQ * HD + 2 * (size_t)Tl::kDqK * (HD + 1) +
         (size_t)Tl::kDqQ * Tl::kDqK + 2 * Tl::kDqQ;
}

// grid (q blocks, BH).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dq, int S, int Sk, int G, int causal, int window) {
  constexpr int BQ = Tiles<HD>::kDqQ;
  constexpr int BK = Tiles<HD>::kDqK;
  using SF = Frag<BQ, BK>;
  using QF = Frag<BQ, HD>;
  extern __shared__ float smem[];
  float* qs = smem;                      // (BQ, HD)
  float* dos = qs + BQ * HD;             // (BQ, HD)
  float* ks = dos + BQ * HD;             // (BK, HD + 1)
  float* vs = ks + BK * (HD + 1);        // (BK, HD + 1)
  float* dss = vs + BK * (HD + 1);       // (BQ, BK)
  float* lse_s = dss + BQ * BK;          // (BQ,)
  float* delta_s = lse_s + BQ;           // (BQ,)

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int q1 = min(q0 + BQ, S) - 1;
  const long qoff = (long)h * S;
  const T* kh = k + (long)(h / G) * Sk * HD;
  const T* vh = v + (long)(h / G) * Sk * HD;

  load_rows<T, HD>(qs, HD, q + qoff * HD, q0, BQ, S);
  load_rows<T, HD>(dos, HD, dout + qoff * HD, q0, BQ, S);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    lse_s[r] = q0 + r < S ? lse[qoff + q0 + r] : 0.f;
    delta_s[r] = q0 + r < S ? delta[qoff + q0 + r] : 0.f;
  }
  float acc[QF::RT][QF::CL];
  zero<QF>(acc);

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    if (!live(q0, q1, k0, min(k0 + BK, Sk) - 1, causal, window)) continue;
    __syncthreads();
    load_rows<T, HD>(ks, HD + 1, kh, k0, BK, Sk);
    load_rows<T, HD>(vs, HD + 1, vh, k0, BK, Sk);
    __syncthreads();

    float s[SF::RT][SF::CL], dp[SF::RT][SF::CL];
    zero<SF>(s);
    zero<SF>(dp);
    mm_nt<SF, HD>(s, qs, HD, ks, HD + 1);
    mm_nt<SF, HD>(dp, dos, HD, vs, HD + 1);
#pragma unroll
    for (int i = 0; i < SF::RT; ++i) {
      const int r = SF::row(i);
#pragma unroll
      for (int j = 0; j < SF::CL; ++j) {
        const int c = SF::col(j);
        const bool ok = q0 + r < S && visible(q0 + r, k0 + c, Sk, causal, window);
        const float p = ok ? expf(s[i][j] - lse_s[r]) : 0.f;
        dss[r * BK + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    mm_nn<QF, BK>(acc, dss, BK, ks, HD + 1);
  }

#pragma unroll
  for (int i = 0; i < QF::RT; ++i) {
    const int r = QF::row(i);
    if (q0 + r >= S) continue;
#pragma unroll
    for (int j = 0; j < QF::CL; ++j)
      dq[(qoff + q0 + r) * HD + QF::col(j)] = from_f32<T>(acc[i][j]);
  }
}

// -------------------------------------------------------- backward: dkv pass
template <int HD> constexpr size_t dkv_smem_floats() {
  using Tl = Tiles<HD>;
  return 2 * (size_t)Tl::kDkvK * (HD + 1) + 2 * (size_t)Tl::kDkvQ * HD +
         2 * (size_t)Tl::kDkvQ * Tl::kDkvK + 2 * Tl::kDkvQ;
}

// grid (k blocks, BKv); each block walks the G query heads of its kv head
// times the live q blocks.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, int S, int Sk, int G,
                  int causal, int window) {
  constexpr int BQ = Tiles<HD>::kDkvQ;
  constexpr int BK = Tiles<HD>::kDkvK;
  using SF = Frag<BQ, BK>;
  using KF = Frag<BK, HD>;
  extern __shared__ float smem[];
  float* ks = smem;                      // (BK, HD + 1)
  float* vs = ks + BK * (HD + 1);        // (BK, HD + 1)
  float* qs = vs + BK * (HD + 1);        // (BQ, HD)
  float* dos = qs + BQ * HD;             // (BQ, HD)
  float* ps = dos + BQ * HD;             // (BQ, BK)
  float* dss = ps + BQ * BK;             // (BQ, BK)
  float* lse_s = dss + BQ * BK;          // (BQ,)
  float* delta_s = lse_s + BQ;           // (BQ,)

  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int k1 = min(k0 + BK, Sk) - 1;
  const long koff = (long)kvh * Sk;
  load_rows<T, HD>(ks, HD + 1, k + koff * HD, k0, BK, Sk);
  load_rows<T, HD>(vs, HD + 1, v + koff * HD, k0, BK, Sk);
  float dk_acc[KF::RT][KF::CL], dv_acc[KF::RT][KF::CL];
  zero<KF>(dk_acc);
  zero<KF>(dv_acc);

  // the q blocks that can see keys k0..k1
  const int qb0 = causal ? k0 / BQ * BQ : 0;
  const int q_end = window > 0 ? min(S, k1 + window) : S;

  for (int g = 0; g < G; ++g) {
    const long qoff = ((long)kvh * G + g) * S;
    for (int q0 = qb0; q0 < q_end; q0 += BQ) {
      const int q1 = min(q0 + BQ, S) - 1;
      if (!live(q0, q1, k0, k1, causal, window)) continue;
      __syncthreads();  // the previous q tiles are no longer read
      load_rows<T, HD>(qs, HD, q + qoff * HD, q0, BQ, S);
      load_rows<T, HD>(dos, HD, dout + qoff * HD, q0, BQ, S);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        lse_s[r] = q0 + r < S ? lse[qoff + q0 + r] : 0.f;
        delta_s[r] = q0 + r < S ? delta[qoff + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[SF::RT][SF::CL], dp[SF::RT][SF::CL];
      zero<SF>(s);
      zero<SF>(dp);
      mm_nt<SF, HD>(s, qs, HD, ks, HD + 1);
      mm_nt<SF, HD>(dp, dos, HD, vs, HD + 1);
#pragma unroll
      for (int i = 0; i < SF::RT; ++i) {
        const int r = SF::row(i);
#pragma unroll
        for (int j = 0; j < SF::CL; ++j) {
          const int c = SF::col(j);
          const bool ok = q0 + r < S && visible(q0 + r, k0 + c, Sk, causal, window);
          const float p = ok ? expf(s[i][j] - lse_s[r]) : 0.f;
          ps[r * BK + c] = p;
          dss[r * BK + c] = p * (dp[i][j] - delta_s[r]);
        }
      }
      __syncthreads();
      mm_tn<KF, BQ>(dv_acc, ps, BK, dos, HD);
      mm_tn<KF, BQ>(dk_acc, dss, BK, qs, HD);
    }
  }

#pragma unroll
  for (int i = 0; i < KF::RT; ++i) {
    const int r = KF::row(i);
    if (k0 + r >= Sk) continue;
#pragma unroll
    for (int j = 0; j < KF::CL; ++j) {
      const long at = (koff + k0 + r) * HD + KF::col(j);
      dk[at] = from_f32<T>(dk_acc[i][j]);
      dv[at] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ----------------------------------------------- bf16: tensor-core kernels
using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // four warps: a row group
constexpr int kMmaRows = 64;      // rows of a block's fixed tile: 16 a warp

// Tile sizes of the tensor-core kernels per head dim. Past hd 128, K1 and
// dk/dv keep their output columns in two column groups of four warps (each
// group 128 columns, recomputing the group's S or S^T), so that no thread
// holds more than 64 accumulators of an output tile (128 for dk and dv).
template <int HD> struct MmaTiles {
  static constexpr int kStride = HD + 8;             // bf16 a shared row (+16 B)
  static constexpr int kStages = 2;                  // the cp.async ring
  static constexpr int kGroups = HD > 128 ? 2 : 1;   // column groups of K1, dk/dv
  static constexpr int kCols = HD / kGroups;         // output columns a group
  static constexpr int kFwdK = 64;                   // keys a K1 stage
  static constexpr bool kFwdQRegs = HD <= 128;       // K1's q in registers, else shared
  static constexpr int kDqK = HD > 128 ? 32 : 64;    // keys a dq stage
  static constexpr int kDkvQ = 32;                   // queries a dk/dv stage
  static_assert(HD % 16 == 0 && kCols % 16 == 0, "head dim not a multiple of 16");
};

// The A fragments of columns 16 kc .. 16 kc + 15 from the accumulators of
// two 8-column n tiles (2 kc, 2 kc + 1), an mma C tile being an A tile: a
// bf16 high part and the bf16 low part of what it leaves.
__device__ __forceinline__ void c_to_a(const float (&c0)[4], const float (&c1)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], &hi[0], &lo[0]);
  split_bf16(c0[2], c0[3], &hi[1], &lo[1]);
  split_bf16(c1[0], c1[1], &hi[2], &lo[2]);
  split_bf16(c1[2], c1[3], &hi[3], &lo[3]);
}

// Rows r0 .. r0+N-1 of a (rows, HD) bf16 matrix into shared memory with row
// stride HD + 8, as 16-byte cp.async copies; rows at or past `rows` are
// zero-filled.
template <int HD, int N>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int r0,
                                          int rows) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < N * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(smem_u32(dst + r * (HD + 8) + c), ok ? src + ((long)r0 + r) * HD + c : src,
               ok ? 16 : 0);
  }
}

// Entries r0 .. r0+N-1 of a length-`rows` f32 vector into shared memory;
// entries past the end are zero-filled.
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int r0,
                                         int rows) {
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const bool ok = r0 + i < rows;
    cp_async4(smem_u32(dst + i), ok ? src + r0 + i : src, ok ? 4 : 0);
  }
}

// ldmatrix lane offsets within a 16 x 16 tile: A (row-major rows), B from a
// row-major (n, k) tile (K for S = Q K^T), B from a row-major (k, n) tile
// with .trans (V for P V).
struct Lanes {
  int a_row, a_col, b_row, b_col, t_row, t_col, g8, t4;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row(lane % 8 + ((lane / 8) % 2) * 8), a_col((lane / 16) * 8),
        b_row((lane / 16) * 8 + lane % 8), b_col(((lane / 8) % 2) * 8),
        t_row(((lane / 8) % 2) * 8 + lane % 8), t_col((lane / 16) * 8),
        g8(lane / 4), t4(lane % 4) {}
};

// acc (16 x 8*NT) += A (16 x 16*KC, A fragments from shared rows `a`, row
// stride lda) times B^T, B (8*NT x 16*KC) read from shared rows `b` (row
// stride ldb) by non-transposed ldmatrix: the S = Q K^T form.
template <int KC, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a, int lda,
                                        const bf16* b, int ldb, const Lanes& L) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t af[4];
    ldmatrix_x4(af, smem_u32(a + L.a_row * lda + kc * 16 + L.a_col));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, smem_u32(b + (np * 16 + L.b_row) * ldb + kc * 16 + L.b_col));
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x 8*NT) += A (16 x 16) times B, B (16 x 8*NT) read from shared rows
// `b` (row stride ldb, the 16 summed rows as rows) by transposed ldmatrix:
// the P V form, with A as a bf16 high and a bf16 low part. Two 16-column
// pairs of B at a time, their high products before their low ones, so that
// no MMA waits on the one just before it.
template <int NT>
__device__ __forceinline__ void mma_ab2(float (&acc)[NT][4], const uint32_t (&hi)[4],
                                        const uint32_t (&lo)[4], const bf16* b, int ldb,
                                        const Lanes& L) {
  constexpr int kStep = NT >= 4 ? 2 : 1;
  static_assert((NT / 2) % kStep == 0, "16-column pairs");
#pragma unroll
  for (int dp = 0; dp < NT / 2; dp += kStep) {
    uint32_t bf[kStep][4];
#pragma unroll
    for (int j = 0; j < kStep; ++j)
      ldmatrix_x4_trans(bf[j], smem_u32(b + L.t_row * ldb + (dp + j) * 16 + L.t_col));
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      mma_bf16(acc[2 * (dp + j)], hi, bf[j][0], bf[j][1]);
      mma_bf16(acc[2 * (dp + j) + 1], hi, bf[j][2], bf[j][3]);
    }
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      mma_bf16(acc[2 * (dp + j)], lo, bf[j][0], bf[j][1]);
      mma_bf16(acc[2 * (dp + j) + 1], lo, bf[j][2], bf[j][3]);
    }
  }
}

template <int NT> __device__ __forceinline__ void zero_frags(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// Keys [lo, hi) that query rows q0 .. q1 can see, lo rounded down to `tile`.
__device__ __forceinline__ void key_range(int q0, int q1, int Sk, int causal, int window,
                                          int tile, int* lo, int* hi) {
  *hi = causal ? min(Sk, q1 + 1) : Sk;
  *lo = window > 0 ? max(0, q0 - window + 1) / tile * tile : 0;
}

// Writes rows g8 and g8 + 8 of a warp's (16, 8*NT) f32 accumulator tile as
// bf16 to row-major rows at `dst` (row stride ld) for the rows below `rows`.
template <int NT>
__device__ __forceinline__ void store_frags(bf16* dst, long ld, const float (&c)[NT][4],
                                            int row0, int rows, const Lanes& L) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + L.g8 + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(dst + r * ld + n * 8 + 2 * L.t4) =
          pack_bf16(c[n][2 * h], c[n][2 * h + 1]);
  }
}

template <int HD> constexpr size_t fwd_mma_smem_bytes() {
  using Tl = MmaTiles<HD>;
  return 2 * ((size_t)2 * Tl::kStages * Tl::kFwdK * Tl::kStride +
              (Tl::kFwdQRegs ? 0 : (size_t)kMmaRows * Tl::kStride));
}

// K1, bf16: grid (q blocks, BH), kGroups x 128 threads.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads * MmaTiles<HD>::kGroups)
fa_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                  int S, int Sk, int G, int causal, int window) {
  using Tl = MmaTiles<HD>;
  constexpr int BK = Tl::kFwdK, LD = Tl::kStride;
  constexpr int kKC = HD / 16, kDN = Tl::kCols / 8, kSN = BK / 8;
  constexpr int kTile = BK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);   // kStages x (BK, LD)
  bf16* sv = sk + Tl::kStages * kTile;
  bf16* sq = sv + Tl::kStages * kTile;            // (64, LD) when q is not in registers

  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;   // longest rows first
  const int q1 = min(q0 + kMmaRows, S) - 1;
  const bf16* qh = q + (long)h * S * HD;
  const bf16* kh = k + (long)(h / G) * Sk * HD;
  const bf16* vh = v + (long)(h / G) * Sk * HD;
  int k_lo, k_hi;
  key_range(q0, q1, Sk, causal, window, BK, &k_lo, &k_hi);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  const int warp = threadIdx.x / 32 % 4;                  // row group: rows 16 warp ..
  const int c0 = threadIdx.x / kMmaThreads * Tl::kCols;   // column group's columns
  const Lanes L(threadIdx.x % 32);
  // q: mma A fragments straight from global memory (rows g8, g8 + 8 of the
  // warp's 16; zeros past S), or the tile into shared memory
  uint32_t qa[Tl::kFwdQRegs ? kKC : 1][4];
  if constexpr (Tl::kFwdQRegs) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = q0 + warp * 16 + L.g8 + 8 * hh;
      const uint32_t* src = r < S ? reinterpret_cast<const uint32_t*>(qh + (long)r * HD)
                                  : nullptr;
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        qa[kc][hh] = src ? src[kc * 8 + L.t4] : 0u;
        qa[kc][hh + 2] = src ? src[kc * 8 + 4 + L.t4] : 0u;
      }
    }
  } else {
    load_tile<HD, kMmaRows>(sq, qh, q0, S);
  }
  if (n_tiles > 0) {
    load_tile<HD, BK>(sk, kh, k_lo, Sk);
    load_tile<HD, BK>(sv, vh, k_lo, Sk);
  }
  cp_async_commit();  // with q's copies

  int qpos[2];
  qpos[0] = q0 + warp * 16 + L.g8;
  qpos[1] = qpos[0] + 8;
  float acc[kDN][4];
  zero_frags(acc);
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();  // tile `it` has landed (this thread's part)
    __syncthreads();     // ... everyone's; and tile it-1 is consumed
    if (it + 1 < n_tiles) {
      const int stg = (it + 1) % Tl::kStages;
      load_tile<HD, BK>(sk + stg * kTile, kh, k_lo + (it + 1) * BK, Sk);
      load_tile<HD, BK>(sv + stg * kTile, vh, k_lo + (it + 1) * BK, Sk);
    }
    cp_async_commit();
    const bf16* ck = sk + (it % Tl::kStages) * kTile;
    const bf16* cv = sv + (it % Tl::kStages) * kTile;
    const int key0 = k_lo + it * BK;

    // S = Q K^T: (16 rows, BK keys) a warp
    float sc[kSN][4];
    zero_frags(sc);
    if constexpr (Tl::kFwdQRegs) {
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
#pragma unroll
        for (int np = 0; np < kSN / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_u32(ck + (np * 16 + L.b_row) * LD + kc * 16 + L.b_col));
          mma_bf16(sc[2 * np], qa[kc], bk[0], bk[1]);
          mma_bf16(sc[2 * np + 1], qa[kc], bk[2], bk[3]);
        }
      }
    } else {
      mma_abt<kKC, kSN>(sc, sq + warp * 16 * LD, LD, ck, LD, L);
    }

    // online softmax in the accumulator registers: rows g8 (hh 0), g8+8 (hh 1)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qp = qpos[hh];
      const bool all = key0 + BK <= Sk && (!causal || key0 + BK - 1 <= qp) &&
                       (window <= 0 || qp - key0 < window);
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[n][2 * hh + e];
          if (!all) x = visible(qp, key0 + n * 8 + 2 * L.t4 + e, Sk, causal, window) ? x : kNegInf;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hh], mx);
      const float alpha = expf(m_r[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[n][2 * hh + e];
          x = all || visible(qp, key0 + n * 8 + 2 * L.t4 + e, Sk, causal, window)
                  ? expf(x - m_new) : 0.f;
          sum += x;
        }
      }
      l_r[hh] = l_r[hh] * alpha + sum;
      m_r[hh] = m_new;
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        acc[n][2 * hh] *= alpha;
        acc[n][2 * hh + 1] *= alpha;
      }
    }

    // O += P V, P as a bf16 high and low part
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t ph[4], pl[4];
      c_to_a(sc[2 * kc], sc[2 * kc + 1], ph, pl);
      mma_ab2<kDN>(acc, ph, pl, cv + kc * 16 * LD + c0, LD, L);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lsum = l_r[hh];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const float denom = fmaxf(lsum, 1e-30f);
    const int r = qpos[hh];
    if (r >= S) continue;
    if (L.t4 == 0 && c0 == 0) lse[(long)h * S + r] = m_r[hh] + logf(denom);
#pragma unroll
    for (int n = 0; n < kDN; ++n)
      *reinterpret_cast<uint32_t*>(o + ((long)h * S + r) * HD + c0 + n * 8 + 2 * L.t4) =
          pack_bf16(acc[n][2 * hh] / denom, acc[n][2 * hh + 1] / denom);
  }
}

template <int HD> constexpr size_t dq_mma_smem_bytes() {
  using Tl = MmaTiles<HD>;
  return 2 * ((size_t)2 * kMmaRows * Tl::kStride +
              (size_t)2 * Tl::kStages * Tl::kDqK * Tl::kStride);
}

// K2's dq pass, bf16: grid (q blocks, BH).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
fa_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dq, int S, int Sk, int G, int causal, int window) {
  using Tl = MmaTiles<HD>;
  constexpr int BK = Tl::kDqK, LD = Tl::kStride;
  constexpr int kKC = HD / 16, kDN = HD / 8, kSN = BK / 8;
  constexpr int kTile = BK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);   // (64, LD)
  bf16* sdo = sq + kMmaRows * LD;                 // (64, LD)
  bf16* sk = sdo + kMmaRows * LD;                 // kStages x (BK, LD)
  bf16* sv = sk + Tl::kStages * kTile;

  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;   // longest rows first
  const int q1 = min(q0 + kMmaRows, S) - 1;
  const long qoff = (long)h * S;
  const bf16* kh = k + (long)(h / G) * Sk * HD;
  const bf16* vh = v + (long)(h / G) * Sk * HD;
  int k_lo, k_hi;
  key_range(q0, q1, Sk, causal, window, BK, &k_lo, &k_hi);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  const int warp = threadIdx.x / 32;
  const Lanes L(threadIdx.x % 32);
  load_tile<HD, kMmaRows>(sq, q + qoff * HD, q0, S);
  load_tile<HD, kMmaRows>(sdo, dout + qoff * HD, q0, S);
  if (n_tiles > 0) {
    load_tile<HD, BK>(sk, kh, k_lo, Sk);
    load_tile<HD, BK>(sv, vh, k_lo, Sk);
  }
  cp_async_commit();
  int qpos[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qpos[hh] = q0 + warp * 16 + L.g8 + 8 * hh;
    lse_r[hh] = qpos[hh] < S ? lse[qoff + qpos[hh]] : 0.f;
    delta_r[hh] = qpos[hh] < S ? delta[qoff + qpos[hh]] : 0.f;
  }
  const bf16* wq = sq + warp * 16 * LD;
  const bf16* wdo = sdo + warp * 16 * LD;
  float acc[kDN][4];
  zero_frags(acc);

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int stg = (it + 1) % Tl::kStages;
      load_tile<HD, BK>(sk + stg * kTile, kh, k_lo + (it + 1) * BK, Sk);
      load_tile<HD, BK>(sv + stg * kTile, vh, k_lo + (it + 1) * BK, Sk);
    }
    cp_async_commit();
    const bf16* ck = sk + (it % Tl::kStages) * kTile;
    const bf16* cv = sv + (it % Tl::kStages) * kTile;
    const int key0 = k_lo + it * BK;

    float sc[kSN][4], dp[kSN][4];
    zero_frags(sc);
    zero_frags(dp);
    mma_abt<kKC, kSN>(sc, wq, LD, ck, LD, L);    // S = Q K^T
    mma_abt<kKC, kSN>(dp, wdo, LD, cv, LD, L);   // dP = dO V^T
    // p and ds = p (dP - delta) in the accumulators (rows past S are never
    // written, and their ds reaches only their own dq row)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qp = qpos[hh];
      const bool all = key0 + BK <= Sk && (!causal || key0 + BK - 1 <= qp) &&
                       (window <= 0 || qp - key0 < window);
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = all || visible(qp, key0 + n * 8 + 2 * L.t4 + e, Sk, causal, window);
          const float p = ok ? expf(sc[n][2 * hh + e] - lse_r[hh]) : 0.f;
          sc[n][2 * hh + e] = p * (dp[n][2 * hh + e] - delta_r[hh]);
        }
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t hi[4], lo[4];
      c_to_a(sc[2 * kc], sc[2 * kc + 1], hi, lo);
      mma_ab2<kDN>(acc, hi, lo, ck + kc * 16 * LD, LD, L);
    }
  }
  cp_async_wait<0>();
  store_frags(dq + qoff * HD, HD, acc, q0 + warp * 16, S, L);
}

template <int HD> constexpr size_t dkv_mma_smem_bytes() {
  using Tl = MmaTiles<HD>;
  return 2 * ((size_t)2 * kMmaRows * Tl::kStride +
              (size_t)2 * Tl::kStages * Tl::kDkvQ * Tl::kStride) +
         (size_t)2 * Tl::kStages * Tl::kDkvQ * sizeof(float);
}

// K2's dk/dv pass, bf16: grid (k blocks, BKv), kGroups x 128 threads; a
// block keeps 64 keys and their dk and dv (a column group's columns a
// warp), and walks the G query heads of its kv head times the live q tiles.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads * MmaTiles<HD>::kGroups)
fa_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Sk, int G,
                      int causal, int window) {
  using Tl = MmaTiles<HD>;
  constexpr int BQ = Tl::kDkvQ, LD = Tl::kStride, kCols = Tl::kCols;
  constexpr int kKC = HD / 16, kCN = kCols / 8, kQN = BQ / 8;
  constexpr int kTile = BQ * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);   // (64, LD)
  bf16* sv = sk + kMmaRows * LD;                  // (64, LD)
  bf16* sq = sv + kMmaRows * LD;                  // kStages x (BQ, LD)
  bf16* sdo = sq + Tl::kStages * kTile;           // kStages x (BQ, LD)
  float* s_lse = reinterpret_cast<float*>(sdo + Tl::kStages * kTile);   // kStages x BQ
  float* s_delta = s_lse + Tl::kStages * BQ;                            // kStages x BQ

  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * kMmaRows;
  const int k1 = min(k0 + kMmaRows, Sk) - 1;
  const long koff = (long)kvh * Sk;
  // the q tiles that can see keys k0..k1, for each of the G query heads
  const int q_lo = causal ? k0 / BQ * BQ : 0;
  const int q_hi = window > 0 ? min(S, k1 + window) : S;
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int n_iter = G * n_q;

  const int warp = threadIdx.x / 32 % 4;                  // row group: keys 16 warp ..
  const int c0 = threadIdx.x / kMmaThreads * kCols;       // column group's columns
  const Lanes L(threadIdx.x % 32);
  auto load_q_tile = [&](int i, int stg) {   // iteration i: head i / n_q, tile i % n_q
    const long qoff = ((long)kvh * G + i / n_q) * S;
    const int q0 = q_lo + (i % n_q) * BQ;
    load_tile<HD, BQ>(sq + stg * kTile, q + qoff * HD, q0, S);
    load_tile<HD, BQ>(sdo + stg * kTile, dout + qoff * HD, q0, S);
    load_vec<BQ>(s_lse + stg * BQ, lse + qoff, q0, S);
    load_vec<BQ>(s_delta + stg * BQ, delta + qoff, q0, S);
  };
  load_tile<HD, kMmaRows>(sk, k + koff * HD, k0, Sk);
  load_tile<HD, kMmaRows>(sv, v + koff * HD, k0, Sk);
  if (n_iter > 0) load_q_tile(0, 0);
  cp_async_commit();

  int kpos[2];
  kpos[0] = k0 + warp * 16 + L.g8;
  kpos[1] = kpos[0] + 8;
  const bf16* wk = sk + warp * 16 * LD;
  const bf16* wv = sv + warp * 16 * LD;
  float dk_acc[kCN][4], dv_acc[kCN][4];
  zero_frags(dk_acc);
  zero_frags(dv_acc);

#pragma unroll 1
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_iter) load_q_tile(it + 1, (it + 1) % Tl::kStages);
    cp_async_commit();
    const int stg = it % Tl::kStages;
    const bf16* cq = sq + stg * kTile;
    const bf16* cdo = sdo + stg * kTile;
    const float* clse = s_lse + stg * BQ;
    const float* cdelta = s_delta + stg * BQ;
    const int q0 = q_lo + (it % n_q) * BQ;

    float st[kQN][4], dpt[kQN][4];
    zero_frags(st);
    zero_frags(dpt);
    mma_abt<kKC, kQN>(st, wk, LD, cq, LD, L);     // S^T = K Q^T
    mma_abt<kKC, kQN>(dpt, wv, LD, cdo, LD, L);   // dP^T = V dO^T
    // p^T and ds^T in the accumulators: rows are this warp's keys, columns
    // the tile's queries
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kp = kpos[hh];
      const bool all = q0 + BQ <= S && kp < Sk && (!causal || q0 >= kp) &&
                       (window <= 0 || q0 + BQ - 1 - kp < window);
#pragma unroll
      for (int n = 0; n < kQN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * L.t4 + e;
          const bool ok = all || (q0 + c < S && visible(q0 + c, kp, Sk, causal, window));
          const float p = ok ? expf(st[n][2 * hh + e] - clse[c]) : 0.f;
          st[n][2 * hh + e] = p;
          dpt[n][2 * hh + e] = p * (dpt[n][2 * hh + e] - cdelta[c]);
        }
      }
    }
    // dV += P^T dO and dK += dS^T Q over this block's columns
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      c_to_a(st[2 * kc], st[2 * kc + 1], ph, pl);
      c_to_a(dpt[2 * kc], dpt[2 * kc + 1], dh, dl);
      mma_ab2<kCN>(dv_acc, ph, pl, cdo + kc * 16 * LD + c0, LD, L);
      mma_ab2<kCN>(dk_acc, dh, dl, cq + kc * 16 * LD + c0, LD, L);
    }
  }
  cp_async_wait<0>();
  store_frags(dk + koff * HD + c0, HD, dk_acc, k0 + warp * 16, Sk, L);
  store_frags(dv + koff * HD + c0, HD, dv_acc, k0 + warp * 16, Sk, L);
}

// ----------------------------------------------------------------- launchers
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  int BH, BKv, S, Sk, causal, window;
  cudaStream_t stream;
};

// bf16 runs the tensor-core kernels, f32 the CUDA-core ones.
template <typename T, int HD> int launch_fwd(const Args& a) {
  const int G = a.BH / a.BKv;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = fwd_mma_smem_bytes<HD>();
    const int err = prepare(fa_fwd_mma_kernel<HD>, smem);
    if (err) return err;
    fa_fwd_mma_kernel<HD><<<dim3((a.S + kMmaRows - 1) / kMmaRows, a.BH),
                            kMmaThreads * MmaTiles<HD>::kGroups, smem, a.stream>>>(
            static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
            static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o),
            static_cast<float*>(a.lse_out), a.S, a.Sk, G, a.causal, a.window);
  } else {
    const size_t smem = fwd_smem_floats<HD>() * sizeof(float);
    const int err = prepare(fa_fwd_kernel<T, HD>, smem);
    if (err) return err;
    constexpr int BQ = Tiles<HD>::kFwdQ;
    fa_fwd_kernel<T, HD><<<dim3((a.S + BQ - 1) / BQ, a.BH), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<T*>(a.o), static_cast<float*>(a.lse_out), a.S, a.Sk, G, a.causal,
        a.window);
  }
  return (int)cudaGetLastError();
}

template <typename T, int HD> int launch_dq(const Args& a) {
  const int G = a.BH / a.BKv;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = dq_mma_smem_bytes<HD>();
    const int err = prepare(fa_bwd_dq_mma_kernel<HD>, smem);
    if (err) return err;
    fa_bwd_dq_mma_kernel<HD>
        <<<dim3((a.S + kMmaRows - 1) / kMmaRows, a.BH), kMmaThreads, smem, a.stream>>>(
            static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
            static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
            static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
            static_cast<bf16*>(a.dq), a.S, a.Sk, G, a.causal, a.window);
  } else {
    const size_t smem = dq_smem_floats<HD>() * sizeof(float);
    const int err = prepare(fa_bwd_dq_kernel<T, HD>, smem);
    if (err) return err;
    constexpr int BQ = Tiles<HD>::kDqQ;
    fa_bwd_dq_kernel<T, HD><<<dim3((a.S + BQ - 1) / BQ, a.BH), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.S, a.Sk, G, a.causal,
        a.window);
  }
  return (int)cudaGetLastError();
}

template <typename T, int HD> int launch_dkv(const Args& a) {
  const int G = a.BH / a.BKv;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = dkv_mma_smem_bytes<HD>();
    const int err = prepare(fa_bwd_dkv_mma_kernel<HD>, smem);
    if (err) return err;
    fa_bwd_dkv_mma_kernel<HD><<<dim3((a.Sk + kMmaRows - 1) / kMmaRows, a.BKv),
                                kMmaThreads * MmaTiles<HD>::kGroups, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, a.Sk, G, a.causal,
        a.window);
  } else {
    const size_t smem = dkv_smem_floats<HD>() * sizeof(float);
    const int err = prepare(fa_bwd_dkv_kernel<T, HD>, smem);
    if (err) return err;
    constexpr int BK = Tiles<HD>::kDkvK;
    fa_bwd_dkv_kernel<T, HD>
        <<<dim3((a.Sk + BK - 1) / BK, a.BKv), kThreads, smem, a.stream>>>(
            static_cast<const T*>(a.q), static_cast<const T*>(a.k),
            static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
            static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
            static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.Sk, G, a.causal, a.window);
  }
  return (int)cudaGetLastError();
}

// pass: 0 forward, 1 dq, 2 dkv.
template <typename T, int HD> int run_pass(int pass, const Args& a) {
  if (pass == 0) return launch_fwd<T, HD>(a);
  if (pass == 1) return launch_dq<T, HD>(a);
  return launch_dkv<T, HD>(a);
}

// the head dims built (each a template instance of every kernel)
#define FA_HD_CASES(X) X(16) X(32) X(64) X(96) X(128) X(256)

// Returns cudaErrorInvalidValue for a head dim without a build.
template <typename T> int dispatch(int pass, int hd, const Args& a) {
  switch (hd) {
#define FA_CASE(H) \
  case H: return run_pass<T, H>(pass, a);
    FA_HD_CASES(FA_CASE)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

int run(int pass, int hd, int dtype, const Args& a) {
  return dtype == 1 ? dispatch<__nv_bfloat16>(pass, hd, a) : dispatch<float>(pass, hd, a);
}

// The larger of the f32 and the bf16 kernel's shared memory: both must fit.
template <int HD> size_t smem_of(int pass) {
  size_t f32, mma;
  if (pass == 0) {
    f32 = fwd_smem_floats<HD>() * sizeof(float);
    mma = fwd_mma_smem_bytes<HD>();
  } else if (pass == 1) {
    f32 = dq_smem_floats<HD>() * sizeof(float);
    mma = dq_mma_smem_bytes<HD>();
  } else {
    f32 = dkv_smem_floats<HD>() * sizeof(float);
    mma = dkv_mma_smem_bytes<HD>();
  }
  return f32 > mma ? f32 : mma;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of `pass` (0 forward, 1 dq, 2 dkv) asks for
// at head dim hd, the larger of its f32 and bf16 kernels; 0 for a head dim
// that has no build.
size_t flash_attention_smem_bytes(int pass, int hd) {
  switch (hd) {
#define FA_CASE(H) \
  case H: return smem_of<H>(pass);
    FA_HD_CASES(FA_CASE)
#undef FA_CASE
  }
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv); lse and
// delta are f32. Each returns cudaGetLastError() after its launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int BH, int BKv, int S, int Sk, int hd, int causal, int window,
                        int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse_out = lse;
  a.BH = BH; a.BKv = BKv; a.S = S; a.Sk = Sk; a.causal = causal; a.window = window;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(0, hd, dtype, a);
}

// o and dout 16-byte aligned (the wrapper checks it).
int flash_attention_bwd_delta(const void* o, const void* dout, void* delta, int BH, int S,
                              int hd, int dtype, void* stream) {
  const long rows = (long)BH * S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define FA_CASE(H)                                                        \
  case H:                                                                 \
    return dtype == 1 ? delta_hd<__nv_bfloat16, H>(o, dout, delta, rows, s) \
                      : delta_hd<float, H>(o, dout, delta, rows, s);
    FA_HD_CASES(FA_CASE)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int BH, int BKv,
                           int S, int Sk, int hd, int causal, int window, int dtype,
                           void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dq = dq;
  a.BH = BH; a.BKv = BKv; a.S = S; a.Sk = Sk; a.causal = causal; a.window = window;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(1, hd, dtype, a);
}

int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dk,
                            void* dv, int BH, int BKv, int S, int Sk, int hd, int causal,
                            int window, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dk = dk; a.dv = dv;
  a.BH = BH; a.BKv = BKv; a.S = S; a.Sk = Sk; a.causal = causal; a.window = window;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(2, hd, dtype, a);
}

}  // extern "C"
