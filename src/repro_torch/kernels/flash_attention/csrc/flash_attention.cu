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
// (head, q block); a block skips the k blocks that lie wholly above its
// causal diagonal or wholly below the window of its lowest row. The skip is
// exact: such blocks would add zeros and leave m unchanged. The ragged edge
// of S is masked here (tiles past the end are zero-filled); nothing is
// padded or copied in device memory.
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
// (16 heads, S 2048, hd 256) a causal layer's forward does ~34 GFLOP on
// ~34 MB, far above the ~295 flop/byte ridge. This first design computes
// its tile products on the CUDA cores in f32, from f32 tiles in shared memory,
// each thread holding a register tile of the block's output; it therefore
// runs far below the tensor-core peak the bound assumes. Tensor cores
// (mma.sync or wgmma on bf16 tiles), a TMA ring and the softmax in registers
// of the product are the known levers for a later PR.
//
// Shared memory: tiles are f32. K and V tiles that are read across the
// lanes of a warp by row keep a row stride of hd + 1, so those reads are
// free of bank conflicts. At hd 256 a block asks for up to ~207 KB, under
// the 227 KB one H100 block may use; the launcher sets
// cudaFuncAttributeMaxDynamicSharedMemorySize.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// delta[row] = sum over hd of dO * O in f32; one warp per row of (BH * S).
template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, long rows, int hd) {
  const long row = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32)
    s += to_f32(o[row * hd + d]) * to_f32(dout[row * hd + d]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
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

template <typename T, int HD> int launch_fwd(const Args& a) {
  const size_t smem = fwd_smem_floats<HD>() * sizeof(float);
  const int err = prepare(fa_fwd_kernel<T, HD>, smem);
  if (err) return err;
  constexpr int BQ = Tiles<HD>::kFwdQ;
  fa_fwd_kernel<T, HD><<<dim3((a.S + BQ - 1) / BQ, a.BH), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), static_cast<float*>(a.lse_out), a.S, a.Sk, a.BH / a.BKv,
      a.causal, a.window);
  return (int)cudaGetLastError();
}

template <typename T, int HD> int launch_dq(const Args& a) {
  const size_t smem = dq_smem_floats<HD>() * sizeof(float);
  const int err = prepare(fa_bwd_dq_kernel<T, HD>, smem);
  if (err) return err;
  constexpr int BQ = Tiles<HD>::kDqQ;
  fa_bwd_dq_kernel<T, HD><<<dim3((a.S + BQ - 1) / BQ, a.BH), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.S, a.Sk,
      a.BH / a.BKv, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <typename T, int HD> int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_floats<HD>() * sizeof(float);
  const int err = prepare(fa_bwd_dkv_kernel<T, HD>, smem);
  if (err) return err;
  constexpr int BK = Tiles<HD>::kDkvK;
  fa_bwd_dkv_kernel<T, HD>
      <<<dim3((a.Sk + BK - 1) / BK, a.BKv), kThreads, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
          static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.Sk, a.BH / a.BKv,
          a.causal, a.window);
  return (int)cudaGetLastError();
}

// pass: 0 forward, 1 dq, 2 dkv. Returns -1 for a head dim without a build.
template <typename T, int HD> int run_pass(int pass, const Args& a) {
  if (pass == 0) return launch_fwd<T, HD>(a);
  if (pass == 1) return launch_dq<T, HD>(a);
  return launch_dkv<T, HD>(a);
}

template <typename T> int dispatch(int pass, int hd, const Args& a) {
  switch (hd) {
    case 16: return run_pass<T, 16>(pass, a);
    case 32: return run_pass<T, 32>(pass, a);
    case 64: return run_pass<T, 64>(pass, a);
    case 128: return run_pass<T, 128>(pass, a);
    case 256: return run_pass<T, 256>(pass, a);
    default: return -1;
  }
}

int run(int pass, int hd, int dtype, const Args& a) {
  return dtype == 1 ? dispatch<__nv_bfloat16>(pass, hd, a) : dispatch<float>(pass, hd, a);
}

template <int HD> size_t smem_of(int pass) {
  if (pass == 0) return fwd_smem_floats<HD>() * sizeof(float);
  if (pass == 1) return dq_smem_floats<HD>() * sizeof(float);
  return dkv_smem_floats<HD>() * sizeof(float);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of `pass` (0 forward, 1 dq, 2 dkv) asks for
// at head dim hd; 0 for a head dim that has no build (16, 32, 64, 128, 256).
size_t flash_attention_smem_bytes(int pass, int hd) {
  switch (hd) {
    case 16: return smem_of<16>(pass);
    case 32: return smem_of<32>(pass);
    case 64: return smem_of<64>(pass);
    case 128: return smem_of<128>(pass);
    case 256: return smem_of<256>(pass);
    default: return 0;
  }
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

int flash_attention_bwd_delta(const void* o, const void* dout, void* delta, int BH, int S,
                              int hd, int dtype, void* stream) {
  const long rows = (long)BH * S;
  const int blocks = (int)((rows + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    fa_bwd_delta_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
        static_cast<float*>(delta), rows, hd);
  else
    fa_bwd_delta_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(delta), rows, hd);
  return (int)cudaGetLastError();
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
