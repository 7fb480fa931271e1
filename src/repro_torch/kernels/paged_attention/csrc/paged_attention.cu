// Paged decode attention (K5) and paged chunked-prefill attention (K6) for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernels in src/repro/kernels/paged_attention/kernel.py:
//   paged_decode_attention  <- paged_attention_kernel          (body _pa_kernel)
//   paged_prefill_attention <- paged_prefill_attention_kernel  (body _pp_kernel)
//
// What they compute (as the Pallas bodies do): each (slot, kv head) walks its
// block-table pages tables[b, j] with an online softmax in f32. Scores of
// masked positions are set to -1e30, p is chosen by a select (never by a
// multiply with the mask), so masked positions add exact zeros; the
// denominator is clamped at 1e-30. Decode row g sits at position L-1; prefill
// row (t, g) is flattened as r = t*G + g and sits at start + t, with
// kpos <= qpos and, with a window, kpos > qpos - window. Pages at or past the
// extent are skipped, and so are pages wholly below the window (exact: they
// would add zeros and leave m unchanged).
//
// What bounds them on the H100: bytes. Decode reads every cached K/V byte of
// the slot once per step (G*hd*4 flops per K/V row of 2*hd elements, far
// below the ~295 flop/byte ridge); a 128-row prefill chunk is still at most
// a few tens of flops per byte. So the design only has to stream K/V pages
// once: each (page, hd) K and V tile is read from the pool with coalesced
// 16-byte loads into shared memory and shared by all rows of the block (the
// G query heads of a kv head, and for prefill up to `rows` flattened rows),
// and the running m, l and (rows, hd) accumulator stay in shared memory.
// This first design does its two small products on the CUDA cores in f32;
// tensor cores, a TMA ring and split-K over pages for small decode batches
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Shared-memory floats one block needs: q and accumulator tiles (rows, hd),
// the K tile padded to hd+1 per row (conflict-free score loop), the V tile,
// the (rows, page) score/p tile and m, l, alpha per row.
__host__ __device__ inline size_t smem_floats(int rows, int hd, int page) {
  return (size_t)rows * hd * 2 + (size_t)page * (hd + 1) + (size_t)page * hd +
         (size_t)rows * page + 3 * (size_t)rows;
}

// One (page, hd) tile of pool page `pid`, kv head `kv`, into shared memory as
// f32 with row stride `stride`. The pool is (N, page, Kv, hd) contiguous, so
// each token row is hd contiguous elements: 16-byte vector loads, consecutive
// threads on consecutive addresses.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ pool, int pid, int kv,
                                          int Kv, int hd, int page, float* dst,
                                          int stride) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec_per_row = hd / kVec;
  const long base = ((long)pid * page * Kv + kv) * hd;
  const long row_step = (long)Kv * hd;
  for (int i = threadIdx.x; i < page * vec_per_row; i += blockDim.x) {
    const int s = i / vec_per_row;
    const int c = (i % vec_per_row) * kVec;
    alignas(16) T vals[kVec];
    *reinterpret_cast<uint4*>(vals) =
        *reinterpret_cast<const uint4*>(pool + base + s * row_step + c);
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[s * stride + c + e] = to_f32(vals[e]);
  }
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int window) {
  return kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

// The shared body. Rows row0 .. row0+rows-1 of the flattened (T*G) query of
// slot b, kv head kv; q and out are (B, T, Kv, G, hd) (decode is T = 1, whose
// layout (B, Kv, G, hd) is the same memory). Row r sits at start + r / G.
template <typename T>
__device__ void attend_rows(const T* __restrict__ q, const T* __restrict__ kp,
                            const T* __restrict__ vp, const int* __restrict__ table_row,
                            T* __restrict__ out, int b, int kv, int row0, int rows,
                            int Tq, int Kv, int G, int hd, int page, int P, int start,
                            int qlen, int window, float* smem) {
  float* qs = smem;                         // (rows, hd)
  float* acc = qs + rows * hd;              // (rows, hd)
  float* ks = acc + rows * hd;              // (page, hd + 1)
  float* vs = ks + page * (hd + 1);         // (page, hd)
  float* ss = vs + page * hd;               // (rows, page)
  float* m = ss + rows * page;              // (rows,)
  float* l = m + rows;
  float* alpha = l + rows;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  auto row_offset = [&](int r) -> long {
    const int fr = row0 + r;
    const int t = fr / G;
    const int g = fr % G;
    return ((((long)b * Tq + t) * Kv + kv) * G + g) * hd;
  };

  for (int i = tid; i < rows * hd; i += blockDim.x) {
    const int r = i / hd;
    qs[i] = to_f32(q[row_offset(r) + i % hd]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += blockDim.x) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  // Pages this tile needs: up to the last valid row's position (rows past
  // q_len are garbage by contract), and from the first page that the lowest
  // row's window reaches.
  const int t_lo = row0 / G;
  const int t_hi = (row0 + rows - 1) / G;
  const int end_tok = start + min(qlen, t_hi + 1);  // exclusive
  int n_pages = end_tok > 0 ? (end_tok + page - 1) / page : 0;
  n_pages = min(n_pages, P);
  int j0 = 0;
  if (window > 0) {
    const int lo = start + t_lo - window + 1;
    if (lo > 0) j0 = lo / page;
  }

  for (int j = j0; j < n_pages; ++j) {
    const int pid = table_row[j];
    __syncthreads();  // the previous page's tiles are no longer read
    load_tile(kp, pid, kv, Kv, hd, page, ks, hd + 1);
    load_tile(vp, pid, kv, Kv, hd, page, vs, hd);
    __syncthreads();

    // scores (rows, page)
    for (int i = tid; i < rows * page; i += blockDim.x) {
      const int r = i / page;
      const int s = i % page;
      const int qpos = start + (row0 + r) / G;
      float sc = kNegInf;
      if (visible(j * page + s, qpos, window)) {
        const float* qr = qs + r * hd;
        const float* kr = ks + s * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot;
      }
      ss[i] = sc;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < rows; r += kWarps) {
      const int qpos = start + (row0 + r) / G;
      float mx = kNegInf;
      for (int s = lane; s < page; s += 32) mx = fmaxf(mx, ss[r * page + s]);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < page; s += 32) {
        const float p = visible(j * page + s, qpos, window)
                            ? expf(ss[r * page + s] - m_new) : 0.f;
        ss[r * page + s] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V
    for (int i = tid; i < rows * hd; i += blockDim.x) {
      const int r = i / hd;
      const int d = i % hd;
      const float* pr = ss + r * page;
      float a = acc[i] * alpha[r];
      for (int s = 0; s < page; ++s) a = fmaf(pr[s], vs[s * hd + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < rows * hd; i += blockDim.x) {
    const int r = i / hd;
    const float denom = fmaxf(l[r], 1e-30f);
    out[row_offset(r) + i % hd] = from_f32<T>(acc[i] / denom);
  }
}

// K5: grid (Kv, B); one block holds the G query heads of one kv head.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int Kv, int G,
                    int hd, int page, int P, int window) {
  extern __shared__ float smem[];
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int L = lengths[b];
  attend_rows<T>(q, kp, vp, tables + (long)b * P, out, b, kv, 0, G, 1, Kv, G, hd,
                 page, P, L - 1, 1, window, smem);
}

// K6: grid (row tiles, Kv, B); one block holds `rows_per_block` flattened rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ tables,
                     const int* __restrict__ start, const int* __restrict__ q_len,
                     T* __restrict__ out, int Tq, int Kv, int G, int hd, int page, int P,
                     int window, int rows_per_block) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * rows_per_block;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(rows_per_block, Tq * G - row0);
  attend_rows<T>(q, kp, vp, tables + (long)b * P, out, b, kv, row0, rows, Tq, Kv, G,
                 hd, page, P, start[b], q_len[b], window, smem);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
int launch_decode(const void* q, const void* kp, const void* vp, const void* tables,
                  const void* lengths, void* out, int B, int Kv, int G, int hd,
                  int page, int P, int window, cudaStream_t stream) {
  const size_t smem = smem_floats(G, hd, page) * sizeof(float);
  const int err = prepare(paged_decode_kernel<T>, smem);
  if (err) return err;
  paged_decode_kernel<T><<<dim3(Kv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<T*>(out), Kv, G, hd, page, P, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_prefill(const void* q, const void* kp, const void* vp, const void* tables,
                   const void* start, const void* q_len, void* out, int B, int Tq,
                   int Kv, int G, int hd, int page, int P, int window,
                   int rows_per_block, cudaStream_t stream) {
  const size_t smem = smem_floats(rows_per_block, hd, page) * sizeof(float);
  const int err = prepare(paged_prefill_kernel<T>, smem);
  if (err) return err;
  const int tiles = (Tq * G + rows_per_block - 1) / rows_per_block;
  paged_prefill_kernel<T><<<dim3(tiles, Kv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(start),
      static_cast<const int*>(q_len), static_cast<T*>(out), Tq, Kv, G, hd, page, P,
      window, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of either kernel asks for (the wrapper
// checks it against the card's limit before launching).
size_t paged_attention_smem_bytes(int rows, int hd, int page) {
  return smem_floats(rows, hd, page) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
int paged_decode_attention(const void* q, const void* kp, const void* vp,
                           const void* tables, const void* lengths, void* out, int B,
                           int Kv, int G, int hd, int page, int P, int window,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, kp, vp, tables, lengths, out, B, Kv, G, hd,
                                        page, P, window, s);
  return launch_decode<float>(q, kp, vp, tables, lengths, out, B, Kv, G, hd, page, P,
                              window, s);
}

int paged_prefill_attention(const void* q, const void* kp, const void* vp,
                            const void* tables, const void* start, const void* q_len,
                            void* out, int B, int Tq, int Kv, int G, int hd, int page,
                            int P, int window, int rows_per_block, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_prefill<__nv_bfloat16>(q, kp, vp, tables, start, q_len, out, B, Tq,
                                         Kv, G, hd, page, P, window, rows_per_block, s);
  return launch_prefill<float>(q, kp, vp, tables, start, q_len, out, B, Tq, Kv, G, hd,
                               page, P, window, rows_per_block, s);
}

}  // extern "C"
