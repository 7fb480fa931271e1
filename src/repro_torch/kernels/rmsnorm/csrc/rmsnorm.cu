// Fused RMSNorm forward (K3) and backward (K4) for Hopper (sm_90a), with a
// plain C interface loaded through ctypes.
//
// Replaces the TPU kernels in src/repro/kernels/rmsnorm/kernel.py:
//   rmsnorm_fwd <- rmsnorm_pallas      (body _rmsnorm_kernel)
//   rmsnorm_bwd <- rmsnorm_bwd_pallas  (body _rmsnorm_bwd_kernel)
//
// What they compute (as the Pallas bodies do), per row of x (rows, d), in f32:
//   inv    = rsqrt(mean(x^2) + eps)
//   out    = x * inv * scale                                  (cast to x.dtype)
//   dx     = inv * (g*scale - xhat * mean(g*scale*xhat)),  xhat = x * inv
//   dscale = sum over rows of g * xhat                        (f32)
//
// What bounds them on the H100: bytes. Each is a row reduction plus an
// elementwise pass, a few flops per element against 2 (bf16) or 4 (f32)
// bytes read and written, far below the ~295 flop/byte ridge. The design
// reads each row from device memory once per pass it needs (the second and
// third passes over a row hit L1/L2, since a row is at most 16 KB in f32),
// with neighbouring threads on neighbouring columns.
//
// K3: one block of 256 threads per row; the threads stride over the columns,
// so any width (1152 for gemma3-1b, 4096 for granite-8b) works.
//
// K4: the TPU kernel sums dscale into one (1, d) block revisited by its
// sequential grid. Blocks here run in parallel and in no order, so each block
// walks a fixed, contiguous range of rows and keeps its dscale partial in
// shared memory (each column owned by one thread, so no atomics), writes the
// partial to a (blocks, d) f32 scratch, and a second kernel sums the
// partials of each column in block order. The number of blocks depends only
// on the number of rows, so dscale is the same bits from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Sum of v over the block, the same value returned to every thread. The order
// of the additions is fixed (warp tree, then warp 0 over the warp sums), so
// the result does not change from run to run. `red` holds kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = lane < kWarps ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int d, float eps) {
  __shared__ float red[kWarps];
  const long base = (long)blockIdx.x * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float v = to_f32(x[base + c]);
    ss += v * v;
  }
  const float inv = rsqrtf(block_sum(ss, red) / (float)d + eps);
  for (int c = threadIdx.x; c < d; c += kThreads)
    out[base + c] = from_f32<T>(to_f32(x[base + c]) * inv * scale[c]);
}

// Rows [blockIdx.x * rows_per_block, ...) of x and g; dynamic shared memory
// holds this block's dscale partial, d floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ partial, int rows, int d, int rows_per_block,
                   float eps) {
  extern __shared__ float ds[];
  __shared__ float red[kWarps];
  for (int c = threadIdx.x; c < d; c += kThreads) ds[c] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const long base = (long)r * d;
    float ss = 0.f;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float v = to_f32(x[base + c]);
      ss += v * v;
    }
    const float inv = rsqrtf(block_sum(ss, red) / (float)d + eps);
    float dot = 0.f;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float xhat = to_f32(x[base + c]) * inv;
      dot += to_f32(g[base + c]) * scale[c] * xhat;
    }
    const float rowmean = block_sum(dot, red) / (float)d;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float xhat = to_f32(x[base + c]) * inv;
      const float gv = to_f32(g[base + c]);
      dx[base + c] = from_f32<T>(inv * (gv * scale[c] - xhat * rowmean));
      ds[c] += gv * xhat;  // column c belongs to this thread alone
    }
  }
  for (int c = threadIdx.x; c < d; c += kThreads)
    partial[(long)blockIdx.x * d + c] = ds[c];
}

// dscale[c] = sum of partial[b, c] over b = 0 .. blocks-1, in that order.
__global__ void __launch_bounds__(kThreads)
rmsnorm_dscale_reduce_kernel(const float* __restrict__ partial,
                             float* __restrict__ dscale, int blocks, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(long)b * d + c];
  dscale[c] = s;
}

template <typename T>
int launch_fwd(const void* x, const void* scale, void* out, int rows, int d, float eps,
               cudaStream_t stream) {
  rmsnorm_fwd_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* g, void* dx,
               void* partial, void* dscale, int rows, int d, int blocks, float eps,
               cudaStream_t stream) {
  const int rows_per_block = (rows + blocks - 1) / blocks;
  rmsnorm_bwd_kernel<T><<<blocks, kThreads, (size_t)d * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<float*>(partial),
      rows, d, rows_per_block, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_dscale_reduce_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dscale), blocks, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, out, g, dx); scale and dscale are f32.
// Each returns cudaGetLastError() after its launches.
int rmsnorm_fwd(const void* x, const void* scale, void* out, int rows, int d,
                float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return launch_fwd<float>(x, scale, out, rows, d, eps, s);
}

// partial: (blocks, d) f32 scratch; blocks <= rows.
int rmsnorm_bwd(const void* x, const void* scale, const void* g, void* dx,
                void* partial, void* dscale, int rows, int d, int blocks, float eps,
                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, scale, g, dx, partial, dscale, rows, d, blocks,
                                     eps, s);
  return launch_bwd<float>(x, scale, g, dx, partial, dscale, rows, d, blocks, eps, s);
}

}  // extern "C"
