// Blockwise dynamic 8-bit quantization (K8a) and dequantization (K8b) for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernels in src/repro/kernels/blockwise_quant/kernel.py:
//   blockwise_quantize   <- quantize_pallas    (body _quant_kernel)
//   blockwise_dequantize <- dequantize_pallas  (body _dequant_kernel)
//
// What they compute (as the Pallas bodies do), per block of 256 f32 values:
//   scale = max |x|                                  (f32, exact in any order)
//   idx   = #(midpoints <= x / (scale > 0 ? scale : 1))        (uint8)
//   out   = map[idx] * scale                          (f32, one rounding)
// where map is the 256-entry dynamic map (repro_torch/kernels/blockwise_quant/
// ref.py::dynamic_map) and the 255 midpoints are (map[1:] + map[:-1]) / 2,
// both computed on the host in f32 and passed in, so the kernel sees the very
// values the plain version searches. For finite inputs the count equals
// searchsorted(mid, v, side="right"), and codes, scales and dequantized values
// are the plain version's bits: the division is __fdiv_rn (correctly rounded,
// whatever the flags), and nothing here is contracted into an FMA.
//
// What bounds them on the H100: bytes. K8a reads 4 B and writes 1 B per
// element (plus 4 B per block), K8b the reverse; a handful of operations per
// element. The TPU kernel found its index with a (tile, 255) compare-sum and
// its code with a (tile, 256) one-hot select-sum, because the VPU has no
// gather; here each thread binary-searches the midpoints in shared memory
// (8 steps; shared, not constant memory, since the lanes' addresses diverge)
// and dequantization is a shared-memory lookup.
//
// Layout: one warp per 256-value block; lane l handles values 4l..4l+3 and
// 128+4l..128+4l+3, so the warp's float4 loads and uchar4 stores are each one
// contiguous run. Blocks of 8 warps walk the quantization blocks with a grid
// stride, so the table is loaded into shared memory once per CUDA block. Any
// number of quantization blocks; pointers must be 16-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;            // values per quantization block
constexpr int kThreads = 256;          // 8 warps: 8 quantization blocks at a time
constexpr int kWarps = kThreads / 32;
constexpr int kMid = 255;              // midpoints between the 256 codes
constexpr long kMaxGrid = 132 * 16;    // 16 blocks per SM of an H100

// Number of midpoints <= v (mid sorted ascending): 8 halving steps. The index
// read at step s is at most 255 - s, so it never leaves the 255 entries.
__device__ __forceinline__ uint8_t code_of(const float* mid, float v) {
  int pos = 0;
#pragma unroll
  for (int s = 128; s > 0; s >>= 1)
    if (mid[pos + s - 1] <= v) pos += s;
  return (uint8_t)pos;
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ mid_in,
                uint8_t* __restrict__ codes, float* __restrict__ scales, long nblocks) {
  __shared__ float mid[kMid];
  for (int i = threadIdx.x; i < kMid; i += kThreads) mid[i] = mid_in[i];
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // b is the same for every lane of a warp, so the shuffles below are uniform
  for (long b = (long)blockIdx.x * kWarps + warp; b < nblocks; b += (long)gridDim.x * kWarps) {
    const float4* xb = reinterpret_cast<const float4*>(x + b * kBlock);
    const float4 lo = xb[lane];
    const float4 hi = xb[32 + lane];
    float amax = fmaxf(fmaxf(fmaxf(fabsf(lo.x), fabsf(lo.y)), fmaxf(fabsf(lo.z), fabsf(lo.w))),
                       fmaxf(fmaxf(fabsf(hi.x), fabsf(hi.y)), fmaxf(fabsf(hi.z), fabsf(hi.w))));
#pragma unroll
    for (int o = 16; o > 0; o /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float safe = amax > 0.f ? amax : 1.f;
    uchar4 clo, chi;
    clo.x = code_of(mid, __fdiv_rn(lo.x, safe));
    clo.y = code_of(mid, __fdiv_rn(lo.y, safe));
    clo.z = code_of(mid, __fdiv_rn(lo.z, safe));
    clo.w = code_of(mid, __fdiv_rn(lo.w, safe));
    chi.x = code_of(mid, __fdiv_rn(hi.x, safe));
    chi.y = code_of(mid, __fdiv_rn(hi.y, safe));
    chi.z = code_of(mid, __fdiv_rn(hi.z, safe));
    chi.w = code_of(mid, __fdiv_rn(hi.w, safe));
    uchar4* cb = reinterpret_cast<uchar4*>(codes + b * kBlock);
    cb[lane] = clo;
    cb[32 + lane] = chi;
    if (lane == 0) scales[b] = amax;
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ scales,
                  const float* __restrict__ map_in, float* __restrict__ out, long nblocks) {
  __shared__ float map[256];
  map[threadIdx.x] = map_in[threadIdx.x];  // kThreads == 256
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (long b = (long)blockIdx.x * kWarps + warp; b < nblocks; b += (long)gridDim.x * kWarps) {
    const float s = scales[b];
    const uchar4* cb = reinterpret_cast<const uchar4*>(codes + b * kBlock);
    const uchar4 clo = cb[lane];
    const uchar4 chi = cb[32 + lane];
    float4* ob = reinterpret_cast<float4*>(out + b * kBlock);
    ob[lane] = make_float4(map[clo.x] * s, map[clo.y] * s, map[clo.z] * s, map[clo.w] * s);
    ob[32 + lane] = make_float4(map[chi.x] * s, map[chi.y] * s, map[chi.z] * s, map[chi.w] * s);
  }
}

int grid_for(long nblocks) {
  const long want = (nblocks + kWarps - 1) / kWarps;
  return (int)(want < kMaxGrid ? want : kMaxGrid);
}

}  // namespace

extern "C" {

// x (nblocks * 256,) f32 -> codes (nblocks * 256,) uint8, scales (nblocks,) f32.
// mid: the 255 f32 midpoints of the dynamic map. Returns cudaGetLastError().
int blockwise_quantize(const float* x, const float* mid, uint8_t* codes, float* scales,
                       long long nblocks, cudaStream_t stream) {
  if (nblocks > 0)
    quantize_kernel<<<grid_for(nblocks), kThreads, 0, stream>>>(x, mid, codes, scales,
                                                                (long)nblocks);
  return (int)cudaGetLastError();
}

// codes (nblocks * 256,) uint8, scales (nblocks,) f32 -> out (nblocks * 256,) f32.
// map: the 256 f32 codes of the dynamic map. Returns cudaGetLastError().
int blockwise_dequantize(const uint8_t* codes, const float* scales, const float* map,
                         float* out, long long nblocks, cudaStream_t stream) {
  if (nblocks > 0)
    dequantize_kernel<<<grid_for(nblocks), kThreads, 0, stream>>>(codes, scales, map, out,
                                                                  (long)nblocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
