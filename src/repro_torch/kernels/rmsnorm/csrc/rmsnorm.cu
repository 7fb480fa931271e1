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
// bytes read and written, far below the ~295 flop/byte ridge. So each row is
// read from device memory once, into registers, and the next loads go out
// before a row's reductions wait:
//
// * A row group of WPR warps (1 to 16) holds one row. Warp w holds the
//   row's vectors [w*32*NV, (w+1)*32*NV): lane l's slot i is vector w*32*NV
//   + i*32 + l, so neighbouring lanes load neighbouring 16 bytes and slot i
//   sits at an immediate offset from the lane's first. The vector is 16
//   bytes (8 bf16 or 4 f32 values) wherever d is a multiple of it and x, g
//   and scale are 16-byte aligned, with a predicated last sweep (d 1152 in
//   bf16 is 144 vectors, 4.5 a lane of one warp). Any other d, or a pointer
//   off 16 bytes (a view at an odd storage offset), runs the scalar body of
//   the same kernel: one value a slot, 24 slots a lane, those past d
//   predicated off. cuda.py's `plan` picks WPR, the fewest warps whose lanes
//   hold at most NV_MAX slots (24 for the scalar body), then NV.
// * A row's sums are warp shuffles, then, across the group's warps, a sum in
//   warp order through shared memory behind a named barrier of the group
//   alone. No block-wide barrier runs per row.
// * A block holds up to 8 warps of row groups (at most 16 warps, so that
//   with __launch_bounds__(512) a thread keeps at most 128 registers and 16
//   warps stay resident on an SM). The grid is at most the blocks that keep
//   16 warps on each of 132 SMs; each group walks the rows gid, gid +
//   groups, ..., so the grid and every walk depend on the plan's arguments.
//
// K3 keeps its columns' scale in registers across the rows it walks, loads
// the next row while it reduces this one, and writes out with 16-byte
// stores.
//
// K4 sums ||x||^2 and the row's g.scale.x together (mean(g*scale*xhat) is
// inv times the latter over d), so a row takes one reduction. A thread's
// columns are the same in every row it walks, so its dscale partial stays in
// registers (K4's 128 registers leave no room to load a whole next row; the
// first row's loads go out before scale is staged). Scale sits in shared
// memory during the walk, in planes of float4 (plane j holds values 4j..4j+3
// of every vector) so that a lane's 16-byte reads of it are free of bank
// conflicts. At the end the groups' partials go to shared memory and the
// block adds them per column in group order into one (d,) partial.
// rmsnorm_dscale_combine_kernel, launched as a programmatic dependent launch
// so that it is resident when the row kernel ends, sums the blocks' partials
// 32 columns a block by 32 warps: each warp a fixed contiguous range of
// partials, lanes on neighbouring columns, then the 32 warp sums in order.
// The number of partials and the order of every addition depend on the
// plan alone, so dscale is the same bits from run to run, as the TPU
// kernel's sequential (1, d) accumulator is. The plan is a function of
// (rows, d, dtype) and of the body, which the pointers' alignment picks: the
// same values at another storage offset may take the scalar body, another
// grid and another order, and then dscale's last bits differ.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;          // 16 warps: row groups of a block
constexpr int kMaxWarps = kMaxThreads / 32;

// One slot of a thread's row: VEC consecutive values, loaded and stored as
// one 16-byte access (VEC 8 of bf16, 4 of f32) or one scalar access (VEC 1).
template <typename T, int VEC> struct Pack;
template <> struct Pack<__nv_bfloat16, 8> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float get(int k) const {
    const uint32_t w = (&u.x)[k / 2];
    return __uint_as_float(k % 2 ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * j])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * j + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Pack<float, 4> {
  float4 u;
  __device__ __forceinline__ void load(const float* p) {
    u = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float get(int k) const { return (&u.x)[k]; }
  __device__ __forceinline__ static void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Pack<__nv_bfloat16, 1> {
  __nv_bfloat16 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = p[0]; }
  __device__ __forceinline__ float get(int) const { return __bfloat162float(u); }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&f)[1]) {
    p[0] = __float2bfloat16(f[0]);  // round to nearest even, as XLA's convert
  }
};
template <> struct Pack<float, 1> {
  float u;
  __device__ __forceinline__ void load(const float* p) { u = __ldg(p); }
  __device__ __forceinline__ float get(int) const { return u; }
  __device__ __forceinline__ static void store(float* p, const float (&f)[1]) { p[0] = f[0]; }
};

// Barrier `id` (1..15) of `n` threads: one row group's warps, not the block's.
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Programmatic dependent launch: the row kernel lets the combine after it be
// scheduled; the combine waits in griddep_wait() until the row kernel has
// finished and its writes are visible.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // the same bits in every lane: each level adds equal pairs
}

// Where a thread sits: row group `group` of the block (`gid` of the grid's
// `groups`), lane `lane` of warp `warp`; its slot i starts at value c0 +
// i*kStep of a row, and the slots below `slots` lie inside the row.
template <int VEC, int NV>
struct Place {
  static constexpr int kStep = 32 * VEC;
  int lane, warp, group, gid, groups, c0, slots;
  __device__ __forceinline__ Place(int wpr, int d) {
    lane = threadIdx.x % 32;
    warp = threadIdx.x / 32;
    group = warp / wpr;
    const int per_block = blockDim.x / (32 * wpr);
    gid = blockIdx.x * per_block + group;
    groups = gridDim.x * per_block;
    c0 = ((warp % wpr) * 32 * NV + lane) * VEC;
    slots = c0 < d ? min(NV, (d - c0 + kStep - 1) / kStep) : 0;
  }
};

// A thread's slots of row r of a (rows, d) array.
template <typename T, int VEC, int NV>
__device__ __forceinline__ void load_row(Pack<T, VEC> (&v)[NV], const T* a, int r, int d,
                                         const Place<VEC, NV>& p) {
  const T* src = a + (long)r * d + p.c0;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < p.slots) v[i].load(src + i * Place<VEC, NV>::kStep);
}

// The group's warps' sums of v (warp sums already), added in warp order; the
// same value in every thread of the group. red: [2][kMaxWarps] of V; parity
// alternates between calls, so that one barrier a call keeps a fast warp's
// next write off a slow warp's read.
template <typename V, int VEC, int NV>
__device__ __forceinline__ V group_sum(V v, V (*red)[kMaxWarps], const Place<VEC, NV>& p,
                                       int wpr, int parity) {
  if (wpr == 1) return v;
  if (p.lane == 0) red[parity][p.warp] = v;
  named_barrier(p.group + 1, wpr * 32);
  const V* r = red[parity] + p.group * wpr;
  V s = r[0];
  for (int j = 1; j < wpr; ++j) s += r[j];
  return s;
}

struct Sums {
  float ss, dot;
  __device__ __forceinline__ Sums& operator+=(const Sums& o) {
    ss += o.ss;
    dot += o.dot;
    return *this;
  }
};

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int rows, int d, int wpr, float eps) {
  constexpr int kStep = Place<VEC, NV>::kStep;
  __shared__ float red[2][kMaxWarps];
  const Place<VEC, NV> p(wpr, d);
  Pack<T, VEC> v[NV];
  if (p.gid < rows) load_row(v, x, p.gid, d, p);
  float s[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i >= p.slots) continue;
    const float* src = scale + p.c0 + i * kStep;
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(src) + j);
        s[i][4 * j] = t.x;
        s[i][4 * j + 1] = t.y;
        s[i][4 * j + 2] = t.z;
        s[i][4 * j + 3] = t.w;
      }
    } else {
      s[i][0] = __ldg(src);
    }
  }
  int parity = 0;
  for (int r = p.gid; r < rows; r += p.groups, parity ^= 1) {
    Pack<T, VEC> nx[NV];  // the next row, in flight while this one is reduced
    if (r + p.groups < rows) load_row(nx, x, r + p.groups, d, p);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i >= p.slots) continue;
#pragma unroll
      for (int k = 0; k < VEC; ++k) ss += v[i].get(k) * v[i].get(k);
    }
    ss = group_sum(warp_sum(ss), red, p, wpr, parity);
    const float inv = rsqrtf(ss / (float)d + eps);
    T* dst = out + (long)r * d + p.c0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i >= p.slots) continue;
      float o[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) o[k] = v[i].get(k) * inv * s[i][k];
      Pack<T, VEC>::store(dst + i * kStep, o);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = nx[i];
  }
}

// Scale in K4's shared memory. The 16-byte bodies keep it in VEC/4 planes of
// float4, plane j holding values 4j..4j+3 of every vector, so that lanes on
// neighbouring vectors read neighbouring 16 bytes; the scalar body keeps d
// floats as they are.
template <int VEC>
struct ScaleSmem {
  static constexpr int kPlanes = VEC / 4;
  __device__ __forceinline__ static void fill(float* sm, const float* scale, int d) {
    if constexpr (VEC % 4 == 0) {
      const int nvec = d / VEC;
      float4* s4 = reinterpret_cast<float4*>(sm);
      const float4* src = reinterpret_cast<const float4*>(scale);
      for (int f = threadIdx.x; f < d / 4; f += blockDim.x)
        s4[(f % kPlanes) * nvec + f / kPlanes] = __ldg(src + f);
    } else {
      for (int c = threadIdx.x; c < d; c += blockDim.x) sm[c] = __ldg(scale + c);
    }
  }
  // values c .. c+VEC-1 (c a multiple of VEC)
  __device__ __forceinline__ static void get(const float* sm, int c, int d, float (&f)[VEC]) {
    if constexpr (VEC % 4 == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(sm) + c / VEC;
#pragma unroll
      for (int j = 0; j < kPlanes; ++j) {
        const float4 t = s4[j * (d / VEC)];
        f[4 * j] = t.x;
        f[4 * j + 1] = t.y;
        f[4 * j + 2] = t.z;
        f[4 * j + 3] = t.w;
      }
    } else {
      f[0] = sm[c];
    }
  }
};

// Dynamic shared memory: per_block * d floats, scale during the walk, then
// each group's dscale partial (d floats each), added per column in group
// order into partial[blockIdx.x].
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ partial, int rows, int d, int wpr, float eps) {
  constexpr int kStep = Place<VEC, NV>::kStep;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ Sums red[2][kMaxWarps];
  const Place<VEC, NV> p(wpr, d);
  Pack<T, VEC> xv[NV], gv[NV];
  if (p.gid < rows) {  // the first row's loads go out before scale is staged
    load_row(xv, x, p.gid, d, p);
    load_row(gv, g, p.gid, d, p);
  }
  ScaleSmem<VEC>::fill(sm, scale, d);
  __syncthreads();
  float acc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[i][k] = 0.f;
  int parity = 0;
  for (int r = p.gid; r < rows; r += p.groups, parity ^= 1) {
    if (r != p.gid) {
      load_row(xv, x, r, d, p);
      load_row(gv, g, r, d, p);
    }
    Sums t{0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i >= p.slots) continue;
      float si[VEC];
      ScaleSmem<VEC>::get(sm, p.c0 + i * kStep, d, si);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xf = xv[i].get(k);
        t.ss += xf * xf;
        t.dot += gv[i].get(k) * si[k] * xf;
      }
    }
    t.ss = warp_sum(t.ss);
    t.dot = warp_sum(t.dot);
    t = group_sum(t, red, p, wpr, parity);
    const float inv = rsqrtf(t.ss / (float)d + eps);
    const float rowmean = inv * t.dot / (float)d;
    T* dst = dx + (long)r * d + p.c0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i >= p.slots) continue;
      float si[VEC];
      ScaleSmem<VEC>::get(sm, p.c0 + i * kStep, d, si);
      float o[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xhat = xv[i].get(k) * inv;
        const float gf = gv[i].get(k);
        o[k] = inv * (gf * si[k] - xhat * rowmean);
        acc[i][k] += gf * xhat;
      }
      Pack<T, VEC>::store(dst + i * kStep, o);
    }
  }
  __syncthreads();  // scale's last read is done: sm takes the groups' partials
  float* mine = sm + p.group * d + p.c0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i >= p.slots) continue;
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j)
        reinterpret_cast<float4*>(mine + i * kStep)[j] =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
    } else {
      mine[i * kStep] = acc[i][0];
    }
  }
  __syncthreads();
  const int per_block = blockDim.x / (32 * wpr);
  float* dst = partial + (long)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float t = sm[c];
    for (int q = 1; q < per_block; ++q) t += sm[q * d + c];
    dst[c] = t;
  }
  griddep_launch_dependents();
}

constexpr int kCombineWarps = 32;

// dscale[c] = sum over b of partial[b, c]: warp w adds partials [w*per,
// (w+1)*per) in order, then warp 0 adds the 32 warp sums in order.
__global__ void __launch_bounds__(kCombineWarps * 32)
rmsnorm_dscale_combine_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                              int parts, int d) {
  __shared__ float red[kCombineWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const int per = (parts + kCombineWarps - 1) / kCombineWarps;
  const int b1 = min(parts, (warp + 1) * per);
  griddep_wait();
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int b = warp * per; b < b1; ++b) s += partial[(long)b * d + c];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = red[0][lane];
#pragma unroll
    for (int w = 1; w < kCombineWarps; ++w) t += red[w][lane];
    dscale[c] = t;
  }
}

// The launch plan, from cuda.py's `plan`: the body (vec 1 scalar, else 16
// bytes), NV slots a lane, wpr warps a row, `per_block` rows a block and
// `blocks` blocks.
struct Plan {
  int vec, nv, wpr, per_block, blocks;
};

template <typename T, int VEC, int NV>
int fwd_body(const void* x, const void* scale, void* out, int rows, int d, float eps,
             const Plan& pl, cudaStream_t stream) {
  rmsnorm_fwd_kernel<T, VEC, NV><<<pl.blocks, 32 * pl.wpr * pl.per_block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out),
      rows, d, pl.wpr, eps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int NV>
int bwd_body(const void* x, const void* scale, const void* g, void* dx, void* partial,
             void* dscale, int rows, int d, float eps, const Plan& pl, cudaStream_t stream) {
  auto kernel = rmsnorm_bwd_kernel<T, VEC, NV>;
  // up to 48 KB of partials (plan's widest rows) beside the static sums
  static const cudaError_t opted =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 64 * 1024);
  if (opted != cudaSuccess) return (int)opted;
  kernel<<<pl.blocks, 32 * pl.wpr * pl.per_block, (size_t)pl.per_block * d * sizeof(float),
           stream>>>(static_cast<const T*>(x), static_cast<const float*>(scale),
                     static_cast<const T*>(g), static_cast<T*>(dx),
                     static_cast<float*>(partial), rows, d, pl.wpr, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the combine, scheduled while the row kernel ends
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((d + 31) / 32));
  cfg.blockDim = dim3(kCombineWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, rmsnorm_dscale_combine_kernel,
                                 static_cast<const float*>(partial),
                                 static_cast<float*>(dscale), pl.blocks, d);
}

// The compiled bodies: bf16 16-byte NV 1..5, f32 16-byte NV 1..6, scalar NV
// 24 (cuda.py's NV_MAX and SCALAR_NV). F(T, VEC, NV) is called for the
// plan's one.
#define RMSNORM_DISPATCH(T, pl, F)                                              \
  {                                                                             \
    constexpr int V16 = 16 / (int)sizeof(T);                                    \
    if ((pl).vec == V16) {                                                      \
      switch ((pl).nv) {                                                        \
        case 1: return F(T, V16, 1);                                            \
        case 2: return F(T, V16, 2);                                            \
        case 3: return F(T, V16, 3);                                            \
        case 4: return F(T, V16, 4);                                            \
        case 5: return F(T, V16, 5);                                            \
        case 6: if constexpr (V16 == 4) return F(T, V16, 6); break;             \
      }                                                                         \
    } else if ((pl).vec == 1 && (pl).nv == 24) {                                \
      return F(T, 1, 24);                                                       \
    }                                                                           \
    return (int)cudaErrorInvalidValue;                                          \
  }

template <typename T>
int launch_fwd(const void* x, const void* scale, void* out, int rows, int d, float eps,
               const Plan& pl, cudaStream_t s) {
#define RN_FWD(TT, V, N) fwd_body<TT, V, N>(x, scale, out, rows, d, eps, pl, s)
  RMSNORM_DISPATCH(T, pl, RN_FWD);
#undef RN_FWD
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* g, void* dx, void* partial,
               void* dscale, int rows, int d, float eps, const Plan& pl, cudaStream_t s) {
#define RN_BWD(TT, V, N) \
  bwd_body<TT, V, N>(x, scale, g, dx, partial, dscale, rows, d, eps, pl, s)
  RMSNORM_DISPATCH(T, pl, RN_BWD);
#undef RN_BWD
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, out, g, dx); scale and dscale are f32.
// (vec, nv, wpr, per_block, blocks) is cuda.py's launch plan; a plan with no
// compiled body returns cudaErrorInvalidValue. Each returns
// cudaGetLastError() after its launches.
int rmsnorm_fwd(const void* x, const void* scale, void* out, int rows, int d, float eps,
                int dtype, int vec, int nv, int wpr, int per_block, int blocks,
                void* stream) {
  const Plan pl{vec, nv, wpr, per_block, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, scale, out, rows, d, eps, pl, s);
  return launch_fwd<float>(x, scale, out, rows, d, eps, pl, s);
}

// partial: (blocks, d) f32 scratch, one row per block of the row kernel.
int rmsnorm_bwd(const void* x, const void* scale, const void* g, void* dx, void* partial,
                void* dscale, int rows, int d, float eps, int dtype, int vec, int nv,
                int wpr, int per_block, int blocks, void* stream) {
  const Plan pl{vec, nv, wpr, per_block, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, scale, g, dx, partial, dscale, rows, d, eps, pl, s);
  return launch_bwd<float>(x, scale, g, dx, partial, dscale, rows, d, eps, pl, s);
}

}  // extern "C"
