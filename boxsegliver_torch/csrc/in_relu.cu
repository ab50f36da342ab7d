// Kernel B2: fused instance-norm + ReLU for Hopper, forward and backward.
//
// Replaces the Pallas TPU kernels of boxsegliver_tpu/ops/pallas_kernels.py:
//   B2a  _bwd_stats_kernel (:60-75, call :114-122):
//          gz = g * [x_hat * gamma + beta > 0];  s1 = sum_hw gz;  s2 = sum_hw gz * x_hat
//   B2b  _bwd_apply_kernel (:78-88, call :124-132):
//          dx = gamma * rstd * (gz - s1 / HW - x_hat * s2 / HW)
// and the forward of the same custom VJP, _in_relu_fwd_impl (:47-57), which
// is plain XLA there ("B2-fwd"):
//   mean, var over (h, w) per (b, c) (E[x^2] - E[x]^2 clipped at 0, as flax's
//   instance norm), rstd = rsqrt(var + eps), x_hat = (x - mean) * rstd,
//   y = relu(x_hat * gamma + beta); y and x_hat in the input dtype, rstd f32.
//
// Layout: NCHW, so each (b, c) plane of H * W elements is contiguous.  The
// TPU kernels tile h because Mosaic needs the lane dimension (C) whole; here
// one CTA owns one plane and a loop inside the block takes the place of the
// TPU's sequential h grid.  Loads and stores are 16 bytes a thread (8 bf16 or
// 4 f32) when the plane length and the pointers allow it, one element
// otherwise; sums are f32, reduced with warp shuffles and shared memory.
//
// Bound on the H100 (3.35 TB/s HBM3): all three kernels do a few flops per
// byte, far below the ~295 flops/byte where compute would bind, so bytes
// bind them.  bf16, per element: the forward's floor is 6 B (read x once,
// write y and x_hat) but it reads x twice (stats pass, then normalize pass),
// 8 B moved; B2a reads g and x_hat (4 B); B2b reads g and x_hat and writes dx
// (6 B).  At the largest flagship launch, [8, 64, 256, 256] bf16 (33.6 M
// elements), the floors are 0.060 ms (fwd), 0.040 ms (B2a) and 0.060 ms
// (B2b); chip_smoke.py phase 7 measured 0.100, 0.050 and 0.075 ms there
// (H100 80GB HBM3, 700 W).  Over one train step's 10 pairs (193 M elements)
// the floors are 0.35 / 0.23 / 0.35 ms.  The small-plane launches
// ([8, 512, 32, 32]: 4096 planes of 1024 elements) run at 5-7x their floor:
// one 256-thread CTA per plane is latency-bound there.  Staging the plane in
// shared memory (a 256^2 bf16 plane is 128 KiB) would bring the forward to
// its 6 B floor, and a warp per small plane would cut the latency; both are
// left for a later change.
//
// Rounding: the elementwise arithmetic uses explicitly rounded intrinsics so
// that nvcc contracts nothing into FMAs and each element follows the plain
// PyTorch version (ops/kernels.in_relu_*_plain) operation by operation; the
// order of the per-plane sums differs, and rsqrtf is within 2 ulp of
// torch.rsqrt (the tolerances of chip_smoke.b2_check).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Sum of (a, b) over the block; the result is valid in every thread.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps], sb[kWarps];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  a = lane < kWarps ? sa[lane] : 0.0f;
  b = lane < kWarps ? sb[lane] : 0.0f;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

template <typename T, int N>
__global__ void in_relu_fwd_kernel(const T* __restrict__ x,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta, T* __restrict__ y,
                           T* __restrict__ xhat, float* __restrict__ rstd_out,
                           int channels, int hw, float eps) {
  const int64_t plane = blockIdx.x;
  const int c = (int)(plane % channels);
  const int64_t base = plane * hw;
  const Pack<T, N>* xp = reinterpret_cast<const Pack<T, N>*>(x + base);
  const int groups = hw / N;

  float s = 0.0f, ss = 0.0f;
  for (int i = threadIdx.x; i < groups; i += kThreads) {
    const Pack<T, N> p = xp[i];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float v = to_f(p.v[k]);
      s = __fadd_rn(s, v);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
  }
  block_sum2(s, ss);
  const float inv_hw = __fdiv_rn(1.0f, (float)hw);
  const float mean = __fmul_rn(s, inv_hw);
  const float var =
      fmaxf(__fsub_rn(__fmul_rn(ss, inv_hw), __fmul_rn(mean, mean)), 0.0f);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  if (threadIdx.x == 0) rstd_out[plane] = rstd;
  const float gm = gamma[c], bt = beta[c];

  Pack<T, N>* yp = reinterpret_cast<Pack<T, N>*>(y + base);
  Pack<T, N>* hp = reinterpret_cast<Pack<T, N>*>(xhat + base);
  for (int i = threadIdx.x; i < groups; i += kThreads) {
    const Pack<T, N> p = xp[i];
    Pack<T, N> po, ph;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float h = __fmul_rn(__fsub_rn(to_f(p.v[k]), mean), rstd);
      const float z = __fadd_rn(__fmul_rn(h, gm), bt);
      po.v[k] = from_f<T>(fmaxf(z, 0.0f));
      ph.v[k] = from_f<T>(h);
    }
    yp[i] = po;
    hp[i] = ph;
  }
}

template <typename T, int N>
__global__ void in_relu_bwd_stats_kernel(const T* __restrict__ g,
                                 const T* __restrict__ xhat,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta,
                                 float* __restrict__ s1_out,
                                 float* __restrict__ s2_out, int channels,
                                 int hw) {
  const int64_t plane = blockIdx.x;
  const int c = (int)(plane % channels);
  const int64_t base = plane * hw;
  const Pack<T, N>* gp = reinterpret_cast<const Pack<T, N>*>(g + base);
  const Pack<T, N>* hp = reinterpret_cast<const Pack<T, N>*>(xhat + base);
  const int groups = hw / N;
  const float gm = gamma[c], bt = beta[c];

  float s1 = 0.0f, s2 = 0.0f;
  for (int i = threadIdx.x; i < groups; i += kThreads) {
    const Pack<T, N> pg = gp[i];
    const Pack<T, N> ph = hp[i];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float h = to_f(ph.v[k]);
      const float z = __fadd_rn(__fmul_rn(h, gm), bt);
      const float gz = z > 0.0f ? to_f(pg.v[k]) : 0.0f;
      s1 = __fadd_rn(s1, gz);
      s2 = __fadd_rn(s2, __fmul_rn(gz, h));
    }
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    s1_out[plane] = s1;
    s2_out[plane] = s2;
  }
}

template <typename T, int N>
__global__ void in_relu_bwd_apply_kernel(const T* __restrict__ g,
                                 const T* __restrict__ xhat,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta,
                                 const float* __restrict__ rstd,
                                 const float* __restrict__ s1,
                                 const float* __restrict__ s2,
                                 T* __restrict__ dx, int channels, int hw) {
  const int64_t plane = blockIdx.x;
  const int c = (int)(plane % channels);
  const int64_t base = plane * hw;
  const Pack<T, N>* gp = reinterpret_cast<const Pack<T, N>*>(g + base);
  const Pack<T, N>* hp = reinterpret_cast<const Pack<T, N>*>(xhat + base);
  Pack<T, N>* dp = reinterpret_cast<Pack<T, N>*>(dx + base);
  const int groups = hw / N;
  const float gm = gamma[c], bt = beta[c];
  const float inv_hw = __fdiv_rn(1.0f, (float)hw);
  const float m1 = __fmul_rn(s1[plane], inv_hw);
  const float m2 = __fmul_rn(s2[plane], inv_hw);
  const float coef = __fmul_rn(gm, rstd[plane]);

  for (int i = threadIdx.x; i < groups; i += kThreads) {
    const Pack<T, N> pg = gp[i];
    const Pack<T, N> ph = hp[i];
    Pack<T, N> out;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float h = to_f(ph.v[k]);
      const float z = __fadd_rn(__fmul_rn(h, gm), bt);
      const float gz = z > 0.0f ? to_f(pg.v[k]) : 0.0f;
      const float d = __fsub_rn(__fsub_rn(gz, m1), __fmul_rn(h, m2));
      out.v[k] = from_f<T>(__fmul_rn(coef, d));
    }
    dp[i] = out;
  }
}

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// 16-byte packs when every plane starts 16-byte aligned, else one element.
template <typename T>
bool vec_ok(int hw, const void* const* ptrs, int n) {
  constexpr int N = 16 / sizeof(T);
  if (hw % N) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

template <typename T>
int launch_fwd(const void* x, const float* gm, const float* bt, void* y,
               void* xh, float* rstd, int planes, int channels, int hw,
               float eps, cudaStream_t st) {
  const void* ptrs[] = {x, y, xh};
  constexpr int N = 16 / sizeof(T);
  if (vec_ok<T>(hw, ptrs, 3))
    in_relu_fwd_kernel<T, N><<<planes, kThreads, 0, st>>>(
        (const T*)x, gm, bt, (T*)y, (T*)xh, rstd, channels, hw, eps);
  else
    in_relu_fwd_kernel<T, 1><<<planes, kThreads, 0, st>>>(
        (const T*)x, gm, bt, (T*)y, (T*)xh, rstd, channels, hw, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stats(const void* g, const void* xh, const float* gm,
                 const float* bt, float* s1, float* s2, int planes,
                 int channels, int hw, cudaStream_t st) {
  const void* ptrs[] = {g, xh};
  constexpr int N = 16 / sizeof(T);
  if (vec_ok<T>(hw, ptrs, 2))
    in_relu_bwd_stats_kernel<T, N><<<planes, kThreads, 0, st>>>(
        (const T*)g, (const T*)xh, gm, bt, s1, s2, channels, hw);
  else
    in_relu_bwd_stats_kernel<T, 1><<<planes, kThreads, 0, st>>>(
        (const T*)g, (const T*)xh, gm, bt, s1, s2, channels, hw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* g, const void* xh, const float* gm,
                 const float* bt, const float* rstd, const float* s1,
                 const float* s2, void* dx, int planes, int channels, int hw,
                 cudaStream_t st) {
  const void* ptrs[] = {g, xh, dx};
  constexpr int N = 16 / sizeof(T);
  if (vec_ok<T>(hw, ptrs, 3))
    in_relu_bwd_apply_kernel<T, N><<<planes, kThreads, 0, st>>>(
        (const T*)g, (const T*)xh, gm, bt, rstd, s1, s2, (T*)dx, channels, hw);
  else
    in_relu_bwd_apply_kernel<T, 1><<<planes, kThreads, 0, st>>>(
        (const T*)g, (const T*)xh, gm, bt, rstd, s1, s2, (T*)dx, channels, hw);
  return (int)cudaGetLastError();
}

}  // namespace

// All tensors are contiguous NCHW; planes = N * C, hw = H * W; gamma, beta:
// [C] f32; rstd, s1, s2: [N * C] f32; x, y, x_hat, g, dx in `dtype`
// (0 = float32, 1 = bfloat16).  Each function launches on `stream` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// an unknown dtype.
extern "C" int in_relu_fwd(const void* x, const void* gamma, const void* beta,
                           void* y, void* xhat, void* rstd, int planes,
                           int channels, int hw, float eps, int dtype,
                           void* stream) {
  if (planes == 0 || hw == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_fwd<float>(x, (const float*)gamma, (const float*)beta, y,
                             xhat, (float*)rstd, planes, channels, hw, eps,
                             st);
  if (dtype == kBF16)
    return launch_fwd<__nv_bfloat16>(x, (const float*)gamma,
                                     (const float*)beta, y, xhat,
                                     (float*)rstd, planes, channels, hw, eps,
                                     st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int in_relu_bwd_stats(const void* g, const void* xhat,
                                 const void* gamma, const void* beta,
                                 void* s1, void* s2, int planes, int channels,
                                 int hw, int dtype, void* stream) {
  if (planes == 0 || hw == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_stats<float>(g, xhat, (const float*)gamma,
                               (const float*)beta, (float*)s1, (float*)s2,
                               planes, channels, hw, st);
  if (dtype == kBF16)
    return launch_stats<__nv_bfloat16>(g, xhat, (const float*)gamma,
                                       (const float*)beta, (float*)s1,
                                       (float*)s2, planes, channels, hw, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int in_relu_bwd_apply(const void* g, const void* xhat,
                                 const void* gamma, const void* beta,
                                 const void* rstd, const void* s1,
                                 const void* s2, void* dx, int planes,
                                 int channels, int hw, int dtype,
                                 void* stream) {
  if (planes == 0 || hw == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_apply<float>(g, xhat, (const float*)gamma,
                               (const float*)beta, (const float*)rstd,
                               (const float*)s1, (const float*)s2, dx, planes,
                               channels, hw, st);
  if (dtype == kBF16)
    return launch_apply<__nv_bfloat16>(
        g, xhat, (const float*)gamma, (const float*)beta, (const float*)rstd,
        (const float*)s1, (const float*)s2, dx, planes, channels, hw, st);
  return (int)cudaErrorInvalidValue;
}
