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
// the plane is the unit of work and a loop inside the block takes the place
// of the TPU's sequential h grid.  Loads and stores are 16 bytes a thread (8
// bf16 or 4 f32) when the plane length and the pointers allow it.
//
// Bound on the H100 (3.35 TB/s HBM3): all three kernels do a few flops per
// byte, far below the ~295 flops/byte where compute would bind, so bytes
// bind them.  Floors per element in bf16 (f32 doubles them): the forward
// reads x and writes y and x_hat, 6 B; B2a reads g and x_hat, 4 B; B2b reads
// g and x_hat and writes dx, 6 B.
//
// B2-fwd has three paths, chosen before launch from the shape, the dtype and
// the pointers' alignment by the launch plan in ops/kernels.in_relu_fwd_plan
// (the launcher below only checks that the plan fits):
//   warp    planes of at most 32 lanes * 8 packs (2,048 bf16 / 1,024 f32: the
//           32^2 level).  One warp owns a plane, eight planes per CTA; each
//           lane keeps its packs in registers, the sums are warp shuffles
//           only, and it normalizes from registers: x is read once, 6 B per
//           bf16 element moved.
//   staged  larger planes of 16-byte packs.  The plane is split across a
//           thread-block cluster of 1, 2, 4 or 8 CTAs, the fewest whose
//           chunks fit 64 KiB (64^2 and 128^2: one CTA; 256^2: two; 512^2:
//           eight), so three or more CTAs are resident per SM and one CTA's
//           loads overlap another's stores.  Each CTA fills shared memory
//           with asynchronous bulk copies (cp.async.bulk, completed on an
//           mbarrier), sums its chunk, and the CTAs of a cluster exchange
//           their partial (sum x, sum x^2) through distributed shared memory
//           in rank order, so every CTA of the plane gets the same statistics
//           with no atomics.  It normalizes from shared memory: x is read
//           once, 6 B per bf16 element moved.
//   general odd or unaligned planes and planes too large to stage (512^2
//           f32): one 256-thread CTA per plane reads x twice, once for the
//           sums and once to normalize, 8 B per bf16 element moved.
// B2a and B2b run one 256-thread CTA per plane; at the flagship shapes their
// device time is within 1.3x of the floor, so they keep that design.
//
// B2-fwd split around a collective, for planes whose elements lie on several
// ranks (the spatially sharded evals; in JAX, XLA's partitioner turns the
// forward's statistics into partial sums and an all-reduce).  Inference
// only: no x_hat, no VJP.
//   B2s  in_relu_fwd_partial: (sum x, sum x^2) in f32 over the rank's part of
//        each plane.  Reads x once: |x| / 3.35 TB/s bounds it.  A plane is
//        spread over `splits` CTAs (ops/kernels.in_relu_partial_plan: about
//        1,024 CTAs in all, so the 3-D eval's 30 planes fill 132 SMs); each
//        writes its partial, and a second one-thread-a-plane pass adds them
//        in split order, so the result is the same from run to run.
//   B2y  in_relu_fwd_apply: y = relu((x - mean) * rstd * gamma + beta) from
//        the all-reduced mean and rstd.  Reads x once and writes y once:
//        2 |x| / 3.35 TB/s bounds it.  CTAs tile a plane in a 2-D grid (x:
//        chunks of the plane, y: planes), so no thread divides an index.
//
// Rounding: the elementwise arithmetic uses explicitly rounded intrinsics so
// that nvcc contracts nothing into FMAs and each element follows the plain
// PyTorch version (ops/kernels.in_relu_*_plain) operation by operation; the
// order of the per-plane sums differs, and rsqrtf is within 2 ulp of
// torch.rsqrt (the tolerances of chip_smoke.b2_check).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWarpPacks = 8;             // 16-byte packs a lane may hold
constexpr int kMaxStageBytes = 64 * 1024;    // a staged CTA's chunk
constexpr int kMaxCluster = 8;               // the portable cluster limit
constexpr int kBulkPiece = 16 * 1024;        // bytes per cp.async.bulk

constexpr int kPathGeneral = 0;
constexpr int kPathWarp = 1;
constexpr int kPathStaged = 2;

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

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Sum of (a, b) over the block; the result is valid in every thread.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps], sb[kWarps];
  warp_sum2(a, b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  a = lane < kWarps ? sa[lane] : 0.0f;
  b = lane < kWarps ? sb[lane] : 0.0f;
  warp_sum2(a, b);
}

// Running (sum x, sum x^2) over one pack.
template <typename T, int N>
__device__ __forceinline__ void add_pack(const Pack<T, N>& p, float& s,
                                         float& ss) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float v = to_f(p.v[k]);
    s = __fadd_rn(s, v);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
}

// rstd from the plane's sums, flax's variance E[x^2] - E[x]^2 clipped at 0.
__device__ __forceinline__ float plane_rstd(float s, float ss, int hw,
                                            float eps, float& mean) {
  const float inv_hw = __fdiv_rn(1.0f, (float)hw);
  mean = __fmul_rn(s, inv_hw);
  const float var =
      fmaxf(__fsub_rn(__fmul_rn(ss, inv_hw), __fmul_rn(mean, mean)), 0.0f);
  return rsqrtf(__fadd_rn(var, eps));
}

// y and x_hat of one pack.
template <typename T, int N>
__device__ __forceinline__ void norm_pack(const Pack<T, N>& p, float mean,
                                          float rstd, float gm, float bt,
                                          Pack<T, N>& po, Pack<T, N>& ph) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float h = __fmul_rn(__fsub_rn(to_f(p.v[k]), mean), rstd);
    const float z = __fadd_rn(__fmul_rn(h, gm), bt);
    po.v[k] = from_f<T>(fmaxf(z, 0.0f));
    ph.v[k] = from_f<T>(h);
  }
}

// General path: one CTA per plane, x read twice.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    in_relu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, T* __restrict__ y,
                       T* __restrict__ xhat, float* __restrict__ rstd_out,
                       int channels, int hw, float eps) {
  const int64_t plane = blockIdx.x;
  const int c = (int)(plane % channels);
  const int64_t base = plane * hw;
  const Pack<T, N>* xp = reinterpret_cast<const Pack<T, N>*>(x + base);
  const int groups = hw / N;

  float s = 0.0f, ss = 0.0f;
  for (int i = threadIdx.x; i < groups; i += kThreads) add_pack(xp[i], s, ss);
  block_sum2(s, ss);
  float mean;
  const float rstd = plane_rstd(s, ss, hw, eps, mean);
  if (threadIdx.x == 0) rstd_out[plane] = rstd;
  const float gm = gamma[c], bt = beta[c];

  Pack<T, N>* yp = reinterpret_cast<Pack<T, N>*>(y + base);
  Pack<T, N>* hp = reinterpret_cast<Pack<T, N>*>(xhat + base);
  for (int i = threadIdx.x; i < groups; i += kThreads) {
    Pack<T, N> po, ph;
    norm_pack(xp[i], mean, rstd, gm, bt, po, ph);
    yp[i] = po;
    hp[i] = ph;
  }
}

// Warp path: one warp per plane, the plane in registers (P packs a lane).
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    in_relu_fwd_warp_kernel(const T* __restrict__ x,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta, T* __restrict__ y,
                            T* __restrict__ xhat, float* __restrict__ rstd_out,
                            int planes, int channels, int hw, float eps) {
  constexpr int N = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int64_t plane = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (plane >= planes) return;
  const int c = (int)(plane % channels);
  const int64_t base = plane * hw;
  const Pack<T, N>* xp = reinterpret_cast<const Pack<T, N>*>(x + base);
  const int groups = hw / N;

  Pack<T, N> p[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = lane + 32 * i;
    if (j < groups) {
      p[i] = xp[j];
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) p[i].v[k] = from_f<T>(0.0f);
    }
  }
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) add_pack(p[i], s, ss);
  warp_sum2(s, ss);
  float mean;
  const float rstd = plane_rstd(s, ss, hw, eps, mean);
  if (lane == 0) rstd_out[plane] = rstd;
  const float gm = gamma[c], bt = beta[c];

  Pack<T, N>* yp = reinterpret_cast<Pack<T, N>*>(y + base);
  Pack<T, N>* hp = reinterpret_cast<Pack<T, N>*>(xhat + base);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = lane + 32 * i;
    if (j < groups) {
      Pack<T, N> po, ph;
      norm_pack(p[i], mean, rstd, gm, bt, po, ph);
      yp[j] = po;
      hp[j] = ph;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Staged path: a cluster of `cs` CTAs per plane, CTA `rank` holding chunk
// `rank` (hw / cs elements) in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    in_relu_fwd_staged_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              T* __restrict__ y, T* __restrict__ xhat,
                              float* __restrict__ rstd_out, int channels,
                              int hw, int cs, float eps) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full;
  __shared__ float partial[2];

  const int rank = (int)(blockIdx.x % cs);
  const int64_t plane = blockIdx.x / cs;
  const int c = (int)(plane % channels);
  const int chunk = hw / cs;
  const int64_t base = plane * hw + (int64_t)rank * chunk;
  const uint32_t bytes = (uint32_t)chunk * sizeof(T);
  const uint32_t bar = smem_addr(&full);

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(bar),
                 "r"(bytes)
                 : "memory");
    const char* src = reinterpret_cast<const char*>(x + base);
    const uint32_t dst = smem_addr(stage);
    for (uint32_t off = 0; off < bytes; off += kBulkPiece) {
      const uint32_t n = bytes - off < kBulkPiece ? bytes - off : kBulkPiece;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(dst + off),
          "l"(src + off), "r"(n), "r"(bar)
          : "memory");
    }
  }
  __syncthreads();                       // the barrier is initialised
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar) : "memory");
  }

  const Pack<T, N>* sp = reinterpret_cast<const Pack<T, N>*>(stage);
  const int groups = chunk / N;
  float s = 0.0f, ss = 0.0f;
  for (int i = threadIdx.x; i < groups; i += kThreads) add_pack(sp[i], s, ss);
  block_sum2(s, ss);
  if (cs > 1) {
    // partial sums of every CTA of the cluster, added in rank order
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      partial[0] = s;
      partial[1] = ss;
    }
    cluster.sync();
    s = 0.0f;
    ss = 0.0f;
    for (int r = 0; r < cs; ++r) {
      const float* peer = cluster.map_shared_rank(partial, r);
      s = __fadd_rn(s, peer[0]);
      ss = __fadd_rn(ss, peer[1]);
    }
    // done reading the peers; the matching wait comes before exit
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  }
  float mean;
  const float rstd = plane_rstd(s, ss, hw, eps, mean);
  if (rank == 0 && threadIdx.x == 0) rstd_out[plane] = rstd;
  const float gm = gamma[c], bt = beta[c];

  Pack<T, N>* yp = reinterpret_cast<Pack<T, N>*>(y + base);
  Pack<T, N>* hp = reinterpret_cast<Pack<T, N>*>(xhat + base);
  for (int i = threadIdx.x; i < groups; i += kThreads) {
    Pack<T, N> po, ph;
    norm_pack(sp[i], mean, rstd, gm, bt, po, ph);
    yp[i] = po;
    hp[i] = ph;
  }
  // no CTA may leave while a peer still reads its partial sums
  if (cs > 1) asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    in_relu_bwd_stats_kernel(const T* __restrict__ g,
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
__global__ void __launch_bounds__(kThreads)
    in_relu_bwd_apply_kernel(const T* __restrict__ g,
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

// B2s, first pass: CTA (split, plane) sums elements [split * chunk,
// min(hw, (split + 1) * chunk)) of the plane into part[plane][split].
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    in_relu_partial_kernel(const T* __restrict__ x, float* __restrict__ part,
                           int planes, int hw, int splits, int chunk) {
  const int lo = blockIdx.x * chunk;
  const int n = min(hw - lo, chunk) / N;
  for (int64_t plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const Pack<T, N>* xp =
        reinterpret_cast<const Pack<T, N>*>(x + plane * hw + lo);
    float s = 0.0f, ss = 0.0f;
    for (int i = threadIdx.x; i < n; i += kThreads) add_pack(xp[i], s, ss);
    block_sum2(s, ss);
    if (threadIdx.x == 0) {
      float* o = part + 2 * (plane * splits + blockIdx.x);
      o[0] = s;
      o[1] = ss;
    }
    __syncthreads();                 // block_sum2's shared slots are reused
  }
}

// B2s, second pass: the splits of each plane added in order.
__global__ void __launch_bounds__(kThreads)
    in_relu_partial_combine_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int planes,
                                   int splits) {
  const int64_t plane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (plane >= planes) return;
  const float* p = part + 2 * plane * splits;
  float s = 0.0f, ss = 0.0f;
  for (int k = 0; k < splits; ++k) {
    s = __fadd_rn(s, p[2 * k]);
    ss = __fadd_rn(ss, p[2 * k + 1]);
  }
  out[2 * plane] = s;
  out[2 * plane + 1] = ss;
}

// B2y: CTA (x, y) normalizes packs x * kThreads + t (stride gridDim.x *
// kThreads) of planes y, y + gridDim.y, ...
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    in_relu_apply_kernel(const T* __restrict__ x,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y,
                         int planes, int channels, int hw) {
  const int groups = hw / N;
  for (int64_t plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const int c = (int)(plane % channels);
    const float m = mean[plane], r = rstd[plane], gm = gamma[c],
                bt = beta[c];
    const Pack<T, N>* xp = reinterpret_cast<const Pack<T, N>*>(x + plane * hw);
    Pack<T, N>* yp = reinterpret_cast<Pack<T, N>*>(y + plane * hw);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < groups;
         i += gridDim.x * kThreads) {
      const Pack<T, N> p = xp[i];
      Pack<T, N> po;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float h = __fmul_rn(__fsub_rn(to_f(p.v[k]), m), r);
        po.v[k] = from_f<T>(fmaxf(__fadd_rn(__fmul_rn(h, gm), bt), 0.0f));
      }
      yp[i] = po;
    }
  }
}

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kMaxGridY = 65535;
constexpr int kApplyPacksPerThread = 4;

// 16-byte packs when every plane starts 16-byte aligned, else one element.
template <typename T>
bool vec_ok(int hw, const void* const* ptrs, int n) {
  constexpr int N = 16 / sizeof(T);
  if (hw % N) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

template <typename T, int P>
int launch_warp(const T* x, const float* gm, const float* bt, T* y, T* xh,
                float* rstd, int planes, int channels, int hw, float eps,
                cudaStream_t st) {
  const unsigned grid = (unsigned)((planes + kWarps - 1) / kWarps);
  in_relu_fwd_warp_kernel<T, P><<<grid, kThreads, 0, st>>>(
      x, gm, bt, y, xh, rstd, planes, channels, hw, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_staged(const T* x, const float* gm, const float* bt, T* y, T* xh,
                  float* rstd, int planes, int channels, int hw, int cs,
                  int smem, float eps, cudaStream_t st) {
  static bool smem_set = false;                 // once per dtype
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        in_relu_fwd_staged_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStageBytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((int64_t)planes * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;                // one CTA: no cluster
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, in_relu_fwd_staged_kernel<T>, x, gm, bt, y, xh, rstd, channels,
      hw, cs, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* xv, const float* gm, const float* bt, void* yv,
               void* xhv, float* rstd, int planes, int channels, int hw,
               float eps, int path, int packs, int cs, int smem,
               cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const T* x = (const T*)xv;
  T* y = (T*)yv;
  T* xh = (T*)xhv;
  const void* ptrs[] = {xv, yv, xhv};
  const bool vec = vec_ok<T>(hw, ptrs, 3);
  const int bad = (int)cudaErrorInvalidValue;
  if (path == kPathWarp) {
    if (!vec || (int64_t)packs * 32 * N < hw) return bad;
#define IN_RELU_WARP(P) \
  launch_warp<T, P>(x, gm, bt, y, xh, rstd, planes, channels, hw, eps, st)
    switch (packs) {
      case 1: return IN_RELU_WARP(1);
      case 2: return IN_RELU_WARP(2);
      case 4: return IN_RELU_WARP(4);
      case kMaxWarpPacks: return IN_RELU_WARP(kMaxWarpPacks);
      default: return bad;
    }
#undef IN_RELU_WARP
  }
  if (path == kPathStaged) {
    if (!vec || cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) ||
        hw % (cs * N) || smem != (int)((int64_t)hw / cs * sizeof(T)) ||
        smem > kMaxStageBytes)
      return bad;
    return launch_staged<T>(x, gm, bt, y, xh, rstd, planes, channels, hw, cs,
                            smem, eps, st);
  }
  if (path != kPathGeneral) return bad;
  if (vec)
    in_relu_fwd_kernel<T, N><<<planes, kThreads, 0, st>>>(
        x, gm, bt, y, xh, rstd, channels, hw, eps);
  else
    in_relu_fwd_kernel<T, 1><<<planes, kThreads, 0, st>>>(
        x, gm, bt, y, xh, rstd, channels, hw, eps);
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

template <typename T>
int launch_partial(const void* x, float* part, float* out, int planes, int hw,
                   int splits, int chunk, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const void* ptrs[] = {x};
  if (splits < 1 || chunk < 1 || (int64_t)splits * chunk < hw ||
      (int64_t)(splits - 1) * chunk >= hw)
    return (int)cudaErrorInvalidValue;
  float* dst = splits > 1 ? part : out;
  const dim3 grid((unsigned)splits,
                  (unsigned)(planes < kMaxGridY ? planes : kMaxGridY));
  if (vec_ok<T>(hw, ptrs, 1) && chunk % N == 0)
    in_relu_partial_kernel<T, N><<<grid, kThreads, 0, st>>>(
        (const T*)x, dst, planes, hw, splits, chunk);
  else
    in_relu_partial_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        (const T*)x, dst, planes, hw, splits, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  in_relu_partial_combine_kernel<<<(unsigned)((planes + kThreads - 1) /
                                              kThreads),
                                   kThreads, 0, st>>>(part, out, planes,
                                                      splits);
  return (int)cudaGetLastError();
}

template <typename T, int N>
void launch_apply_n(const void* x, const float* mean, const float* rstd,
                    const float* gm, const float* bt, void* y, int planes,
                    int channels, int hw, cudaStream_t st) {
  const int groups = hw / N;
  const int per_cta = kThreads * kApplyPacksPerThread;
  const dim3 grid((unsigned)((groups + per_cta - 1) / per_cta),
                  (unsigned)(planes < kMaxGridY ? planes : kMaxGridY));
  in_relu_apply_kernel<T, N><<<grid, kThreads, 0, st>>>(
      (const T*)x, mean, rstd, gm, bt, (T*)y, planes, channels, hw);
}

template <typename T>
int launch_fwd_apply(const void* x, const float* mean, const float* rstd,
                     const float* gm, const float* bt, void* y, int planes,
                     int channels, int hw, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const void* ptrs[] = {x, y};
  if (vec_ok<T>(hw, ptrs, 2))
    launch_apply_n<T, N>(x, mean, rstd, gm, bt, y, planes, channels, hw, st);
  else
    launch_apply_n<T, 1>(x, mean, rstd, gm, bt, y, planes, channels, hw, st);
  return (int)cudaGetLastError();
}

}  // namespace

// All tensors are contiguous NCHW; planes = N * C, hw = H * W; gamma, beta:
// [C] f32; rstd, s1, s2: [N * C] f32; x, y, x_hat, g, dx in `dtype`
// (0 = float32, 1 = bfloat16).  Each function launches on `stream` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// an unknown dtype or, in in_relu_fwd, a plan that does not fit the
// operands.  in_relu_fwd's plan (ops/kernels.in_relu_fwd_plan): `path` 0
// general, 1 warp with `packs` 16-byte packs a lane (eight planes a CTA),
// 2 staged on clusters of `cluster` CTAs with `smem_bytes` of dynamic shared
// memory each.
extern "C" int in_relu_fwd(const void* x, const void* gamma, const void* beta,
                           void* y, void* xhat, void* rstd, int planes,
                           int channels, int hw, float eps, int dtype,
                           int path, int packs, int cluster, int smem_bytes,
                           void* stream) {
  if (planes == 0 || hw == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_fwd<float>(x, (const float*)gamma, (const float*)beta, y,
                             xhat, (float*)rstd, planes, channels, hw, eps,
                             path, packs, cluster, smem_bytes, st);
  if (dtype == kBF16)
    return launch_fwd<__nv_bfloat16>(x, (const float*)gamma,
                                     (const float*)beta, y, xhat,
                                     (float*)rstd, planes, channels, hw, eps,
                                     path, packs, cluster, smem_bytes, st);
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

// B2s: out [planes, 2] f32 = (sum x, sum x^2) over each plane of x (`hw`
// elements in `dtype`), covered by `splits` CTAs of `chunk` elements
// (ops/kernels.in_relu_partial_plan); with splits > 1 the CTAs write `part`
// [planes, splits, 2] f32 scratch and a second launch adds it in order.
extern "C" int in_relu_fwd_partial(const void* x, void* part, void* out,
                                   int planes, int hw, int splits, int chunk,
                                   int dtype, void* stream) {
  if (planes == 0 || hw == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_partial<float>(x, (float*)part, (float*)out, planes, hw,
                                 splits, chunk, st);
  if (dtype == kBF16)
    return launch_partial<__nv_bfloat16>(x, (float*)part, (float*)out, planes,
                                         hw, splits, chunk, st);
  return (int)cudaErrorInvalidValue;
}

// B2y: y = relu((x - mean) * rstd * gamma + beta) in `dtype`; mean, rstd
// [planes] f32, gamma, beta [channels] f32.
extern "C" int in_relu_fwd_apply(const void* x, const void* mean,
                                 const void* rstd, const void* gamma,
                                 const void* beta, void* y, int planes,
                                 int channels, int hw, int dtype,
                                 void* stream) {
  if (planes == 0 || hw == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_fwd_apply<float>(x, (const float*)mean, (const float*)rstd,
                                   (const float*)gamma, (const float*)beta, y,
                                   planes, channels, hw, st);
  if (dtype == kBF16)
    return launch_fwd_apply<__nv_bfloat16>(
        x, (const float*)mean, (const float*)rstd, (const float*)gamma,
        (const float*)beta, y, planes, channels, hw, st);
  return (int)cudaErrorInvalidValue;
}
