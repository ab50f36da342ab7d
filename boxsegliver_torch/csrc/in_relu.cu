// Kernel B2: fused instance-norm + ReLU for Hopper, forward and backward.
//
// Replaces the Pallas TPU kernels of boxsegliver_tpu/ops/pallas_kernels.py:
//   B2a  _bwd_stats_kernel (:60-75, call :114-122):
//          gz = g * [x_hat * gamma + beta > 0];  s1 = sum_hw gz;  s2 = sum_hw gz * x_hat
//   B2b  _bwd_apply_kernel (:78-88, call :124-132):
//          dx = gamma * rstd * (gz - s1 / HW - x_hat * s2 / HW)
//   B2f  both at once, the whole VJP _in_relu_bwd_pallas (:91-135) but dgamma
//        and dbeta (sums over N of s2 and s1), where a plane fits on chip
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
// Bound on the H100 (3.35 TB/s HBM3): every kernel here does a few flops
// per byte, far below the ~295 flops/byte where compute would bind, so
// bytes bind them.  Floors per element in bf16 (f32 doubles them): the
// forward reads x and writes y and x_hat, 6 B; the backward as one function
// reads g and x_hat and writes dx, 6 B.
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
//
// The backward (the VJP _in_relu_bwd_pallas, pallas_kernels.py:91-135) has
// three paths, chosen by ops/kernels.in_relu_bwd_plan.  The TPU split it in
// two kernels only because Mosaic would not hold a plane; Hopper can, so
// where a plane fits on chip one kernel, B2f (in_relu_bwd), reads g and
// x_hat once, sums s1 and s2, and writes dx and the sums: 6 B per bf16
// element, where B2a + B2b move 10 B.
//   fused warp    planes of at most 32 lanes * 8 packs: one warp a plane,
//                 eight planes a CTA, g and x_hat in registers, the sums by
//                 warp shuffles, dx from the registers.
//   fused staged  planes whose g + x_hat chunks fit a cluster of 1, 2, 4 or
//                 8 CTAs (the limits are the plan's): each CTA bulk-copies
//                 its chunk of both operands into shared memory in two
//                 parts on two mbarriers, sums each part as it lands (0-4 %
//                 faster than one part at the training shapes:
//                 tools/b2_bwd_tune.py --parts), the cluster adds its
//                 partial (s1, s2)
//                 through distributed shared memory in rank order (no
//                 atomics: the same from run to run), and each CTA writes dx
//                 from shared memory.
//   split         planes too large to stage, unaligned or odd planes: B2a
//                 (in_relu_bwd_stats) covers a plane with `splits` CTAs of
//                 `chunk` elements and a second pass adds their partials in
//                 split order, as B2s does; B2b (in_relu_bwd_apply) runs on a
//                 2-D grid of `apply_ctas` CTAs a plane x planes, as B2y
//                 does.  splits = apply_ctas = 1 is the first design, one
//                 256-thread CTA a plane for each kernel.
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
constexpr int kMaxBwdStageBytes = 192 * 1024;  // a fused staged CTA's g + x_hat
constexpr int kStageParts = 2;               // mbarriers a fused staged chunk
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

// Thread 0: initialise mbarrier `bar` for one arrival that expects `bytes`
// of bulk copies.
__device__ __forceinline__ void stage_begin(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Thread 0: bulk-copy `bytes` (a multiple of 16) from global `src` to shared
// address `dst`, in pieces that complete on mbarrier `bar`.
__device__ __forceinline__ void stage_copy(uint32_t dst, const void* src,
                                           uint32_t bytes, uint32_t bar) {
  const char* from = reinterpret_cast<const char*>(src);
  for (uint32_t off = 0; off < bytes; off += kBulkPiece) {
    const uint32_t n = bytes - off < kBulkPiece ? bytes - off : kBulkPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst + off),
        "l"(from + off), "r"(n), "r"(bar)
        : "memory");
  }
}

// Every thread: wait until the copies on `bar` (phase 0) have landed.
__device__ __forceinline__ void stage_wait(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar) : "memory");
  }
}

// (a, b), each CTA's block sum, replaced by the cluster's: every CTA's
// partial read through distributed shared memory and added in rank order,
// so every CTA of the cluster gets the same sums with no atomics.  Arrives
// on the cluster barrier; the CTA must call cluster_leave() before it exits
// (a peer may still be reading its `partial`).
__device__ __forceinline__ void cluster_sum2(float& a, float& b,
                                             float* partial, int cs) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    partial[0] = a;
    partial[1] = b;
  }
  cluster.sync();
  a = 0.0f;
  b = 0.0f;
  for (int r = 0; r < cs; ++r) {
    const float* peer = cluster.map_shared_rank(partial, r);
    a = __fadd_rn(a, peer[0]);
    b = __fadd_rn(b, peer[1]);
  }
  // done reading the peers; the matching wait is cluster_leave()
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_leave() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
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
    stage_begin(bar, bytes);
    stage_copy(smem_addr(stage), x + base, bytes, bar);
  }
  __syncthreads();                       // the barrier is initialised
  stage_wait(bar);

  const Pack<T, N>* sp = reinterpret_cast<const Pack<T, N>*>(stage);
  const int groups = chunk / N;
  float s = 0.0f, ss = 0.0f;
  for (int i = threadIdx.x; i < groups; i += kThreads) add_pack(sp[i], s, ss);
  block_sum2(s, ss);
  if (cs > 1) cluster_sum2(s, ss, partial, cs);
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
  if (cs > 1) cluster_leave();
}

// ---- backward: the same per-element arithmetic on every path -------------

// Running (s1, s2) = (sum gz, sum gz * x_hat) over one pack of g and x_hat,
// gz = g * [x_hat * gamma + beta > 0].
template <typename T, int N>
__device__ __forceinline__ void add_grad_pack(const Pack<T, N>& pg,
                                              const Pack<T, N>& ph, float gm,
                                              float bt, float& s1, float& s2) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float h = to_f(ph.v[k]);
    const float z = __fadd_rn(__fmul_rn(h, gm), bt);
    const float gz = z > 0.0f ? to_f(pg.v[k]) : 0.0f;
    s1 = __fadd_rn(s1, gz);
    s2 = __fadd_rn(s2, __fmul_rn(gz, h));
  }
}

// What dx of a plane needs besides g and x_hat.
struct GradCoef {
  float gm, bt, m1, m2, coef;
};

__device__ __forceinline__ GradCoef grad_coef(float gm, float bt, float rstd,
                                              float s1, float s2, int hw) {
  const float inv_hw = __fdiv_rn(1.0f, (float)hw);
  return {gm, bt, __fmul_rn(s1, inv_hw), __fmul_rn(s2, inv_hw),
          __fmul_rn(gm, rstd)};
}

// dx = (gamma * rstd) * ((gz - s1 / HW) - x_hat * s2 / HW) of one pack.
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> grad_pack(const Pack<T, N>& pg,
                                                const Pack<T, N>& ph,
                                                const GradCoef& k) {
  Pack<T, N> out;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float h = to_f(ph.v[e]);
    const float z = __fadd_rn(__fmul_rn(h, k.gm), k.bt);
    const float gz = z > 0.0f ? to_f(pg.v[e]) : 0.0f;
    const float d = __fsub_rn(__fsub_rn(gz, k.m1), __fmul_rn(h, k.m2));
    out.v[e] = from_f<T>(__fmul_rn(k.coef, d));
  }
  return out;
}

// B2f, fused warp path: one warp per plane, g and x_hat in registers (P
// packs of each a lane).
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    in_relu_bwd_warp_kernel(const T* __restrict__ g,
                            const T* __restrict__ xhat,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            const float* __restrict__ rstd,
                            T* __restrict__ dx, float* __restrict__ s1_out,
                            float* __restrict__ s2_out, int planes,
                            int channels, int hw) {
  constexpr int N = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int64_t plane = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (plane >= planes) return;
  const int c = (int)(plane % channels);
  const int64_t base = plane * hw;
  const Pack<T, N>* gp = reinterpret_cast<const Pack<T, N>*>(g + base);
  const Pack<T, N>* hp = reinterpret_cast<const Pack<T, N>*>(xhat + base);
  const int groups = hw / N;
  const float gm = gamma[c], bt = beta[c];

  Pack<T, N> pg[P], ph[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = lane + 32 * i;
    if (j < groups) {
      pg[i] = gp[j];
      ph[i] = hp[j];
    }
  }
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (lane + 32 * i < groups) add_grad_pack(pg[i], ph[i], gm, bt, s1, s2);
  warp_sum2(s1, s2);
  if (lane == 0) {
    s1_out[plane] = s1;
    s2_out[plane] = s2;
  }
  const GradCoef k = grad_coef(gm, bt, rstd[plane], s1, s2, hw);
  Pack<T, N>* dp = reinterpret_cast<Pack<T, N>*>(dx + base);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = lane + 32 * i;
    if (j < groups) dp[j] = grad_pack(pg[i], ph[i], k);
  }
}

// B2f, fused staged path: a cluster of `cs` CTAs per plane; CTA `rank`
// holds chunk `rank` (hw / cs elements) of g, then of x_hat, in shared
// memory.  The chunk lands in kStageParts parts, each on its own mbarrier,
// so the sums start on the first part while the others arrive.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    in_relu_bwd_staged_kernel(const T* __restrict__ g,
                              const T* __restrict__ xhat,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              const float* __restrict__ rstd,
                              T* __restrict__ dx, float* __restrict__ s1_out,
                              float* __restrict__ s2_out, int channels,
                              int hw, int cs) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full[kStageParts];
  __shared__ float partial[2];

  const int rank = (int)(blockIdx.x % cs);
  const int64_t plane = blockIdx.x / cs;
  const int c = (int)(plane % channels);
  const int chunk = hw / cs;
  const int64_t base = plane * hw + (int64_t)rank * chunk;
  const uint32_t bytes = (uint32_t)chunk * sizeof(T);
  const int groups = chunk / N;
  const int per = (groups + kStageParts - 1) / kStageParts;  // packs a part

  if (threadIdx.x == 0) {
    const char* gs = reinterpret_cast<const char*>(g + base);
    const char* hs = reinterpret_cast<const char*>(xhat + base);
    for (int p = 0; p < kStageParts; ++p) {
      const uint32_t bar = smem_addr(&full[p]);
      const int lo = p * per, hi = min(groups, lo + per);
      if (hi <= lo) continue;            // no copy, and no thread waits
      const uint32_t off = (uint32_t)lo * 16, n = (uint32_t)(hi - lo) * 16;
      stage_begin(bar, 2 * n);
      stage_copy(smem_addr(stage) + off, gs + off, n, bar);
      stage_copy(smem_addr(stage) + bytes + off, hs + off, n, bar);
    }
  }
  __syncthreads();                       // the barriers are initialised

  const Pack<T, N>* sg = reinterpret_cast<const Pack<T, N>*>(stage);
  const Pack<T, N>* sh = reinterpret_cast<const Pack<T, N>*>(stage + bytes);
  const float gm = gamma[c], bt = beta[c];
  float s1 = 0.0f, s2 = 0.0f;
  for (int p = 0; p < kStageParts; ++p) {
    const int lo = p * per, hi = min(groups, lo + per);
    if (hi <= lo) continue;
    stage_wait(smem_addr(&full[p]));
    for (int i = lo + threadIdx.x; i < hi; i += kThreads)
      add_grad_pack(sg[i], sh[i], gm, bt, s1, s2);
  }
  block_sum2(s1, s2);
  if (cs > 1) cluster_sum2(s1, s2, partial, cs);
  if (rank == 0 && threadIdx.x == 0) {
    s1_out[plane] = s1;
    s2_out[plane] = s2;
  }
  const GradCoef k = grad_coef(gm, bt, rstd[plane], s1, s2, hw);
  Pack<T, N>* dp = reinterpret_cast<Pack<T, N>*>(dx + base);
  for (int i = threadIdx.x; i < groups; i += kThreads)
    dp[i] = grad_pack(sg[i], sh[i], k);
  if (cs > 1) cluster_leave();
}

// B2a (split path), first pass: CTA (split, plane) sums elements [split *
// chunk, min(hw, (split + 1) * chunk)) of the plane into o1 / o2 at (plane *
// splits + split) * ostride: s1 / s2 themselves when splits == 1, else the
// interleaved partials of B2s's combine pass.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    in_relu_bwd_stats_kernel(const T* __restrict__ g,
                             const T* __restrict__ xhat,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta,
                             float* __restrict__ o1, float* __restrict__ o2,
                             int ostride, int planes, int channels, int hw,
                             int splits, int chunk) {
  const int lo = blockIdx.x * chunk;
  const int n = min(hw - lo, chunk) / N;
  for (int64_t plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const int c = (int)(plane % channels);
    const float gm = gamma[c], bt = beta[c];
    const Pack<T, N>* gp =
        reinterpret_cast<const Pack<T, N>*>(g + plane * hw + lo);
    const Pack<T, N>* hp =
        reinterpret_cast<const Pack<T, N>*>(xhat + plane * hw + lo);
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = threadIdx.x; i < n; i += kThreads)
      add_grad_pack(gp[i], hp[i], gm, bt, s1, s2);
    block_sum2(s1, s2);
    if (threadIdx.x == 0) {
      const int64_t o = (plane * splits + blockIdx.x) * ostride;
      o1[o] = s1;
      o2[o] = s2;
    }
    __syncthreads();                 // block_sum2's shared slots are reused
  }
}

// B2b (split path): CTA (x, y) writes dx of packs x * kThreads + t (stride
// gridDim.x * kThreads) of planes y, y + gridDim.y, ...
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    in_relu_bwd_apply_kernel(const T* __restrict__ g,
                             const T* __restrict__ xhat,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta,
                             const float* __restrict__ rstd,
                             const float* __restrict__ s1,
                             const float* __restrict__ s2,
                             T* __restrict__ dx, int planes, int channels,
                             int hw) {
  const int groups = hw / N;
  for (int64_t plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const int c = (int)(plane % channels);
    const GradCoef k =
        grad_coef(gamma[c], beta[c], rstd[plane], s1[plane], s2[plane], hw);
    const Pack<T, N>* gp = reinterpret_cast<const Pack<T, N>*>(g + plane * hw);
    const Pack<T, N>* hp =
        reinterpret_cast<const Pack<T, N>*>(xhat + plane * hw);
    Pack<T, N>* dp = reinterpret_cast<Pack<T, N>*>(dx + plane * hw);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < groups;
         i += gridDim.x * kThreads)
      dp[i] = grad_pack(gp[i], hp[i], k);
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

// B2s and B2a, second pass: the interleaved partials of each plane's
// splits added in split order, into o1 / o2 at plane * ostride.
__global__ void __launch_bounds__(kThreads)
    in_relu_partial_combine_kernel(const float* __restrict__ part,
                                   float* __restrict__ o1,
                                   float* __restrict__ o2, int ostride,
                                   int planes, int splits) {
  const int64_t plane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (plane >= planes) return;
  const float* p = part + 2 * plane * splits;
  float s = 0.0f, ss = 0.0f;
  for (int k = 0; k < splits; ++k) {
    s = __fadd_rn(s, p[2 * k]);
    ss = __fadd_rn(ss, p[2 * k + 1]);
  }
  o1[plane * ostride] = s;
  o2[plane * ostride] = ss;
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

// Launch `kernel` on `grid` CTAs in clusters of `cs` (no cluster attribute
// for one) with `smem` bytes of dynamic shared memory; the kernel's limit is
// raised to `max_smem` on the first launch (`smem_set`).
template <typename... KArgs, typename... Args>
int launch_clustered(void (*kernel)(KArgs...), bool& smem_set, int max_smem,
                     int64_t grid, int cs, int smem, cudaStream_t st,
                     Args... args) {
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_staged(const T* x, const float* gm, const float* bt, T* y, T* xh,
                  float* rstd, int planes, int channels, int hw, int cs,
                  int smem, float eps, cudaStream_t st) {
  static bool smem_set = false;                 // once per dtype
  return launch_clustered(in_relu_fwd_staged_kernel<T>, smem_set,
                          kMaxStageBytes, (int64_t)planes * cs, cs, smem, st,
                          x, gm, bt, y, xh, rstd, channels, hw, cs, eps);
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

template <typename T, int P>
int launch_bwd_warp(const T* g, const T* xh, const float* gm, const float* bt,
                    const float* rstd, T* dx, float* s1, float* s2,
                    int planes, int channels, int hw, cudaStream_t st) {
  const unsigned grid = (unsigned)((planes + kWarps - 1) / kWarps);
  in_relu_bwd_warp_kernel<T, P><<<grid, kThreads, 0, st>>>(
      g, xh, gm, bt, rstd, dx, s1, s2, planes, channels, hw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* gv, const void* xhv, const float* gm,
               const float* bt, const float* rstd, void* dxv, float* s1,
               float* s2, int planes, int channels, int hw, int path,
               int packs, int cs, int smem, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const T* g = (const T*)gv;
  const T* xh = (const T*)xhv;
  T* dx = (T*)dxv;
  const void* ptrs[] = {gv, xhv, dxv};
  const bool vec = vec_ok<T>(hw, ptrs, 3);
  const int bad = (int)cudaErrorInvalidValue;
  if (path == kPathWarp) {
    if (!vec || (int64_t)packs * 32 * N < hw) return bad;
#define IN_RELU_BWD_WARP(P)                                                 \
  launch_bwd_warp<T, P>(g, xh, gm, bt, rstd, dx, s1, s2, planes, channels, \
                        hw, st)
    switch (packs) {
      case 1: return IN_RELU_BWD_WARP(1);
      case 2: return IN_RELU_BWD_WARP(2);
      case 4: return IN_RELU_BWD_WARP(4);
      case kMaxWarpPacks: return IN_RELU_BWD_WARP(kMaxWarpPacks);
      default: return bad;
    }
#undef IN_RELU_BWD_WARP
  }
  if (path == kPathStaged) {
    if (!vec || cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) ||
        hw % (cs * N) || smem != (int)((int64_t)hw / cs * 2 * sizeof(T)) ||
        smem > kMaxBwdStageBytes)
      return bad;
    static bool smem_set = false;               // once per dtype
    return launch_clustered(in_relu_bwd_staged_kernel<T>, smem_set,
                            kMaxBwdStageBytes, (int64_t)planes * cs, cs, smem,
                            st, g, xh, gm, bt, rstd, dx, s1, s2, channels, hw,
                            cs);
  }
  return bad;                // the split path is B2a + B2b, not this kernel
}

template <typename T>
int launch_stats(const void* g, const void* xh, const float* gm,
                 const float* bt, float* part, float* s1, float* s2,
                 int planes, int channels, int hw, int splits, int chunk,
                 cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const void* ptrs[] = {g, xh};
  if (splits < 1 || chunk < 1 || (int64_t)splits * chunk < hw ||
      (int64_t)(splits - 1) * chunk >= hw)
    return (int)cudaErrorInvalidValue;
  // one split writes s1 / s2 directly, several their interleaved partials
  float* o1 = splits > 1 ? part : s1;
  float* o2 = splits > 1 ? part + 1 : s2;
  const int ostride = splits > 1 ? 2 : 1;
  const dim3 grid((unsigned)splits,
                  (unsigned)(planes < kMaxGridY ? planes : kMaxGridY));
  if (vec_ok<T>(hw, ptrs, 2) && chunk % N == 0)
    in_relu_bwd_stats_kernel<T, N><<<grid, kThreads, 0, st>>>(
        (const T*)g, (const T*)xh, gm, bt, o1, o2, ostride, planes, channels,
        hw, splits, chunk);
  else
    in_relu_bwd_stats_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        (const T*)g, (const T*)xh, gm, bt, o1, o2, ostride, planes, channels,
        hw, splits, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  in_relu_partial_combine_kernel<<<(unsigned)((planes + kThreads - 1) /
                                              kThreads),
                                   kThreads, 0, st>>>(part, s1, s2, 1, planes,
                                                      splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* g, const void* xh, const float* gm,
                 const float* bt, const float* rstd, const float* s1,
                 const float* s2, void* dx, int planes, int channels, int hw,
                 int ctas, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const void* ptrs[] = {g, xh, dx};
  if (ctas < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas,
                  (unsigned)(planes < kMaxGridY ? planes : kMaxGridY));
  if (vec_ok<T>(hw, ptrs, 3))
    in_relu_bwd_apply_kernel<T, N><<<grid, kThreads, 0, st>>>(
        (const T*)g, (const T*)xh, gm, bt, rstd, s1, s2, (T*)dx, planes,
        channels, hw);
  else
    in_relu_bwd_apply_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        (const T*)g, (const T*)xh, gm, bt, rstd, s1, s2, (T*)dx, planes,
        channels, hw);
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
                                   kThreads, 0, st>>>(part, out, out + 1, 2,
                                                      planes, splits);
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
// an unknown dtype or a plan that does not fit the operands.  in_relu_fwd's
// plan (ops/kernels.in_relu_fwd_plan): `path` 0
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

// B2f: dx in `dtype` and s1, s2 [planes] f32 of the fused backward, under
// in_relu_bwd_plan's fused plan: `path` 1 warp with `packs` 16-byte packs a
// lane (eight planes a CTA), 2 staged on clusters of `cluster` CTAs with
// `smem_bytes` (g + x_hat chunks) of dynamic shared memory each; any other
// plan, or one that does not fit the operands, is refused.
extern "C" int in_relu_bwd(const void* g, const void* xhat, const void* gamma,
                           const void* beta, const void* rstd, void* dx,
                           void* s1, void* s2, int planes, int channels,
                           int hw, int dtype, int path, int packs,
                           int cluster, int smem_bytes, void* stream) {
  if (planes == 0 || hw == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_bwd<float>(g, xhat, (const float*)gamma,
                             (const float*)beta, (const float*)rstd, dx,
                             (float*)s1, (float*)s2, planes, channels, hw,
                             path, packs, cluster, smem_bytes, st);
  if (dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(
        g, xhat, (const float*)gamma, (const float*)beta, (const float*)rstd,
        dx, (float*)s1, (float*)s2, planes, channels, hw, path, packs,
        cluster, smem_bytes, st);
  return (int)cudaErrorInvalidValue;
}

// B2a: s1, s2 [planes] f32, each plane covered by `splits` CTAs of `chunk`
// elements; with splits > 1 the CTAs write `part` [planes, splits, 2] f32
// scratch and a second launch adds it in split order.
extern "C" int in_relu_bwd_stats(const void* g, const void* xhat,
                                 const void* gamma, const void* beta,
                                 void* part, void* s1, void* s2, int planes,
                                 int channels, int hw, int splits, int chunk,
                                 int dtype, void* stream) {
  if (planes == 0 || hw == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_stats<float>(g, xhat, (const float*)gamma,
                               (const float*)beta, (float*)part, (float*)s1,
                               (float*)s2, planes, channels, hw, splits, chunk,
                               st);
  if (dtype == kBF16)
    return launch_stats<__nv_bfloat16>(
        g, xhat, (const float*)gamma, (const float*)beta, (float*)part,
        (float*)s1, (float*)s2, planes, channels, hw, splits, chunk, st);
  return (int)cudaErrorInvalidValue;
}

// B2b: dx in `dtype` from s1, s2 and rstd, `apply_ctas` CTAs a plane.
extern "C" int in_relu_bwd_apply(const void* g, const void* xhat,
                                 const void* gamma, const void* beta,
                                 const void* rstd, const void* s1,
                                 const void* s2, void* dx, int planes,
                                 int channels, int hw, int apply_ctas,
                                 int dtype, void* stream) {
  if (planes == 0 || hw == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_apply<float>(g, xhat, (const float*)gamma,
                               (const float*)beta, (const float*)rstd,
                               (const float*)s1, (const float*)s2, dx, planes,
                               channels, hw, apply_ctas, st);
  if (dtype == kBF16)
    return launch_apply<__nv_bfloat16>(
        g, xhat, (const float*)gamma, (const float*)beta, (const float*)rstd,
        (const float*)s1, (const float*)s2, dx, planes, channels, hw,
        apply_ctas, st);
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
