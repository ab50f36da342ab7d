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
// Kernel B3: G-Net's modulated block, norm -> * gamma -> + s -> ReLU, in one
// kernel each way (the JAX package leaves it to XLA:
// boxsegliver_tpu/models/gunet.py:215-232).  Per (b, c) plane of x:
//   x_hat = (x - mean) * rstd (B2-fwd's statistics), n = x_hat * w_c + b_c,
//   y = relu(gamma[b, c] * n + s[b, c, :]),
// with the norm's scale w and center b, the context's gamma and the spatial
// term s each optional (1, 0, 1 and 0 stand in, which change no value).
// B3 is B2's function with gamma and s added, so its kernels are B2's
// bodies (the device functions fwd_* and bwd_* below) under another
// epilogue: ModFwd and ModBwd where B2 takes AffineFwd and AffineBwd.
//   B3-fwd  modnorm_relu_fwd: B2-fwd's three paths and plans (warp, staged,
//           general) with s read once beside x; in training it writes y,
//           x_hat and rstd, under no-grad y alone.
//   B3-bwd  modnorm_relu_bwd: g_m = g * [y > 0]; ds = g_m, written once; the
//           plane sums a = sum g_m and b = sum g_m * x_hat (d_gamma = w b +
//           b_c a, d_w and d_b their sums over the batch times gamma, in
//           ops/kernels); dx = (gamma w rstd) ((g_m - a / HW) - x_hat b / HW).
//           B2f's fused warp and staged paths (y read beside g and x_hat,
//           g_m kept in g's place), or B2a's split sums and B2b's apply
//           pass where a plane does not fit on chip.
// Bound: the function reads x and s and writes y forward (6 B per bf16
// element), and reads g, y and x_hat and writes dx and ds backward (10 B):
// 16 B an element a training step, 6 under no-grad.  The x_hat that the
// training forward stores for the backward is the design's, not the
// function's, as in B2's bound (portbench/flops.py).
//
// Rounding: the elementwise arithmetic uses explicitly rounded intrinsics so
// that nvcc contracts nothing into FMAs and each element follows the plain
// PyTorch version (ops/kernels.in_relu_*_plain, modnorm_relu_*_plain)
// operation by operation; the order of the per-plane sums differs, and
// rsqrtf is within 2 ulp of torch.rsqrt (the tolerances of
// chip_smoke.b2_check).

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

// ---- epilogues: what B2 and B3 do per plane and per element ----------------
//
// The kernel bodies below (fwd_*, bwd_*) are written once, templated on an
// epilogue Epi that gives each plane's constants (Epi::Plane, e.plane(p))
// and the per-element step:
//   forward   z = e.z(k, x_hat, s), y = relu(z); Epi::kSpatial: s is read
//             (e.s_plane) beside x;
//   backward  g is kept where e.keep(k, x_hat, y) (the ReLU's mask), dx's
//             coefficient is e.coef(k, rstd); Epi::kReadsY: the mask is read
//             from y, g_m replaces g where g is held and is written as ds.

// B2-fwd: z = x_hat * gamma_c + beta_c.
template <typename T>
struct AffineFwd {
  static constexpr bool kSpatial = false;
  const float* gamma;
  const float* beta;
  int channels;
  struct Plane {
    float gm, bt;
  };
  __device__ __forceinline__ Plane plane(int64_t p) const {
    const int c = (int)(p % channels);
    return {gamma[c], beta[c]};
  }
  __device__ __forceinline__ const T* s_plane(int64_t, int) const {
    return nullptr;
  }
  __device__ __forceinline__ float z(const Plane& k, float h, float) const {
    return __fadd_rn(__fmul_rn(h, k.gm), k.bt);
  }
};

// B3's per-plane operands: gamma [planes] f32 (the context's slice), weight
// and bias [channels] f32 (the norm's scale and center), each null where the
// block has none.
struct ModParams {
  const float* gamma;
  const float* weight;
  const float* bias;
  int channels;
};

struct ModPlane {
  float gm, w, b;
};

__device__ __forceinline__ ModPlane mod_plane(const ModParams& mp,
                                              int64_t plane) {
  const int c = (int)(plane % mp.channels);
  return {mp.gamma ? mp.gamma[plane] : 1.0f, mp.weight ? mp.weight[c] : 1.0f,
          mp.bias ? mp.bias[c] : 0.0f};
}

// B3-fwd: z = (x_hat * w_c + b_c) * gamma[b, c] + s.  s holds [N, C, *S]
// planes of hw contiguous elements, sample b at b * s_bstride (a channel
// slice of a wider tensor has s_bstride > C * hw), or is null.
template <typename T>
struct ModFwd {
  static constexpr bool kSpatial = true;
  ModParams mp;
  const T* s;
  int64_t s_bstride;
  using Plane = ModPlane;
  __device__ __forceinline__ Plane plane(int64_t p) const {
    return mod_plane(mp, p);
  }
  __device__ __forceinline__ const T* s_plane(int64_t p, int hw) const {
    return s ? s + (p / mp.channels) * s_bstride +
                   (p % mp.channels) * (int64_t)hw
             : nullptr;
  }
  __device__ __forceinline__ float z(const Plane& k, float h, float sv) const {
    return __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(h, k.w), k.b), k.gm), sv);
  }
};

// B2's backward: the mask recomputed from x_hat, dx's coefficient gamma_c *
// rstd.
struct AffineBwd {
  static constexpr bool kReadsY = false;
  const float* gamma;
  const float* beta;
  int channels;
  struct Plane {
    float gm, bt;
  };
  __device__ __forceinline__ Plane plane(int64_t p) const {
    const int c = (int)(p % channels);
    return {gamma[c], beta[c]};
  }
  __device__ __forceinline__ bool keep(const Plane& k, float h, float) const {
    return __fadd_rn(__fmul_rn(h, k.gm), k.bt) > 0.0f;
  }
  __device__ __forceinline__ float coef(const Plane& k, float rstd) const {
    return __fmul_rn(k.gm, rstd);
  }
};

// B3's backward: the mask y > 0, dx's coefficient gamma[b, c] * w_c * rstd.
struct ModBwd {
  static constexpr bool kReadsY = true;
  ModParams mp;
  using Plane = ModPlane;
  __device__ __forceinline__ Plane plane(int64_t p) const {
    return mod_plane(mp, p);
  }
  __device__ __forceinline__ bool keep(const Plane&, float, float yv) const {
    return yv > 0.0f;
  }
  __device__ __forceinline__ float coef(const Plane& k, float rstd) const {
    return __fmul_rn(__fmul_rn(k.gm, k.w), rstd);
  }
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> zero_pack() {
  Pack<T, N> p;
#pragma unroll
  for (int k = 0; k < N; ++k) p.v[k] = from_f<T>(0.0f);
  return p;
}

// Pack i of the spatial plane sp where the epilogue reads one, else zeros
// (which no epilogue without s reads).
template <typename Epi, typename T, int N>
__device__ __forceinline__ Pack<T, N> s_pack(const T* sp, int i) {
  if constexpr (Epi::kSpatial) {
    if (sp) return reinterpret_cast<const Pack<T, N>*>(sp)[i];
  }
  return zero_pack<T, N>();
}

// y and x_hat of one pack (ps: the spatial term's pack).
template <typename Epi, typename T, int N>
__device__ __forceinline__ void norm_pack(const Epi& e,
                                          const typename Epi::Plane& k,
                                          const Pack<T, N>& p,
                                          const Pack<T, N>& ps, float mean,
                                          float rstd, Pack<T, N>& po,
                                          Pack<T, N>& ph) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float h = __fmul_rn(__fsub_rn(to_f(p.v[i]), mean), rstd);
    po.v[i] = from_f<T>(fmaxf(e.z(k, h, to_f(ps.v[i])), 0.0f));
    ph.v[i] = from_f<T>(h);
  }
}

// Running (s1, s2) = (sum gz, sum gz * x_hat) over one pack of g and x_hat,
// gz = g where the epilogue keeps the element, else 0 (py: y's pack, read
// only under Epi::kReadsY, where gz also replaces g in pg: g itself or 0,
// exact in any dtype).
template <typename Epi, typename T, int N>
__device__ __forceinline__ void grad_sum_pack(const Epi& e,
                                              const typename Epi::Plane& k,
                                              Pack<T, N>& pg,
                                              const Pack<T, N>& ph,
                                              const Pack<T, N>& py, float& s1,
                                              float& s2) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float h = to_f(ph.v[i]);
    float yv = 0.0f;
    if constexpr (Epi::kReadsY) yv = to_f(py.v[i]);
    const float gz = e.keep(k, h, yv) ? to_f(pg.v[i]) : 0.0f;
    if constexpr (Epi::kReadsY) pg.v[i] = from_f<T>(gz);
    s1 = __fadd_rn(s1, gz);
    s2 = __fadd_rn(s2, __fmul_rn(gz, h));
  }
}

// What dx of a plane needs besides g and x_hat.
struct GradCoef {
  float m1, m2, coef;
};

template <typename Epi>
__device__ __forceinline__ GradCoef grad_coef(const Epi& e,
                                              const typename Epi::Plane& k,
                                              float rstd, float s1, float s2,
                                              int hw) {
  const float inv_hw = __fdiv_rn(1.0f, (float)hw);
  return {__fmul_rn(s1, inv_hw), __fmul_rn(s2, inv_hw), e.coef(k, rstd)};
}

// dx = coef * ((gz - s1 / HW) - x_hat * s2 / HW) of one pack: under
// Epi::kReadsY pg holds gz already, else the mask is taken again.
template <typename Epi, typename T, int N>
__device__ __forceinline__ Pack<T, N> grad_pack(const Epi& e,
                                                const typename Epi::Plane& k,
                                                const GradCoef& c,
                                                const Pack<T, N>& pg,
                                                const Pack<T, N>& ph) {
  Pack<T, N> out;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float h = to_f(ph.v[i]);
    float gz = to_f(pg.v[i]);
    if constexpr (!Epi::kReadsY) gz = e.keep(k, h, 0.0f) ? gz : 0.0f;
    const float d = __fsub_rn(__fsub_rn(gz, c.m1), __fmul_rn(h, c.m2));
    out.v[i] = from_f<T>(__fmul_rn(c.coef, d));
  }
  return out;
}

// ---- the forward's bodies: B2-fwd's paths, B3-fwd's under ModFwd ----------
// xhat and rstd_out may be null (B3 under no-grad).

// General path: one CTA per plane, x read twice.
template <typename T, int N, typename Epi>
__device__ __forceinline__ void fwd_general(const Epi& e,
                                            const T* __restrict__ x,
                                            T* __restrict__ y,
                                            T* __restrict__ xhat,
                                            float* __restrict__ rstd_out,
                                            int hw, float eps) {
  const int64_t plane = blockIdx.x;
  const int64_t base = plane * hw;
  const Pack<T, N>* xp = reinterpret_cast<const Pack<T, N>*>(x + base);
  const T* sp = e.s_plane(plane, hw);
  const int groups = hw / N;

  float s = 0.0f, ss = 0.0f;
  for (int i = threadIdx.x; i < groups; i += kThreads) add_pack(xp[i], s, ss);
  block_sum2(s, ss);
  float mean;
  const float rstd = plane_rstd(s, ss, hw, eps, mean);
  if (rstd_out && threadIdx.x == 0) rstd_out[plane] = rstd;
  const typename Epi::Plane k = e.plane(plane);

  Pack<T, N>* yp = reinterpret_cast<Pack<T, N>*>(y + base);
  Pack<T, N>* hp = reinterpret_cast<Pack<T, N>*>(xhat + base);
  for (int i = threadIdx.x; i < groups; i += kThreads) {
    Pack<T, N> po, ph;
    norm_pack(e, k, xp[i], s_pack<Epi, T, N>(sp, i), mean, rstd, po, ph);
    yp[i] = po;
    if (xhat) hp[i] = ph;
  }
}

// Warp path: one warp per plane, the plane (and s) in registers, P packs a
// lane.
template <typename T, int P, typename Epi>
__device__ __forceinline__ void fwd_warp(const Epi& e,
                                         const T* __restrict__ x,
                                         T* __restrict__ y,
                                         T* __restrict__ xhat,
                                         float* __restrict__ rstd_out,
                                         int planes, int hw, float eps) {
  constexpr int N = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int64_t plane = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (plane >= planes) return;
  const int64_t base = plane * hw;
  const Pack<T, N>* xp = reinterpret_cast<const Pack<T, N>*>(x + base);
  const T* sp = e.s_plane(plane, hw);
  const int groups = hw / N;

  Pack<T, N> p[P], ps[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = lane + 32 * i;
    p[i] = j < groups ? xp[j] : zero_pack<T, N>();
    ps[i] = j < groups ? s_pack<Epi, T, N>(sp, j) : zero_pack<T, N>();
  }
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) add_pack(p[i], s, ss);
  warp_sum2(s, ss);
  float mean;
  const float rstd = plane_rstd(s, ss, hw, eps, mean);
  if (rstd_out && lane == 0) rstd_out[plane] = rstd;
  const typename Epi::Plane k = e.plane(plane);

  Pack<T, N>* yp = reinterpret_cast<Pack<T, N>*>(y + base);
  Pack<T, N>* hp = reinterpret_cast<Pack<T, N>*>(xhat + base);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = lane + 32 * i;
    if (j < groups) {
      Pack<T, N> po, ph;
      norm_pack(e, k, p[i], ps[i], mean, rstd, po, ph);
      yp[j] = po;
      if (xhat) hp[j] = ph;
    }
  }
}

// Staged path: a cluster of `cs` CTAs per plane, CTA `rank` holding chunk
// `rank` (hw / cs elements) of x in shared memory; s, where the epilogue
// has one, is read from device memory as each element is normalized.
template <typename T, typename Epi>
__device__ __forceinline__ void fwd_staged(const Epi& e,
                                           const T* __restrict__ x,
                                           T* __restrict__ y,
                                           T* __restrict__ xhat,
                                           float* __restrict__ rstd_out,
                                           int hw, int cs, float eps) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full;
  __shared__ float partial[2];

  const int rank = (int)(blockIdx.x % cs);
  const int64_t plane = blockIdx.x / cs;
  const int chunk = hw / cs;
  const int64_t base = plane * hw + (int64_t)rank * chunk;
  const uint32_t bytes = (uint32_t)chunk * sizeof(T);
  const uint32_t bar = smem_addr(&full);
  const T* sp = e.s_plane(plane, hw);
  if (sp) sp += (int64_t)rank * chunk;

  if (threadIdx.x == 0) {
    stage_begin(bar, bytes);
    stage_copy(smem_addr(stage), x + base, bytes, bar);
  }
  __syncthreads();                       // the barrier is initialised
  stage_wait(bar);

  const Pack<T, N>* xs = reinterpret_cast<const Pack<T, N>*>(stage);
  const int groups = chunk / N;
  float s = 0.0f, ss = 0.0f;
  for (int i = threadIdx.x; i < groups; i += kThreads) add_pack(xs[i], s, ss);
  block_sum2(s, ss);
  if (cs > 1) cluster_sum2(s, ss, partial, cs);
  float mean;
  const float rstd = plane_rstd(s, ss, hw, eps, mean);
  if (rstd_out && rank == 0 && threadIdx.x == 0) rstd_out[plane] = rstd;
  const typename Epi::Plane k = e.plane(plane);

  Pack<T, N>* yp = reinterpret_cast<Pack<T, N>*>(y + base);
  Pack<T, N>* hp = reinterpret_cast<Pack<T, N>*>(xhat + base);
  auto out = [&](int i) {
    Pack<T, N> po, ph;
    norm_pack(e, k, xs[i], s_pack<Epi, T, N>(sp, i), mean, rstd, po, ph);
    yp[i] = po;
    if (xhat) hp[i] = ph;
  };
  if constexpr (Epi::kSpatial) {
#pragma unroll 4                         // s's loads in flight together
    for (int i = threadIdx.x; i < groups; i += kThreads) out(i);
  } else {
    for (int i = threadIdx.x; i < groups; i += kThreads) out(i);
  }
  if (cs > 1) cluster_leave();
}

// ---- the backward's bodies: B2f, B2a, B2b; B3-bwd's under ModBwd -----------
// y and ds are read and written only under Epi::kReadsY (ds may be null
// there: s takes no gradient).

// Pack i of y where the epilogue reads y, else of x_hat (which it ignores).
template <typename Epi, typename T, int N>
__device__ __forceinline__ const Pack<T, N>& y_pack(const Pack<T, N>* yp,
                                                    const Pack<T, N>* hp,
                                                    int64_t i) {
  if constexpr (Epi::kReadsY) return yp[i];
  return hp[i];
}

// Fused warp path: one warp per plane, g and x_hat (and y) in registers, P
// packs of each a lane.
template <typename T, int P, typename Epi>
__device__ __forceinline__ void bwd_warp(const Epi& e, const T* __restrict__ g,
                                         const T* __restrict__ y,
                                         const T* __restrict__ xhat,
                                         const float* __restrict__ rstd,
                                         T* __restrict__ dx,
                                         T* __restrict__ ds,
                                         float* __restrict__ s1_out,
                                         float* __restrict__ s2_out,
                                         int planes, int hw) {
  constexpr int N = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int64_t plane = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (plane >= planes) return;
  const int64_t base = plane * hw;
  const Pack<T, N>* gp = reinterpret_cast<const Pack<T, N>*>(g + base);
  const Pack<T, N>* yp = reinterpret_cast<const Pack<T, N>*>(y + base);
  const Pack<T, N>* hp = reinterpret_cast<const Pack<T, N>*>(xhat + base);
  Pack<T, N>* sp = reinterpret_cast<Pack<T, N>*>(ds + base);
  const int groups = hw / N;
  const typename Epi::Plane k = e.plane(plane);

  Pack<T, N> pg[P], ph[P], py[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = lane + 32 * i;
    if (j < groups) {
      pg[i] = gp[j];
      ph[i] = hp[j];
      if constexpr (Epi::kReadsY) py[i] = yp[j];
    }
  }
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = lane + 32 * i;
    if (j < groups) {
      grad_sum_pack(e, k, pg[i], ph[i], Epi::kReadsY ? py[i] : ph[i], s1, s2);
      if constexpr (Epi::kReadsY)
        if (ds) sp[j] = pg[i];
    }
  }
  warp_sum2(s1, s2);
  if (lane == 0) {
    s1_out[plane] = s1;
    s2_out[plane] = s2;
  }
  const GradCoef c = grad_coef(e, k, rstd[plane], s1, s2, hw);
  Pack<T, N>* dp = reinterpret_cast<Pack<T, N>*>(dx + base);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = lane + 32 * i;
    if (j < groups) dp[j] = grad_pack(e, k, c, pg[i], ph[i]);
  }
}

// Fused staged path: a cluster of `cs` CTAs per plane; CTA `rank` holds
// chunk `rank` (hw / cs elements) of g, then of x_hat, in shared memory.
// The chunk lands in kStageParts parts, each on its own mbarrier, so the
// sums start on the first part while the others arrive.  y, where the
// epilogue reads it, comes from device memory in the first pass, which
// leaves g_m in g's place for the second.
template <typename T, typename Epi>
__device__ __forceinline__ void bwd_staged(const Epi& e,
                                           const T* __restrict__ g,
                                           const T* __restrict__ y,
                                           const T* __restrict__ xhat,
                                           const float* __restrict__ rstd,
                                           T* __restrict__ dx,
                                           T* __restrict__ ds,
                                           float* __restrict__ s1_out,
                                           float* __restrict__ s2_out, int hw,
                                           int cs) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full[kStageParts];
  __shared__ float partial[2];

  const int rank = (int)(blockIdx.x % cs);
  const int64_t plane = blockIdx.x / cs;
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

  Pack<T, N>* sg = reinterpret_cast<Pack<T, N>*>(stage);
  const Pack<T, N>* sh = reinterpret_cast<const Pack<T, N>*>(stage + bytes);
  const Pack<T, N>* yp = reinterpret_cast<const Pack<T, N>*>(y + base);
  Pack<T, N>* sp = reinterpret_cast<Pack<T, N>*>(ds + base);
  const typename Epi::Plane k = e.plane(plane);
  float s1 = 0.0f, s2 = 0.0f;
  for (int p = 0; p < kStageParts; ++p) {
    const int lo = p * per, hi = min(groups, lo + per);
    if (hi <= lo) continue;
    stage_wait(smem_addr(&full[p]));
    if constexpr (Epi::kReadsY) {
#pragma unroll 4                         // y's loads in flight together
      for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
        Pack<T, N> pg = sg[i];
        grad_sum_pack(e, k, pg, sh[i], yp[i], s1, s2);
        sg[i] = pg;
        if (ds) sp[i] = pg;
      }
    } else {
      for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
        Pack<T, N> pg = sg[i];
        grad_sum_pack(e, k, pg, sh[i], sh[i], s1, s2);
      }
    }
  }
  block_sum2(s1, s2);                    // its barrier also publishes sg
  if (cs > 1) cluster_sum2(s1, s2, partial, cs);
  if (rank == 0 && threadIdx.x == 0) {
    s1_out[plane] = s1;
    s2_out[plane] = s2;
  }
  const GradCoef c = grad_coef(e, k, rstd[plane], s1, s2, hw);
  Pack<T, N>* dp = reinterpret_cast<Pack<T, N>*>(dx + base);
  for (int i = threadIdx.x; i < groups; i += kThreads)
    dp[i] = grad_pack(e, k, c, sg[i], sh[i]);
  if (cs > 1) cluster_leave();
}

// Split path, first pass: CTA (split, plane) sums elements [split * chunk,
// min(hw, (split + 1) * chunk)) of the plane into o1 / o2 at (plane *
// splits + split) * ostride: s1 / s2 themselves when splits == 1, else the
// interleaved partials of the combine pass.
template <typename T, int N, typename Epi>
__device__ __forceinline__ void bwd_stats(const Epi& e,
                                          const T* __restrict__ g,
                                          const T* __restrict__ y,
                                          const T* __restrict__ xhat,
                                          float* __restrict__ o1,
                                          float* __restrict__ o2, int ostride,
                                          int planes, int hw, int splits,
                                          int chunk) {
  const int lo = blockIdx.x * chunk;
  const int n = min(hw - lo, chunk) / N;
  for (int64_t plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const typename Epi::Plane k = e.plane(plane);
    const int64_t base = plane * hw + lo;
    const Pack<T, N>* gp = reinterpret_cast<const Pack<T, N>*>(g + base);
    const Pack<T, N>* yp = reinterpret_cast<const Pack<T, N>*>(y + base);
    const Pack<T, N>* hp = reinterpret_cast<const Pack<T, N>*>(xhat + base);
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      Pack<T, N> pg = gp[i];
      grad_sum_pack(e, k, pg, hp[i], y_pack<Epi>(yp, hp, i), s1, s2);
    }
    block_sum2(s1, s2);
    if (threadIdx.x == 0) {
      const int64_t o = (plane * splits + blockIdx.x) * ostride;
      o1[o] = s1;
      o2[o] = s2;
    }
    __syncthreads();                 // block_sum2's shared slots are reused
  }
}

// Split path, apply: CTA (x, y) writes dx (and ds) of packs x * kThreads + t
// (stride gridDim.x * kThreads) of planes y, y + gridDim.y, ...
template <typename T, int N, typename Epi>
__device__ __forceinline__ void bwd_apply(const Epi& e,
                                          const T* __restrict__ g,
                                          const T* __restrict__ y,
                                          const T* __restrict__ xhat,
                                          const float* __restrict__ rstd,
                                          const float* __restrict__ s1,
                                          const float* __restrict__ s2,
                                          T* __restrict__ dx,
                                          T* __restrict__ ds, int planes,
                                          int hw) {
  const int groups = hw / N;
  for (int64_t plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const typename Epi::Plane k = e.plane(plane);
    const GradCoef c = grad_coef(e, k, rstd[plane], s1[plane], s2[plane], hw);
    const int64_t base = plane * hw;
    const Pack<T, N>* gp = reinterpret_cast<const Pack<T, N>*>(g + base);
    const Pack<T, N>* yp = reinterpret_cast<const Pack<T, N>*>(y + base);
    const Pack<T, N>* hp = reinterpret_cast<const Pack<T, N>*>(xhat + base);
    Pack<T, N>* dp = reinterpret_cast<Pack<T, N>*>(dx + base);
    Pack<T, N>* sp = reinterpret_cast<Pack<T, N>*>(ds + base);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < groups;
         i += gridDim.x * kThreads) {
      Pack<T, N> pg = gp[i];
      const Pack<T, N> ph = hp[i];
      if constexpr (Epi::kReadsY) {
        float u = 0.0f, v = 0.0f;        // the sums are the first pass's
        grad_sum_pack(e, k, pg, ph, yp[i], u, v);
        if (ds) sp[i] = pg;
      }
      dp[i] = grad_pack(e, k, c, pg, ph);
    }
  }
}

// ---- B2's kernels ----------------------------------------------------------

// B2-fwd, general path: one CTA per plane, x read twice.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    in_relu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, T* __restrict__ y,
                       T* __restrict__ xhat, float* __restrict__ rstd_out,
                       int channels, int hw, float eps) {
  fwd_general<T, N>(AffineFwd<T>{gamma, beta, channels}, x, y, xhat,
                    rstd_out, hw, eps);
}

// B2-fwd, warp path.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    in_relu_fwd_warp_kernel(const T* __restrict__ x,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta, T* __restrict__ y,
                            T* __restrict__ xhat, float* __restrict__ rstd_out,
                            int planes, int channels, int hw, float eps) {
  fwd_warp<T, P>(AffineFwd<T>{gamma, beta, channels}, x, y, xhat, rstd_out,
                 planes, hw, eps);
}

// B2-fwd, staged path.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    in_relu_fwd_staged_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              T* __restrict__ y, T* __restrict__ xhat,
                              float* __restrict__ rstd_out, int channels,
                              int hw, int cs, float eps) {
  fwd_staged<T>(AffineFwd<T>{gamma, beta, channels}, x, y, xhat, rstd_out,
                hw, cs, eps);
}

// B2f, fused warp path.
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
  bwd_warp<T, P>(AffineBwd{gamma, beta, channels}, g, nullptr, xhat, rstd,
                 dx, nullptr, s1_out, s2_out, planes, hw);
}

// B2f, fused staged path.
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
  bwd_staged<T>(AffineBwd{gamma, beta, channels}, g, nullptr, xhat, rstd, dx,
                nullptr, s1_out, s2_out, hw, cs);
}

// B2a (split path), first pass.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    in_relu_bwd_stats_kernel(const T* __restrict__ g,
                             const T* __restrict__ xhat,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta,
                             float* __restrict__ o1, float* __restrict__ o2,
                             int ostride, int planes, int channels, int hw,
                             int splits, int chunk) {
  bwd_stats<T, N>(AffineBwd{gamma, beta, channels}, g, nullptr, xhat, o1, o2,
                  ostride, planes, hw, splits, chunk);
}

// B2b (split path).
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
  bwd_apply<T, N>(AffineBwd{gamma, beta, channels}, g, nullptr, xhat, rstd,
                  s1, s2, dx, nullptr, planes, hw);
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

// The interleaved partials of each plane's splits added in split order,
// into o1 / o2 at plane * ostride (one thread a plane).
__device__ __forceinline__ void combine_partials(const float* __restrict__ part,
                                                 float* __restrict__ o1,
                                                 float* __restrict__ o2,
                                                 int ostride, int planes,
                                                 int splits) {
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

// B2s and B2a, second pass.
__global__ void __launch_bounds__(kThreads)
    in_relu_partial_combine_kernel(const float* __restrict__ part,
                                   float* __restrict__ o1,
                                   float* __restrict__ o2, int ostride,
                                   int planes, int splits) {
  combine_partials(part, o1, o2, ostride, planes, splits);
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

// ---- B3's kernels: B2's bodies under ModFwd and ModBwd ----------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    modnorm_relu_fwd_kernel(ModFwd<T> e, const T* __restrict__ x,
                            T* __restrict__ y, T* __restrict__ xhat,
                            float* __restrict__ rstd_out, int hw, float eps) {
  fwd_general<T, N>(e, x, y, xhat, rstd_out, hw, eps);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    modnorm_relu_fwd_warp_kernel(ModFwd<T> e, const T* __restrict__ x,
                                 T* __restrict__ y, T* __restrict__ xhat,
                                 float* __restrict__ rstd_out, int planes,
                                 int hw, float eps) {
  fwd_warp<T, P>(e, x, y, xhat, rstd_out, planes, hw, eps);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    modnorm_relu_fwd_staged_kernel(ModFwd<T> e, const T* __restrict__ x,
                                   T* __restrict__ y, T* __restrict__ xhat,
                                   float* __restrict__ rstd_out, int hw,
                                   int cs, float eps) {
  fwd_staged<T>(e, x, y, xhat, rstd_out, hw, cs, eps);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    modnorm_relu_bwd_warp_kernel(ModBwd e, const T* __restrict__ g,
                                 const T* __restrict__ y,
                                 const T* __restrict__ xhat,
                                 const float* __restrict__ rstd,
                                 T* __restrict__ dx, T* __restrict__ ds,
                                 float* __restrict__ a_out,
                                 float* __restrict__ b_out, int planes,
                                 int hw) {
  bwd_warp<T, P>(e, g, y, xhat, rstd, dx, ds, a_out, b_out, planes, hw);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    modnorm_relu_bwd_staged_kernel(ModBwd e, const T* __restrict__ g,
                                   const T* __restrict__ y,
                                   const T* __restrict__ xhat,
                                   const float* __restrict__ rstd,
                                   T* __restrict__ dx, T* __restrict__ ds,
                                   float* __restrict__ a_out,
                                   float* __restrict__ b_out, int hw, int cs) {
  bwd_staged<T>(e, g, y, xhat, rstd, dx, ds, a_out, b_out, hw, cs);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    modnorm_relu_bwd_stats_kernel(ModBwd e, const T* __restrict__ g,
                                  const T* __restrict__ y,
                                  const T* __restrict__ xhat,
                                  float* __restrict__ o1,
                                  float* __restrict__ o2, int ostride,
                                  int planes, int hw, int splits, int chunk) {
  bwd_stats<T, N>(e, g, y, xhat, o1, o2, ostride, planes, hw, splits, chunk);
}

// the split sums' second pass under B3's name
__global__ void __launch_bounds__(kThreads)
    modnorm_relu_combine_kernel(const float* __restrict__ part,
                                float* __restrict__ o1, float* __restrict__ o2,
                                int ostride, int planes, int splits) {
  combine_partials(part, o1, o2, ostride, planes, splits);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    modnorm_relu_bwd_apply_kernel(ModBwd e, const T* __restrict__ g,
                                  const T* __restrict__ y,
                                  const T* __restrict__ xhat,
                                  const float* __restrict__ rstd,
                                  const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  T* __restrict__ dx, T* __restrict__ ds,
                                  int planes, int hw) {
  bwd_apply<T, N>(e, g, y, xhat, rstd, a, b, dx, ds, planes, hw);
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

// ---- launches: one launcher a direction, for B2's kernels and B3's ---------
//
// A family F (B2's or B3's) holds a launch's operands and gives each path's
// kernel: warp<P>, staged, general<N> forward; warp<P>, staged, stats<N>,
// combine, apply<N> backward.  The launchers check the plan (ops/kernels:
// in_relu_fwd_plan, in_relu_bwd_plan) against the operands and refuse one
// that does not fit.

template <typename Tp>
struct InReluFwdLaunch {
  using T = Tp;
  const T* x;
  const float* gamma;
  const float* beta;
  T* y;
  T* xh;
  float* rstd;
  int planes, channels, hw;
  float eps;
  template <int P>
  void warp(unsigned grid, cudaStream_t st) const {
    in_relu_fwd_warp_kernel<T, P><<<grid, kThreads, 0, st>>>(
        x, gamma, beta, y, xh, rstd, planes, channels, hw, eps);
  }
  int staged(int64_t grid, int cs, int smem, cudaStream_t st) const {
    static bool smem_set = false;               // once per dtype
    return launch_clustered(in_relu_fwd_staged_kernel<T>, smem_set,
                            kMaxStageBytes, grid, cs, smem, st, x, gamma,
                            beta, y, xh, rstd, channels, hw, cs, eps);
  }
  template <int N>
  void general(cudaStream_t st) const {
    in_relu_fwd_kernel<T, N><<<planes, kThreads, 0, st>>>(
        x, gamma, beta, y, xh, rstd, channels, hw, eps);
  }
};

template <typename Tp>
struct ModnormFwdLaunch {
  using T = Tp;
  ModFwd<T> e;
  const T* x;
  T* y;
  T* xh;
  float* rstd;
  int planes, hw;
  float eps;
  template <int P>
  void warp(unsigned grid, cudaStream_t st) const {
    modnorm_relu_fwd_warp_kernel<T, P><<<grid, kThreads, 0, st>>>(
        e, x, y, xh, rstd, planes, hw, eps);
  }
  int staged(int64_t grid, int cs, int smem, cudaStream_t st) const {
    static bool smem_set = false;               // once per dtype
    return launch_clustered(modnorm_relu_fwd_staged_kernel<T>, smem_set,
                            kMaxStageBytes, grid, cs, smem, st, e, x, y, xh,
                            rstd, hw, cs, eps);
  }
  template <int N>
  void general(cudaStream_t st) const {
    modnorm_relu_fwd_kernel<T, N><<<planes, kThreads, 0, st>>>(
        e, x, y, xh, rstd, hw, eps);
  }
};

// The forward under in_relu_fwd_plan's plan: `path` 0 general, 1 warp with
// `packs` 16-byte packs a lane (eight planes a CTA), 2 staged on clusters of
// `cs` CTAs with `smem` bytes of dynamic shared memory each; `vec`: every
// operand's planes start 16-byte aligned.
template <typename F>
int launch_fwd(const F& f, bool vec, int path, int packs, int cs, int smem,
               cudaStream_t st) {
  using T = typename F::T;
  constexpr int N = 16 / sizeof(T);
  const int hw = f.hw, bad = (int)cudaErrorInvalidValue;
  if (path == kPathWarp) {
    if (!vec || (int64_t)packs * 32 * N < hw) return bad;
    const unsigned grid = (unsigned)((f.planes + kWarps - 1) / kWarps);
    switch (packs) {
      case 1: f.template warp<1>(grid, st); break;
      case 2: f.template warp<2>(grid, st); break;
      case 4: f.template warp<4>(grid, st); break;
      case kMaxWarpPacks: f.template warp<kMaxWarpPacks>(grid, st); break;
      default: return bad;
    }
    return (int)cudaGetLastError();
  }
  if (path == kPathStaged) {
    if (!vec || cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) ||
        hw % (cs * N) || smem != (int)((int64_t)hw / cs * sizeof(T)) ||
        smem > kMaxStageBytes)
      return bad;
    return f.staged((int64_t)f.planes * cs, cs, smem, st);
  }
  if (path != kPathGeneral) return bad;
  if (vec)
    f.template general<N>(st);
  else
    f.template general<1>(st);
  return (int)cudaGetLastError();
}

template <typename Tp>
struct InReluBwdLaunch {
  using T = Tp;
  const T* g;
  const T* xh;
  const float* gamma;
  const float* beta;
  const float* rstd;
  T* dx;
  float* s1;
  float* s2;
  int planes, channels, hw;
  template <int P>
  void warp(unsigned grid, cudaStream_t st) const {
    in_relu_bwd_warp_kernel<T, P><<<grid, kThreads, 0, st>>>(
        g, xh, gamma, beta, rstd, dx, s1, s2, planes, channels, hw);
  }
  int staged(int64_t grid, int cs, int smem, cudaStream_t st) const {
    static bool smem_set = false;               // once per dtype
    return launch_clustered(in_relu_bwd_staged_kernel<T>, smem_set,
                            kMaxBwdStageBytes, grid, cs, smem, st, g, xh,
                            gamma, beta, rstd, dx, s1, s2, channels, hw, cs);
  }
  template <int N>
  void stats(dim3 grid, float* o1, float* o2, int ostride, int splits,
             int chunk, cudaStream_t st) const {
    in_relu_bwd_stats_kernel<T, N><<<grid, kThreads, 0, st>>>(
        g, xh, gamma, beta, o1, o2, ostride, planes, channels, hw, splits,
        chunk);
  }
  void combine(const float* part, int splits, cudaStream_t st) const {
    in_relu_partial_combine_kernel<<<(unsigned)((planes + kThreads - 1) /
                                                kThreads),
                                     kThreads, 0, st>>>(part, s1, s2, 1,
                                                        planes, splits);
  }
  template <int N>
  void apply(dim3 grid, cudaStream_t st) const {
    in_relu_bwd_apply_kernel<T, N><<<grid, kThreads, 0, st>>>(
        g, xh, gamma, beta, rstd, s1, s2, dx, planes, channels, hw);
  }
};

template <typename Tp>
struct ModnormBwdLaunch {
  using T = Tp;
  ModBwd e;
  const T* g;
  const T* y;
  const T* xh;
  const float* rstd;
  T* dx;
  T* ds;
  float* s1;
  float* s2;
  int planes, hw;
  template <int P>
  void warp(unsigned grid, cudaStream_t st) const {
    modnorm_relu_bwd_warp_kernel<T, P><<<grid, kThreads, 0, st>>>(
        e, g, y, xh, rstd, dx, ds, s1, s2, planes, hw);
  }
  int staged(int64_t grid, int cs, int smem, cudaStream_t st) const {
    static bool smem_set = false;               // once per dtype
    return launch_clustered(modnorm_relu_bwd_staged_kernel<T>, smem_set,
                            kMaxBwdStageBytes, grid, cs, smem, st, e, g, y,
                            xh, rstd, dx, ds, s1, s2, hw, cs);
  }
  template <int N>
  void stats(dim3 grid, float* o1, float* o2, int ostride, int splits,
             int chunk, cudaStream_t st) const {
    modnorm_relu_bwd_stats_kernel<T, N><<<grid, kThreads, 0, st>>>(
        e, g, y, xh, o1, o2, ostride, planes, hw, splits, chunk);
  }
  void combine(const float* part, int splits, cudaStream_t st) const {
    modnorm_relu_combine_kernel<<<(unsigned)((planes + kThreads - 1) /
                                             kThreads),
                                  kThreads, 0, st>>>(part, s1, s2, 1, planes,
                                                     splits);
  }
  template <int N>
  void apply(dim3 grid, cudaStream_t st) const {
    modnorm_relu_bwd_apply_kernel<T, N><<<grid, kThreads, 0, st>>>(
        e, g, y, xh, rstd, s1, s2, dx, ds, planes, hw);
  }
};

// The fused backward under in_relu_bwd_plan's plan: `path` 1 warp with
// `packs` 16-byte packs a lane (eight planes a CTA), 2 staged on clusters of
// `cs` CTAs with `smem` bytes (the g + x_hat chunks) each; the split path
// is launch_bwd_sums and launch_bwd_apply.
template <typename F>
int launch_bwd_fused(const F& f, bool vec, int path, int packs, int cs,
                     int smem, cudaStream_t st) {
  using T = typename F::T;
  constexpr int N = 16 / sizeof(T);
  const int hw = f.hw, bad = (int)cudaErrorInvalidValue;
  if (path == kPathWarp) {
    if (!vec || (int64_t)packs * 32 * N < hw) return bad;
    const unsigned grid = (unsigned)((f.planes + kWarps - 1) / kWarps);
    switch (packs) {
      case 1: f.template warp<1>(grid, st); break;
      case 2: f.template warp<2>(grid, st); break;
      case 4: f.template warp<4>(grid, st); break;
      case kMaxWarpPacks: f.template warp<kMaxWarpPacks>(grid, st); break;
      default: return bad;
    }
    return (int)cudaGetLastError();
  }
  if (path == kPathStaged) {
    if (!vec || cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) ||
        hw % (cs * N) || smem != (int)((int64_t)hw / cs * 2 * sizeof(T)) ||
        smem > kMaxBwdStageBytes)
      return bad;
    return f.staged((int64_t)f.planes * cs, cs, smem, st);
  }
  return bad;
}

// The split path's sums into f.s1, f.s2 [planes]: each plane covered by
// `splits` CTAs of `chunk` elements; with splits > 1 they write `part`
// [planes, splits, 2] and F's combine pass adds it in split order.
template <typename F>
int launch_bwd_sums(const F& f, bool vec, float* part, int splits, int chunk,
                    cudaStream_t st) {
  using T = typename F::T;
  constexpr int N = 16 / sizeof(T);
  if (splits < 1 || chunk < 1 || (int64_t)splits * chunk < f.hw ||
      (int64_t)(splits - 1) * chunk >= f.hw)
    return (int)cudaErrorInvalidValue;
  // one split writes s1 / s2 directly, several their interleaved partials
  float* o1 = splits > 1 ? part : f.s1;
  float* o2 = splits > 1 ? part + 1 : f.s2;
  const int ostride = splits > 1 ? 2 : 1;
  const dim3 grid((unsigned)splits,
                  (unsigned)(f.planes < kMaxGridY ? f.planes : kMaxGridY));
  if (vec && chunk % N == 0)
    f.template stats<N>(grid, o1, o2, ostride, splits, chunk, st);
  else
    f.template stats<1>(grid, o1, o2, ostride, splits, chunk, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  f.combine(part, splits, st);
  return (int)cudaGetLastError();
}

// The split path's apply pass, `ctas` CTAs a plane.
template <typename F>
int launch_bwd_apply(const F& f, bool vec, int ctas, cudaStream_t st) {
  using T = typename F::T;
  constexpr int N = 16 / sizeof(T);
  if (ctas < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas,
                  (unsigned)(f.planes < kMaxGridY ? f.planes : kMaxGridY));
  if (vec)
    f.template apply<N>(grid, st);
  else
    f.template apply<1>(grid, st);
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

// The C entry points' bodies for one dtype.

template <typename T>
int in_relu_fwd_t(const void* x, const float* gamma, const float* beta,
                  void* y, void* xhat, float* rstd, int planes, int channels,
                  int hw, float eps, int path, int packs, int cs, int smem,
                  cudaStream_t st) {
  const InReluFwdLaunch<T> f = {(const T*)x, gamma, beta, (T*)y, (T*)xhat,
                                rstd, planes, channels, hw, eps};
  const void* ptrs[] = {x, y, xhat};
  return launch_fwd(f, vec_ok<T>(hw, ptrs, 3), path, packs, cs, smem, st);
}

template <typename T>
InReluBwdLaunch<T> in_relu_bwd_family(const void* g, const void* xhat,
                                      const void* gamma, const void* beta,
                                      const void* rstd, void* dx, void* s1,
                                      void* s2, int planes, int channels,
                                      int hw) {
  return {(const T*)g, (const T*)xhat, (const float*)gamma,
          (const float*)beta, (const float*)rstd, (T*)dx, (float*)s1,
          (float*)s2, planes, channels, hw};
}

template <typename T>
int modnorm_relu_fwd_t(const ModFwd<T>& e, const void* x, void* y,
                       void* xhat, float* rstd, int planes, int hw, float eps,
                       int path, int packs, int cs, int smem,
                       cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const ModnormFwdLaunch<T> f = {e, (const T*)x, (T*)y, (T*)xhat, rstd,
                                 planes, hw, eps};
  const void* ptrs[] = {x, y, xhat, e.s};
  const bool vec = vec_ok<T>(hw, ptrs, 4) && e.s_bstride % N == 0;
  return launch_fwd(f, vec, path, packs, cs, smem, st);
}

template <typename T>
int modnorm_relu_bwd_t(const ModBwd& e, const void* g, const void* y,
                       const void* xhat, const float* rstd, void* dx,
                       void* ds, float* a, float* b, float* part, int planes,
                       int hw, int path, int packs, int cs, int smem,
                       int splits, int chunk, int apply_ctas,
                       cudaStream_t st) {
  const ModnormBwdLaunch<T> f = {e, (const T*)g, (const T*)y, (const T*)xhat,
                                 rstd, (T*)dx, (T*)ds, a, b, planes, hw};
  const void* ptrs[] = {g, y, xhat, dx, ds};
  const bool vec = vec_ok<T>(hw, ptrs, 5);
  if (path != kPathGeneral)
    return launch_bwd_fused(f, vec, path, packs, cs, smem, st);
  if (apply_ctas < 1) return (int)cudaErrorInvalidValue;
  const int err = launch_bwd_sums(f, vec, part, splits, chunk, st);
  return err ? err : launch_bwd_apply(f, vec, apply_ctas, st);
}

// ---- channels-last (NHWC) plans: B2 and B3 over [N, H * W, C] slabs ------
//
// A channels-last activation holds sample n as an [H * W, C] slab, C
// innermost, so an (n, c) plane is a column of the slab with its elements C
// apart.  The NHWC plans keep each thread on fixed channels: thread t of a
// CTA owns the pack of `pack` channels (a 16-byte vector, 8 bf16 or 4 f32;
// one element where C or a pointer does not allow it) at column v = t % V of
// the CTA's channel tile (V packs, at most kNhwcMaxTile channels), and walks
// the rows r = t / V, r + R, ... (R = kThreads / V).  A warp's loads cover
// 32 / V rows of V * 16 contiguous bytes, whole 128-byte lines at V = 8, so
// they coalesce at every width of G-Net.  A thread keeps its channels' sums
// in float32 registers and its channels' constants (mean, rstd, gamma, ...)
// in registers for the whole slab.  The CTA adds the sums over its row
// groups in a fixed order (shuffles within a warp, then the warps in order
// through shared memory), so the outputs are equal from run to run.
// The forward writes y and each plane's mean and rstd, not x_hat: the
// backward reads x in x_hat's place and takes x_hat from it again in
// float32 (2 B an element less written forward, and x_hat unrounded).
//   staged  a cluster of `cs` CTAs covers all rows of one (sample, tile),
//           each CTA hw / cs rows of it, which it copies into shared memory
//           (cp.async: x and s forward; g, x and y backward).  The CTAs add
//           their sums through distributed shared memory in rank order and
//           apply from shared memory: each operand is read once.
//   split   a tile too large for a cluster (G-Net's 256^2 level): a sums
//           pass writes each CTA's partial (a chunk of `chunk` rows), the
//           combine pass adds a plane's partials in a fixed order (a warp a
//           plane), and the apply pass reads the operands again, the
//           samples in reverse so that its first reads find the L2 warm.
// Bound: the function's bytes, as the NCHW plans' (B2 10 B an element a
// bf16 training step, B3 16 B, 6 under no-grad); the split plan reads its
// operands twice.  The same sums pass also gives channel_sums_nhwc, the
// channel sums of a channels-last tensor (a conv bias's gradient).

constexpr int kNhwcMaxTile = 64;                 // channels a CTA covers
constexpr int kNhwcMaxStageBytes = 200 * 1024;   // a staged CTA's operands
constexpr int kNhwcParts = 4;        // commit groups a staged CTA's copies
constexpr int kNhwcUnroll = 8;       // rows a split-plan thread loads at once
constexpr int kNhwcUnrollGrad = 4;   // the same, of two or three operands
constexpr int kNhwcMinBlocks = 2;                // CTAs an SM should hold

// 16-byte asynchronous copy global -> shared (cp.async, cached in L2 only),
// completed per thread by the commit groups below.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` of the thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> ld_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void st_pack(T* p, const Pack<T, N>& v) {
  *reinterpret_cast<Pack<T, N>*>(p) = v;
}

// A store marked as streaming (evict first from L2), where it is 16 bytes:
// the split plan's apply pass keeps the L2 for the operands it reads again.
template <typename T, int N>
__device__ __forceinline__ void st_pack_cs(T* p, const Pack<T, N>& v) {
  if constexpr (sizeof(Pack<T, N>) == 16)
    __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(&v));
  else
    st_pack(p, v);
}

// A thread's place in an NHWC CTA: column v of V packs, row group r of R,
// and the channel of its first element.
struct NhwcLane {
  int v, r, R, c0;
};

__device__ __forceinline__ NhwcLane nhwc_lane(int V, int tile, int pack) {
  const int v = (int)threadIdx.x % V;
  return {v, (int)threadIdx.x / V, kThreads / V, (tile * V + v) * pack};
}

// Running (sum x, sum x^2) of each channel of one pack.
template <typename T, int N>
__device__ __forceinline__ void add_cols(const Pack<T, N>& p, float (&a)[N],
                                         float (&b)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float v = to_f(p.v[k]);
    a[k] = __fadd_rn(a[k], v);
    b[k] = __fadd_rn(b[k], __fmul_rn(v, v));
  }
}

// Each channel's (a, b) added over the CTA's row groups in a fixed order:
// the lanes of a warp that share a column by shuffles, then the warps in
// order through `red` [kWarps][kNhwcMaxTile][2].  The tile's sums land in
// `out` [V * N][2]; ends on a barrier, so `out` is visible to every thread.
template <int N>
__device__ __forceinline__ void nhwc_block_sum(float (&a)[N], float (&b)[N],
                                               int V, float* red, float* out) {
  for (int o = V; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      a[k] = __fadd_rn(a[k], __shfl_xor_sync(0xffffffffu, a[k], o));
      b[k] = __fadd_rn(b[k], __shfl_xor_sync(0xffffffffu, b[k], o));
    }
  }
  const int lane = (int)threadIdx.x % 32, warp = (int)threadIdx.x / 32;
  if (lane < V) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float* q = red + 2 * (warp * kNhwcMaxTile + lane * N + k);
      q[0] = a[k];
      q[1] = b[k];
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < 2 * V * N) {  // moment t % 2 of channel t / 2
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w)
      s = __fadd_rn(s, red[2 * w * kNhwcMaxTile + threadIdx.x]);
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// y and x_hat of one pack, each element under its own channel's constants.
template <typename Epi, typename T, int N>
__device__ __forceinline__ void norm_cols(const Epi& e,
                                          const typename Epi::Plane (&k)[N],
                                          const float (&mean)[N],
                                          const float (&rs)[N],
                                          const Pack<T, N>& p,
                                          const Pack<T, N>& ps,
                                          Pack<T, N>& po, Pack<T, N>& ph) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float h = __fmul_rn(__fsub_rn(to_f(p.v[j]), mean[j]), rs[j]);
    po.v[j] = from_f<T>(fmaxf(e.z(k[j], h, to_f(ps.v[j])), 0.0f));
    ph.v[j] = from_f<T>(h);
  }
}

// Running (s1, s2) = (sum gz, sum gz * x_hat) of each channel of one pack,
// as grad_sum_pack (x_hat given in float32, h): under Epi::kReadsY gz
// replaces g in pg.
template <typename Epi, typename T, int N>
__device__ __forceinline__ void grad_sum_cols(
    const Epi& e, const typename Epi::Plane (&k)[N], Pack<T, N>& pg,
    const float (&hv)[N], const Pack<T, N>& py, float (&a)[N],
    float (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float h = hv[j];
    float yv = 0.0f;
    if constexpr (Epi::kReadsY) yv = to_f(py.v[j]);
    const float gz = e.keep(k[j], h, yv) ? to_f(pg.v[j]) : 0.0f;
    if constexpr (Epi::kReadsY) pg.v[j] = from_f<T>(gz);
    a[j] = __fadd_rn(a[j], gz);
    b[j] = __fadd_rn(b[j], __fmul_rn(gz, h));
  }
}

// dx of one pack, as grad_pack, each element under its channel's constants
// (x_hat given in float32, h).
template <typename Epi, typename T, int N>
__device__ __forceinline__ Pack<T, N> grad_cols(
    const Epi& e, const typename Epi::Plane (&k)[N], const GradCoef (&c)[N],
    const Pack<T, N>& pg, const float (&hv)[N]) {
  Pack<T, N> out;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float h = hv[j];
    float gz = to_f(pg.v[j]);
    if constexpr (!Epi::kReadsY) gz = e.keep(k[j], h, 0.0f) ? gz : 0.0f;
    const float d = __fsub_rn(__fsub_rn(gz, c[j].m1), __fmul_rn(h, c[j].m2));
    out.v[j] = from_f<T>(__fmul_rn(c[j].coef, d));
  }
  return out;
}

// x_hat of one pack in float32, (x - mean) * rstd as the forward computes
// it: the NHWC plans keep x for the backward, not x_hat.
template <typename T, int N>
__device__ __forceinline__ void xhat_cols(const Pack<T, N>& p,
                                          const float (&mean)[N],
                                          const float (&rs)[N],
                                          float (&h)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    h[j] = __fmul_rn(__fsub_rn(to_f(p.v[j]), mean[j]), rs[j]);
}

// The spatial term's pack at element offset `o` where the epilogue reads
// one, else zeros.
template <typename Epi, typename T, int N>
__device__ __forceinline__ Pack<T, N> s_cols(const T* s, int64_t o) {
  if constexpr (Epi::kSpatial) {
    if (s) return ld_pack<T, N>(s + o);
  }
  return zero_pack<T, N>();
}

// `out` [2 * tc] replaced by the cluster's sums, read from every CTA's
// `part` through distributed shared memory and added in rank order, so
// every CTA gets the same sums with no atomics.  A CTA that called it must
// pass one more cluster barrier before it exits (a peer may still read its
// `part`).
__device__ __forceinline__ void nhwc_cluster_add(float* out, float* part,
                                                 int tc, int cs) {
  cg::cluster_group cluster = cg::this_cluster();
  if ((int)threadIdx.x < 2 * tc) part[threadIdx.x] = out[threadIdx.x];
  cluster.sync();
  if ((int)threadIdx.x < 2 * tc) {
    float s = 0.0f;
    for (int q = 0; q < cs; ++q)
      s = __fadd_rn(s, cluster.map_shared_rank(part, q)[threadIdx.x]);
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// The thread's rows l.r + k * l.R (k < K) of `arrays` operands (src[a] at
// the CTA's first row, rows `pitch[a]` elements apart) copied into `dst`
// ([arrays][rows][V] packs, the thread's column at l.v) in kNhwcParts
// commit groups: cp.async where a pack is 16 bytes, so that every copy is
// in flight at once and each part can be summed as it lands (a thread reads
// back only its own copies: no barrier); plain loads otherwise.
template <typename T, int N, int A>
__device__ __forceinline__ void nhwc_stage(Pack<T, N>* dst,
                                           const T* const (&src)[A],
                                           const int64_t (&pitch)[A],
                                           int arrays, const NhwcLane& l,
                                           int rows, int V, int K, int per) {
  for (int q = 0; q < kNhwcParts; ++q) {
    for (int k = q * per; k < min(K, (q + 1) * per); ++k) {
      const int i = l.r + k * l.R;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (a >= arrays) break;
        Pack<T, N>* d = dst + ((int64_t)a * rows + i) * V + l.v;
        const T* from = src[a] + (int64_t)i * pitch[a];
        if constexpr (sizeof(Pack<T, N>) == 16)
          cp_async16(d, from);
        else
          *d = ld_pack<T, N>(from);
      }
    }
    cp_async_commit();
  }
}

// Staged forward: a cluster of `cs` CTAs per (sample, tile); CTA `rank`
// keeps rows [rank * hw / cs, (rank + 1) * hw / cs) of x in shared memory,
// and of s (B3's spatial term, `s_row` elements a row and `s_sample` a
// sample apart; null for B2 or where the block has none) after them.  It
// writes y and, in training, each channel's mean and rstd (mean_out and
// rstd_out null under no-grad).
template <typename T, int N, typename Epi>
__device__ __forceinline__ void nhwc_fwd_staged(
    const Epi& e, const T* __restrict__ x, const T* __restrict__ s,
    int64_t s_row, int64_t s_sample, T* __restrict__ y,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, int C, int hw,
    int V, int cs, float eps) {
  using P = Pack<T, N>;
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ float red[2 * kWarps * kNhwcMaxTile];
  __shared__ float sums[2 * kNhwcMaxTile];
  __shared__ float part[2 * kNhwcMaxTile];
  const int tc = V * N, tiles = C / tc;
  const int rank = (int)(blockIdx.x % cs);
  const int item = (int)(blockIdx.x / cs);
  const int tile = item % tiles;
  const int64_t n = item / tiles;
  const int rows = hw / cs, row0 = rank * rows;
  const NhwcLane l = nhwc_lane(V, tile, N);
  const int64_t base = (n * hw + row0) * C + l.c0;
  const bool has_s = Epi::kSpatial && s;
  const P* st = reinterpret_cast<const P*>(stage) + l.v;  // row i: st[i * V]
  const P* ss = st + (int64_t)rows * V;                   // s's after them
  const int K = rows > l.r ? (rows - l.r + l.R - 1) / l.R : 0;
  const int per = (K + kNhwcParts - 1) / kNhwcParts;
  {
    const T* src[2] = {x + base,
                       has_s ? s + n * s_sample + (int64_t)row0 * s_row + l.c0
                             : x};
    const int64_t pitch[2] = {C, s_row};
    nhwc_stage<T, N, 2>(reinterpret_cast<P*>(stage), src, pitch,
                        has_s ? 2 : 1, l, rows, V, K, per);
  }
  float a[N], b[N];
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = b[k] = 0.0f;
  for (int q = 0; q < kNhwcParts; ++q) {
    cp_async_wait(kNhwcParts - 1 - q);
    for (int k = q * per; k < min(K, (q + 1) * per); ++k)
      add_cols(st[(l.r + k * l.R) * V], a, b);
  }
  nhwc_block_sum<N>(a, b, V, red, sums);
  if (cs > 1) nhwc_cluster_add(sums, part, tc, cs);
  if ((int)threadIdx.x < tc) {     // channel t's mean and rstd, over its sums
    const int t = threadIdx.x;
    float mean;
    const float r = plane_rstd(sums[2 * t], sums[2 * t + 1], hw, eps, mean);
    sums[2 * t] = mean;
    sums[2 * t + 1] = r;
    if (rstd_out && rank == 0) {
      mean_out[n * C + tile * tc + t] = mean;
      rstd_out[n * C + tile * tc + t] = r;
    }
  }
  __syncthreads();
  typename Epi::Plane k[N];
  float mean[N], rs[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mean[j] = sums[2 * (l.v * N + j)];
    rs[j] = sums[2 * (l.v * N + j) + 1];
    k[j] = e.plane(n * C + l.c0 + j);
  }
  for (int i = l.r; i < rows; i += l.R) {
    P po, ph;
    norm_cols(e, k, mean, rs, st[i * V],
              has_s ? ss[i * V] : zero_pack<T, N>(), po, ph);
    st_pack(y + base + (int64_t)i * C, po);
  }
  if (cs > 1) cg::this_cluster().sync();       // peers done with `part`
}

// A thread's channels' mean and rstd (the forward's, of sample n).
template <int N>
__device__ __forceinline__ void nhwc_stats_of(const float* __restrict__ mean,
                                              const float* __restrict__ rstd,
                                              int64_t p, float (&mx)[N],
                                              float (&rx)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mx[j] = mean[p + j];
    rx[j] = rstd[p + j];
  }
}

// Staged backward: as the forward, with g, x and, where the epilogue reads
// it, y in shared memory; x_hat is taken from x again, in float32.  The
// first pass leaves g_m in g's place for the second and writes ds (if not
// null).
template <typename T, int N, typename Epi>
__device__ __forceinline__ void nhwc_bwd_staged(
    const Epi& e, const T* __restrict__ g, const T* __restrict__ y,
    const T* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ rstd, T* __restrict__ dx, T* __restrict__ ds,
    float* __restrict__ s1_out, float* __restrict__ s2_out, int C, int hw,
    int V, int cs) {
  using P = Pack<T, N>;
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ float red[2 * kWarps * kNhwcMaxTile];
  __shared__ float sums[2 * kNhwcMaxTile];
  __shared__ float part[2 * kNhwcMaxTile];
  const int tc = V * N, tiles = C / tc;
  const int rank = (int)(blockIdx.x % cs);
  const int item = (int)(blockIdx.x / cs);
  const int tile = item % tiles;
  const int64_t n = item / tiles;
  const int rows = hw / cs, row0 = rank * rows;
  const NhwcLane l = nhwc_lane(V, tile, N);
  const int64_t base = (n * hw + row0) * C + l.c0;
  P* sg = reinterpret_cast<P*>(stage) + l.v;
  const P* sx = sg + (int64_t)rows * V;
  const P* sy = sx + (int64_t)rows * V;
  const int K = rows > l.r ? (rows - l.r + l.R - 1) / l.R : 0;
  const int per = (K + kNhwcParts - 1) / kNhwcParts;
  {
    const T* src[3] = {g + base, x + base,
                       Epi::kReadsY ? y + base : g + base};
    const int64_t pitch[3] = {C, C, C};
    nhwc_stage<T, N, 3>(reinterpret_cast<P*>(stage), src, pitch,
                        Epi::kReadsY ? 3 : 2, l, rows, V, K, per);
  }
  typename Epi::Plane k[N];
  float a[N], b[N], mx[N], rx[N];
  nhwc_stats_of<N>(mean, rstd, n * C + l.c0, mx, rx);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    k[j] = e.plane(n * C + l.c0 + j);
    a[j] = b[j] = 0.0f;
  }
  for (int q = 0; q < kNhwcParts; ++q) {
    cp_async_wait(kNhwcParts - 1 - q);
    for (int kk = q * per; kk < min(K, (q + 1) * per); ++kk) {
      const int i = l.r + kk * l.R;
      P pg = sg[i * V];
      float h[N];
      xhat_cols(sx[i * V], mx, rx, h);
      if constexpr (Epi::kReadsY) {
        grad_sum_cols(e, k, pg, h, sy[i * V], a, b);
        sg[i * V] = pg;
        if (ds) st_pack(ds + base + (int64_t)i * C, pg);
      } else {
        grad_sum_cols(e, k, pg, h, pg, a, b);
      }
    }
  }
  nhwc_block_sum<N>(a, b, V, red, sums);
  if (cs > 1) nhwc_cluster_add(sums, part, tc, cs);
  if ((int)threadIdx.x < tc) {     // channel t's sums out, its coefficients
    const int t = threadIdx.x;
    const int64_t p = n * C + tile * tc + t;
    if (rank == 0) {
      s1_out[p] = sums[2 * t];
      s2_out[p] = sums[2 * t + 1];
    }
    const GradCoef gc =
        grad_coef(e, e.plane(p), rstd[p], sums[2 * t], sums[2 * t + 1], hw);
    red[3 * t] = gc.m1;                // red is free after nhwc_block_sum
    red[3 * t + 1] = gc.m2;
    red[3 * t + 2] = gc.coef;
  }
  __syncthreads();
  GradCoef c[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float* q = red + 3 * (l.v * N + j);
    c[j] = {q[0], q[1], q[2]};
  }
  for (int i = l.r; i < rows; i += l.R) {
    float h[N];
    xhat_cols(sx[i * V], mx, rx, h);
    st_pack(dx + base + (int64_t)i * C, grad_cols(e, k, c, sg[i * V], h));
  }
  if (cs > 1) cg::this_cluster().sync();
}

// Split plan, the forward's sums pass: CTA (split, tile, n) adds rows
// [split * chunk, min(hw, (split + 1) * chunk)) of its tile and writes
// (sum x, sum x^2) of each channel to part[((n * C + c) * splits + split) *
// 2], the layout combine_partials adds in split order.
template <typename T, int N>
__device__ __forceinline__ void nhwc_sums_x(const T* __restrict__ x,
                                            float* __restrict__ part, int C,
                                            int hw, int V, int splits,
                                            int chunk) {
  using P = Pack<T, N>;
  __shared__ float red[2 * kWarps * kNhwcMaxTile];
  __shared__ float sums[2 * kNhwcMaxTile];
  const int tc = V * N, tile = blockIdx.y;
  const int64_t n = blockIdx.z;
  const int lo = blockIdx.x * chunk, rows = min(hw - lo, chunk);
  const NhwcLane l = nhwc_lane(V, tile, N);
  const int64_t base = (n * hw + lo) * C + l.c0;
  float a[N], b[N];
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = b[k] = 0.0f;
  for (int i0 = l.r; i0 < rows; i0 += kNhwcUnroll * l.R) {
    P p[kNhwcUnroll];
#pragma unroll
    for (int u = 0; u < kNhwcUnroll; ++u)
      if (i0 + u * l.R < rows)
        p[u] = ld_pack<T, N>(x + base + (int64_t)(i0 + u * l.R) * C);
#pragma unroll
    for (int u = 0; u < kNhwcUnroll; ++u)
      if (i0 + u * l.R < rows) add_cols(p[u], a, b);
  }
  nhwc_block_sum<N>(a, b, V, red, sums);
  if ((int)threadIdx.x < 2 * tc) {
    const int t = threadIdx.x;
    part[((n * C + tile * tc + t / 2) * splits + blockIdx.x) * 2 + t % 2] =
        sums[t];
  }
}

// Split plan, the backward's sums pass: as nhwc_sums_x over (sum gz, sum
// gz * x_hat), x_hat taken from x again.
template <typename T, int N, typename Epi>
__device__ __forceinline__ void nhwc_sums_grad(
    const Epi& e, const T* __restrict__ g, const T* __restrict__ y,
    const T* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ rstd, float* __restrict__ part, int C, int hw,
    int V, int splits, int chunk) {
  using P = Pack<T, N>;
  __shared__ float red[2 * kWarps * kNhwcMaxTile];
  __shared__ float sums[2 * kNhwcMaxTile];
  const int tc = V * N, tile = blockIdx.y;
  const int64_t n = blockIdx.z;
  const int lo = blockIdx.x * chunk, rows = min(hw - lo, chunk);
  const NhwcLane l = nhwc_lane(V, tile, N);
  const int64_t base = (n * hw + lo) * C + l.c0;
  typename Epi::Plane k[N];
  float a[N], b[N], mx[N], rx[N];
  nhwc_stats_of<N>(mean, rstd, n * C + l.c0, mx, rx);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    k[j] = e.plane(n * C + l.c0 + j);
    a[j] = b[j] = 0.0f;
  }
  for (int i0 = l.r; i0 < rows; i0 += kNhwcUnrollGrad * l.R) {
    P pg[kNhwcUnrollGrad], px[kNhwcUnrollGrad], py[kNhwcUnrollGrad];
#pragma unroll
    for (int u = 0; u < kNhwcUnrollGrad; ++u) {
      const int64_t o = base + (int64_t)(i0 + u * l.R) * C;
      if (i0 + u * l.R < rows) {
        pg[u] = ld_pack<T, N>(g + o);
        px[u] = ld_pack<T, N>(x + o);
        if constexpr (Epi::kReadsY) py[u] = ld_pack<T, N>(y + o);
      }
    }
#pragma unroll
    for (int u = 0; u < kNhwcUnrollGrad; ++u)
      if (i0 + u * l.R < rows) {
        float h[N];
        xhat_cols(px[u], mx, rx, h);
        grad_sum_cols(e, k, pg[u], h, Epi::kReadsY ? py[u] : pg[u], a, b);
      }
  }
  nhwc_block_sum<N>(a, b, V, red, sums);
  if ((int)threadIdx.x < 2 * tc) {
    const int t = threadIdx.x;
    part[((n * C + tile * tc + t / 2) * splits + blockIdx.x) * 2 + t % 2] =
        sums[t];
  }
}

// Split plan, the forward's apply pass: CTA (chunk, tile, n) writes y of
// its rows from the combined sums `tot` [N * C][2]; the first chunk's CTAs
// write mean and rstd (null under no-grad).  The sums pass read the
// samples in order; the apply pass walks them in reverse, so that its first
// reads find what the sums pass left in L2.
template <typename T, int N, typename Epi>
__device__ __forceinline__ void nhwc_fwd_apply(
    const Epi& e, const T* __restrict__ x, const T* __restrict__ s,
    int64_t s_row, int64_t s_sample, const float* __restrict__ tot,
    T* __restrict__ y, float* __restrict__ mean_out,
    float* __restrict__ rstd_out, int C, int hw, int V, int chunk,
    float eps) {
  using P = Pack<T, N>;
  const int tile = blockIdx.y, ci = gridDim.x - 1 - blockIdx.x;
  const int64_t n = gridDim.z - 1 - blockIdx.z;
  const int lo = ci * chunk, rows = min(hw - lo, chunk);
  const NhwcLane l = nhwc_lane(V, tile, N);
  const int64_t base = (n * hw + lo) * C + l.c0;
  typename Epi::Plane k[N];
  float mean[N], rs[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int64_t p = n * C + l.c0 + j;
    rs[j] = plane_rstd(tot[2 * p], tot[2 * p + 1], hw, eps, mean[j]);
    k[j] = e.plane(p);
    if (rstd_out && ci == 0 && l.r == 0) {
      mean_out[p] = mean[j];
      rstd_out[p] = rs[j];
    }
  }
  const T* sp = Epi::kSpatial && s
                    ? s + n * s_sample + (int64_t)lo * s_row + l.c0
                    : nullptr;
  // B3 reads s beside x: half the rows at once, within the registers
  constexpr int U = Epi::kSpatial ? kNhwcUnrollGrad : kNhwcUnroll;
  for (int i0 = l.r; i0 < rows; i0 += U * l.R) {
    P p[U], ps[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * l.R;
      if (i < rows) {
        p[u] = ld_pack<T, N>(x + base + (int64_t)i * C);
        ps[u] = s_cols<Epi, T, N>(sp, (int64_t)i * s_row);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * l.R;
      if (i < rows) {
        P po, ph;
        norm_cols(e, k, mean, rs, p[u], ps[u], po, ph);
        st_pack_cs(y + base + (int64_t)i * C, po);
      }
    }
  }
}

// Split plan, the backward's apply pass: dx (and ds under Epi::kReadsY)
// from the combined sums s1, s2 [N * C], x_hat taken from x again; the
// samples in reverse, as nhwc_fwd_apply's.
template <typename T, int N, typename Epi>
__device__ __forceinline__ void nhwc_bwd_apply(
    const Epi& e, const T* __restrict__ g, const T* __restrict__ y,
    const T* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ s1,
    const float* __restrict__ s2, T* __restrict__ dx, T* __restrict__ ds,
    int C, int hw, int V, int chunk) {
  using P = Pack<T, N>;
  const int tile = blockIdx.y, ci = gridDim.x - 1 - blockIdx.x;
  const int64_t n = gridDim.z - 1 - blockIdx.z;
  const int lo = ci * chunk, rows = min(hw - lo, chunk);
  const NhwcLane l = nhwc_lane(V, tile, N);
  const int64_t base = (n * hw + lo) * C + l.c0;
  typename Epi::Plane k[N];
  GradCoef c[N];
  float mx[N], rx[N];
  nhwc_stats_of<N>(mean, rstd, n * C + l.c0, mx, rx);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int64_t p = n * C + l.c0 + j;
    k[j] = e.plane(p);
    c[j] = grad_coef(e, k[j], rx[j], s1[p], s2[p], hw);
  }
  for (int i0 = l.r; i0 < rows; i0 += kNhwcUnrollGrad * l.R) {
    P pg[kNhwcUnrollGrad], px[kNhwcUnrollGrad], py[kNhwcUnrollGrad];
#pragma unroll
    for (int u = 0; u < kNhwcUnrollGrad; ++u) {
      const int64_t o = base + (int64_t)(i0 + u * l.R) * C;
      if (i0 + u * l.R < rows) {
        pg[u] = ld_pack<T, N>(g + o);
        px[u] = ld_pack<T, N>(x + o);
        if constexpr (Epi::kReadsY) py[u] = ld_pack<T, N>(y + o);
      }
    }
#pragma unroll
    for (int u = 0; u < kNhwcUnrollGrad; ++u) {
      const int i = i0 + u * l.R;
      if (i < rows) {
        const int64_t o = base + (int64_t)i * C;
        float h[N];
        xhat_cols(px[u], mx, rx, h);
        if constexpr (Epi::kReadsY) {
          float ua[N], ub[N];          // the sums are the first pass's
#pragma unroll
          for (int j = 0; j < N; ++j) ua[j] = ub[j] = 0.0f;
          grad_sum_cols(e, k, pg[u], h, py[u], ua, ub);
          if (ds) st_pack_cs(ds + o, pg[u]);
        }
        st_pack_cs(dx + o, grad_cols(e, k, c, pg[u], h));
      }
    }
  }
}

// ---- the NHWC kernels: B2's under AffineFwd / AffineBwd, B3's under ModFwd
// / ModBwd (named so that a trace tells B2 from B3)

#define NHWC_KERNEL \
  template <typename T, int N>       \
  __global__ void __launch_bounds__(kThreads, kNhwcMinBlocks)

NHWC_KERNEL in_relu_nhwc_fwd_staged_kernel(AffineFwd<T> e, const T* x, T* y,
                                           float* mean, float* rstd, int C,
                                           int hw, int V, int cs, float eps) {
  nhwc_fwd_staged<T, N>(e, x, (const T*)nullptr, 0, 0, y, mean, rstd, C, hw,
                        V, cs, eps);
}

NHWC_KERNEL in_relu_nhwc_sums_kernel(const T* x, float* part, int C, int hw,
                                     int V, int splits, int chunk) {
  nhwc_sums_x<T, N>(x, part, C, hw, V, splits, chunk);
}

NHWC_KERNEL in_relu_nhwc_fwd_apply_kernel(AffineFwd<T> e, const T* x,
                                          const float* tot, T* y, float* mean,
                                          float* rstd, int C, int hw, int V,
                                          int chunk, float eps) {
  nhwc_fwd_apply<T, N>(e, x, (const T*)nullptr, 0, 0, tot, y, mean, rstd, C,
                       hw, V, chunk, eps);
}

NHWC_KERNEL in_relu_nhwc_bwd_staged_kernel(AffineBwd e, const T* g,
                                           const T* x, const float* mean,
                                           const float* rstd, T* dx,
                                           float* s1, float* s2, int C,
                                           int hw, int V, int cs) {
  nhwc_bwd_staged<T, N>(e, g, (const T*)nullptr, x, mean, rstd, dx,
                        (T*)nullptr, s1, s2, C, hw, V, cs);
}

NHWC_KERNEL in_relu_nhwc_bwd_sums_kernel(AffineBwd e, const T* g, const T* x,
                                         const float* mean, const float* rstd,
                                         float* part, int C, int hw, int V,
                                         int splits, int chunk) {
  nhwc_sums_grad<T, N>(e, g, (const T*)nullptr, x, mean, rstd, part, C, hw,
                       V, splits, chunk);
}

NHWC_KERNEL in_relu_nhwc_bwd_apply_kernel(AffineBwd e, const T* g, const T* x,
                                          const float* mean,
                                          const float* rstd, const float* s1,
                                          const float* s2, T* dx, int C,
                                          int hw, int V, int chunk) {
  nhwc_bwd_apply<T, N>(e, g, (const T*)nullptr, x, mean, rstd, s1, s2, dx,
                       (T*)nullptr, C, hw, V, chunk);
}

NHWC_KERNEL modnorm_relu_nhwc_fwd_staged_kernel(ModFwd<T> e, const T* x,
                                                const T* s, int64_t s_row,
                                                int64_t s_sample, T* y,
                                                float* mean, float* rstd,
                                                int C, int hw, int V, int cs,
                                                float eps) {
  nhwc_fwd_staged<T, N>(e, x, s, s_row, s_sample, y, mean, rstd, C, hw, V, cs,
                        eps);
}

NHWC_KERNEL modnorm_relu_nhwc_sums_kernel(const T* x, float* part, int C,
                                          int hw, int V, int splits,
                                          int chunk) {
  nhwc_sums_x<T, N>(x, part, C, hw, V, splits, chunk);
}

NHWC_KERNEL modnorm_relu_nhwc_fwd_apply_kernel(ModFwd<T> e, const T* x,
                                               const T* s, int64_t s_row,
                                               int64_t s_sample,
                                               const float* tot, T* y,
                                               float* mean, float* rstd,
                                               int C, int hw, int V,
                                               int chunk, float eps) {
  nhwc_fwd_apply<T, N>(e, x, s, s_row, s_sample, tot, y, mean, rstd, C, hw, V,
                       chunk, eps);
}

NHWC_KERNEL modnorm_relu_nhwc_bwd_staged_kernel(ModBwd e, const T* g,
                                                const T* y, const T* x,
                                                const float* mean,
                                                const float* rstd, T* dx,
                                                T* ds, float* a, float* b,
                                                int C, int hw, int V, int cs) {
  nhwc_bwd_staged<T, N>(e, g, y, x, mean, rstd, dx, ds, a, b, C, hw, V, cs);
}

NHWC_KERNEL modnorm_relu_nhwc_bwd_sums_kernel(ModBwd e, const T* g,
                                              const T* y, const T* x,
                                              const float* mean,
                                              const float* rstd, float* part,
                                              int C, int hw, int V, int splits,
                                              int chunk) {
  nhwc_sums_grad<T, N>(e, g, y, x, mean, rstd, part, C, hw, V, splits, chunk);
}

NHWC_KERNEL modnorm_relu_nhwc_bwd_apply_kernel(ModBwd e, const T* g,
                                               const T* y, const T* x,
                                               const float* mean,
                                               const float* rstd,
                                               const float* a, const float* b,
                                               T* dx, T* ds, int C, int hw,
                                               int V, int chunk) {
  nhwc_bwd_apply<T, N>(e, g, y, x, mean, rstd, a, b, dx, ds, C, hw, V, chunk);
}

// Channel sums of a channels-last tensor (a conv bias's gradient, where
// the tensor is the gradient of the conv's output): the split plan's sums
// pass over all the tensor's rows as one sample, under a name of its own
// (it is neither B2 nor B3).
NHWC_KERNEL channel_sums_nhwc_kernel(const T* x, float* part, int C, int rows,
                                     int V, int splits, int chunk) {
  nhwc_sums_x<T, N>(x, part, C, rows, V, splits, chunk);
}

#undef NHWC_KERNEL

// The split plan's combine, one warp a plane: lane j adds chunks j, j + 32,
// ... in order, then the lanes' sums by shuffles (the same order on every
// run), into (o1, o2) at plane * ostride.
__device__ __forceinline__ void nhwc_combine_warp(const float* __restrict__ part,
                                                  float* __restrict__ o1,
                                                  float* __restrict__ o2,
                                                  int ostride, int planes,
                                                  int splits) {
  const int64_t plane = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = (int)threadIdx.x % 32;
  if (plane >= planes) return;             // a whole warp: plane is uniform
  const float* p = part + 2 * plane * splits;
  float s = 0.0f, ss = 0.0f;
  for (int k = lane; k < splits; k += 32) {
    s = __fadd_rn(s, p[2 * k]);
    ss = __fadd_rn(ss, p[2 * k + 1]);
  }
  warp_sum2(s, ss);
  if (lane == 0) {
    o1[plane * ostride] = s;
    o2[plane * ostride] = ss;
  }
}

__global__ void __launch_bounds__(kThreads)
    in_relu_nhwc_combine_kernel(const float* part, float* o1, float* o2,
                                int ostride, int planes, int splits) {
  nhwc_combine_warp(part, o1, o2, ostride, planes, splits);
}

__global__ void __launch_bounds__(kThreads)
    modnorm_relu_nhwc_combine_kernel(const float* part, float* o1, float* o2,
                                     int ostride, int planes, int splits) {
  nhwc_combine_warp(part, o1, o2, ostride, planes, splits);
}

__global__ void __launch_bounds__(kThreads)
    channel_sums_combine_kernel(const float* part, float* o1, float* o2,
                                int ostride, int planes, int splits) {
  nhwc_combine_warp(part, o1, o2, ostride, planes, splits);
}


// ---- NHWC launches ----------------------------------------------------------
//
// ops/kernels.in_relu_nhwc_plan's plan: `path` kPathStaged (a cluster of
// `cs` CTAs a (sample, tile), `smem` bytes of dynamic shared memory each) or
// kPathGeneral for the split plan (`splits` chunks of `chunk` rows a sample,
// then the combine and apply passes); `pack` elements a thread's vector,
// `v` vectors a row of the tile.
struct NhwcPlan {
  int path, pack, v, cs, smem, splits, chunk;
};

// A family (B2 or B3, forward or backward) gives the paths' launches for
// pack P: staged<P>, sums<P>, combine, apply<P>, and arrays(), the operands
// a staged CTA keeps (x, and B3's s where given; g and x_hat, and B3's y).
template <int P, typename F>
int nhwc_run(const F& f, const NhwcPlan& p, cudaStream_t st) {
  using T = typename F::T;
  const int tiles = f.C / (p.v * P);
  if (p.path == kPathStaged) {
    if (p.cs < 1 || p.cs > kMaxCluster || (p.cs & (p.cs - 1)) ||
        f.hw % p.cs ||
        p.smem != (int)((int64_t)f.hw / p.cs * p.v * P * sizeof(T) *
                        f.arrays()) ||
        p.smem > kNhwcMaxStageBytes)
      return (int)cudaErrorInvalidValue;
    return f.template staged<P>(p, (int64_t)f.n * tiles * p.cs, st);
  }
  if (p.path != kPathGeneral || p.splits < 1 || p.chunk < 1 ||
      (int64_t)p.splits * p.chunk < f.hw ||
      (int64_t)(p.splits - 1) * p.chunk >= f.hw || f.n > kMaxGridY ||
      tiles > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.splits, (unsigned)tiles, (unsigned)f.n);
  f.template sums<P>(p, grid, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  f.combine(p, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  f.template apply<P>(p, grid, st);
  return (int)cudaGetLastError();
}

// The plan checked against the operands, then run at its pack: 16 / sizeof(T)
// elements where C and every pointer allow 16-byte vectors (`vec`), 4 bf16
// (the split backward: its threads hold half the channels' constants), else
// 1.
template <typename F>
int nhwc_launch(const F& f, bool vec, const NhwcPlan& p, cudaStream_t st) {
  using T = typename F::T;
  constexpr int N = 16 / sizeof(T);
  if (p.v < 1 || p.v > 32 || (p.v & (p.v - 1)) || p.v * p.pack > kNhwcMaxTile ||
      f.C % (p.v * p.pack))
    return (int)cudaErrorInvalidValue;
  if (p.pack == N && vec && f.C % N == 0) return nhwc_run<N>(f, p, st);
  if constexpr (N == 8) {  // 8-byte vectors of bf16: fewer registers a thread
    if (p.pack == 4 && vec && f.C % 4 == 0) return nhwc_run<4>(f, p, st);
  }
  if (p.pack == 1) return nhwc_run<1>(f, p, st);
  return (int)cudaErrorInvalidValue;
}

// the split plan's combine: each plane's partials added in a fixed order
// into (o1, o2) at plane * ostride
template <typename K>
void nhwc_combine(K kernel, const float* part, float* o1, float* o2,
                  int ostride, int planes, int splits, cudaStream_t st) {
  kernel<<<(unsigned)(((int64_t)planes * 32 + kThreads - 1) / kThreads),
           kThreads, 0, st>>>(part, o1, o2, ostride, planes, splits);
}

template <typename Tp>
struct InReluNhwcFwd {
  using T = Tp;
  AffineFwd<T> e;
  const T* x;
  T* y;
  float* mean;
  float* rstd;
  float* part;
  float* tot;
  int n, C, hw;
  float eps;
  int arrays() const { return 1; }
  template <int P>
  int staged(const NhwcPlan& p, int64_t grid, cudaStream_t st) const {
    static bool smem_set = false;               // once per dtype and pack
    return launch_clustered(in_relu_nhwc_fwd_staged_kernel<T, P>, smem_set,
                            kNhwcMaxStageBytes, grid, p.cs, p.smem, st, e, x,
                            y, mean, rstd, C, hw, p.v, p.cs, eps);
  }
  template <int P>
  void sums(const NhwcPlan& p, dim3 grid, cudaStream_t st) const {
    in_relu_nhwc_sums_kernel<T, P><<<grid, kThreads, 0, st>>>(
        x, part, C, hw, p.v, p.splits, p.chunk);
  }
  void combine(const NhwcPlan& p, cudaStream_t st) const {
    nhwc_combine(in_relu_nhwc_combine_kernel, part, tot, tot + 1, 2, n * C,
                 p.splits, st);
  }
  template <int P>
  void apply(const NhwcPlan& p, dim3 grid, cudaStream_t st) const {
    in_relu_nhwc_fwd_apply_kernel<T, P><<<grid, kThreads, 0, st>>>(
        e, x, tot, y, mean, rstd, C, hw, p.v, p.chunk, eps);
  }
};

template <typename Tp>
struct ModnormNhwcFwd {
  using T = Tp;
  ModFwd<T> e;
  const T* x;
  const T* s;
  int64_t s_row, s_sample;
  T* y;
  float* mean;
  float* rstd;
  float* part;
  float* tot;
  int n, C, hw;
  float eps;
  int arrays() const { return s ? 2 : 1; }
  template <int P>
  int staged(const NhwcPlan& p, int64_t grid, cudaStream_t st) const {
    static bool smem_set = false;
    return launch_clustered(modnorm_relu_nhwc_fwd_staged_kernel<T, P>,
                            smem_set, kNhwcMaxStageBytes, grid, p.cs, p.smem,
                            st, e, x, s, s_row, s_sample, y, mean, rstd, C,
                            hw, p.v, p.cs, eps);
  }
  template <int P>
  void sums(const NhwcPlan& p, dim3 grid, cudaStream_t st) const {
    modnorm_relu_nhwc_sums_kernel<T, P><<<grid, kThreads, 0, st>>>(
        x, part, C, hw, p.v, p.splits, p.chunk);
  }
  void combine(const NhwcPlan& p, cudaStream_t st) const {
    nhwc_combine(modnorm_relu_nhwc_combine_kernel, part, tot, tot + 1, 2,
                 n * C, p.splits, st);
  }
  template <int P>
  void apply(const NhwcPlan& p, dim3 grid, cudaStream_t st) const {
    modnorm_relu_nhwc_fwd_apply_kernel<T, P><<<grid, kThreads, 0, st>>>(
        e, x, s, s_row, s_sample, tot, y, mean, rstd, C, hw, p.v, p.chunk,
        eps);
  }
};

template <typename Tp>
struct InReluNhwcBwd {
  using T = Tp;
  AffineBwd e;
  const T* g;
  const T* x;
  const float* mean;
  const float* rstd;
  T* dx;
  float* s1;
  float* s2;
  float* part;
  int n, C, hw;
  int arrays() const { return 2; }
  template <int P>
  int staged(const NhwcPlan& p, int64_t grid, cudaStream_t st) const {
    static bool smem_set = false;
    return launch_clustered(in_relu_nhwc_bwd_staged_kernel<T, P>, smem_set,
                            kNhwcMaxStageBytes, grid, p.cs, p.smem, st, e, g,
                            x, mean, rstd, dx, s1, s2, C, hw, p.v, p.cs);
  }
  template <int P>
  void sums(const NhwcPlan& p, dim3 grid, cudaStream_t st) const {
    in_relu_nhwc_bwd_sums_kernel<T, P><<<grid, kThreads, 0, st>>>(
        e, g, x, mean, rstd, part, C, hw, p.v, p.splits, p.chunk);
  }
  void combine(const NhwcPlan& p, cudaStream_t st) const {
    nhwc_combine(in_relu_nhwc_combine_kernel, part, s1, s2, 1, n * C,
                 p.splits, st);
  }
  template <int P>
  void apply(const NhwcPlan& p, dim3 grid, cudaStream_t st) const {
    in_relu_nhwc_bwd_apply_kernel<T, P><<<grid, kThreads, 0, st>>>(
        e, g, x, mean, rstd, s1, s2, dx, C, hw, p.v, p.chunk);
  }
};

template <typename Tp>
struct ModnormNhwcBwd {
  using T = Tp;
  ModBwd e;
  const T* g;
  const T* y;
  const T* x;
  const float* mean;
  const float* rstd;
  T* dx;
  T* ds;
  float* s1;
  float* s2;
  float* part;
  int n, C, hw;
  int arrays() const { return 3; }
  template <int P>
  int staged(const NhwcPlan& p, int64_t grid, cudaStream_t st) const {
    static bool smem_set = false;
    return launch_clustered(modnorm_relu_nhwc_bwd_staged_kernel<T, P>,
                            smem_set, kNhwcMaxStageBytes, grid, p.cs, p.smem,
                            st, e, g, y, x, mean, rstd, dx, ds, s1, s2, C, hw,
                            p.v, p.cs);
  }
  template <int P>
  void sums(const NhwcPlan& p, dim3 grid, cudaStream_t st) const {
    modnorm_relu_nhwc_bwd_sums_kernel<T, P><<<grid, kThreads, 0, st>>>(
        e, g, y, x, mean, rstd, part, C, hw, p.v, p.splits, p.chunk);
  }
  void combine(const NhwcPlan& p, cudaStream_t st) const {
    nhwc_combine(modnorm_relu_nhwc_combine_kernel, part, s1, s2, 1, n * C,
                 p.splits, st);
  }
  template <int P>
  void apply(const NhwcPlan& p, dim3 grid, cudaStream_t st) const {
    modnorm_relu_nhwc_bwd_apply_kernel<T, P><<<grid, kThreads, 0, st>>>(
        e, g, y, x, mean, rstd, s1, s2, dx, ds, C, hw, p.v, p.chunk);
  }
};

// 16-byte vectors fit: every pointer on 16 bytes and `strides` (elements)
// multiples of the vector.
template <typename T>
bool nhwc_vec_ok(const void* const* ptrs, int n, const int64_t* strides,
                 int ns) {
  constexpr int N = 16 / sizeof(T);
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  for (int i = 0; i < ns; ++i)
    if (strides[i] % N) return false;
  return true;
}

template <typename T>
int in_relu_nhwc_fwd_t(const void* x, const float* gamma, const float* beta,
                       void* y, float* mean, float* rstd, float* part,
                       float* tot, int n, int C, int hw, float eps,
                       const NhwcPlan& p, cudaStream_t st) {
  const InReluNhwcFwd<T> f = {{gamma, beta, C}, (const T*)x, (T*)y, mean,
                              rstd, part, tot, n, C, hw, eps};
  const void* ptrs[] = {x, y};
  return nhwc_launch(f, nhwc_vec_ok<T>(ptrs, 2, nullptr, 0), p, st);
}

template <typename T>
int modnorm_relu_nhwc_fwd_t(const ModParams& mp, const void* x, const void* s,
                            int64_t s_row, int64_t s_sample, void* y,
                            float* mean, float* rstd, float* part, float* tot,
                            int n, int C, int hw, float eps, const NhwcPlan& p,
                            cudaStream_t st) {
  const ModnormNhwcFwd<T> f = {{mp, nullptr, 0}, (const T*)x, (const T*)s,
                               s_row, s_sample, (T*)y, mean, rstd, part, tot,
                               n, C, hw, eps};
  const void* ptrs[] = {x, y, s};
  const int64_t strides[] = {s_row, s_sample};
  return nhwc_launch(f, nhwc_vec_ok<T>(ptrs, 3, strides, s ? 2 : 0), p, st);
}

template <typename T>
int in_relu_nhwc_bwd_t(const void* g, const void* x, const float* mean,
                       const float* gamma, const float* beta,
                       const float* rstd, void* dx, float* s1, float* s2,
                       float* part, int n, int C, int hw, const NhwcPlan& p,
                       cudaStream_t st) {
  const InReluNhwcBwd<T> f = {{gamma, beta, C}, (const T*)g, (const T*)x,
                              mean, rstd, (T*)dx, s1, s2, part, n, C, hw};
  const void* ptrs[] = {g, x, dx};
  return nhwc_launch(f, nhwc_vec_ok<T>(ptrs, 3, nullptr, 0), p, st);
}

template <typename T>
int modnorm_relu_nhwc_bwd_t(const ModBwd& e, const void* g, const void* y,
                            const void* x, const float* mean,
                            const float* rstd, void* dx, void* ds, float* a,
                            float* b, float* part, int n, int C, int hw,
                            const NhwcPlan& p, cudaStream_t st) {
  const ModnormNhwcBwd<T> f = {e, (const T*)g, (const T*)y, (const T*)x,
                               mean, rstd, (T*)dx, (T*)ds, a, b, part, n, C,
                               hw};
  const void* ptrs[] = {g, y, x, dx, ds};
  return nhwc_launch(f, nhwc_vec_ok<T>(ptrs, 5, nullptr, 0), p, st);
}

// channel_sums_nhwc's launches for dtype T at pack P.
template <typename T, int P>
int channel_sums_t(const void* x, float* part, float* out, int C, int rows,
                   int v, int splits, int chunk, cudaStream_t st) {
  const dim3 grid((unsigned)splits, (unsigned)(C / (v * P)), 1);
  channel_sums_nhwc_kernel<T, P><<<grid, kThreads, 0, st>>>(
      (const T*)x, part, C, rows, v, splits, chunk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nhwc_combine(channel_sums_combine_kernel, part, out, out + 1, 2, C, splits,
               st);
  return (int)cudaGetLastError();
}

// The plan checked as the split plan's (nhwc_launch, nhwc_run), then run.
template <typename T>
int channel_sums_plan(const void* x, float* part, float* out, int C, int rows,
                      int pack, int v, int splits, int chunk,
                      cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const void* ptrs[] = {x};
  if (v < 1 || v > 32 || (v & (v - 1)) || v * pack > kNhwcMaxTile ||
      C % (v * pack) || C / (v * pack) > kMaxGridY || splits < 1 ||
      chunk < 1 || (int64_t)splits * chunk < rows ||
      (int64_t)(splits - 1) * chunk >= rows)
    return (int)cudaErrorInvalidValue;
  if (pack == N && C % N == 0 && nhwc_vec_ok<T>(ptrs, 1, nullptr, 0))
    return channel_sums_t<T, N>(x, part, out, C, rows, v, splits, chunk, st);
  if (pack == 1)
    return channel_sums_t<T, 1>(x, part, out, C, rows, v, splits, chunk, st);
  return (int)cudaErrorInvalidValue;
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
    return in_relu_fwd_t<float>(x, (const float*)gamma, (const float*)beta,
                                y, xhat, (float*)rstd, planes, channels, hw,
                                eps, path, packs, cluster, smem_bytes, st);
  if (dtype == kBF16)
    return in_relu_fwd_t<__nv_bfloat16>(
        x, (const float*)gamma, (const float*)beta, y, xhat, (float*)rstd,
        planes, channels, hw, eps, path, packs, cluster, smem_bytes, st);
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
  const void* ptrs[] = {g, xhat, dx};
  if (dtype == kF32)
    return launch_bwd_fused(
        in_relu_bwd_family<float>(g, xhat, gamma, beta, rstd, dx, s1, s2,
                                  planes, channels, hw),
        vec_ok<float>(hw, ptrs, 3), path, packs, cluster, smem_bytes, st);
  if (dtype == kBF16)
    return launch_bwd_fused(
        in_relu_bwd_family<__nv_bfloat16>(g, xhat, gamma, beta, rstd, dx, s1,
                                          s2, planes, channels, hw),
        vec_ok<__nv_bfloat16>(hw, ptrs, 3), path, packs, cluster, smem_bytes,
        st);
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
  const void* ptrs[] = {g, xhat};
  if (dtype == kF32)
    return launch_bwd_sums(
        in_relu_bwd_family<float>(g, xhat, gamma, beta, nullptr, nullptr, s1,
                                  s2, planes, channels, hw),
        vec_ok<float>(hw, ptrs, 2), (float*)part, splits, chunk, st);
  if (dtype == kBF16)
    return launch_bwd_sums(
        in_relu_bwd_family<__nv_bfloat16>(g, xhat, gamma, beta, nullptr,
                                          nullptr, s1, s2, planes, channels,
                                          hw),
        vec_ok<__nv_bfloat16>(hw, ptrs, 2), (float*)part, splits, chunk, st);
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
  const void* ptrs[] = {g, xhat, dx};
  void* sums[] = {const_cast<void*>(s1), const_cast<void*>(s2)};
  if (dtype == kF32)
    return launch_bwd_apply(
        in_relu_bwd_family<float>(g, xhat, gamma, beta, rstd, dx, sums[0],
                                  sums[1], planes, channels, hw),
        vec_ok<float>(hw, ptrs, 3), apply_ctas, st);
  if (dtype == kBF16)
    return launch_bwd_apply(
        in_relu_bwd_family<__nv_bfloat16>(g, xhat, gamma, beta, rstd, dx,
                                          sums[0], sums[1], planes, channels,
                                          hw),
        vec_ok<__nv_bfloat16>(hw, ptrs, 3), apply_ctas, st);
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

// B3-fwd: y (and in training x_hat and rstd) of relu((x_hat * w + b) *
// gamma + s) on in_relu_fwd's plans.  x, s, y, x_hat in `dtype`; s [N, C,
// *S] with contiguous planes, sample b at b * s_bstride elements; gamma
// [planes] f32, weight and bias [channels] f32; s, gamma, weight and bias
// each null where the block has none; x_hat and rstd both null under
// no-grad.
extern "C" int modnorm_relu_fwd(const void* x, const void* s,
                                long long s_bstride, const void* gamma,
                                const void* weight, const void* bias, void* y,
                                void* xhat, void* rstd, int planes,
                                int channels, int hw, float eps, int dtype,
                                int path, int packs, int cluster,
                                int smem_bytes, void* stream) {
  if (planes == 0 || hw == 0) return 0;
  if ((xhat == nullptr) != (rstd == nullptr) || channels < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const ModParams mp = {(const float*)gamma, (const float*)weight,
                        (const float*)bias, channels};
  if (dtype == kF32)
    return modnorm_relu_fwd_t<float>(
        {mp, (const float*)s, (int64_t)s_bstride}, x, y, xhat, (float*)rstd,
        planes, hw, eps, path, packs, cluster, smem_bytes, st);
  if (dtype == kBF16)
    return modnorm_relu_fwd_t<__nv_bfloat16>(
        {mp, (const __nv_bfloat16*)s, (int64_t)s_bstride}, x, y, xhat,
        (float*)rstd, planes, hw, eps, path, packs, cluster, smem_bytes, st);
  return (int)cudaErrorInvalidValue;
}

// B3-bwd: dx and ds (null where s takes no gradient) in `dtype`, and the
// plane sums a = sum g_m, b = sum g_m * x_hat [planes] f32, under
// in_relu_bwd_plan's plan (`path` 1 fused warp, 2 fused staged, 0 split
// with `part` [planes, splits, 2] f32 scratch when splits > 1).
extern "C" int modnorm_relu_bwd(const void* g, const void* y, const void* xhat,
                                const void* rstd, const void* gamma,
                                const void* weight, void* dx, void* ds,
                                void* a, void* b, void* part, int planes,
                                int channels, int hw, int dtype, int path,
                                int packs, int cluster, int smem_bytes,
                                int splits, int chunk, int apply_ctas,
                                void* stream) {
  if (planes == 0 || hw == 0) return 0;
  if (channels < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const ModBwd e = {{(const float*)gamma, (const float*)weight, nullptr,
                     channels}};
  if (dtype == kF32)
    return modnorm_relu_bwd_t<float>(
        e, g, y, xhat, (const float*)rstd, dx, ds, (float*)a, (float*)b,
        (float*)part, planes, hw, path, packs, cluster, smem_bytes, splits,
        chunk, apply_ctas, st);
  if (dtype == kBF16)
    return modnorm_relu_bwd_t<__nv_bfloat16>(
        e, g, y, xhat, (const float*)rstd, dx, ds, (float*)a, (float*)b,
        (float*)part, planes, hw, path, packs, cluster, smem_bytes, splits,
        chunk, apply_ctas, st);
  return (int)cudaErrorInvalidValue;
}

// Channels-last (NHWC) B2 and B3: x, y, g, dx and ds hold [n, hw,
// channels] slabs (sample, row, channel; channels innermost), gamma, beta,
// weight and bias [channels] f32, mean, rstd, s1, s2 (a, b), and B3's gamma
// [n * channels] f32.  The forward writes y and, in training, each plane's
// mean and rstd, not x_hat: the backward takes x and takes x_hat from it
// again, in float32.  The plan
// (ops/kernels.in_relu_nhwc_plan): `path` 2 staged on clusters of `cluster`
// CTAs with `smem_bytes` of dynamic shared memory each, or 0 split (`splits`
// chunks of `chunk` rows a sample; scratch `part` [n * channels, splits, 2]
// f32 and, forward, `tot` [n * channels, 2] f32); `pack` elements a
// thread's vector (16 bytes' worth, or 1) and `v` vectors a row of a CTA's
// channel tile.  Returns as the NCHW entries do; a plan that does not fit
// the operands is refused.
extern "C" int in_relu_nhwc_fwd(const void* x, const void* gamma,
                                const void* beta, void* y, void* mean,
                                void* rstd, void* part, void* tot, int n,
                                int channels, int hw, float eps, int dtype,
                                int path, int pack, int v, int cluster,
                                int smem_bytes, int splits, int chunk,
                                void* stream) {
  if (n == 0 || hw == 0 || channels == 0) return 0;
  const NhwcPlan p = {path, pack, v, cluster, smem_bytes, splits, chunk};
  if ((path != kPathStaged && (!part || !tot)) || !mean || !rstd)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return in_relu_nhwc_fwd_t<float>(x, (const float*)gamma,
                                     (const float*)beta, y, (float*)mean,
                                     (float*)rstd, (float*)part, (float*)tot,
                                     n, channels, hw, eps, p, st);
  if (dtype == kBF16)
    return in_relu_nhwc_fwd_t<__nv_bfloat16>(
        x, (const float*)gamma, (const float*)beta, y, (float*)mean,
        (float*)rstd, (float*)part, (float*)tot, n, channels, hw, eps, p, st);
  return (int)cudaErrorInvalidValue;
}

// B2's backward over NHWC slabs from g and the forward's x, mean and rstd:
// dx, and s1, s2 [n * channels] f32.
extern "C" int in_relu_nhwc_bwd(const void* g, const void* x,
                                const void* mean, const void* gamma,
                                const void* beta, const void* rstd, void* dx,
                                void* s1, void* s2, void* part, int n,
                                int channels, int hw, int dtype, int path,
                                int pack, int v, int cluster, int smem_bytes,
                                int splits, int chunk, void* stream) {
  if (n == 0 || hw == 0 || channels == 0) return 0;
  const NhwcPlan p = {path, pack, v, cluster, smem_bytes, splits, chunk};
  if (path != kPathStaged && !part) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return in_relu_nhwc_bwd_t<float>(
        g, x, (const float*)mean, (const float*)gamma, (const float*)beta,
        (const float*)rstd, dx, (float*)s1, (float*)s2, (float*)part, n,
        channels, hw, p, st);
  if (dtype == kBF16)
    return in_relu_nhwc_bwd_t<__nv_bfloat16>(
        g, x, (const float*)mean, (const float*)gamma, (const float*)beta,
        (const float*)rstd, dx, (float*)s1, (float*)s2, (float*)part, n,
        channels, hw, p, st);
  return (int)cudaErrorInvalidValue;
}

// B3-fwd over NHWC slabs; s [n, hw, channels] with rows `s_row` and samples
// `s_sample` elements apart (a channel slice of a wider tensor), or null;
// mean and rstd both null under no-grad.
extern "C" int modnorm_relu_nhwc_fwd(const void* x, const void* s,
                                     long long s_row, long long s_sample,
                                     const void* gamma, const void* weight,
                                     const void* bias, void* y, void* mean,
                                     void* rstd, void* part, void* tot, int n,
                                     int channels, int hw, float eps,
                                     int dtype, int path, int pack, int v,
                                     int cluster, int smem_bytes, int splits,
                                     int chunk, void* stream) {
  if (n == 0 || hw == 0 || channels == 0) return 0;
  if ((mean == nullptr) != (rstd == nullptr)) return (int)cudaErrorInvalidValue;
  const NhwcPlan p = {path, pack, v, cluster, smem_bytes, splits, chunk};
  if (path != kPathStaged && (!part || !tot)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const ModParams mp = {(const float*)gamma, (const float*)weight,
                        (const float*)bias, channels};
  if (dtype == kF32)
    return modnorm_relu_nhwc_fwd_t<float>(
        mp, x, s, (int64_t)s_row, (int64_t)s_sample, y, (float*)mean,
        (float*)rstd, (float*)part, (float*)tot, n, channels, hw, eps, p, st);
  if (dtype == kBF16)
    return modnorm_relu_nhwc_fwd_t<__nv_bfloat16>(
        mp, x, s, (int64_t)s_row, (int64_t)s_sample, y, (float*)mean,
        (float*)rstd, (float*)part, (float*)tot, n, channels, hw, eps, p, st);
  return (int)cudaErrorInvalidValue;
}

// B3-bwd over NHWC slabs from g, the forward's y, x, mean and rstd: dx, ds
// (null where s takes no gradient), a and b [n * channels] f32.
extern "C" int modnorm_relu_nhwc_bwd(const void* g, const void* y,
                                     const void* x, const void* mean,
                                     const void* rstd, const void* gamma,
                                     const void* weight, void* dx, void* ds,
                                     void* a, void* b, void* part, int n,
                                     int channels, int hw, int dtype, int path,
                                     int pack, int v, int cluster,
                                     int smem_bytes, int splits, int chunk,
                                     void* stream) {
  if (n == 0 || hw == 0 || channels == 0) return 0;
  const NhwcPlan p = {path, pack, v, cluster, smem_bytes, splits, chunk};
  if (path != kPathStaged && !part) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const ModBwd e = {{(const float*)gamma, (const float*)weight, nullptr,
                     channels}};
  if (dtype == kF32)
    return modnorm_relu_nhwc_bwd_t<float>(
        e, g, y, x, (const float*)mean, (const float*)rstd, dx, ds, (float*)a,
        (float*)b, (float*)part, n, channels, hw, p, st);
  if (dtype == kBF16)
    return modnorm_relu_nhwc_bwd_t<__nv_bfloat16>(
        e, g, y, x, (const float*)mean, (const float*)rstd, dx, ds, (float*)a,
        (float*)b, (float*)part, n, channels, hw, p, st);
  return (int)cudaErrorInvalidValue;
}

// (sum x, sum x^2) [channels, 2] f32 of each channel of a channels-last x
// ([rows, channels] in `dtype`: every position of every sample), on the
// split plan of ops/kernels.in_relu_nhwc_split_plan (`pack`, `v`, `splits`
// chunks of `chunk` rows; scratch `part` [channels, splits, 2] f32).
extern "C" int channel_sums_nhwc(const void* x, void* part, void* out,
                                 int channels, int rows, int dtype, int pack,
                                 int v, int splits, int chunk, void* stream) {
  if (rows == 0 || channels == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return channel_sums_plan<float>(x, (float*)part, (float*)out, channels,
                                    rows, pack, v, splits, chunk, st);
  if (dtype == kBF16)
    return channel_sums_plan<__nv_bfloat16>(x, (float*)part, (float*)out,
                                            channels, rows, pack, v, splits,
                                            chunk, st);
  return (int)cudaErrorInvalidValue;
}
