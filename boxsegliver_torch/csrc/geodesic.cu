// Kernel G1: batched 2-D geodesic distance by raster scan, for Hopper.
//
// Not a port of a TPU kernel: the JAX package computes this function with
// XLA (boxsegliver_tpu/ops/geodesic.py:93 geodesic2d, a lax.scan over rows
// of min-plus associative scans).  The host twin is
// csrc/boxseg_native.cpp::geodesic2d_raster_scan and the plain PyTorch
// version ops/geodesic.geodesic2d.  Per field b, from seeds (distance 0,
// everything else +inf), `iters` times a forward pass (top-left to
// bottom-right) then a backward pass (the same on reversed indices), each
// row y solving
//   c[x] = min(d[x], min over the three upper neighbours n of
//                    d_up[n] + sqrt((1-lamb)*l^2 + lamb*(I[x]-I_up[n])^2))
//   d[x] = min(c[x], d[x-1] + sqrt((1-lamb) + lamb*(I[x]-I[x-1])^2)),
// with l^2 = 2 on the diagonals and 1 straight up.  Unreached pixels stay
// +inf (the C++ scan's FLT_MAX; its "skip an unreached neighbour" is
// inf + step = inf here).
//
// What bounds it: the bytes are few (each image, seed mask and field once:
// 9 B a pixel), but every pass's row y needs that pass's row y-1 and the
// previous pass's row y, so a field is a chain of 2 * iters * h dependent
// row steps.  The design therefore aims at the latency of one row step.
//
// Design.
// (1) geodesic_edges, fully parallel, once a launch: the four undirected
//     edge weights of every pixel (to x-1, to (y-1, x-1), (y-1, x),
//     (y-1, x+1); +inf where the neighbour is outside) into a float4
//     scratch [n, h, w], and the field's start (0 at seeds, +inf
//     elsewhere).  The backward pass reads the same edges mirrored, so no
//     sqrt is left on the chain: it only adds, takes minima and shuffles.
// (2) geodesic_rows: a lane owns k contiguous columns of a row.  The row
//     just solved stays in registers as the next row's upper row; its
//     neighbours across a lane boundary come with the solution itself
//     (below), so a row step reads no field value another thread wrote.
//     A row step:
//       c[j] from the registers (the upper row), the previous pass's d and
//       the edges; the lane's (sum w, last c) pair, its c part formed as a
//       balanced tree so the chain climbs log2(k) (add, min) levels (the
//       serial run cl[j] = min(c[j], cl[j-1] + w[j]) for the fix-up runs
//       beside it); a 5-stage Kogge-Stone scan of the lanes' pairs whose
//       sums (image-only) are formed beside the chain, so each stage on
//       the chain is one shuffle, one add and one min; one shuffle for the
//       lane's incoming d_in; the fix-up d[j] = min(cl[j], d_in + the
//       lane's prefix sum of w).  The next lane's first d, the upper
//       neighbour after the lane's last column, is min(c_next, d_last +
//       w_next) from two shuffles made early in the step.
//     The backward pass runs the same steps in mirrored order (rows from
//     the bottom, lanes and columns from the right, shfl_down for
//     shfl_up).  Each warp streams its rows through a ring of kRing slots
//     in shared memory: cp.async copies run kAhead rows ahead of the
//     chain, and row s+1 is read from its slot into registers while row s
//     runs.  kAhead = 4 trades two needs: fewer rows in flight run faster
//     where the edges sit in the L2 (the refiner's [64, 128, 128]), more
//     where they come from device memory ([64, 256, 256]).
//     warp plan (w <= 256): one CTA of one warp a field, k in {2, 4, 8}
//       (ceil(w / 32) rounded up; the columns past w hold +inf), no block
//       barrier.
//     block plan (257 <= w <= 1024): one CTA of ceil(w / 128) warps a
//       field, k = 4; each warp publishes its scan total and its first
//       column's (c, w) to shared memory, one __syncthreads a row (double
//       buffered by step parity), and each warp folds the totals of the
//       warps before it.
// The sums reassociate against the plain version's doubling (the serial
// run, the tree, the scan and the fix-up are all in one fixed order,
// emulated operation for operation in tests/test_torch_g1_order.py);
// products, sums and the sqrt are explicitly rounded intrinsics (no FMA
// contraction).  geodesic_chain_clocks times the chain alone (no memory,
// the image-only sums hoisted): the fewest dependent clocks one warp-plan
// row step takes, and the nanoseconds they took at the clock the SM ran.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;
constexpr int kStages = 5;             // log2(kLanes)
constexpr int kMaxK = 8;               // columns a lane, warp plan
constexpr int kBlockK = 4;             // columns a lane, block plan
constexpr int kMaxBlockWarps = 8;      // 8 x 32 x 4 = 1024 columns
constexpr int kAhead = 4;              // rows in flight ahead of the chain
constexpr int kRing = 8;               // slots: rows s-2 .. s+kAhead
static_assert(kRing >= kAhead + 2 && (kRing & (kRing - 1)) == 0, "ring");

__device__ __forceinline__ float step_cost(float l2, float dI, float a,
                                           float lamb) {
  // sqrt((1-lamb)*l2 + lamb*dI*dI), rounded as the plain version
  return __fsqrt_rn(__fadd_rn(__fmul_rn(a, l2),
                              __fmul_rn(__fmul_rn(lamb, dI), dI)));
}

__global__ void geodesic_edges(const float* __restrict__ img,
                               const uint8_t* __restrict__ seeds,
                               float4* __restrict__ edges,
                               float* __restrict__ dist, int H, int W,
                               int64_t total, float lamb) {
  const float inf = CUDART_INF_F;
  const float a = __fsub_rn(1.0f, lamb);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int x = (int)(i % W);
    const int y = (int)(i / W % H);
    const float I = img[i];
    float4 e = make_float4(inf, inf, inf, inf);
    if (x > 0) e.x = step_cost(1.0f, __fsub_rn(I, img[i - 1]), a, lamb);
    if (y > 0) {
      const float* up = img + i - W;
      if (x > 0) e.y = step_cost(2.0f, __fsub_rn(I, up[-1]), a, lamb);
      e.z = step_cost(1.0f, __fsub_rn(I, up[0]), a, lamb);
      if (x + 1 < W) e.w = step_cost(2.0f, __fsub_rn(I, up[1]), a, lamb);
    }
    edges[i] = e;
    dist[i] = seeds[i] ? 0.0f : inf;
  }
}

// the lane `off` ranks earlier / one rank later in scan order
template <bool kFwd>
__device__ __forceinline__ float from_prev(float v, int off) {
  return kFwd ? __shfl_up_sync(kFull, v, off)
              : __shfl_down_sync(kFull, v, off);
}
template <bool kFwd>
__device__ __forceinline__ float from_next(float v) {
  return kFwd ? __shfl_down_sync(kFull, v, 1) : __shfl_up_sync(kFull, v, 1);
}

// one row's inputs at a lane's k columns, in scan order: the scan weight
// (to the column before), the upper edges toward the column before, above
// and after, and the previous pass's d
template <int K>
struct RowIn {
  float sw[K], wp[K], wv[K], wn[K], dold[K];
};

// what the row above leaves the next row: d at the lane's columns (scan
// order) and at the columns just before and after them
template <int K>
struct Chain {
  float pd[K];
  float pd_prev, pd_next;
};

// the image-only sums of a row step, off the chain
template <int K>
struct Sums {
  float t[K];          // the lane's prefix sums of sw
  float as[kStages];   // the scan's sum at each stage (+inf: no partner)
  float a;             // the sum over the warp's lanes up to this one
  float w_next;        // sw of the next lane's first column
};

// cp.async of 16 or 4 bytes from global to shared memory, issued only
// where p holds (no branch in the row step)
__device__ __forceinline__ void cp_async16_if(uint32_t dst, const void* src,
                                              bool p) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
      "@p cp.async.cg.shared.global [%0], [%1], 16;\n\t}\n" ::"r"(dst),
      "l"(src), "r"((int)p));
}
__device__ __forceinline__ void cp_async4_if(uint32_t dst, const void* src,
                                             bool p) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
      "@p cp.async.ca.shared.global [%0], [%1], 4;\n\t}\n" ::"r"(dst),
      "l"(src), "r"((int)p));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// all but the kAhead - 1 newest groups of this thread have landed
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kAhead - 1) : "memory");
}

// A lane's columns of one field and its entries in its warp's ring of
// kRing row slots in shared memory.  Each lane copies and reads only its
// own entries: the edges of columns base-1 .. base+k ([kRing][k + 2][32]
// float4, so a column's 32 lanes are 512 contiguous bytes) and the previous
// pass's d of its k columns in groups of G ([kRing][k / G][32][G] float).
// G = 4 where rows start on 16 bytes (w % 4 == 0, k % 4 == 0): the field's
// values then move as float4, else as floats.
template <int K, int G>
struct Lane {
  static_assert(K % G == 0, "groups");
  static constexpr int kBytes = kRing * kLanes * ((K + 2) * 16 + K * 4);
  static constexpr int kSlotE = (K + 2) * kLanes;   // float4 a slot
  static constexpr int kSlotD = K * kLanes;         // float a slot
  const float4* e;     // the edges at column base-1 of row 0
  float* d;            // the field at column base of row 0
  const float4* re;    // the lane's edge entries of slot 0
  const float* rd;     // its d entries of slot 0
  uint32_t se, sd;     // the same as shared addresses
  unsigned emask;      // bit jj: column base-1+jj lies in the row
  unsigned dmask;      // bit j: column base+j lies in the row

  __device__ Lane(const float4* edges, float* dist, unsigned char* ring,
                  int W, int base, int lane)
      : e(edges + base - 1), d(dist + base),
        re(reinterpret_cast<const float4*>(ring) + lane),
        rd(reinterpret_cast<const float*>(ring + kRing * kSlotE * 16) +
           lane * G),
        se((uint32_t)__cvta_generic_to_shared(re)),
        sd((uint32_t)__cvta_generic_to_shared(rd)), emask(0), dmask(0) {
#pragma unroll
    for (int jj = 0; jj < K + 2; ++jj)
      emask |= (unsigned)(base - 1 + jj >= 0 && base - 1 + jj < W) << jj;
#pragma unroll
    for (int j = 0; j < K; ++j) dmask |= (unsigned)(base + j < W) << j;
  }
  __device__ bool edge_in(int jj) const { return emask >> jj & 1; }
  __device__ bool col_in(int j) const { return dmask >> j & 1; }
  // offset of column j's d in a slot, from rd
  static __device__ int dpos(int j) { return j / G * kLanes * G + j % G; }
  // +inf in every entry of a column outside the row, in every slot: the
  // copies skip them, so a row's reads need no test
  __device__ void fill_outside() const {
    const float inf = CUDART_INF_F;
    for (int slot = 0; slot < kRing; ++slot) {
#pragma unroll
      for (int jj = 0; jj < K + 2; ++jj)
        if (!edge_in(jj))
          const_cast<float4*>(re)[slot * kSlotE + jj * kLanes] =
              make_float4(inf, inf, inf, inf);
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (!col_in(j)) const_cast<float*>(rd)[slot * kSlotD + dpos(j)] = inf;
    }
  }
  // +inf in every edge entry of a slot: the row below the backward pass's
  // first row
  __device__ void clear_edges(int slot) const {
    const float inf = CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < K + 2; ++jj)
      const_cast<float4*>(re)[slot * kSlotE + jj * kLanes] =
          make_float4(inf, inf, inf, inf);
  }
};

// start the copies of row y (nothing outside the field); one group a row
template <int K, int G, bool kFwd>
__device__ __forceinline__ void copy_row(const Lane<K, G>& L, int H, int W,
                                         int y, int slot) {
  using Ln = Lane<K, G>;
  const bool ok = (unsigned)y < (unsigned)H;
  const int row = (ok ? y : 0) * W;          // h * w < 2^31
  const uint32_t se = L.se + slot * Ln::kSlotE * 16;
  const uint32_t sd = L.sd + slot * Ln::kSlotD * 4;
  // forward reads columns base .. base+k-1, backward one more each side
#pragma unroll
  for (int jj = kFwd ? 1 : 0; jj <= (kFwd ? K : K + 1); ++jj)
    cp_async16_if(se + jj * kLanes * 16, L.e + row + jj, ok && L.edge_in(jj));
#pragma unroll
  for (int j = 0; j < K; j += G) {
    if constexpr (G == 4)
      cp_async16_if(sd + Ln::dpos(j) * 4, L.d + row + j, ok && L.col_in(j));
    else
      cp_async4_if(sd + Ln::dpos(j) * 4, L.d + row + j, ok && L.col_in(j));
  }
  cp_async_commit();
}

// row y's inputs from its slot (and, backward, the slot of row y+1, the
// step before), in scan order; entries outside the field hold +inf
template <int K, int G, bool kFwd>
__device__ __forceinline__ void read_row(RowIn<K>& in, const Lane<K, G>& L,
                                         int slot, int slot_up) {
  using Ln = Lane<K, G>;
  const float4* e = L.re + slot * Ln::kSlotE;
  const float4* eu = L.re + slot_up * Ln::kSlotE;
  const float* d = L.rd + slot * Ln::kSlotD;
  float dold[K];
#pragma unroll
  for (int j = 0; j < K; j += G) {
    if constexpr (G == 4) {
      const float4 v = *reinterpret_cast<const float4*>(d + Ln::dpos(j));
      dold[j] = v.x;
      dold[j + 1] = v.y;
      dold[j + 2] = v.z;
      dold[j + 3] = v.w;
    } else {
      dold[j] = d[Ln::dpos(j)];
    }
  }
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int j = kFwd ? t : K - 1 - t;
    in.dold[t] = dold[j];
    if (kFwd) {
      const float4 v = e[(j + 1) * kLanes];
      in.sw[t] = v.x;
      in.wp[t] = v.y;
      in.wv[t] = v.z;
      in.wn[t] = v.w;
    } else {
      // mirrored: to x+1 in this row; (y+1, x+1), (y+1, x), (y+1, x-1)
      in.sw[t] = e[(j + 2) * kLanes].x;
      in.wp[t] = eu[(j + 2) * kLanes].y;
      in.wv[t] = eu[(j + 1) * kLanes].z;
      in.wn[t] = eu[j * kLanes].w;
    }
  }
}

template <int K, bool kFwd>
__device__ __forceinline__ Sums<K> row_sums(const RowIn<K>& in, int r) {
  const float inf = CUDART_INF_F;
  Sums<K> s;
  s.t[0] = in.sw[0];
#pragma unroll
  for (int j = 1; j < K; ++j) s.t[j] = __fadd_rn(s.t[j - 1], in.sw[j]);
  float a = s.t[K - 1];
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    const int off = 1 << st;
    const float ap = from_prev<kFwd>(a, off);
    s.as[st] = r >= off ? a : inf;
    a = r >= off ? __fadd_rn(ap, a) : a;
  }
  s.a = a;
  s.w_next = from_next<kFwd>(in.sw[0]);
  return s;
}

// shared memory of the block plan, double buffered by step parity: each
// warp's (scan sum, scan min) at its last lane and (c, sw) of its first
// column, indexed by the warp's rank in scan order
struct BlockShare {
  float2 total[2][kMaxBlockWarps];
  float2 first[2][kMaxBlockWarps];
};

// One row step on the chain.  r: the lane's rank in scan order; q, nw: the
// warp's rank in scan order and the warps of the field (block plan); par:
// the step's parity.  Leaves the row's d in st.pd.
template <int K, bool kFwd, bool kBlock>
__device__ __forceinline__ void row_chain(const RowIn<K>& in,
                                          const Sums<K>& s, Chain<K>& st,
                                          int r, int q, int nw, int par,
                                          BlockShare* sh) {
  const float inf = CUDART_INF_F;
  float c[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float before = j > 0 ? st.pd[j - 1] : st.pd_prev;
    const float after = j < K - 1 ? st.pd[j + 1] : st.pd_next;
    c[j] = fminf(fminf(in.dold[j], __fadd_rn(st.pd[j], in.wv[j])),
                 fminf(__fadd_rn(before, in.wp[j]),
                       __fadd_rn(after, in.wn[j])));
  }
  float c_next = from_next<kFwd>(c[0]);
  float w_next = s.w_next;
  // the lane's serial run, for the fix-up; beside it the run's last value
  // again as a balanced tree of the (w, c) pairs, so the chain climbs
  // log2(k) (add, min) levels and not k - 1
  float cl[K], tw[K], tc[K];
  cl[0] = c[0];
#pragma unroll
  for (int j = 1; j < K; ++j) cl[j] = fminf(c[j], __fadd_rn(cl[j - 1],
                                                            in.sw[j]));
#pragma unroll
  for (int j = 0; j < K; ++j) {
    tw[j] = in.sw[j];
    tc[j] = c[j];
  }
  int m = K;
#pragma unroll
  for (int lv = 0; lv < 3; ++lv) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      if (2 * i + 1 < m) {
        tc[i] = fminf(tc[2 * i + 1], __fadd_rn(tc[2 * i], tw[2 * i + 1]));
        tw[i] = __fadd_rn(tw[2 * i], tw[2 * i + 1]);
      }
    }
    if (m % 2) {
      tc[m / 2] = tc[m - 1];
      tw[m / 2] = tw[m - 1];
    }
    m = (m + 1) / 2;
  }
  float b = tc[0];
#pragma unroll
  for (int st_i = 0; st_i < kStages; ++st_i)
    b = fminf(b, __fadd_rn(from_prev<kFwd>(b, 1 << st_i), s.as[st_i]));
  const float bp1 = from_prev<kFwd>(b, 1);
  float incl, d_in;
  if (!kBlock) {
    incl = b;
    d_in = r == 0 ? inf : bp1;
    if (r == kLanes - 1) c_next = w_next = inf;
  } else {
    const float ap1 = from_prev<kFwd>(s.a, 1);
    if (r == kLanes - 1) sh->total[par][q] = make_float2(s.a, b);
    if (r == 0) sh->first[par][q] = make_float2(c[0], in.sw[0]);
    __syncthreads();
    float carry = inf;
    for (int i = 0; i < q; ++i) {
      const float2 v = sh->total[par][i];
      carry = fminf(v.y, __fadd_rn(carry, v.x));
    }
    incl = fminf(b, __fadd_rn(carry, s.a));
    d_in = r == 0 ? carry : fminf(bp1, __fadd_rn(carry, ap1));
    if (r == kLanes - 1) {
      const float2 v = q + 1 < nw ? sh->first[par][q + 1]
                                  : make_float2(inf, inf);
      c_next = v.x;
      w_next = v.y;
    }
  }
#pragma unroll
  for (int j = 0; j < K - 1; ++j)
    st.pd[j] = fminf(cl[j], __fadd_rn(d_in, s.t[j]));
  st.pd[K - 1] = incl;
  st.pd_prev = d_in;
  st.pd_next = fminf(c_next, __fadd_rn(incl, w_next));
}

template <int K, int G, bool kFwd, bool kBlock>
__device__ __forceinline__ void row_step(const RowIn<K>& in, Chain<K>& st,
                                         const Lane<K, G>& L, int W, int y,
                                         int r, int q, int nw, int par,
                                         BlockShare* sh) {
  row_chain<K, kFwd, kBlock>(in, row_sums<K, kFwd>(in, r), st, r, q, nw,
                             par, sh);
  float* out = L.d + y * W;
  float d[K];                                  // physical column order
#pragma unroll
  for (int t = 0; t < K; ++t) d[kFwd ? t : K - 1 - t] = st.pd[t];
#pragma unroll
  for (int j = 0; j < K; j += G) {
    if (!L.col_in(j)) continue;
    if constexpr (G == 4)
      *reinterpret_cast<float4*>(out + j) =
          make_float4(d[j], d[j + 1], d[j + 2], d[j + 3]);
    else
      out[j] = d[j];
  }
}

template <int K, int G, bool kFwd, bool kBlock>
__device__ __forceinline__ void run_pass(const Lane<K, G>& L, int H, int W,
                                         int lane, int wf, int nw, int& step,
                                         BlockShare* sh) {
  constexpr int kMask = kRing - 1;
  const float inf = CUDART_INF_F;
  const int r = kFwd ? lane : kLanes - 1 - lane;
  const int q = kFwd ? wf : nw - 1 - wf;
  Chain<K> st;
#pragma unroll
  for (int j = 0; j < K; ++j) st.pd[j] = inf;
  st.pd_prev = st.pd_next = inf;
  auto row = [H](int s) { return kFwd ? s : H - 1 - s; };
  if (!kFwd) L.clear_edges(kMask);
  // the ring's copies read what the previous pass just stored
  __threadfence();
  for (int s = 0; s < kAhead; ++s) copy_row<K, G, kFwd>(L, H, W, row(s), s);
  cp_async_wait_ahead();
  RowIn<K> in_a, in_b;
  read_row<K, G, kFwd>(in_a, L, 0, kMask);
  // step s: start the copies of row s + kAhead, read row s + 1 from its
  // slot, then run row s's chain
  for (int s = 0; s < H; s += 2) {
    copy_row<K, G, kFwd>(L, H, W, row(s + kAhead), (s + kAhead) & kMask);
    cp_async_wait_ahead();
    read_row<K, G, kFwd>(in_b, L, (s + 1) & kMask, s & kMask);
    row_step<K, G, kFwd, kBlock>(in_a, st, L, W, row(s), r, q, nw,
                                 step++ & 1, sh);
    if (s + 1 == H) break;
    copy_row<K, G, kFwd>(L, H, W, row(s + 1 + kAhead),
                         (s + 1 + kAhead) & kMask);
    cp_async_wait_ahead();
    read_row<K, G, kFwd>(in_a, L, (s + 2) & kMask, (s + 1) & kMask);
    row_step<K, G, kFwd, kBlock>(in_b, st, L, W, row(s + 1), r, q, nw,
                                 step++ & 1, sh);
  }
  // no copy may still land in the ring when the next pass refills it
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The register budget is a measured choice: under the 256-thread bound
// ptxas fits the block plan and the k = 8 warp plan in 80 registers, which
// ran faster on the H100 than an unbounded k = 8; k <= 4 ran faster with
// the warp plan's own 32-thread bound.
template <int K, int G, bool kBlock>
__global__ void __launch_bounds__(kBlock || K == kMaxK
                                      ? kLanes * kMaxBlockWarps : kLanes)
geodesic_rows(const float4* __restrict__ edges, float* __restrict__ dist,
              int H, int W, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ BlockShare sh;
  const int lane = threadIdx.x % kLanes;
  const int wf = kBlock ? threadIdx.x / kLanes : 0;
  const int nw = kBlock ? blockDim.x / kLanes : 1;
  const int64_t off = (int64_t)blockIdx.x * H * W;
  const Lane<K, G> L(edges + off, dist + off,
                     smem + wf * Lane<K, G>::kBytes, W,
                     (wf * kLanes + lane) * K, lane);
  L.fill_outside();
  int step = 0;
  for (int it = 0; it < iters; ++it) {
    run_pass<K, G, true, kBlock>(L, H, W, lane, wf, nw, step, &sh);
    run_pass<K, G, false, kBlock>(L, H, W, lane, wf, nw, step, &sh);
  }
}

// one CTA a field; each warp's ring is dynamic shared memory: 48 KiB
// (warp plan, k = 8) or up to 8 x 28 KiB (block plan)
template <int K, int G, bool kBlock>
cudaError_t launch_one(const float4* edges, float* dist, int n, int h,
                        int w, int iters, int warps, cudaStream_t stream) {
  const int bytes = warps * Lane<K, G>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      geodesic_rows<K, G, kBlock>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  geodesic_rows<K, G, kBlock><<<n, kLanes * warps, bytes, stream>>>(
      edges, dist, h, w, iters);
  return cudaGetLastError();
}

// rows that start on 16 bytes move the field's values as float4
template <int K, bool kBlock>
cudaError_t launch_rows(const float4* edges, float* dist, int n, int h,
                        int w, int iters, int warps, cudaStream_t stream) {
  if (K % 4 == 0 && w % 4 == 0)
    return launch_one<K, (K % 4 == 0 ? 4 : 1), kBlock>(
        edges, dist, n, h, w, iters, warps, stream);
  return launch_one<K, 1, kBlock>(edges, dist, n, h, w, iters, warps,
                                  stream);
}

// the warp plan's chain alone: `steps` row steps of one warp on inputs held
// in registers (no loads or stores; the image-only sums once, outside the
// timed loop); clocks[0] gets the SM clocks the loop took, clocks[1] its
// nanoseconds on the global timer
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int K>
__global__ void chain_probe(const float* __restrict__ vals,
                            float* __restrict__ out,
                            long long* __restrict__ clocks, int steps) {
  const int lane = threadIdx.x;
  RowIn<K> in;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const float* v = vals + 5 * (lane * K + t);
    in.sw[t] = v[0];
    in.wp[t] = v[1];
    in.wv[t] = v[2];
    in.wn[t] = v[3];
    in.dold[t] = v[4];
  }
  const Sums<K> s = row_sums<K, true>(in, lane);
  Chain<K> st;
#pragma unroll
  for (int j = 0; j < K; ++j) st.pd[j] = CUDART_INF_F;
  st.pd_prev = st.pd_next = CUDART_INF_F;
  __syncwarp();
  const long long t0 = clock64();
  const unsigned long long g0 = global_ns();
  for (int i = 0; i < steps; ++i)
    row_chain<K, true, false>(in, s, st, lane, 0, 1, 0, nullptr);
  __syncwarp();
  const long long t1 = clock64();
  const unsigned long long g1 = global_ns();
  float acc = st.pd_prev + st.pd_next;
#pragma unroll
  for (int j = 0; j < K; ++j) acc += st.pd[j];
  out[lane] = acc;
  if (lane == 0) {
    clocks[0] = t1 - t0;
    clocks[1] = (long long)(g1 - g0);
  }
}

template <int K>
cudaError_t launch_probe(const float* vals, float* out, long long* clocks,
                         int steps, cudaStream_t stream) {
  chain_probe<K><<<1, kLanes, 0, stream>>>(vals, out, clocks, steps);
  return cudaGetLastError();
}

}  // namespace

// img: [n, h, w] float32; seeds: [n, h, w] uint8 / bool; dist: [n, h, w]
// float32 (written); edges: [n, h, w] float4 scratch.  The plan (path 0
// warp / 1 block, k columns a lane, warps a field) comes from ops/kernels.
// geodesic_plan; a plan that does not cover the row is refused.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int geodesic2d_raster(const void* img, const void* seeds,
                                 void* dist, void* edges, int n, int h, int w,
                                 float lamb, int iters, int path, int k,
                                 int warps, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  const bool warp_ok = path == 0 && (k == 2 || k == 4 || k == kMaxK) &&
                       warps == 1 && kLanes * k >= w;
  const bool block_ok = path == 1 && k == kBlockK && warps >= 2 &&
                        warps <= kMaxBlockWarps && kLanes * k * warps >= w;
  if (!(warp_ok || block_ok) || (int64_t)n * h * w >= (1ll << 31) ||
      iters < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = (int64_t)n * h * w;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = want < (1 << 16) ? (int)want : 1 << 16;
  geodesic_edges<<<blocks, threads, 0, s>>>(
      (const float*)img, (const uint8_t*)seeds, (float4*)edges,
      (float*)dist, h, w, total, lamb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || iters == 0) return (int)err;
  const float4* e = (const float4*)edges;
  float* d = (float*)dist;
  if (path == 1)
    return (int)launch_rows<kBlockK, true>(e, d, n, h, w, iters, warps, s);
  if (k == 2) return (int)launch_rows<2, false>(e, d, n, h, w, iters, 1, s);
  if (k == 4) return (int)launch_rows<4, false>(e, d, n, h, w, iters, 1, s);
  return (int)launch_rows<kMaxK, false>(e, d, n, h, w, iters, 1, s);
}

// The chain floor: one warp runs `steps` warp-plan row steps of k columns a
// lane with everything in registers; vals: 5 * 32 * k floats (the inputs),
// out: 32 floats, clocks: two int64 (SM clocks of the loop, and its
// nanoseconds on the global timer).
extern "C" int geodesic_chain_clocks(const void* vals, void* out,
                                     void* clocks, int k, int steps,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* v = (const float*)vals;
  float* o = (float*)out;
  long long* c = (long long*)clocks;
  switch (k) {
    case 4: return (int)launch_probe<4>(v, o, c, steps, s);
    case 8: return (int)launch_probe<8>(v, o, c, steps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
