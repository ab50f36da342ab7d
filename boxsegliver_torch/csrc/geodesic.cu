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
// Design: one CTA per field, one thread per column (w <= 1024).  A row
// step reads the previous row's three upper neighbours (written by the
// previous step, visible after __syncthreads), forms (w[x], c[x]) and solves
// the min-plus recurrence as a block-wide inclusive scan of the pairs under
// combine(a, b) = (w_a + w_b, min(c_b, c_a + w_b)): a Kogge-Stone scan in
// each warp by shuffles, the 32 warp totals scanned by warp 0, then each
// warp folds in the prefix of the warps before it.  The fields live in
// global memory (L1 / L2 resident at the device refiner's 128 x 128 half
// resolution).  Products, sums and the sqrt are explicitly rounded
// intrinsics (no FMA contraction), so only the scan's reassociation of the
// w sums separates the result from the plain version (about 1e-5 relative).
//
// Bound on the H100: the function reads each image (4 B/px) and seed mask
// (1 B/px) once and writes each field (4 B/px) once: N * h * w * 9 B over
// 3.35 TB/s.  It is also a chain of 2 * iters * h dependent row steps per
// field (each a few barriers and a log-depth scan, about 1-2 us), so at the
// refiner's sizes the serial chain, not the bytes, bounds a launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float step_cost(float l2, float dI, float a,
                                           float lamb) {
  // sqrt((1-lamb)*l2 + lamb*dI*dI), rounded as the plain version
  return __fsqrt_rn(__fadd_rn(__fmul_rn(a, l2),
                              __fmul_rn(__fmul_rn(lamb, dI), dI)));
}

__global__ void geodesic_kernel(const float* __restrict__ img,
                                const uint8_t* __restrict__ seeds,
                                float* __restrict__ dist, int H, int W,
                                float lamb, int iters) {
  __shared__ float s_w[32];
  __shared__ float s_c[32];
  const int64_t base = (int64_t)blockIdx.x * H * W;
  img += base;
  seeds += base;
  dist += base;
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const bool active = x < W;
  const float inf = CUDART_INF_F;
  const float a = __fsub_rn(1.0f, lamb);

  for (int64_t i = x; i < (int64_t)H * W; i += blockDim.x)
    dist[i] = seeds[i] ? 0.0f : inf;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int pass = 0; pass < 2; ++pass) {
      const bool fwd = pass == 0;
      // physical column of scan position x, and of its left neighbour
      const int px = fwd ? x : W - 1 - x;
      const int pl = fwd ? px - 1 : px + 1;
      for (int s = 0; s < H; ++s) {
        const int y = fwd ? s : H - 1 - s;
        float wv = 0.0f, cv = inf;
        if (active) {
          const float I = img[(int64_t)y * W + px];
          cv = dist[(int64_t)y * W + px];
          wv = x == 0 ? inf
                      : step_cost(1.0f, __fsub_rn(I, img[(int64_t)y * W + pl]),
                                  a, lamb);
          if (s > 0) {
            const int yu = fwd ? y - 1 : y + 1;
            const float* drow = dist + (int64_t)yu * W;
            const float* irow = img + (int64_t)yu * W;
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
              const int nx = x + dx;                    // scan position
              if (nx < 0 || nx >= W) continue;
              const int pn = fwd ? nx : W - 1 - nx;
              const float l2 = dx == 0 ? 1.0f : 2.0f;
              const float cand = __fadd_rn(
                  drow[pn], step_cost(l2, __fsub_rn(I, irow[pn]), a, lamb));
              cv = fminf(cv, cand);
            }
          }
        }
        // warp-level inclusive min-plus scan of (w, c)
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float wp = __shfl_up_sync(kFull, wv, off);
          const float cp = __shfl_up_sync(kFull, cv, off);
          if (lane >= off) {
            cv = fminf(cv, __fadd_rn(cp, wv));
            wv = __fadd_rn(wp, wv);
          }
        }
        if (nwarps > 1) {
          if (lane == 31) {
            s_w[warp] = wv;
            s_c[warp] = cv;
          }
          __syncthreads();
          if (warp == 0) {
            float tw = lane < nwarps ? s_w[lane] : 0.0f;
            float tc = lane < nwarps ? s_c[lane] : inf;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
              const float wp = __shfl_up_sync(kFull, tw, off);
              const float cp = __shfl_up_sync(kFull, tc, off);
              if (lane >= off) {
                tc = fminf(tc, __fadd_rn(cp, tw));
                tw = __fadd_rn(wp, tw);
              }
            }
            if (lane < nwarps) {
              s_w[lane] = tw;
              s_c[lane] = tc;
            }
          }
          __syncthreads();
          if (warp > 0) cv = fminf(cv, __fadd_rn(s_c[warp - 1], wv));
        }
        if (active) dist[(int64_t)y * W + px] = cv;
        __syncthreads();
      }
    }
  }
}

}  // namespace

// img: [n, h, w] float32; seeds: [n, h, w] uint8 / bool; dist: [n, h, w]
// float32 (written).  w <= 1024.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int geodesic2d_raster(const void* img, const void* seeds,
                                 void* dist, int n, int h, int w, float lamb,
                                 int iters, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  if (w > 1024) return (int)cudaErrorInvalidValue;
  const int threads = (w + 31) / 32 * 32;
  geodesic_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const uint8_t*)seeds, (float*)dist, h, w, lamb,
      iters);
  return (int)cudaGetLastError();
}
