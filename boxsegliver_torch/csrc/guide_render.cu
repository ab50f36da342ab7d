// Kernel B1: batched max-over-objects Gaussian guide render for Hopper.
//
// Replaces the Pallas TPU kernel boxsegliver_tpu/ops/pallas_kernels.py
// _guide_kernel / gaussian_guide_batch (:221-275).  Per sample b and pixel
// (r, c):
//   g = max over valid k of exp(-((r-cy)^2 * iy + (c-cx)^2 * ix)),
//   iy = 0.5 / max(sy^2, 1e-12), ix = 0.5 / max(sx^2, 1e-12),
//   out = scale * clip(g, 0, 1) + offset      (g = 0 when no object is valid)
// Differences from the TPU kernel: validity is a [bs, K] mask (the TPU
// kernel's n_objs prefix is its special case), and the affine epilogue that
// the guided sweep applies (scale = discount / 2, offset = GUIDE_BG) is fused.
//
// Bound on the H100: at the sweep's shape (bs = 2 directions, 256 x 256,
// K = 20 slots) the kernel writes 2 * 256^2 * 4 B = 512 KiB (0.16 us at 3.35
// TB/s, 4 B per pixel moved) and evaluates one exponential per pixel and
// valid object (about 1 M: 0.24 us at 16 exponentials per SM per clock), so
// a launch costs its own latency, a few microseconds.  The design keeps that
// latency short:
//   - a CTA renders a tile of 16 rows x 64 columns of one sample (the sweep
//     needs 128 CTAs, about one wave of 132 SMs);
//   - warp 0 compacts the sample's valid objects into a shared-memory list
//     (ballots), so invalid slots cost nothing and the pixel loop has no
//     branch;
//   - per chunk of up to 64 valid objects the CTA computes each object's
//     iy, ix once, then the row terms (r-cy)^2 * iy of its 16 rows and the
//     column terms (c-cx)^2 * ix of its 64 columns into shared memory, so a
//     pixel does one add, one expf and one max per object;
//   - each thread renders 4 adjacent pixels of a row and writes them with
//     one 16-byte store (4-byte stores when W is not a multiple of 4).
// The terms are the same rounded products as the plain PyTorch version's
// (ops/kernels.gaussian_guide_batch_plain), the exponent is not factored,
// and explicitly rounded intrinsics keep nvcc from contracting FMAs, so the
// result is bit-equal to the plain version (the sweep's argmax peak and
// support test read exact guide values).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 16;
constexpr int kTileCols = 64;                 // kThreads / kTileRows quads
constexpr int kChunk = 64;                    // objects whose terms are cached
constexpr int kMaxObjects = 2048;             // ops/kernels._MAX_OBJECTS

__global__ void __launch_bounds__(kThreads)
    guide_render_kernel(const float* __restrict__ centers,
                        const float* __restrict__ stddevs,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ out, int K, int H, int W,
                        float scale, float offset) {
  __shared__ int s_idx[kMaxObjects];
  __shared__ int s_n;
  __shared__ float s_obj[kChunk][4];                    // cy, cx, iy, ix
  __shared__ float s_ey[kChunk][kTileRows];
  __shared__ __align__(16) float s_ex[kChunk][kTileCols];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;
  const int tr = threadIdx.x / (kTileCols / 4);
  const int tq = threadIdx.x % (kTileCols / 4);

  if (threadIdx.x < 32) {                               // compact valid k
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < K; base += 32) {
      const int k = base + lane;
      const bool ok = k < K && valid[(int64_t)b * K + k];
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) s_idx[n + __popc(m & ((1u << lane) - 1u))] = k;
      n += __popc(m);
    }
    if (lane == 0) s_n = n;
  }
  __syncthreads();
  const int n_valid = s_n;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int base = 0; base < n_valid; base += kChunk) {
    const int kc = min(kChunk, n_valid - base);
    if (threadIdx.x < kc) {
      const int64_t o = (int64_t)b * K + s_idx[base + threadIdx.x];
      const float sy = stddevs[2 * o], sx = stddevs[2 * o + 1];
      s_obj[threadIdx.x][0] = centers[2 * o];
      s_obj[threadIdx.x][1] = centers[2 * o + 1];
      s_obj[threadIdx.x][2] = __fdiv_rn(0.5f, fmaxf(__fmul_rn(sy, sy), 1e-12f));
      s_obj[threadIdx.x][3] = __fdiv_rn(0.5f, fmaxf(__fmul_rn(sx, sx), 1e-12f));
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kc * (kTileRows + kTileCols); t += kThreads) {
      const int j = t / (kTileRows + kTileCols);
      const int m = t % (kTileRows + kTileCols);
      if (m < kTileRows) {
        const float d = __fsub_rn((float)(row0 + m), s_obj[j][0]);
        s_ey[j][m] = __fmul_rn(__fmul_rn(d, d), s_obj[j][2]);
      } else {
        const int q = m - kTileRows;
        const float d = __fsub_rn((float)(col0 + q), s_obj[j][1]);
        s_ex[j][q] = __fmul_rn(__fmul_rn(d, d), s_obj[j][3]);
      }
    }
    __syncthreads();
    for (int j = 0; j < kc; ++j) {
      const float ey = s_ey[j][tr];
      const float4 ex = *reinterpret_cast<const float4*>(&s_ex[j][4 * tq]);
      acc[0] = fmaxf(acc[0], expf(-__fadd_rn(ey, ex.x)));
      acc[1] = fmaxf(acc[1], expf(-__fadd_rn(ey, ex.y)));
      acc[2] = fmaxf(acc[2], expf(-__fadd_rn(ey, ex.z)));
      acc[3] = fmaxf(acc[3], expf(-__fadd_rn(ey, ex.w)));
    }
    __syncthreads();                       // before the next chunk's terms
  }

  const int r = row0 + tr;
  const int c0 = col0 + 4 * tq;
  if (r >= H || c0 >= W) return;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    acc[q] = __fadd_rn(__fmul_rn(fminf(fmaxf(acc[q], 0.0f), 1.0f), scale),
                       offset);
  float* row = out + ((int64_t)b * H + r) * W;
  if (W % 4 == 0) {
    *reinterpret_cast<float4*>(row + c0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    for (int q = 0; q < 4 && c0 + q < W; ++q) row[c0 + q] = acc[q];
  }
}

}  // namespace

// centers, stddevs: [bs, K, 2] float32 (ij); valid: [bs, K] uint8 / bool;
// out: [bs, H, W] float32, 16-byte aligned; K <= 2048, bs <= 65535.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int guide_render(const void* centers, const void* stddevs,
                            const void* valid, void* out, int bs, int K,
                            int H, int W, float scale, float offset,
                            void* stream) {
  if (bs == 0 || H == 0 || W == 0) return 0;
  if (K > kMaxObjects || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((W + kTileCols - 1) / kTileCols),
                  (unsigned)((H + kTileRows - 1) / kTileRows), (unsigned)bs);
  guide_render_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)centers, (const float*)stddevs, (const uint8_t*)valid,
      (float*)out, K, H, W, scale, offset);
  return (int)cudaGetLastError();
}
