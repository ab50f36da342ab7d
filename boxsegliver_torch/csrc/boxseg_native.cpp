// Native host-side kernels of the port's data and eval path (own copy of
// boxsegliver_tpu/csrc/boxseg_native.cpp; the port imports nothing of the
// JAX package).  Built with g++ into build/native/ at first use and bound
// with ctypes by csrc/native.py.
//
// The reference delegates these to third-party binaries:
//  - GeodisTK (C++) raster-scan geodesic distance for interactive guides
//    (reference DataLoader/NF/input_pipeline_g_simply.py:476-489,
//     entry/main_eval.py:30)
//  - scipy.ndimage C connected components for post-processing hot loops
//    (reference evaluator_liver.py:690, utils/array_kits.py:357-384)
//
// Semantics:
//  - geodesic distance: raster-scan passes; step cost between neighbors
//    p,q = sqrt((1-lamb) * ||p-q||^2 + lamb * (I(p)-I(q))^2), seeds at 0,
//    unreached pixels FLT_MAX (such neighbors are skipped).
//    lamb=0 → Euclidean-ish; lamb=1 → pure intensity gradient (GeodisTK).
//    The 2-D scan is bound (csrc/native.geodesic2d); the 3-D scan and the
//    labeling helpers are carried unbound until the 3D tower is ported.
//  - connected components: union-find over 6- (connectivity=1) or 26-
//    (connectivity=3) neighborhoods, labels 1..n in first-voxel order, plus
//    a largest-component shortcut.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <limits>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Geodesic distance, 2D raster scan
// ---------------------------------------------------------------------------

void geodesic2d_raster_scan(const float* img, const uint8_t* seeds,
                            float* dist, int h, int w, float lamb, int iters) {
    const float INF = std::numeric_limits<float>::max();
    for (int i = 0; i < h * w; ++i) dist[i] = seeds[i] ? 0.0f : INF;

    const int dy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
    const int dx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
    float local[8];
    for (int k = 0; k < 8; ++k)
        local[k] = std::sqrt(float(dy[k] * dy[k] + dx[k] * dx[k]));

    for (int it = 0; it < iters; ++it) {
        // forward pass
        for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
                int idx = y * w + x;
                float cur = dist[idx];
                for (int k = 0; k < 4; ++k) {  // causal neighbors
                    int ny = y + dy[k], nx = x + dx[k];
                    if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
                    int nidx = ny * w + nx;
                    if (dist[nidx] == INF) continue;
                    float dI = img[idx] - img[nidx];
                    float step = std::sqrt((1.0f - lamb) * local[k] * local[k]
                                           + lamb * dI * dI);
                    float cand = dist[nidx] + step;
                    if (cand < cur) cur = cand;
                }
                dist[idx] = cur;
            }
        }
        // backward pass
        for (int y = h - 1; y >= 0; --y) {
            for (int x = w - 1; x >= 0; --x) {
                int idx = y * w + x;
                float cur = dist[idx];
                for (int k = 4; k < 8; ++k) {
                    int ny = y + dy[k], nx = x + dx[k];
                    if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
                    int nidx = ny * w + nx;
                    if (dist[nidx] == INF) continue;
                    float dI = img[idx] - img[nidx];
                    float step = std::sqrt((1.0f - lamb) * local[k] * local[k]
                                           + lamb * dI * dI);
                    float cand = dist[nidx] + step;
                    if (cand < cur) cur = cand;
                }
                dist[idx] = cur;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Geodesic distance, 3D raster scan (anisotropic spacing)
// ---------------------------------------------------------------------------

void geodesic3d_raster_scan(const float* img, const uint8_t* seeds,
                            float* dist, int d, int h, int w,
                            float sz, float sy, float sx,
                            float lamb, int iters) {
    const float INF = std::numeric_limits<float>::max();
    const long n = (long)d * h * w;
    for (long i = 0; i < n; ++i) dist[i] = seeds[i] ? 0.0f : INF;

    // 13 causal + 13 anti-causal neighbors (26-connectivity halves)
    std::vector<int> oz, oy, ox;
    std::vector<float> local;
    for (int z = -1; z <= 1; ++z)
        for (int y = -1; y <= 1; ++y)
            for (int x = -1; x <= 1; ++x) {
                if (z == 0 && y == 0 && x == 0) continue;
                if (z < 0 || (z == 0 && (y < 0 || (y == 0 && x < 0)))) {
                    oz.push_back(z); oy.push_back(y); ox.push_back(x);
                    local.push_back(std::sqrt(z * sz * z * sz + y * sy * y * sy
                                              + x * sx * x * sx));
                }
            }
    const int m = (int)oz.size();

    auto pass = [&](bool fwd) {
        int z0 = fwd ? 0 : d - 1, z1 = fwd ? d : -1, zs = fwd ? 1 : -1;
        int y0 = fwd ? 0 : h - 1, y1 = fwd ? h : -1, ys = fwd ? 1 : -1;
        int x0 = fwd ? 0 : w - 1, x1 = fwd ? w : -1, xs = fwd ? 1 : -1;
        int sign = fwd ? 1 : -1;
        for (int z = z0; z != z1; z += zs)
            for (int y = y0; y != y1; y += ys)
                for (int x = x0; x != x1; x += xs) {
                    long idx = ((long)z * h + y) * w + x;
                    float cur = dist[idx];
                    for (int k = 0; k < m; ++k) {
                        int nz = z + sign * oz[k], ny = y + sign * oy[k],
                            nx = x + sign * ox[k];
                        if (nz < 0 || nz >= d || ny < 0 || ny >= h ||
                            nx < 0 || nx >= w) continue;
                        long nidx = ((long)nz * h + ny) * w + nx;
                        if (dist[nidx] == INF) continue;
                        float dI = img[idx] - img[nidx];
                        float step = std::sqrt(
                            (1.0f - lamb) * local[k] * local[k] + lamb * dI * dI);
                        float cand = dist[nidx] + step;
                        if (cand < cur) cur = cand;
                    }
                    dist[idx] = cur;
                }
    };
    for (int it = 0; it < iters; ++it) { pass(true); pass(false); }
}

// ---------------------------------------------------------------------------
// 3D connected components (union-find)
// ---------------------------------------------------------------------------

static inline int uf_find(std::vector<int>& parent, int i) {
    while (parent[i] != i) { parent[i] = parent[parent[i]]; i = parent[i]; }
    return i;
}

static inline void uf_union(std::vector<int>& parent, int a, int b) {
    int ra = uf_find(parent, a), rb = uf_find(parent, b);
    if (ra != rb) parent[std::max(ra, rb)] = std::min(ra, rb);
}

// labels 1..n written into out (int32); returns n
int label_components_3d(const uint8_t* mask, int32_t* out,
                        int d, int h, int w, int connectivity) {
    const long n = (long)d * h * w;
    std::vector<int> parent(1, 0);  // parent[0] unused
    std::memset(out, 0, n * sizeof(int32_t));

    // neighbor offsets pointing to already-visited voxels
    std::vector<long> offs;
    for (int z = -1; z <= 0; ++z)
        for (int y = -1; y <= 1; ++y)
            for (int x = -1; x <= 1; ++x) {
                if (z == 0 && (y > 0 || (y == 0 && x >= 0))) continue;
                int manh = std::abs(z) + std::abs(y) + std::abs(x);
                if (connectivity == 1 && manh > 1) continue;
                if (connectivity == 2 && manh > 2) continue;
                offs.push_back(((long)z * h + y) * w + x);
            }

    int next = 0;
    for (int z = 0; z < d; ++z)
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
                long idx = ((long)z * h + y) * w + x;
                if (!mask[idx]) continue;
                int lbl = 0;
                for (long off : offs) {
                    // bounds check via coordinates
                    long nidx = idx + off;
                    if (nidx < 0) continue;
                    int nz = (int)(nidx / ((long)h * w));
                    long rem = nidx % ((long)h * w);
                    int ny = (int)(rem / w), nx = (int)(rem % w);
                    if (std::abs(nz - z) > 1 || std::abs(ny - y) > 1 ||
                        std::abs(nx - x) > 1) continue;
                    int nl = out[nidx];
                    if (nl > 0) {
                        if (lbl == 0) lbl = nl;
                        else uf_union(parent, lbl, nl);
                    }
                }
                if (lbl == 0) {
                    lbl = ++next;
                    parent.push_back(lbl);
                }
                out[idx] = lbl;
            }

    // flatten + relabel consecutively
    std::vector<int> remap(next + 1, 0);
    int count = 0;
    for (long i = 0; i < n; ++i) {
        if (!out[i]) continue;
        int r = uf_find(parent, out[i]);
        if (!remap[r]) remap[r] = ++count;
        out[i] = remap[r];
    }
    return count;
}

// keep only the largest component; returns its size
long largest_component_3d(const uint8_t* mask, uint8_t* out,
                          int d, int h, int w, int connectivity) {
    const long n = (long)d * h * w;
    std::vector<int32_t> labels(n);
    int count = label_components_3d(mask, labels.data(), d, h, w, connectivity);
    if (count == 0) { std::memset(out, 0, n); return 0; }
    std::vector<long> sizes(count + 1, 0);
    for (long i = 0; i < n; ++i) sizes[labels[i]]++;
    sizes[0] = 0;
    int best = (int)(std::max_element(sizes.begin(), sizes.end()) - sizes.begin());
    for (long i = 0; i < n; ++i) out[i] = labels[i] == best ? 1 : 0;
    return sizes[best];
}

}  // extern "C"
