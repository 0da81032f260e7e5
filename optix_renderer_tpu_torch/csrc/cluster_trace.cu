// Cluster-tier ray/triangle kernels for scenes above 4096 triangles.
//
// cluster_closest (B3) replaces optix_renderer_tpu/accel/pallas_cluster.py::
// _closest_cluster_kernel, cluster_any (B4) replaces pallas_cluster.py::
// _any_cluster_kernel and winner_attrs (B5) replaces pallas_cluster.py::
// _winner_attr_kernel.  They compute what the TPU kernels compute, without their
// DMA rings, visit groups, SMEM lists and (8, 128) planes:
//
// * B3: for each ray of a 1024-ray tile, start from key0/cid0 and walk the tile's
//   front-to-back cluster list lists[tile, :counts[tile]] (packed [nearq | cid]
//   entries).  A lane stops at the first entry whose decoded near
//   ((entry >> cid_bits) * scale) is at or past its own t_up = key | 63 read as a
//   float (the upper decode of its running key; the TPU kernel stops at the
//   tile's largest t_up, so this is at least as tight and safe for the same
//   reason: any hit in a later cluster has t >= its entry distance >= t_up).  A
//   cluster whose AABB the lane's ray misses within (0, t_up) is skipped; else all
//   64 triangles are tested with no-cull Moller-Trumbore (|det| >= 1e-12, u, v >=
//   0, u + v <= 1, t > 0) and the lane keeps the minimum of the packed key
//   (f32 bits of t & ~63) | local id, taking the cluster id on a strict decrease.
// * B4: the same walk with t_max as the bound; hits count with 0 < t < t_max and
//   the first one ends the lane.
// * B5: for each lane, the 20 shade_a columns and the 6 uv columns of shade_b of
//   its winning sorted triangle cid * 64 + (key & 63), attribute-major (26, N),
//   zeros on a miss.  The TPU walked list positions with a one-hot matmul because
//   per-lane gathers are slow there; here one thread per lane reads its two rows.
//
// What bounds them on an H100.  B3/B4: per visited (lane, cluster) pair a 24-op
// slab test, and per cluster that passes it 64 Moller-Trumbore tests of ~53 f32
// operations (one IEEE division) against 36 bytes of table each: arithmetic, not
// bytes.  The design gives every ray its own thread with its ray, inverse
// direction and running key in registers; one block is a quarter of a tile (256
// threads) whose threads read the same list entries and, while they agree, the
// same cluster rows, so those loads are broadcasts through L1 (a cluster is 4 KB,
// contiguous: rows [64c, 64c + 64) of the flat table).  B5 moves 112 bytes a lane
// (8 in, 104 out) and reads 104 bytes of its winner's rows: bytes.
//
// Build with --fmad=false: the float operations are those of the plain PyTorch
// versions (optix_renderer_tpu_torch/accel/cluster_trace.py) operation for
// operation, and FMA contraction would move their rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;     // rays per list (cluster_trace.TILE, checked through cluster_tile())
constexpr int kCluster = 64;    // triangles per cluster
constexpr int kTabCols = 16;    // flat table row: v0(3) e1(3) e2(3) prim(1) n(3) mesh area pad
constexpr int kLocalMask = kCluster - 1;
constexpr int32_t kMissKey = 0x7FFFFFFF;
constexpr int kShadeA = 20, kShadeB = 8, kUv = 6;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // 1 / direction, |direction| clamped to >= 1e-20
};

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ org, const float* __restrict__ dir, int i) {
  Ray r;
  r.ox = org[3 * (size_t)i + 0];
  r.oy = org[3 * (size_t)i + 1];
  r.oz = org[3 * (size_t)i + 2];
  r.dx = dir[3 * (size_t)i + 0];
  r.dy = dir[3 * (size_t)i + 1];
  r.dz = dir[3 * (size_t)i + 2];
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  return r;
}

// Per-lane ray vs cluster AABB within (0, t_lim): axes x, y, z in turn, as
// pallas_cluster.py::_lane_slab.  The operands are finite, so fminf/fmaxf give
// torch.minimum/maximum's values.
__device__ __forceinline__ bool lane_slab(const float* __restrict__ bmin, const float* __restrict__ bmax,
                                          const Ray& r, float t_lim) {
  float t0 = (__ldg(bmin + 0) - r.ox) * r.ix;
  float t1 = (__ldg(bmax + 0) - r.ox) * r.ix;
  float near = fminf(t0, t1), far = fmaxf(t0, t1);
  t0 = (__ldg(bmin + 1) - r.oy) * r.iy;
  t1 = (__ldg(bmax + 1) - r.oy) * r.iy;
  near = fmaxf(near, fminf(t0, t1));
  far = fminf(far, fmaxf(t0, t1));
  t0 = (__ldg(bmin + 2) - r.oz) * r.iz;
  t1 = (__ldg(bmax + 2) - r.oz) * r.iz;
  near = fmaxf(near, fminf(t0, t1));
  far = fminf(far, fmaxf(t0, t1));
  return near <= far && far > 0.0f && near < t_lim;
}

// Moller-Trumbore against one table row (brute_trace.cu::mt_row's operation
// order).  Returns the hit flag without a t bound.
__device__ __forceinline__ bool mt_row(const float* __restrict__ row, const Ray& r, float& t) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));      // v0x v0y v0z e1x
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);  // e1y e1z e2x e2y
  const float e2z = __ldg(row + 8);
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) >= 1e-12f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
}

// Adds this warp's (slab tests, ray/triangle tests) to work[0], work[1].  Every
// lane of the warp calls it (no lane has returned early).
__device__ __forceinline__ void add_work(unsigned long long* work, unsigned slabs, unsigned tests) {
  slabs = __reduce_add_sync(0xffffffffu, slabs);
  tests = __reduce_add_sync(0xffffffffu, tests);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(work + 0, (unsigned long long)slabs);
    atomicAdd(work + 1, (unsigned long long)tests);
  }
}

__global__ void __launch_bounds__(kThreads)
closest_cluster_kernel(const float* __restrict__ tab, const float* __restrict__ cmin,
                       const float* __restrict__ cmax, const int32_t* __restrict__ lists, int maxv,
                       const int32_t* __restrict__ counts, const float* __restrict__ scales, int cid_bits,
                       const float* __restrict__ org, const float* __restrict__ dir,
                       const int32_t* __restrict__ key0, const int32_t* __restrict__ cid0, int n,
                       int32_t* __restrict__ key_out, int32_t* __restrict__ cid_out,
                       unsigned long long* __restrict__ work) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int tile = (blockIdx.x * blockDim.x) / kTile;  // one tile for the whole block
  const int cmask = (1 << cid_bits) - 1;
  unsigned slabs = 0, tests = 0;
  if (live) {
    const Ray r = load_ray(org, dir, i);
    int32_t key = key0[i];
    int32_t cid = cid0[i];
    const int cnt = counts[tile];
    const float scale = scales[tile];
    const int32_t* __restrict__ lst = lists + (size_t)tile * maxv;
    for (int k = 0; k < cnt; ++k) {
      const int32_t e = __ldg(lst + k);
      const float t_up = __int_as_float(key | kLocalMask);
      if ((float)(e >> cid_bits) * scale >= t_up) break;  // front to back: no later cluster can improve
      const int c = e & cmask;
      ++slabs;
      if (!lane_slab(cmin + 3 * c, cmax + 3 * c, r, t_up)) continue;
      tests += kCluster;
      const float* __restrict__ rows = tab + (size_t)c * kCluster * kTabCols;
      int32_t kmin = kMissKey;
#pragma unroll 4
      for (int l = 0; l < kCluster; ++l) {
        float t;
        if (mt_row(rows + l * kTabCols, r, t)) kmin = min(kmin, (__float_as_int(t) & ~kLocalMask) | l);
      }
      if (kmin < key) {
        key = kmin;
        cid = c;
      }
    }
    key_out[i] = key;
    cid_out[i] = cid;
  }
  if (work != nullptr) add_work(work, slabs, tests);
}

__global__ void __launch_bounds__(kThreads)
any_cluster_kernel(const float* __restrict__ tab, const float* __restrict__ cmin,
                   const float* __restrict__ cmax, const int32_t* __restrict__ lists, int maxv,
                   const int32_t* __restrict__ counts, const float* __restrict__ scales, int cid_bits,
                   const float* __restrict__ org, const float* __restrict__ dir,
                   const float* __restrict__ tmax, int n, uint8_t* __restrict__ occ_out,
                   unsigned long long* __restrict__ work) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int tile = (blockIdx.x * blockDim.x) / kTile;
  const int cmask = (1 << cid_bits) - 1;
  unsigned slabs = 0, tests = 0;
  if (live) {
    const Ray r = load_ray(org, dir, i);
    const float t_lim = tmax[i];
    const int cnt = counts[tile];
    const float scale = scales[tile];
    const int32_t* __restrict__ lst = lists + (size_t)tile * maxv;
    bool occluded = false;
    for (int k = 0; k < cnt && !occluded; ++k) {
      const int32_t e = __ldg(lst + k);
      if ((float)(e >> cid_bits) * scale >= t_lim) break;  // no later cluster holds a hit below t_max
      const int c = e & cmask;
      ++slabs;
      if (!lane_slab(cmin + 3 * c, cmax + 3 * c, r, t_lim)) continue;
      const float* __restrict__ rows = tab + (size_t)c * kCluster * kTabCols;
      for (int l = 0; l < kCluster; ++l) {
        float t;
        ++tests;
        if (mt_row(rows + l * kTabCols, r, t) && t < t_lim) {
          occluded = true;  // the first hit decides the lane
          break;
        }
      }
    }
    occ_out[i] = occluded ? 1 : 0;
  }
  if (work != nullptr) add_work(work, slabs, tests);
}

__global__ void __launch_bounds__(kThreads)
winner_attr_kernel(const float* __restrict__ shade_a, const float* __restrict__ shade_b,
                   const int32_t* __restrict__ key, const int32_t* __restrict__ cid, int n,
                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t c = cid[i];
  if (c < 0) {
#pragma unroll
    for (int j = 0; j < kShadeA + kUv; ++j) out[(size_t)j * n + i] = 0.0f;
    return;
  }
  const size_t row = (size_t)c * kCluster + (key[i] & kLocalMask);
  const float* __restrict__ a = shade_a + row * kShadeA;
  const float* __restrict__ b = shade_b + row * kShadeB;
#pragma unroll
  for (int j = 0; j < kShadeA; ++j) out[(size_t)j * n + i] = __ldg(a + j);
#pragma unroll
  for (int j = 0; j < kUv; ++j) out[(size_t)(kShadeA + j) * n + i] = __ldg(b + j);
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is a device pointer
// (`work` may be null); `stream` is a cudaStream_t.  Returns cudaGetLastError()
// after the launch.  `lists` has a row of `maxv` entries for each tile of 1024 rays.
extern "C" int cluster_closest(const float* tab, const float* cmin, const float* cmax, const int32_t* lists,
                               int maxv, const int32_t* counts, const float* scales, int cid_bits, const float* org,
                               const float* dir, const int32_t* key0, const int32_t* cid0,
                               int n, int32_t* key_out, int32_t* cid_out, unsigned long long* work,
                               void* stream) {
  closest_cluster_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      tab, cmin, cmax, lists, maxv, counts, scales, cid_bits, org, dir, key0, cid0, n, key_out, cid_out, work);
  return (int)cudaGetLastError();
}

extern "C" int cluster_any(const float* tab, const float* cmin, const float* cmax, const int32_t* lists,
                           int maxv, const int32_t* counts, const float* scales, int cid_bits, const float* org,
                           const float* dir, const float* tmax, int n, uint8_t* occ_out,
                           unsigned long long* work, void* stream) {
  any_cluster_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      tab, cmin, cmax, lists, maxv, counts, scales, cid_bits, org, dir, tmax, n, occ_out, work);
  return (int)cudaGetLastError();
}

extern "C" int cluster_tile() { return kTile; }

extern "C" int winner_attrs(const float* shade_a, const float* shade_b, const int32_t* key, const int32_t* cid,
                            int n, float* out, void* stream) {
  winner_attr_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(shade_a, shade_b, key, cid, n, out);
  return (int)cudaGetLastError();
}
