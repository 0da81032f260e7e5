// Cluster-tier ray/triangle kernels for scenes above 4096 triangles.
//
// B3 (closest hit) replaces the closest-hit kernel of
// optix_renderer_tpu/accel/pallas_cluster.py (:848) and B4 (occlusion) its any-hit
// kernel (:1020).  They compute what the TPU kernels compute, without their DMA
// rings, visit groups, SMEM lists and (8, 128) planes.  The winner-attribute
// kernel (:1657) is fused into the shading, kernel K4 (cluster_shade.cu).
//
// The walk (cluster_closest_walk, cluster_any_walk): what every trace of the
// cluster tier takes on the card (accel/cluster.py).  The TPU kernels walk dense
// per-tile cluster lists that a cull made before them, because a TPU core cannot
// walk data-dependently per lane; a CUDA warp can, so these take no lists: a warp
// serves its 32 rays one at a time.  For one ray the 32 threads slab-test the
// supercluster boxes (64 Morton-contiguous clusters each, up to 8 boxes a thread a
// round), pick the overlapped superclusters front to back by a warp minimum over
// packed [near | slot] words, slab-test a picked supercluster's 64 cluster boxes
// two a thread, pick those front to back too and intersect each picked cluster
// with no-cull Moller-Trumbore (|det| >= 1e-12, u, v >= 0, u + v <= 1, t > 0).
// Picking stops at the first box whose near is at or past the ray's running
// bound, so nothing is capped and nothing can overflow: the result is the minimum
// packed key (f32 bits of t & ~63) | local id, with the cluster id taken on a
// strict decrease, over every cluster whose box the ray passes within its bound
// (B3, starting from key0/cid0), or the OR of 0 < t < t_max (B4, where a hit ends
// the ray), with no cull before the kernel and no fallback after it.  The key is
// bit-equal to the plain PyTorch walk's (accel/cluster_trace.py).
//
// What bounds them on an H100: arithmetic, not bytes.  Per (ray, box) pair a 24-op
// slab test, per (ray, cluster) pair 64 Moller-Trumbore tests of ~53 f32
// operations (one IEEE division) against 36 bytes of table each.  With one thread
// per ray and 64 serial tests, a warp pays 64 tests for every cluster that ANY of
// its lanes passes: on the 1M-triangle terrain the lanes of such a loop were used
// to 0.43 (primaries), 0.40 (shadow rays) and 0.12 (bounce rays).  So the
// intersection is warp-cooperative: the warp's one ray is in every lane (warp_ray),
// every thread tests 2 of the 64 triangles, and the warp reduces
// (__reduce_min_sync over the packed key; a ballot for B4).  The minimum does not
// depend on the order of the tests, so the key equals the serial loop's.  A
// cluster's rows reach the tests through shared memory: each warp stages the 48
// used bytes of the 64 rows (3 KB) with cp.async into one of two buffers, and the
// copy of the next candidate cluster is started before the tests of this one
// (decided with the bound as it stands, which can only shrink, so a needed cluster
// is never missing).  Warps never wait for each other: no __syncthreads.
//
// Baked walk (cluster_closest_walk_baked): B3's walk form for rays that all
// share one origin (primary rays), over the shared-origin table that
// accel/cluster.py::bake_shared_origin_tab makes per camera position; replaces
// the baked=True body of pallas_cluster.py's closest-hit kernel (:984; its test
// _mt_chunk_baked).  Columns 0-9 of each row hold n2 = e2 x e1, uvec = e2 x T,
// vvec = T x e1 and tconst = e2 . vvec (T = origin - v0), so a test is
// det = d . n2, u = (d . uvec) / det, v = (d . vvec) / det, t = tconst / det:
// 27 f32 operations against Moller-Trumbore's 53.  The walk, the staging (the
// 12 staged columns already hold column 9) and the packed key are B3's; only
// the row type and its test differ (the template argument of ray_walk).  The
// boxes are the unbaked ones and the slab tests use the rays' own origins.
//
// Build with --fmad=false: the float operations are those of the plain PyTorch
// versions (optix_renderer_tpu_torch/accel/cluster_trace.py) operation for
// operation, and FMA contraction would move their rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTraceThreads = 128;  // B3/B4: four independent warps
constexpr int kWarps = kTraceThreads / 32;
constexpr int kCluster = 64;    // triangles per cluster
constexpr int kGroup = 64;      // clusters per supercluster (accel.build.SC_GROUP, cluster_group())
constexpr int kTabCols = 16;    // flat table row: v0(3) e1(3) e2(3) prim(1) n(3) mesh area pad
constexpr int kLocalMask = kCluster - 1;
constexpr int32_t kMissKey = 0x7FFFFFFF;
constexpr int kStageCols = 12;  // staged floats per row: the 9 used and 3 more (three 16-byte pieces)
constexpr int kStageFloats = kCluster * kStageCols;  // 3 KB per buffer
constexpr int kStagePieces = kStageFloats / 4;       // 16-byte pieces per buffer
constexpr int kScRound = 8;     // the walk: supercluster boxes per thread and round (256 a round)
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // no candidate (above every packed [near | slot] word)

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // 1 / direction, |direction| clamped to >= 1e-20
};

struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

struct BakedTri {  // a row of the shared-origin table
  float n2x, n2y, n2z, ux, uy, uz, vx, vy, vz, tc;
};

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d);
}

__device__ __forceinline__ void set_inverse(Ray& r) {
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ org, const float* __restrict__ dir, int i) {
  Ray r;
  r.ox = org[3 * (size_t)i + 0];
  r.oy = org[3 * (size_t)i + 1];
  r.oz = org[3 * (size_t)i + 2];
  r.dx = dir[3 * (size_t)i + 0];
  r.dy = dir[3 * (size_t)i + 1];
  r.dz = dir[3 * (size_t)i + 2];
  set_inverse(r);
  return r;
}

// Lane `src`'s ray in every lane of the warp (the inverse recomputed from the
// same direction, so it is the same value).
__device__ __forceinline__ Ray warp_ray(const Ray& r, int src) {
  Ray o;
  o.ox = __shfl_sync(kFull, r.ox, src);
  o.oy = __shfl_sync(kFull, r.oy, src);
  o.oz = __shfl_sync(kFull, r.oz, src);
  o.dx = __shfl_sync(kFull, r.dx, src);
  o.dy = __shfl_sync(kFull, r.dy, src);
  o.dz = __shfl_sync(kFull, r.dz, src);
  set_inverse(o);
  return o;
}

// Ray vs AABB: axes x, y, z in turn, as pallas_cluster.py::_lane_slab.  Returns
// near <= far && far > 0 and the entry distance; the slab test within (0, t_lim)
// is `box_span(...) && near < t_lim`.  The operands are finite, so fminf/fmaxf
// give torch.minimum/maximum's values.
__device__ __forceinline__ bool box_span(const float* __restrict__ bmin, const float* __restrict__ bmax,
                                         const Ray& r, float& near) {
  float t0 = (__ldg(bmin + 0) - r.ox) * r.ix;
  float t1 = (__ldg(bmax + 0) - r.ox) * r.ix;
  float far = fmaxf(t0, t1);
  near = fminf(t0, t1);
  t0 = (__ldg(bmin + 1) - r.oy) * r.iy;
  t1 = (__ldg(bmax + 1) - r.oy) * r.iy;
  near = fmaxf(near, fminf(t0, t1));
  far = fminf(far, fmaxf(t0, t1));
  t0 = (__ldg(bmin + 2) - r.oz) * r.iz;
  t1 = (__ldg(bmax + 2) - r.oz) * r.iz;
  near = fmaxf(near, fminf(t0, t1));
  far = fminf(far, fmaxf(t0, t1));
  return near <= far && far > 0.0f;
}

// ---- staging a cluster's rows in shared memory -------------------------------

// Starts the copy of the used 48 bytes of each of the 64 rows of one cluster
// (`rows`: global, 64 rows of 16 floats) into `buf` (shared, kStageFloats): six
// 16-byte cp.async a lane.  Row l lands at buf + 12 l.
__device__ __forceinline__ void stage_cluster(float* buf, const float* __restrict__ rows, int lane) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(buf);
#pragma unroll
  for (int i = 0; i < kStagePieces / 32; ++i) {
    const int q = lane + 32 * i;
    const int row = q / 3, part = q - 3 * row;
    const unsigned long long src = (unsigned long long)__cvta_generic_to_global(rows + row * kTabCols + 4 * part);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16u * q), "l"(src) : "memory");
  }
}

// Closes the group of copies started since the last commit (an empty group is
// legal and complete at once, so every step can commit exactly one).
__device__ __forceinline__ void stage_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most kPending of this thread's committed groups are in flight,
// then makes the warp's copies visible to all its lanes.
template <int kPending>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
  __syncwarp();
}

// One staged row (12 floats at `row`, 16-byte aligned) as a triangle: 9 floats
// of the unbaked table, 10 of the baked one.
template <class Q>
__device__ Q staged(const float* row);

template <>
__device__ __forceinline__ Tri staged<Tri>(const float* row) {
  const float4 a = *reinterpret_cast<const float4*>(row);      // v0x v0y v0z e1x
  const float4 b = *reinterpret_cast<const float4*>(row + 4);  // e1y e1z e2x e2y
  Tri q;
  q.v0x = a.x, q.v0y = a.y, q.v0z = a.z;
  q.e1x = a.w, q.e1y = b.x, q.e1z = b.y;
  q.e2x = b.z, q.e2y = b.w, q.e2z = row[8];
  return q;
}

template <>
__device__ __forceinline__ BakedTri staged<BakedTri>(const float* row) {
  const float4 a = *reinterpret_cast<const float4*>(row);      // n2x n2y n2z ux
  const float4 b = *reinterpret_cast<const float4*>(row + 4);  // uy uz vx vy
  const float2 c = *reinterpret_cast<const float2*>(row + 8);  // vz tconst
  BakedTri q;
  q.n2x = a.x, q.n2y = a.y, q.n2z = a.z;
  q.ux = a.w, q.uy = b.x, q.uz = b.y;
  q.vx = b.z, q.vy = b.w, q.vz = c.x;
  q.tc = c.y;
  return q;
}

// Moller-Trumbore against one triangle (brute_trace.cu::mt_row's operation
// order).  Returns the hit flag without a t bound.
__device__ __forceinline__ bool mt_tri(const Tri& q, const Ray& r, float& t) {
  const float px = r.dy * q.e2z - r.dz * q.e2y;
  const float py = r.dz * q.e2x - r.dx * q.e2z;
  const float pz = r.dx * q.e2y - r.dy * q.e2x;
  const float det = q.e1x * px + q.e1y * py + q.e1z * pz;
  const bool ok = fabsf(det) >= 1e-12f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float tx = r.ox - q.v0x;
  const float ty = r.oy - q.v0y;
  const float tz = r.oz - q.v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * q.e1z - tz * q.e1y;
  const float qy = tz * q.e1x - tx * q.e1z;
  const float qz = tx * q.e1y - ty * q.e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  t = (q.e2x * qx + q.e2y * qy + q.e2z * qz) * inv;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
}

// The shared-origin test against one baked row (_mt_chunk_baked's operation
// order; the ray's origin is the one the table was baked for and is not read).
__device__ __forceinline__ bool mt_tri(const BakedTri& q, const Ray& r, float& t) {
  const float det = r.dx * q.n2x + r.dy * q.n2y + r.dz * q.n2z;
  const bool ok = fabsf(det) >= 1e-12f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float u = (r.dx * q.ux + r.dy * q.uy + r.dz * q.uz) * inv;
  const float v = (r.dx * q.vx + r.dy * q.vy + r.dz * q.vz) * inv;
  t = q.tc * inv;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
}

// ---- the warp-cooperative intersection ---------------------------------------

// One ray (the same in every lane) against one staged cluster: lane l holds
// triangles l (q0) and l + 32 (q1).  Returns the minimum packed key over the hits.
template <class Q>
__device__ __forceinline__ int32_t warp_closest(const Q& q0, const Q& q1, const Ray& r, int lane) {
  float t;
  int32_t k = kMissKey;
  if (mt_tri(q0, r, t)) k = (__float_as_int(t) & ~kLocalMask) | lane;
  if (mt_tri(q1, r, t)) k = min(k, (__float_as_int(t) & ~kLocalMask) | (lane + 32));
  return __reduce_min_sync(kFull, k);
}

// The same for occlusion: is there a hit with t < t_lim; `first` is the local id
// of the first such triangle (64 if none).
__device__ __forceinline__ bool warp_any(const Tri& q0, const Tri& q1, const Ray& r, float t_lim, int& first) {
  float t;
  const bool h0 = mt_tri(q0, r, t) && t < t_lim;
  const unsigned b0 = __ballot_sync(kFull, h0);
  const bool h1 = mt_tri(q1, r, t) && t < t_lim;
  const unsigned b1 = __ballot_sync(kFull, h1);
  first = b0 ? __ffs(b0) - 1 : (b1 ? 31 + __ffs(b1) : kCluster);
  return (b0 | b1) != 0;
}

// Adds this warp's counts to work[0..3]: (ray, box) slab tests and ray/triangle
// tests that the rules need (summed over the lanes), and the lane slots the warp
// spent on them, 32 for every step it took (counted by lane 0).  Every lane of
// the warp calls it.
__device__ __forceinline__ void add_work(unsigned long long* work, unsigned slabs, unsigned tests,
                                         unsigned slab_steps, unsigned test_steps) {
  slabs = __reduce_add_sync(kFull, slabs);
  tests = __reduce_add_sync(kFull, tests);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(work + 0, (unsigned long long)slabs);
    atomicAdd(work + 1, (unsigned long long)tests);
    atomicAdd(work + 2, 32ull * slab_steps);
    atomicAdd(work + 3, 32ull * test_steps);
  }
}

// ---- the walk --------------------------------------------------------------------

struct WalkArgs {
  const float* tab;
  const float* cmin;  // (C, 3)
  const float* cmax;
  int n_clusters;
  const float* scmin;  // (S, 3): box of clusters [64 s, 64 s + 64)
  const float* scmax;
  int n_super;
  const float* org;
  const float* dir;
  const int32_t* key0;  // B3
  const int32_t* cid0;  // B3
  const float* tmax;    // B4
  int n;
  int32_t* key_out;  // B3
  int32_t* cid_out;  // B3
  uint8_t* occ_out;  // B4
  unsigned long long* work;
};

// A box that the ray passes within (0, bound) as a packed candidate: the f32 bits
// of its entry distance (clamped at 0, so they order as unsigned) with the low
// bits replaced by `slot`; kNone if the ray misses it.  The dropped bits make the
// packed near an underestimate, which keeps the front-to-back stop conservative.
__device__ __forceinline__ uint32_t candidate(const float* __restrict__ bmin, const float* __restrict__ bmax,
                                              const Ray& r, float bound, uint32_t slot, uint32_t slot_mask) {
  float near;
  if (!(box_span(bmin, bmax, r, near) && near < bound)) return kNone;
  return (__float_as_uint(fmaxf(near, 0.0f)) & ~slot_mask) | slot;
}

// The nearest of the warp's cluster candidates (w0: slot lane, w1: slot lane + 32),
// removed from its owner; kNone when none is left.
__device__ __forceinline__ uint32_t pick_cluster(uint32_t& w0, uint32_t& w1, int lane) {
  const uint32_t p = __reduce_min_sync(kFull, min(w0, w1));
  if (p != kNone && (int)(p & 31u) == lane) {
    if (p & 32u) w1 = kNone; else w0 = kNone;
  }
  return p;
}

// Q: the row type of a.tab (Tri, or BakedTri for the baked walk, closest only).
template <bool kAny, bool kCount, class Q>
__device__ __forceinline__ void ray_walk(const WalkArgs& a) {
  __shared__ __align__(16) float stage[kWarps][2][kStageFloats];
  const int lane = threadIdx.x & 31;
  float* const buf = &stage[threadIdx.x >> 5][0][0];
  const int base = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;  // this warp's first ray
  if (base >= a.n) return;  // the whole warp leaves; warps never wait for each other
  const bool live = base + lane < a.n;
  const int ii = live ? base + lane : a.n - 1;
  const Ray mine = load_ray(a.org, a.dir, ii);
  int32_t my_key = kAny ? 0 : a.key0[ii];
  int32_t my_cid = kAny ? -1 : a.cid0[ii];
  const float my_tlim = kAny ? a.tmax[ii] : 0.0f;
  bool my_occ = false;
  unsigned slabs = 0, tests = 0, slab_steps = 0, test_steps = 0;
  const int n_rays = min(32, a.n - base);

  for (int s = 0; s < n_rays; ++s) {
    // ray s of the warp, its running key and bound, the same in every lane
    const Ray r = warp_ray(mine, s);
    int32_t key = __shfl_sync(kFull, my_key, s);
    int32_t cid = __shfl_sync(kFull, my_cid, s);
    const float t_lim = __shfl_sync(kFull, my_tlim, s);
    bool occluded = false;
    if (kAny && !(t_lim > 0.0f)) continue;  // no t lies in (0, t_max)

    for (int s0 = 0; s0 < a.n_super && !occluded; s0 += 32 * kScRound) {
      // level 1: up to 8 supercluster boxes a thread
      uint32_t v[kScRound];
      {
        const float bound = kAny ? t_lim : __int_as_float(key | kLocalMask);
#pragma unroll
        for (int j = 0; j < kScRound; ++j) {
          const int sc = s0 + 32 * j + lane;
          v[j] = kNone;
          if (sc < a.n_super) {
            v[j] = candidate(a.scmin + 3 * sc, a.scmax + 3 * sc, r, bound, 32 * j + lane, 0xffu);
            if (kCount) ++slabs;
          }
        }
        if (kCount) slab_steps += kScRound;
      }
      while (!occluded) {
        uint32_t m = v[0];
#pragma unroll
        for (int j = 1; j < kScRound; ++j) m = min(m, v[j]);
        const uint32_t p = __reduce_min_sync(kFull, m);
        if (p == kNone) break;
        // front to back: every supercluster left is at least this far
        if (__uint_as_float(p & ~0xffu) >= (kAny ? t_lim : __int_as_float(key | kLocalMask))) break;
        const int slot = p & 0xffu;
        if ((slot & 31) == lane) {
#pragma unroll
          for (int j = 0; j < kScRound; ++j)
            if ((slot >> 5) == j) v[j] = kNone;
        }
        const int sc = s0 + slot;

        // level 2: the supercluster's 64 cluster boxes, two a thread
        const int c0 = sc * kGroup + lane, c1 = c0 + 32;
        uint32_t w0 = kNone, w1 = kNone;
        {
          const float bound = kAny ? t_lim : __int_as_float(key | kLocalMask);
          if (c0 < a.n_clusters) {
            w0 = candidate(a.cmin + 3 * c0, a.cmax + 3 * c0, r, bound, lane, (uint32_t)kLocalMask);
            if (kCount) ++slabs;
          }
          if (c1 < a.n_clusters) {
            w1 = candidate(a.cmin + 3 * c1, a.cmax + 3 * c1, r, bound, lane + 32, (uint32_t)kLocalMask);
            if (kCount) ++slabs;
          }
          if (kCount) slab_steps += 2;
        }
        // clusters front to back; the rows of the next candidate are copied while
        // this one is tested
        uint32_t cur = pick_cluster(w0, w1, lane);
        if (cur != kNone)
          stage_cluster(buf, a.tab + (size_t)(sc * kGroup + (int)(cur & kLocalMask)) * kCluster * kTabCols, lane);
        stage_commit();
        int par = 0;
        while (cur != kNone) {
          const float bound = kAny ? t_lim : __int_as_float(key | kLocalMask);
          if (__uint_as_float(cur & ~(uint32_t)kLocalMask) >= bound) break;  // and so is every cluster left
          const uint32_t nxt = pick_cluster(w0, w1, lane);
          if (nxt != kNone && __uint_as_float(nxt & ~(uint32_t)kLocalMask) < bound)
            stage_cluster(buf + (par ^ 1) * kStageFloats,
                          a.tab + (size_t)(sc * kGroup + (int)(nxt & kLocalMask)) * kCluster * kTabCols, lane);
          stage_commit();
          stage_wait<1>();
          const float* rows = buf + par * kStageFloats;
          const Q q0 = staged<Q>(rows + lane * kStageCols);
          const Q q1 = staged<Q>(rows + (lane + 32) * kStageCols);
          if constexpr (kAny) {  // compiled for Tri rows only: warp_any takes no baked row
            int first;
            occluded = warp_any(q0, q1, r, t_lim, first);
            if (kCount && lane == 0) tests += occluded ? first + 1 : kCluster;
          } else {
            const int32_t kmin = warp_closest(q0, q1, r, lane);
            if (kmin < key) {
              key = kmin;
              cid = sc * kGroup + (int)(cur & kLocalMask);
            }
            if (kCount && lane == 0) tests += kCluster;
          }
          if (kCount) test_steps += 2;
          __syncwarp();  // every lane is done with this buffer before the copy after next lands in it
          if (occluded) break;  // a hit decides the ray
          cur = nxt;
          par ^= 1;
        }
        stage_wait<0>();  // no copy in flight when the buffers are used again
      }
    }
    if (lane == s) {
      my_key = key;
      my_cid = cid;
      my_occ = occluded;
    }
  }
  if (live) {
    if (kAny) {
      a.occ_out[base + lane] = my_occ ? 1 : 0;
    } else {
      a.key_out[base + lane] = my_key;
      a.cid_out[base + lane] = my_cid;
    }
  }
  if (kCount) add_work(a.work, slabs, tests, slab_steps, test_steps);
}

template <bool kCount, class Q>
__global__ void __launch_bounds__(kTraceThreads) closest_walk_kernel(const WalkArgs a) {
  ray_walk<false, kCount, Q>(a);
}

template <bool kCount>
__global__ void __launch_bounds__(kTraceThreads) any_walk_kernel(const WalkArgs a) {
  ray_walk<true, kCount, Tri>(a);
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

template <class Q>
int launch_closest_walk(const WalkArgs& a, void* stream) {
  const int blocks = blocks_for(a.n, kTraceThreads);
  if (a.work != nullptr)
    closest_walk_kernel<true, Q><<<blocks, kTraceThreads, 0, (cudaStream_t)stream>>>(a);
  else
    closest_walk_kernel<false, Q><<<blocks, kTraceThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is a device pointer;
// `work` may be null, else it points at four counters to add to (see add_work);
// `stream` is a cudaStream_t.  Returns cudaGetLastError() after the launch.
// `cmin`/`cmax` are the (n_clusters, 3) cluster boxes and `scmin`/`scmax` the
// (n_super, 3) boxes of each run of 64 clusters.
extern "C" int cluster_closest_walk(const float* tab, const float* cmin, const float* cmax, int n_clusters,
                                    const float* scmin, const float* scmax, int n_super, const float* org,
                                    const float* dir, const int32_t* key0, const int32_t* cid0, int n,
                                    int32_t* key_out, int32_t* cid_out, unsigned long long* work, void* stream) {
  const WalkArgs a{tab, cmin, cmax, n_clusters, scmin, scmax, n_super, org, dir, key0, cid0, nullptr,
                   n, key_out, cid_out, nullptr, work};
  return launch_closest_walk<Tri>(a, stream);
}

// The baked walk: `tab` is the shared-origin table of the rays' one origin.
extern "C" int cluster_closest_walk_baked(const float* tab, const float* cmin, const float* cmax, int n_clusters,
                                          const float* scmin, const float* scmax, int n_super, const float* org,
                                          const float* dir, const int32_t* key0, const int32_t* cid0, int n,
                                          int32_t* key_out, int32_t* cid_out, unsigned long long* work,
                                          void* stream) {
  const WalkArgs a{tab, cmin, cmax, n_clusters, scmin, scmax, n_super, org, dir, key0, cid0, nullptr,
                   n, key_out, cid_out, nullptr, work};
  return launch_closest_walk<BakedTri>(a, stream);
}

extern "C" int cluster_any_walk(const float* tab, const float* cmin, const float* cmax, int n_clusters,
                                const float* scmin, const float* scmax, int n_super, const float* org,
                                const float* dir, const float* tmax, int n, uint8_t* occ_out,
                                unsigned long long* work, void* stream) {
  const WalkArgs a{tab, cmin, cmax, n_clusters, scmin, scmax, n_super, org, dir, nullptr, nullptr, tmax,
                   n, nullptr, nullptr, occ_out, work};
  const int blocks = blocks_for(n, kTraceThreads);
  if (work != nullptr)
    any_walk_kernel<true><<<blocks, kTraceThreads, 0, (cudaStream_t)stream>>>(a);
  else
    any_walk_kernel<false><<<blocks, kTraceThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int cluster_group() { return kGroup; }
