// Kernel K-sweep (sc_sweep): the cluster tier's per-ray supercluster sweep.
//
// It replaces what XLA fuses of optix_renderer_tpu/accel/pallas_cluster.py:
// 151-256 (no Pallas kernel): the dense slab test of every ray against every
// supercluster box, reduced per ray to its t bound (ray_t_bounds) and, where
// asked, its corridor sort key (corridor_keys_and_t_bounds).  Per lane it is
// accel/cluster.py's _sc_slab_sweep, _t_bound_from_sweep and the key's
// packing, in their order: those run some 40 (t bound) to 65 (key and t bound)
// PyTorch passes over (N, S) float and bool tensors, 1 GiB each at 1M rays and
// S = 256.
//
// What bounds it on an H100: issue slots.  A lane reads 28 bytes (origin,
// direction, t_max) and writes 8; per box it runs a 24-op slab test and a few
// compares and selects, so a lane that tests every box of S = 256 issues about
// 7 k instructions for the t bound and about 2.7 times that for a key with its
// middle index.
//
// What the design does about it:
// * One thread a ray; the boxes go through shared memory, up to kChunk at a
//   time, as two float4 words a box.  Every lane of a warp reads the same box,
//   so each read is a broadcast.
// * Groups: when a block stages a chunk it makes the union box of each run of
//   kGroup boxes (Morton-contiguous superclusters, so a compact region).  A
//   lane slab-tests the union first and skips the group where it misses it
//   without a NaN: on each axis a box's slab interval lies inside its union's
//   (rounding is monotonic), so no box of the group can be hit.  A skipped group
//   counts as its first box missed, which is what the box loop would leave in
//   the registers (the others tie with it).  A warp skips a group when all its
//   lanes do: the dead lanes a frame moves above the scene, and rays that pass
//   only part of it.
// * The t bound alone (mode 0) of a ray whose t_max is exactly +0 is +0 whatever
//   the boxes (the minimum of +0 and a bound above 0, or a miss's 0), so such a
//   lane tests no box: RATIO's rays of miss and light lanes, whose answer no
//   buffer reads.  Any other t_max is swept, a -0, negative or NaN one too: the
//   plain sweep passes it on where a box is hit and writes 0 where none is.
// * Pass 1 keeps in registers the farthest exit of the hit boxes (which is
//   above 0 exactly when some box is hit, so it also says whether one is), and
//   for a key the first and last hit box by entry distance.  The key's middle
//   index needs the mean of those two, so a second pass recomputes each box's
//   entry distance; it runs only where the key has room for the middle index.
//
// Bit-equal to the plain version on the card:
// * min and max inside the slab chain pass a NaN on (min.NaN / max.NaN), as
//   torch.minimum and torch.maximum do: a NaN anywhere makes the box a miss.
//   Where a NaN's payload reaches an output (a NaN t_max), the first NaN
//   operand is returned, as torch.minimum does.
// * Ties go to the smallest box index, as PyTorch's CUDA min(dim), max(dim)
//   and argmin pick: strict comparisons over the boxes in index order.  A NaN
//   distance wins the argmin, as it does there.
// * Build with --fmad=false and without fast math: each float operation is one
//   of the plain version's PyTorch operations, rounded once; the reciprocal of
//   the direction is IEEE division, and a product or sum with a Python scalar
//   takes the scalar rounded to float.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rays a block
constexpr int kChunk = 512;    // boxes staged a round: 2 float4 each, 16 KB
constexpr int kGroup = 32;     // staged boxes a group: a ray tests the group's union box first
constexpr int kMissKey = 0x7FFFFFFF;
// accel/cluster.py's _INF and the margin of the t bound: Python floats, rounded to float as PyTorch does
constexpr float kBig = (float)3.0e38;
constexpr float kMarginScale = (float)1.0001;
constexpr float kMarginAdd = (float)1e-3;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch.minimum on the card: the first NaN operand, else the smaller
__device__ __forceinline__ float torch_minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// cluster_trace.inv_dir: 1 / d with |d| clamped to >= 1e-20, its sign kept (-0 counts as positive)
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d);
}

struct Lane {
  float ox, oy, oz, ix, iy, iz;
};

// The slab test of one staged box, axes x, y, z in turn: (near, far), and whether the ray hits it
// (near <= far and far > 0; false if any step was NaN).
__device__ __forceinline__ bool slab(const float4* __restrict__ box, const Lane& r, float& near, float& far) {
  const float4 a = box[0], b = box[1];  // (min x, min y, min z, max x), (max y, max z, -, -)
  float t0 = __fmul_rn(__fsub_rn(a.x, r.ox), r.ix);
  float t1 = __fmul_rn(__fsub_rn(a.w, r.ox), r.ix);
  near = min_nan(t0, t1);
  far = max_nan(t0, t1);
  t0 = __fmul_rn(__fsub_rn(a.y, r.oy), r.iy);
  t1 = __fmul_rn(__fsub_rn(b.x, r.oy), r.iy);
  near = max_nan(near, min_nan(t0, t1));
  far = min_nan(far, max_nan(t0, t1));
  t0 = __fmul_rn(__fsub_rn(a.z, r.oz), r.iz);
  t1 = __fmul_rn(__fsub_rn(b.y, r.oz), r.iz);
  near = max_nan(near, min_nan(t0, t1));
  far = min_nan(far, max_nan(t0, t1));
  return near <= far && far > 0.0f;
}

// Stage boxes [c0, c0 + count) as two float4 words each, then the union box of each group of kGroup staged boxes
// (the least and greatest of every min and max coordinate, so an inverted box lies inside too), one warp a group.
__device__ __forceinline__ void stage(float4* sbox, float4* sgroup, const float* __restrict__ bmin,
                                      const float* __restrict__ bmax, int c0, int count) {
  for (int j = threadIdx.x; j < count; j += kThreads) {
    const size_t k = 3 * (size_t)(c0 + j);
    sbox[2 * j] = make_float4(bmin[k], bmin[k + 1], bmin[k + 2], bmax[k]);
    sbox[2 * j + 1] = make_float4(bmax[k + 1], bmax[k + 2], 0.0f, 0.0f);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int g = threadIdx.x / 32; g * kGroup < count; g += kThreads / 32) {
    const float inf = __int_as_float(0x7f800000);
    float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
    const int j = g * kGroup + lane;
    if (j < count) {
      const float4 a = sbox[2 * j], b = sbox[2 * j + 1];
      const float mn[3] = {a.x, a.y, a.z}, mx[3] = {a.w, b.x, b.y};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = fminf(mn[k], mx[k]);
        hi[k] = fmaxf(mn[k], mx[k]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
        hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
      }
    }
    if (lane == 0) {
      sgroup[2 * g] = make_float4(lo[0], lo[1], lo[2], hi[0]);
      sgroup[2 * g + 1] = make_float4(hi[1], hi[2], 0.0f, 0.0f);
    }
  }
  __syncthreads();
}

// Does the ray miss every box of a group?  It does where it misses the group's union box without a NaN: each
// box's slab interval on an axis lies inside the union's (rounding is monotonic), so a hit on a box is a hit on
// the union.  A NaN in the union's test skips nothing.
__device__ __forceinline__ bool misses_group(const float4* __restrict__ group, const Lane& r) {
  float near, far;
  slab(group, r, near, far);
  return near > far || far <= 0.0f;
}

struct Args {
  int n, s, key_bits;
  const float *bmin, *bmax, *org, *dir;
  const float* t_max;  // null: every ray takes t_value
  int t_stride;        // 0: one t_max for every ray
  float t_value;
  float* t_out;
  int* key_out;
};

__device__ __forceinline__ float t_max_of(const Args& a, int i) {
  return a.t_max != nullptr ? a.t_max[(size_t)i * a.t_stride] : a.t_value;
}

// kMode 0: the t bound; 1: and a key of the first and last box; 2: and a key of the first, middle and last box.
template <int kMode>
__global__ void __launch_bounds__(kThreads) supercluster_sweep_kernel(Args a) {
  __shared__ float4 sbox[2 * kChunk];
  __shared__ float4 sgroup[2 * kChunk / kGroup];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < a.n;
  // the t bound alone reads t_max first: a lane whose t_max is +0 tests no box
  const float t0 = kMode == 0 && live ? t_max_of(a, i) : 0.0f;
  const bool sweep = live && !(kMode == 0 && __float_as_uint(t0) == 0u);
  Lane r{};
  if (live) {
    const size_t k = 3 * (size_t)i;
    r = {a.org[k], a.org[k + 1], a.org[k + 2], inv_dir(a.dir[k]), inv_dir(a.dir[k + 1]), inv_dir(a.dir[k + 2])};
  }
  // pass 1: the farthest exit of the hit boxes (0 if none: a hit box's far is above 0); the first box by
  // entry distance (misses at kBig) and the last (misses at -kBig), the smallest index on ties.  A group the
  // ray misses counts as its first box missed: the others tie with it.
  float far_bound = 0.0f;
  float entry_t = __int_as_float(0x7f800000), exit_t = -__int_as_float(0x7f800000);
  int first = 0, last = 0;
  int staged = -1;
  for (int c0 = 0; c0 < a.s; c0 += kChunk) {
    const int count = min(kChunk, a.s - c0);
    __syncthreads();
    stage(sbox, sgroup, a.bmin, a.bmax, c0, count);
    staged = c0;
    if (!sweep) continue;
    for (int g0 = 0; g0 < count; g0 += kGroup) {
      if (misses_group(sgroup + 2 * (g0 / kGroup), r)) {
        if (kMode > 0) {
          if (kBig < entry_t) {
            entry_t = kBig;
            first = c0 + g0;
          }
          if (-kBig > exit_t) {
            exit_t = -kBig;
            last = c0 + g0;
          }
        }
        continue;
      }
      const int g1 = min(count, g0 + kGroup);
#pragma unroll 4
      for (int j = g0; j < g1; ++j) {
        float near, far;
        const bool hit = slab(sbox + 2 * j, r, near, far);
        far_bound = hit ? fmaxf(far_bound, far) : far_bound;
        if (kMode > 0) {
          const float c = fmaxf(near, 0.0f);  // torch.clamp(near, min=0): near is no NaN where hit
          const float e = hit ? c : kBig;
          const float x = hit ? c : -kBig;
          if (e < entry_t) {
            entry_t = e;
            first = c0 + j;
          }
          if (x > exit_t) {
            exit_t = x;
            last = c0 + j;
          }
        }
      }
    }
  }
  const bool any_hit = far_bound > 0.0f;

  int mid = 0;
  if (kMode == 2) {
    // pass 2: the box whose clamped entry distance is nearest the middle of the corridor.  A NaN distance
    // (an infinite entry distance less an infinite middle) wins, as in PyTorch's argmin: it counts as -1.
    // A group the ray misses counts as its first box missed, at |kBig - mid_t| (no NaN: kBig is finite).
    const float mid_t = any_hit ? __fmul_rn(__fadd_rn(entry_t, exit_t), 0.5f) : 0.0f;
    const float v_miss = fabsf(__fsub_rn(kBig, mid_t));
    float best = __int_as_float(0x7f800000);
    for (int c0 = 0; c0 < a.s; c0 += kChunk) {
      const int count = min(kChunk, a.s - c0);
      if (c0 != staged) {
        __syncthreads();
        stage(sbox, sgroup, a.bmin, a.bmax, c0, count);
        staged = c0;
      }
      if (!live) continue;
      for (int g0 = 0; g0 < count; g0 += kGroup) {
        if (misses_group(sgroup + 2 * (g0 / kGroup), r)) {
          if (v_miss < best) {
            best = v_miss;
            mid = c0 + g0;
          }
          continue;
        }
        const int g1 = min(count, g0 + kGroup);
#pragma unroll 4
        for (int j = g0; j < g1; ++j) {
          float near, far;
          const bool hit = slab(sbox + 2 * j, r, near, far);
          float v = fabsf(__fsub_rn(hit ? fmaxf(near, 0.0f) : kBig, mid_t));
          v = v != v ? -1.0f : v;
          if (v < best) {
            best = v;
            mid = c0 + j;
          }
        }
      }
    }
  }
  if (!live) return;

  const float t = kMode == 0 ? t0 : t_max_of(a, i);
  a.t_out[i] = any_hit ? torch_minimum(t, __fadd_rn(__fmul_rn(far_bound, kMarginScale), kMarginAdd)) : 0.0f;
  if (kMode > 0) {
    const int sb = a.key_bits;
    int key;
    if (kMode == 2) {
      key = (first << (2 * sb)) | (mid << sb) | last;
    } else if (2 * sb <= 31) {
      key = (first << sb) | last;
    } else {
      key = first;
    }
    a.key_out[i] = any_hit ? key : kMissKey;
  }
}

}  // namespace

// The sweep of n rays (origin, direction (n, 3) float32) over s boxes (box_min, box_max (s, 3) float32).
// t_max: a device pointer read at i * t_stride (t_stride 0: one value for all), or null to take t_value.
// key_bits < 0: the t bound only, into t_out (n,) float32; else also the corridor key into key_out (n,) int32,
// packed with key_bits bits an index (accel/cluster.py::_cid_bits(s)).
extern "C" int sc_sweep(int n, int s, int key_bits, const float* box_min, const float* box_max, const float* origin,
                        const float* direction, const float* t_max, int t_stride, float t_value, float* t_out,
                        int* key_out, void* stream) {
  const Args a{n, s, key_bits, box_min, box_max, origin, direction, t_max, t_stride, t_value, t_out, key_out};
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (key_bits < 0) {
    supercluster_sweep_kernel<0><<<grid, kThreads, 0, st>>>(a);
  } else if (3 * key_bits <= 31) {
    supercluster_sweep_kernel<2><<<grid, kThreads, 0, st>>>(a);
  } else {
    supercluster_sweep_kernel<1><<<grid, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
