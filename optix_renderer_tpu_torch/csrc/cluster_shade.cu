// Kernel K4 (cluster_shade): the cluster tier's winners -> SurfaceInteraction.
//
// It replaces kernel B5 (the winner-attribute fetch that stood for
// optix_renderer_tpu/accel/pallas_cluster.py:1657, _winner_attr_kernel) and what
// XLA fuses of optix_renderer_tpu/engine/shade.py:141-275 (_mesh_attr_rows and
// build_surface_interaction_fused; no Pallas kernel).  Per lane it is
// accel/cluster_trace.py::fetch_winner_attrs_plain followed by
// engine/shade.py::build_surface_interaction_fused, in their order: the winning
// sorted triangle's rows shade_a[r] and shade_b[r], r = cid * 64 + (key & 63)
// (accel/build.py: v0 e1 e2 | n1 n2 n3 | mesh prim, and the corner uvs);
// Moller-Trumbore repeated for exact (t, u, v) (accel/brute_trace.py::
// moller_trumbore's order); w = 1 - u - v; the normal interpolated as
// (w * a + u * b) + v * c and normalized with eps 1e-30; the area
// 0.5 * sqrt(|e1 x e2|^2); p = o + t d; uv interpolated and wrapped as
// |fmod(uv, 1)|; the mesh's row (diffuse, emit, alpha, light flag, material, texture
// id); with textures the bilinear atlas sample where the texture id is >= 0;
// alpha clamped to [0.01, 1]; the miss program's fill where cid < 0
// (hit_miss.cuh:52-63).  The plain version reads the mesh's row from a float
// copy of the mesh table; the ids and the light flag survive the round trip
// exactly, so the kernel reads the mesh arrays themselves.
//
// What bounds it on an H100: bytes.  Per lane 8 in (key, cid), 24 (the ray),
// 112 of the winner's rows (80 of shade_a, 32 of shade_b) and 70 out (the ten
// SurfaceInteraction fields): about 214 bytes, 0.067 ms at 1M lanes and 3.35
// TB/s.  The mesh table and the atlas are small and stay in the caches.  Before
// this kernel the same work was B5 (one thread a lane, 26 scalar loads of the
// rows, the (26, N) columns written out: 104 bytes a lane written and read back)
// and about 135 PyTorch passes of the fused shading over those columns.
//
// What the design does about it:
// * Rows as vectors.  A shade_a row is 80 bytes and a shade_b row 32, each
//   16-byte aligned: five float4 loads and two, where B5 made 26 scalar ones.
//   Bounce rays' winners lie anywhere in the 117 MB of rows of a 1M-triangle
//   scene, so these are DRAM sector reads; a whole row a request keeps them few.
// * No intermediate: the columns never leave the thread.
// * Coalesced stores: the (N, 3) and (N, 2) fields go through shared memory and
//   out as float4 words, as K3 writes them (shade_common.cuh).
// * The normal's divisions share one correctly rounded in-range reciprocal
//   (shade_common.cuh's div3, K3's).
//
// Build with --fmad=false and without fast math: each operation below is one of
// the plain versions' PyTorch operations on the card, rounded once, so the two
// agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade_common.cuh"

namespace {

constexpr int kCluster = 64;  // triangles a cluster
constexpr int kRowA = 5;      // float4 words of a shade_a row (20 floats)
constexpr int kRowB = 2;      // of a shade_b row (8 floats, 6 used)
// columns of a shade_a row
constexpr int kV0 = 0, kE1 = 3, kE2 = 6, kN1 = 9, kN2 = 12, kN3 = 15, kMesh = 18;

struct Mesh {
  const float *diffuse, *emit, *alpha;  // (M, 3), (M, 3), (M,)
  const uint8_t* is_light;
  const int *material_id, *diffuse_tex;
};

// One hit lane j of the block (global lane i, winning sorted triangle `row`): its (N, 3) and (N, 2) fields into the
// block's shared tiles, its one-word fields straight out.
__device__ __forceinline__ void shade_winner(int j, int i, size_t row, const float* __restrict__ org,
                                             const float* __restrict__ dir, const float4* __restrict__ shade_a,
                                             const float4* __restrict__ shade_b, const Mesh& mesh, int has_textures,
                                             const Atlas& atlas, float (&s3)[4][3 * kThreads],
                                             float (&s2)[2 * kThreads], const Outputs& out) {
  float a[4 * kRowA], b[4 * kRowB];
#pragma unroll
  for (int k = 0; k < kRowA; ++k) reinterpret_cast<float4*>(a)[k] = __ldg(shade_a + row * kRowA + k);
#pragma unroll
  for (int k = 0; k < kRowB; ++k) reinterpret_cast<float4*>(b)[k] = __ldg(shade_b + row * kRowB + k);
  const float ox = __ldg(org + 3 * (size_t)i), oy = __ldg(org + 3 * (size_t)i + 1), oz = __ldg(org + 3 * (size_t)i + 2);
  const float dx = __ldg(dir + 3 * (size_t)i), dy = __ldg(dir + 3 * (size_t)i + 1), dz = __ldg(dir + 3 * (size_t)i + 2);
  const float e1x = a[kE1], e1y = a[kE1 + 1], e1z = a[kE1 + 2];
  const float e2x = a[kE2], e2y = a[kE2 + 1], e2z = a[kE2 + 2];

  // Moller-Trumbore (t, u, v) without the hit test
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv = 1.0f / (fabsf(det) < 1e-12f ? 1.0f : det);
  const float tx = ox - a[kV0];
  const float ty = oy - a[kV0 + 1];
  const float tz = oz - a[kV0 + 2];
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  const float w = 1.0f - u - v;

  s3[0][3 * j] = ox + t * dx;
  s3[0][3 * j + 1] = oy + t * dy;
  s3[0][3 * j + 2] = oz + t * dz;

  float nx = w * a[kN1] + u * a[kN2] + v * a[kN3];
  float ny = w * a[kN1 + 1] + u * a[kN2 + 1] + v * a[kN3 + 1];
  float nz = w * a[kN1 + 2] + u * a[kN2 + 2] + v * a[kN3 + 2];
  normalize_eps(nx, ny, nz);
  s3[1][3 * j] = nx;
  s3[1][3 * j + 1] = ny;
  s3[1][3 * j + 2] = nz;

  // |fmod(x, 1)| (hit_miss.cuh:34-35)
  const float x_uv = w * b[0] + u * b[2] + v * b[4], y_uv = w * b[1] + u * b[3] + v * b[5];
  const float uu = wrap_unit(x_uv), vv = wrap_unit(y_uv);
  s2[2 * j] = uu;
  s2[2 * j + 1] = vv;

  const int m = (int)a[kMesh];
  float d0 = __ldg(mesh.diffuse + 3 * m), d1 = __ldg(mesh.diffuse + 3 * m + 1), d2 = __ldg(mesh.diffuse + 3 * m + 2);
  if (has_textures) {  // hit_miss.cuh:40-44
    const int tex = __ldg(mesh.diffuse_tex + m);
    if (tex >= 0) sample_atlas(atlas, tex, uu, vv, d0, d1, d2);
  }
  s3[2][3 * j] = d0;
  s3[2][3 * j + 1] = d1;
  s3[2][3 * j + 2] = d2;
#pragma unroll
  for (int k = 0; k < 3; ++k) s3[3][3 * j + k] = __ldg(mesh.emit + 3 * m + k);
  out.alpha[i] = clamp2(__ldg(mesh.alpha + m), kAlphaMin, 1.0f);  // hit_miss.cuh:45-46
  out.is_light[i] = __ldg(mesh.is_light + m) != 0;
  out.material_id[i] = __ldg(mesh.material_id + m);

  const float ax = e1y * e2z - e1z * e2y;
  const float ay = e1z * e2x - e1x * e2z;
  const float az = e1x * e2y - e1y * e2x;
  out.area[i] = 0.5f * sqrtf(ax * ax + ay * ay + az * az);
}

__global__ void __launch_bounds__(kThreads) cluster_shade_kernel(
    int n, const int32_t* __restrict__ key, const int32_t* __restrict__ cid, const float* __restrict__ org,
    const float* __restrict__ dir, const float4* __restrict__ shade_a, const float4* __restrict__ shade_b, Mesh mesh,
    int has_textures, Atlas atlas, const float* __restrict__ miss_color, Outputs out) {
  // this block's lanes of the (N, 3) fields p, n_geom, diffuse, emit and of the (N, 2) uv, lane-major
  __shared__ __align__(16) float s3[4][3 * kThreads];
  __shared__ __align__(16) float s2[2 * kThreads];
  const int base = blockIdx.x * kThreads;
  const int lanes = min(kThreads, n - base);
  const int j = threadIdx.x, i = base + j;
  if (j < lanes) {
    const int32_t c = cid[i];
    const bool valid = c >= 0;
    out.hit[i] = valid;
    if (valid) {
      const size_t row = (size_t)c * kCluster + (key[i] & (kCluster - 1));
      shade_winner(j, i, row, org, dir, shade_a, shade_b, mesh, has_textures, atlas, s3, s2, out);
    } else {
      shade_miss(j, i, miss_color, s3, s2, out);
    }
  }

  __syncthreads();
  store_tiles(s3, s2, out, base, lanes);
}

}  // namespace

// `shade_a` (Tp, 20) and `shade_b` (Tp, 8) are 16-byte aligned; `org`/`dir` are (n, 3); the mesh arrays are the
// scene's (M, 3) diffuse and emit, (M,) alpha, light flag (bytes), material id and diffuse texture id; every output
// pointer is 16-byte aligned.
extern "C" int cluster_shade(int n, const int32_t* key, const int32_t* cid, const float* org, const float* dir,
                             const float* shade_a, const float* shade_b, const float* mesh_diffuse,
                             const float* mesh_emit, const float* mesh_alpha, const uint8_t* mesh_is_light,
                             const int* mesh_material_id, const int* mesh_diffuse_tex, int has_textures,
                             const float* pixels, const int* tex_offset, const int* tex_width, const int* tex_height,
                             const float* miss_color, uint8_t* hit, float* p, float* uv, float* n_geom,
                             float* diffuse, float* alpha, float* emit, uint8_t* is_light, int* material_id,
                             float* area, void* stream) {
  const Mesh mesh{mesh_diffuse, mesh_emit, mesh_alpha, mesh_is_light, mesh_material_id, mesh_diffuse_tex};
  const Atlas atlas{pixels, tex_offset, tex_width, tex_height};
  const Outputs out{hit, p, uv, n_geom, diffuse, alpha, emit, is_light, material_id, area};
  cluster_shade_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      n, key, cid, org, dir, reinterpret_cast<const float4*>(shade_a), reinterpret_cast<const float4*>(shade_b),
      mesh, has_textures, atlas, miss_color, out);
  return (int)cudaGetLastError();
}
