// Kernel K0 (camera_rng): a frame's camera and RNG head.
//
// It replaces what XLA fuses of optix_renderer_tpu/engine/renderer.py:89-96
// (no Pallas kernel): the tile's pixel ids in block-major order, the RNG
// seeding get_rng(frame_id + 10007, pixel) (lcg_random.cuh:54-62), the two
// jitter draws and the jittered, normalized primary rays
// (deviceCode.cu:65-73).  Per lane it is
// engine/camera_kernel.py::camera_rng_plain in its order: that function runs
// 123 PyTorch operations a 1024^2 frame over 8-byte lanes, where each 32-bit
// product of the hash takes several int64 passes.
//
// What bounds it on an H100: bytes.  It reads nothing a lane (the camera's
// four vectors and the frame id are 56 bytes for the whole grid) and writes
// the origin (12 bytes), the direction (12) and the state (8): 32 bytes a
// lane, 0.0100 ms at 1M lanes.  Its arithmetic is three IEEE divisions, a
// square root and a few dozen integer operations a lane.  On an H100 it takes
// 0.0133 ms on a 1024^2 frame (graph replays), 75 % of the byte bound.
//
// What the design does about it:
// * The pixel id comes from the lane's index, the tile's width, rows, row
//   offset and block edges in registers: no pixel-id tensor exists.
// * The hash and the LCG run in native 32-bit unsigned arithmetic, which is
//   what core/rng.py's int64 masks compute.
// * Coalesced stores.  A block's directions go through shared memory and out
//   as float4 words (3,072 contiguous bytes a block of 256 lanes); the
//   origins, the camera position repeated, are written as float4 words
//   straight from registers.
//
// The frame id is read from device memory where the caller passes a pointer
// (a frame graph's 0-d int64 tensor, which every replay advances), else taken
// from the value argument.
//
// Build with --fmad=false and without fast math: each float operation below
// is one of the plain version's PyTorch operations on the card, rounded once.
// In particular a PyTorch division by a Python scalar on the card multiplies
// by the float reciprocal of the float constant ((px + ju) / width is
// (px + ju) * (1.0f / width)), a division of two tensors is IEEE division,
// torch.sqrt is the correctly rounded root, and the int64 -> float32 casts
// round to nearest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // lanes a block
constexpr uint32_t kLcgA = 1664525u;   // lcg_random.cuh:43
constexpr uint32_t kLcgC = 1013904223u;  // lcg_random.cuh:44
constexpr uint32_t kFrameSalt = 10007u;  // get_rng(accumId + 10007, ...), deviceCode.cu:65

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// MurmurHash3 mix round (lcg_random.cuh:11-28)
__device__ __forceinline__ uint32_t murmur_mix(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

// MurmurHash3 finalizer (lcg_random.cuh:30-39)
__device__ __forceinline__ uint32_t murmur_finalize(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// one LCG step and its draw: the new state rounded to float, times 2^-32
__device__ __forceinline__ float lcg_randomf(uint32_t& s) {
  s = s * kLcgA + kLcgC;
  return __fmul_rn(__uint2float_rn(s), 0x1p-32f);
}

struct Tile {
  int width, rows, row_offset;
  int bh, bw;          // block edges: rows % bh == 0, width % bw == 0
  float inv_w, inv_h;  // 1.0f / width, 1.0f / height: PyTorch's reciprocal of a Python divisor
};

struct Camera {
  const float *pos, *d00, *du, *dv;
};

__global__ void __launch_bounds__(kThreads)
    camera_rng_kernel(int n, Tile t, const long long* frame_id, long long frame_value, Camera cam, float* origin,
                      float* dir, long long* state) {
  __shared__ float4 sdir4[3 * kThreads / 4];
  float* sdir = reinterpret_cast<float*>(sdir4);
  const int base = blockIdx.x * kThreads;
  const int i = base + threadIdx.x;
  if (i < n) {
    // lane i of the tile in block-major order: blocks of bh x bw pixels, row-major over the tile and inside a block
    const int lx = i % t.bw;
    int q = i / t.bw;
    const int ly = q % t.bh;
    q /= t.bh;
    const int blocks_across = t.width / t.bw;
    const int col = (q % blocks_across) * t.bw + lx;
    const long long row = (long long)t.row_offset + (long long)(q / blocks_across) * t.bh + ly;
    const long long pixel = row * t.width + col;

    const unsigned long long fid = (unsigned long long)(frame_id != nullptr ? *frame_id : frame_value);
    uint32_t s = murmur_mix(0u, (uint32_t)pixel);
    s = murmur_mix(s, (uint32_t)fid + kFrameSalt);
    s = murmur_finalize(s);
    const float ju = lcg_randomf(s);
    const float jv = lcg_randomf(s);

    const float u = __fmul_rn(__fadd_rn(__ll2float_rn(col), ju), t.inv_w);
    const float v = __fmul_rn(__fadd_rn(__ll2float_rn(row), jv), t.inv_h);
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d[k] = __fadd_rn(__fadd_rn(cam.d00[k], __fmul_rn(u, cam.du[k])), __fmul_rn(v, cam.dv[k]));
    }
    const float len = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                                           __fmul_rn(d[2], d[2])));
#pragma unroll
    for (int k = 0; k < 3; ++k) sdir[3 * threadIdx.x + k] = __fdiv_rn(d[k], len);
    state[i] = (long long)s;
  }
  __syncthreads();

  const int lanes = min(kThreads, n - base);
  float* out_dir = dir + 3LL * base;
  float* out_origin = origin + 3LL * base;
  if (lanes == kThreads) {  // a whole block: 3 * 256 floats of each, 16-byte aligned (base is a multiple of 256)
    const float p0 = cam.pos[0], p1 = cam.pos[1], p2 = cam.pos[2];
    for (int j = threadIdx.x; j < 3 * kThreads / 4; j += kThreads) {
      reinterpret_cast<float4*>(out_dir)[j] = sdir4[j];
      // floats 4j .. 4j+3 of the block's origins are pos[(4j) % 3], ...; the block starts at a lane, so at pos[0]
      const int r = (4 * j) % 3;
      reinterpret_cast<float4*>(out_origin)[j] = r == 0   ? make_float4(p0, p1, p2, p0)
                                                 : r == 1 ? make_float4(p1, p2, p0, p1)
                                                          : make_float4(p2, p0, p1, p2);
    }
  } else {  // the ragged last block
    for (int j = threadIdx.x; j < 3 * lanes; j += kThreads) {
      out_dir[j] = sdir[j];
      out_origin[j] = cam.pos[j % 3];
    }
  }
}

}  // namespace

// frame_id: a device pointer to the 0-d int64 frame id, or null to take frame_value.  The outputs: origin and
// direction (n, 3) float32, state (n,) int64 in [0, 2^32).
extern "C" int camera_rng(int n, int width, int height, int rows, int row_offset, int bh, int bw,
                          const long long* frame_id, long long frame_value, const float* pos, const float* d00,
                          const float* du, const float* dv, float* origin, float* dir, long long* state,
                          void* stream) {
  // the reciprocals PyTorch takes on the host for a division by a Python scalar, in float
  const Tile t{width, rows, row_offset, bh, bw, 1.0f / (float)width, 1.0f / (float)height};
  const Camera cam{pos, d00, du, dv};
  camera_rng_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      n, t, frame_id, frame_value, cam, origin, dir, state);
  return (int)cudaGetLastError();
}
