// K6: nearest-pixel projective warp of an image onto a grid.
//
// Replaces the TPU kernel emfusion_tpu/ops/pallas/warp_pallas.py
// (_warp_kernel, entries warp_image_to_grid_pallas and
// select_grid_at_pixels_pallas). For each output cell (s, l) it maps the
// cell's coordinates through a 3x3 homography, picks the nearest (or the
// floor) source pixel, clamps it into the image and reads it; with
// mask_oob, cells whose point falls outside the image or behind the plane
// get 0. The TPU kernel selected the pixel with one-hot matmuls over a
// window of bf16 hi/lo halves, because its gather ran on a scalar loop;
// Hopper gathers directly, so each thread reads its float32 pixel and the
// value is exact (the TPU's hi/lo split was exact only to ~4e-6).
//
// On the TPU this warp is a stage inside the fusion, ψ-sample, raycast and
// band kernels (the reference-plane factorisation). The port's direct
// kernels need no reference plane: fusion.cu does the same nearest-pixel
// projective pick per voxel, and the ψ sampler and the raycast run per
// pixel, so there is nothing to warp back.
//
// Bound on the card: bytes, 2.2 MB written and at most the 1.2 MB image
// read at 480x640 -> 600x896, 1 µs at 3.35 TB/s. What holds it back is
// launching blocks and each cell's arithmetic, not bytes (an H100,
// scripts/k6_variants.py and its probes): a thread a cell in 128-thread
// blocks (4,200 blocks to that grid) spent 82-88% of its time to the grid
// launching them (an empty kernel on the same grid), and once the blocks
// are few, a cell's two IEEE divisions, floors and conversions are the
// time (the same grid and stores copying the image, with no homography,
// take two thirds of this kernel's time). So a block of 32 x 8 threads
// takes a 128 x 8 tile, four consecutive cells along l a thread with one
// 16-byte store (525 blocks to that grid); the products of the
// homography's first two columns with the tile's column and row
// coordinates (and, to the grid, those coordinates' own divisions) are
// computed once a block into shared memory, so a cell adds three pairs
// and divides twice; the floor is the conversion to int rounding down
// and the clamp is on the integer, which picks the same pixel as floorf
// and a float clamp for every input (NaN converts to 0, an infinity or a
// value out of range saturates). Each value is the plain version's bits:
// the same float32 operations in the same order, built with --fmad=false
// so that products and sums round apart; no reciprocal replaces a
// division.
//
// emf_warp_floor is a measurement entry that no path calls: it launches
// an empty kernel on emf_warp's grid and block, so that a timing can tell
// the launch of K6's grid from its work (chip_smoke.py's K6 rows,
// scripts/k6_variants.py).
#include <cuda_runtime.h>

#define EMF_WARP_BLOCK_X 32
#define EMF_WARP_BLOCK_Y 8
#define EMF_WARP_CPT 4                               // cells a thread
#define EMF_WARP_TILE (EMF_WARP_BLOCK_X * EMF_WARP_CPT)  // columns a block

struct EmfWarpArgs {
  float m00, m01, m02, m10, m11, m12, m20, m21, m22;
  float a0, b0, da, db;
  int H, W, nS, nL;
  int grid_coords, round_half, mask_oob;
  int vec;  // 1: nL % 4 == 0 and out 16-byte aligned
};

// Cell i's plane coordinate along an axis of n cells spanning [o, o + d)
// (grid_coords), else i.
__device__ __forceinline__ float emf_warp_coord(const EmfWarpArgs& a, int i,
                                                int n, float d, float o) {
  float g = (float)i;
  if (a.grid_coords) g = (g + 0.5f) / (float)n * d + o;
  return g;
}

__global__ void emf_warp_kernel(const float* __restrict__ img,
                                float* __restrict__ out, EmfWarpArgs a) {
  __shared__ __align__(16) float cu[EMF_WARP_TILE], cw[EMF_WARP_TILE],
      cz[EMF_WARP_TILE];
  __shared__ float ru[EMF_WARP_BLOCK_Y], rw[EMF_WARP_BLOCK_Y],
      rz[EMF_WARP_BLOCK_Y];
  const int t = threadIdx.y * EMF_WARP_BLOCK_X + threadIdx.x;
  const int lb = blockIdx.x * EMF_WARP_TILE;
  const int sb = blockIdx.y * EMF_WARP_BLOCK_Y;
  for (int c = t; c < EMF_WARP_TILE;
       c += EMF_WARP_BLOCK_X * EMF_WARP_BLOCK_Y) {
    const float ag = emf_warp_coord(a, lb + c, a.nL, a.da, a.a0);
    cu[c] = a.m00 * ag;
    cw[c] = a.m10 * ag;
    cz[c] = a.m20 * ag;
  }
  if (t < EMF_WARP_BLOCK_Y) {
    const float bg = emf_warp_coord(a, sb + t, a.nS, a.db, a.b0);
    ru[t] = a.m01 * bg;
    rw[t] = a.m11 * bg;
    rz[t] = a.m21 * bg;
  }
  __syncthreads();
  const int s = sb + threadIdx.y;
  const int c0 = threadIdx.x * EMF_WARP_CPT;
  const int l0 = lb + c0;
  if (s >= a.nS || l0 >= a.nL) return;
  const float bu = ru[threadIdx.y], bw = rw[threadIdx.y],
              bz = rz[threadIdx.y];
  const float off = a.round_half ? 0.5f : 0.0f;
  float v[EMF_WARP_CPT];
#pragma unroll
  for (int j = 0; j < EMF_WARP_CPT; ++j) {
    // (m00 ag + m01 bg) + m02, as the plain version sums it
    const float hz = cz[c0 + j] + bz + a.m22;
    const float zs = fabsf(hz) < 1e-12f ? 1e-12f : hz;
    const float ug = (cu[c0 + j] + bu + a.m02) / zs;
    const float wg = (cw[c0 + j] + bw + a.m12) / zs;
    const int pu = min(max(__float2int_rd(ug + off), 0), a.W - 1);
    const int pw = min(max(__float2int_rd(wg + off), 0), a.H - 1);
    v[j] = __ldg(img + (size_t)pw * a.W + pu);
    if (a.mask_oob) {
      const bool inb = (ug > -0.5f) && (ug < (float)a.W - 0.5f) &&
                       (wg > -0.5f) && (wg < (float)a.H - 0.5f) &&
                       (hz > 0.0f);
      if (!inb) v[j] = 0.0f;
    }
  }
  float* row = out + (size_t)s * a.nL;
  if (a.vec && l0 + EMF_WARP_CPT <= a.nL) {
    *reinterpret_cast<float4*>(row + l0) = make_float4(v[0], v[1], v[2],
                                                       v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < EMF_WARP_CPT; ++j)
    if (l0 + j < a.nL) row[l0 + j] = v[j];
}

__global__ void emf_warp_empty(EmfWarpArgs a) {}

static dim3 emf_warp_grid(int nS, int nL) {
  return dim3((nL + EMF_WARP_TILE - 1) / EMF_WARP_TILE,
              (nS + EMF_WARP_BLOCK_Y - 1) / EMF_WARP_BLOCK_Y);
}

static EmfWarpArgs emf_warp_args(const float* out, int H, int W, int nS,
                                 int nL, float m00, float m01, float m02,
                                 float m10, float m11, float m12, float m20,
                                 float m21, float m22, float a0, float b0,
                                 float da, float db, int grid_coords,
                                 int round_half, int mask_oob) {
  const int vec = (nL % 4 == 0) && (((size_t)out & 15) == 0);
  EmfWarpArgs a = {m00, m01, m02, m10, m11, m12, m20, m21, m22,
                   a0,  b0,  da,  db,  H,   W,   nS,  nL,
                   grid_coords, round_half, mask_oob, vec};
  return a;
}

extern "C" int emf_warp(const float* img, float* out, int H, int W, int nS,
                        int nL, float m00, float m01, float m02, float m10,
                        float m11, float m12, float m20, float m21, float m22,
                        float a0, float b0, float da, float db,
                        int grid_coords, int round_half, int mask_oob,
                        void* stream) {
  if (nS <= 0 || nL <= 0) return 0;
  const EmfWarpArgs a = emf_warp_args(out, H, W, nS, nL, m00, m01, m02, m10,
                                      m11, m12, m20, m21, m22, a0, b0, da, db,
                                      grid_coords, round_half, mask_oob);
  emf_warp_kernel<<<emf_warp_grid(nS, nL),
                    dim3(EMF_WARP_BLOCK_X, EMF_WARP_BLOCK_Y), 0,
                    (cudaStream_t)stream>>>(img, out, a);
  return (int)cudaGetLastError();
}

extern "C" int emf_warp_floor(const float* img, float* out, int H, int W,
                              int nS, int nL, float m00, float m01, float m02,
                              float m10, float m11, float m12, float m20,
                              float m21, float m22, float a0, float b0,
                              float da, float db, int grid_coords,
                              int round_half, int mask_oob, void* stream) {
  if (nS <= 0 || nL <= 0) return 0;
  const EmfWarpArgs a = emf_warp_args(out, H, W, nS, nL, m00, m01, m02, m10,
                                      m11, m12, m20, m21, m22, a0, b0, da, db,
                                      grid_coords, round_half, mask_oob);
  emf_warp_empty<<<emf_warp_grid(nS, nL),
                   dim3(EMF_WARP_BLOCK_X, EMF_WARP_BLOCK_Y), 0,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
