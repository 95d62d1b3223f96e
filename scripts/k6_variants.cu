// K6 (emfusion_tpu_torch/csrc/warp.cu) at other layouts, for
// scripts/k6_variants.py, which builds this file as warp.cu, once for each
// EMF_WARP_VARIANT it defines (8, int4, is the layout csrc/warp.cu took).
// Every variant computes each output cell exactly as the product does (the
// same float32 operations in the same order, --fmad=false), so the picks
// and values are the same bits; the script holds each build against
// warp_homography_plain. They differ in
// how cells are laid over threads and blocks:
//   0 cell:  a thread a cell, 128-thread blocks on a (nL / 128, nS) grid
//            (csrc/warp.cu's first layout);
//   1 flat4: a thread four consecutive cells of the flattened (nS, nL)
//            output, one 16-byte store where the four share a row and the
//            address is aligned, 256-thread blocks on a 1-D grid;
//   2 tile:  2-D blocks of 32 x 8 threads, a thread four consecutive
//            cells along l (a block a 128 x 8 tile, so its source pixels
//            form a compact patch), 16-byte stores;
//   3 wave:  flat4's threads on a grid of one wave (the co-resident
//            blocks from cudaOccupancyMaxActiveBlocksPerMultiprocessor
//            times the SMs), each thread striding over the output;
//   4 pre4:  tile's layout, the products of the homography's first two
//            columns with the tile's column and row coordinates (and
//            those coordinates' divisions) computed once a block into
//            shared memory, so a cell adds three pairs and divides twice;
//            32-bit pixel indices;
//   5 pre8:  pre4 with 16 x 16-thread blocks of eight cells a thread (a
//            block a 128 x 16 tile);
//   6 split4, 7 split8: pre4 and pre8 with a thread's cells in three
//            passes (every division, then every load, then the masks),
//            so that no load is in flight across a division's call to
//            its slow path, which would wait for it;
//   8 int4:  pre4 with the floor taken by the conversion to int (rounding
//            down) and the clamp on the integer, the same pixel for every
//            input: one conversion a coordinate in place of a floor and a
//            conversion;
//   9 int2:  int4 with two cells a thread (a block a 64 x 8 tile).
// 100 and 101 are probes, not K6: tile's grid and stores with no
// homography (100 stores each cell's l, 101 copies the image's clamped
// pixel (s, l)); the script times them and holds nothing.
// emf_warp_floor launches an empty kernel of the variant's grid and block:
// the launch alone.
#include <cuda_runtime.h>

#ifndef EMF_WARP_VARIANT
#define EMF_WARP_VARIANT 0
#endif

struct EmfWarpArgs {
  float m00, m01, m02, m10, m11, m12, m20, m21, m22;
  float a0, b0, da, db;
  int H, W, nS, nL;
  int grid_coords, round_half, mask_oob;
  int vec;  // 1: nL % 4 == 0 and out 16-byte aligned
};

// The pick at homogeneous (hu, hw, hz): the nearest (or floor) pixel,
// clamped into the image; 0 outside it or behind the plane (mask_oob).
__device__ __forceinline__ float emf_warp_pick(const float* __restrict__ img,
                                               const EmfWarpArgs& a, float hu,
                                               float hw, float hz) {
  const float zs = fabsf(hz) < 1e-12f ? 1e-12f : hz;
  const float ug = hu / zs;
  const float wg = hw / zs;
  const float off = a.round_half ? 0.5f : 0.0f;
  const int pu = (int)fminf(fmaxf(floorf(ug + off), 0.0f), (float)(a.W - 1));
  const int pw = (int)fminf(fmaxf(floorf(wg + off), 0.0f), (float)(a.H - 1));
  float v = __ldg(img + (size_t)pw * a.W + pu);
  if (a.mask_oob) {
    const bool inb = (ug > -0.5f) && (ug < (float)a.W - 0.5f) &&
                     (wg > -0.5f) && (wg < (float)a.H - 0.5f) && (hz > 0.0f);
    if (!inb) v = 0.0f;
  }
  return v;
}

// The cell's plane coordinate along l (or s: the same with nS, db, b0).
__device__ __forceinline__ float emf_warp_coord(const EmfWarpArgs& a, int i,
                                                int n, float d, float o) {
  float g = (float)i;
  if (a.grid_coords) g = (g + 0.5f) / (float)n * d + o;
  return g;
}

__device__ __forceinline__ float emf_warp_cell(const float* __restrict__ img,
                                               const EmfWarpArgs& a, int s,
                                               int l) {
  const float ag = emf_warp_coord(a, l, a.nL, a.da, a.a0);
  const float bg = emf_warp_coord(a, s, a.nS, a.db, a.b0);
  return emf_warp_pick(img, a, a.m00 * ag + a.m01 * bg + a.m02,
                       a.m10 * ag + a.m11 * bg + a.m12,
                       a.m20 * ag + a.m21 * bg + a.m22);
}

// Four consecutive cells of the flattened output from cell c0 (32-bit
// indices: the entries refuse an output of 2^31 cells or more): one
// 16-byte store where they share a row (vec), else one cell at a time.
__device__ __forceinline__ void emf_warp_four(const float* __restrict__ img,
                                              float* __restrict__ out,
                                              const EmfWarpArgs& a,
                                              unsigned c0, unsigned total) {
  const unsigned nL = (unsigned)a.nL;
  if (a.vec && c0 + 4 <= total) {
    const unsigned s = c0 / nL;
    const int l = (int)(c0 - s * nL);
    float4 v;
    v.x = emf_warp_cell(img, a, (int)s, l);
    v.y = emf_warp_cell(img, a, (int)s, l + 1);
    v.z = emf_warp_cell(img, a, (int)s, l + 2);
    v.w = emf_warp_cell(img, a, (int)s, l + 3);
    *reinterpret_cast<float4*>(out + c0) = v;
    return;
  }
  for (unsigned c = c0; c < c0 + 4 && c < total; ++c) {
    const unsigned s = c / nL;
    out[c] = emf_warp_cell(img, a, (int)s, (int)(c - s * nL));
  }
}

#if EMF_WARP_VARIANT == 0
#define EMF_WARP_BLOCK_X 128
#define EMF_WARP_BLOCK_Y 1
__global__ void emf_warp_kernel(const float* __restrict__ img,
                                float* __restrict__ out, EmfWarpArgs a) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (l >= a.nL) return;
  out[(size_t)s * a.nL + l] = emf_warp_cell(img, a, s, l);
}
static dim3 emf_warp_grid(const EmfWarpArgs& a) {
  return dim3((a.nL + EMF_WARP_BLOCK_X - 1) / EMF_WARP_BLOCK_X, a.nS);
}
#elif EMF_WARP_VARIANT == 1 || EMF_WARP_VARIANT == 3
#define EMF_WARP_BLOCK_X 256
#define EMF_WARP_BLOCK_Y 1
__global__ void emf_warp_kernel(const float* __restrict__ img,
                                float* __restrict__ out, EmfWarpArgs a) {
  const unsigned total = (unsigned)a.nS * (unsigned)a.nL;
  const unsigned step = gridDim.x * blockDim.x * 4;
  for (unsigned c0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
       c0 < total; c0 += step)
    emf_warp_four(img, out, a, c0, total);
}
static dim3 emf_warp_grid(const EmfWarpArgs& a) {
  const size_t total = (size_t)a.nS * a.nL;
  const size_t per = (size_t)EMF_WARP_BLOCK_X * 4;
  int blocks = (int)((total + per - 1) / per);
#if EMF_WARP_VARIANT == 3
  // asked once (the first call runs before any graph capture)
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, emf_warp_kernel,
                                                  EMF_WARP_BLOCK_X, 0);
    wave = per_sm * sms > 0 ? per_sm * sms : -1;
  }
  if (wave > 0 && blocks > wave) blocks = wave;
#endif
  return dim3(blocks);
}
#elif EMF_WARP_VARIANT == 2
#define EMF_WARP_BLOCK_X 32
#define EMF_WARP_BLOCK_Y 8
__global__ void emf_warp_kernel(const float* __restrict__ img,
                                float* __restrict__ out, EmfWarpArgs a) {
  const int l0 = (blockIdx.x * EMF_WARP_BLOCK_X + threadIdx.x) * 4;
  const int s = blockIdx.y * EMF_WARP_BLOCK_Y + threadIdx.y;
  if (s >= a.nS || l0 >= a.nL) return;
  const size_t row = (size_t)s * a.nL;
  if (a.vec && l0 + 4 <= a.nL) {
    float4 v;
    v.x = emf_warp_cell(img, a, s, l0);
    v.y = emf_warp_cell(img, a, s, l0 + 1);
    v.z = emf_warp_cell(img, a, s, l0 + 2);
    v.w = emf_warp_cell(img, a, s, l0 + 3);
    *reinterpret_cast<float4*>(out + row + l0) = v;
    return;
  }
  for (int l = l0; l < l0 + 4 && l < a.nL; ++l)
    out[row + l] = emf_warp_cell(img, a, s, l);
}
static dim3 emf_warp_grid(const EmfWarpArgs& a) {
  const int tile = EMF_WARP_BLOCK_X * 4;
  return dim3((a.nL + tile - 1) / tile,
              (a.nS + EMF_WARP_BLOCK_Y - 1) / EMF_WARP_BLOCK_Y);
}
#elif EMF_WARP_VARIANT >= 4 && EMF_WARP_VARIANT <= 9
#if EMF_WARP_VARIANT == 4 || EMF_WARP_VARIANT == 6 || EMF_WARP_VARIANT == 8
#define EMF_WARP_BLOCK_X 32
#define EMF_WARP_BLOCK_Y 8
#define EMF_WARP_CPT 4
#elif EMF_WARP_VARIANT == 9
#define EMF_WARP_BLOCK_X 32
#define EMF_WARP_BLOCK_Y 8
#define EMF_WARP_CPT 2
#else
#define EMF_WARP_BLOCK_X 16
#define EMF_WARP_BLOCK_Y 16
#define EMF_WARP_CPT 8
#endif
#define EMF_WARP_TILE (EMF_WARP_BLOCK_X * EMF_WARP_CPT)
__global__ void emf_warp_kernel(const float* __restrict__ img,
                                float* __restrict__ out, EmfWarpArgs a) {
  // the products of the homography's first two columns with the tile's
  // column and row coordinates, each computed once a block
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
  float v[EMF_WARP_CPT];
#if EMF_WARP_VARIANT >= 8
  // the floor as a conversion rounding down, the clamp on the integer:
  // the same pixel as floorf and the float clamp for every input (NaN
  // converts to 0, an infinity or a value out of range saturates)
  const float off = a.round_half ? 0.5f : 0.0f;
#pragma unroll
  for (int j = 0; j < EMF_WARP_CPT; ++j) {
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
#elif EMF_WARP_VARIANT >= 6
  // every division first, then every load, then the masks: no load is
  // in flight across a division's call to its slow path
  float ug[EMF_WARP_CPT], wg[EMF_WARP_CPT], hz[EMF_WARP_CPT];
#pragma unroll
  for (int j = 0; j < EMF_WARP_CPT; ++j) {
    hz[j] = cz[c0 + j] + bz + a.m22;
    const float zs = fabsf(hz[j]) < 1e-12f ? 1e-12f : hz[j];
    ug[j] = (cu[c0 + j] + bu + a.m02) / zs;
    wg[j] = (cw[c0 + j] + bw + a.m12) / zs;
  }
  const float off = a.round_half ? 0.5f : 0.0f;
#pragma unroll
  for (int j = 0; j < EMF_WARP_CPT; ++j) {
    const int pu =
        (int)fminf(fmaxf(floorf(ug[j] + off), 0.0f), (float)(a.W - 1));
    const int pw =
        (int)fminf(fmaxf(floorf(wg[j] + off), 0.0f), (float)(a.H - 1));
    v[j] = __ldg(img + (size_t)pw * a.W + pu);
  }
  if (a.mask_oob) {
#pragma unroll
    for (int j = 0; j < EMF_WARP_CPT; ++j) {
      const bool inb = (ug[j] > -0.5f) && (ug[j] < (float)a.W - 0.5f) &&
                       (wg[j] > -0.5f) && (wg[j] < (float)a.H - 0.5f) &&
                       (hz[j] > 0.0f);
      if (!inb) v[j] = 0.0f;
    }
  }
#else
#pragma unroll
  for (int j = 0; j < EMF_WARP_CPT; j += 4) {
    const float4 u = *reinterpret_cast<const float4*>(cu + c0 + j);
    const float4 w = *reinterpret_cast<const float4*>(cw + c0 + j);
    const float4 z = *reinterpret_cast<const float4*>(cz + c0 + j);
    v[j] = emf_warp_pick(img, a, u.x + bu + a.m02, w.x + bw + a.m12,
                         z.x + bz + a.m22);
    v[j + 1] = emf_warp_pick(img, a, u.y + bu + a.m02, w.y + bw + a.m12,
                             z.y + bz + a.m22);
    v[j + 2] = emf_warp_pick(img, a, u.z + bu + a.m02, w.z + bw + a.m12,
                             z.z + bz + a.m22);
    v[j + 3] = emf_warp_pick(img, a, u.w + bu + a.m02, w.w + bw + a.m12,
                             z.w + bz + a.m22);
  }
#endif
  float* row = out + (size_t)s * a.nL;
  if (a.vec && l0 + EMF_WARP_CPT <= a.nL) {
#if EMF_WARP_CPT == 2
    *reinterpret_cast<float2*>(row + l0) = make_float2(v[0], v[1]);
#else
#pragma unroll
    for (int j = 0; j < EMF_WARP_CPT; j += 4)
      *reinterpret_cast<float4*>(row + l0 + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
#endif
    return;
  }
#pragma unroll
  for (int j = 0; j < EMF_WARP_CPT; ++j)
    if (l0 + j < a.nL) row[l0 + j] = v[j];
}
static dim3 emf_warp_grid(const EmfWarpArgs& a) {
  return dim3((a.nL + EMF_WARP_TILE - 1) / EMF_WARP_TILE,
              (a.nS + EMF_WARP_BLOCK_Y - 1) / EMF_WARP_BLOCK_Y);
}
#elif EMF_WARP_VARIANT == 100 || EMF_WARP_VARIANT == 101
// Probes, not K6 (the script times them and holds nothing): tile's grid
// and stores, with no homography; 100 stores each cell's l, 101 copies
// the clamped pixel (s, l) of the image.
#define EMF_WARP_BLOCK_X 32
#define EMF_WARP_BLOCK_Y 8
__global__ void emf_warp_kernel(const float* __restrict__ img,
                                float* __restrict__ out, EmfWarpArgs a) {
  const int l0 = (blockIdx.x * EMF_WARP_BLOCK_X + threadIdx.x) * 4;
  const int s = blockIdx.y * EMF_WARP_BLOCK_Y + threadIdx.y;
  if (s >= a.nS || l0 + 4 > a.nL) return;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#if EMF_WARP_VARIANT == 100
    v[j] = (float)(l0 + j);
#else
    v[j] = __ldg(img + (size_t)min(s, a.H - 1) * a.W + min(l0 + j, a.W - 1));
#endif
  }
  *reinterpret_cast<float4*>(out + (size_t)s * a.nL + l0) =
      make_float4(v[0], v[1], v[2], v[3]);
}
static dim3 emf_warp_grid(const EmfWarpArgs& a) {
  return dim3((a.nL + 127) / 128, (a.nS + EMF_WARP_BLOCK_Y - 1) /
                                       EMF_WARP_BLOCK_Y);
}
#endif

__global__ void emf_warp_empty(EmfWarpArgs a) {}

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
  if ((size_t)nS * nL >= ((size_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const EmfWarpArgs a = emf_warp_args(out, H, W, nS, nL, m00, m01, m02, m10,
                                      m11, m12, m20, m21, m22, a0, b0, da, db,
                                      grid_coords, round_half, mask_oob);
  emf_warp_kernel<<<emf_warp_grid(a), dim3(EMF_WARP_BLOCK_X, EMF_WARP_BLOCK_Y),
                    0, (cudaStream_t)stream>>>(img, out, a);
  return (int)cudaGetLastError();
}

extern "C" int emf_warp_floor(const float* img, float* out, int H, int W,
                              int nS, int nL, float m00, float m01, float m02,
                              float m10, float m11, float m12, float m20,
                              float m21, float m22, float a0, float b0,
                              float da, float db, int grid_coords,
                              int round_half, int mask_oob, void* stream) {
  if (nS <= 0 || nL <= 0) return 0;
  if ((size_t)nS * nL >= ((size_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const EmfWarpArgs a = emf_warp_args(out, H, W, nS, nL, m00, m01, m02, m10,
                                      m11, m12, m20, m21, m22, a0, b0, da, db,
                                      grid_coords, round_half, mask_oob);
  emf_warp_empty<<<emf_warp_grid(a), dim3(EMF_WARP_BLOCK_X, EMF_WARP_BLOCK_Y),
                   0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
