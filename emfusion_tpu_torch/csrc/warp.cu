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
// Bound on the card: bytes and latency. At 480x640 -> 600x896 it writes
// 2.2 MB and reads at most the 1.2 MB image, under 1 µs at 3.35 TB/s; the
// picks are dependent loads from L2. The design puts l on the thread
// index, so the output rows are written coalesced and neighbouring threads
// read neighbouring pixels. Built with --fmad=false so the picks round as
// the plain version's separately rounded products do.
#include <cuda_runtime.h>

struct EmfWarpArgs {
  float m00, m01, m02, m10, m11, m12, m20, m21, m22;
  float a0, b0, da, db;
  int H, W, nS, nL;
  int grid_coords, round_half, mask_oob;
};

__global__ void emf_warp_kernel(const float* __restrict__ img,
                                float* __restrict__ out, EmfWarpArgs a) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (l >= a.nL) return;
  float ag = (float)l, bg = (float)s;
  if (a.grid_coords) {
    ag = (ag + 0.5f) / (float)a.nL * a.da + a.a0;
    bg = (bg + 0.5f) / (float)a.nS * a.db + a.b0;
  }
  const float hu = a.m00 * ag + a.m01 * bg + a.m02;
  const float hw = a.m10 * ag + a.m11 * bg + a.m12;
  const float hz = a.m20 * ag + a.m21 * bg + a.m22;
  const float zs = fabsf(hz) < 1e-12f ? 1e-12f : hz;
  const float ug = hu / zs;
  const float wg = hw / zs;
  const float off = a.round_half ? 0.5f : 0.0f;
  const float pu = fminf(fmaxf(floorf(ug + off), 0.0f), (float)(a.W - 1));
  const float pw = fminf(fmaxf(floorf(wg + off), 0.0f), (float)(a.H - 1));
  float v = __ldg(img + (size_t)pw * a.W + (size_t)pu);
  if (a.mask_oob) {
    const bool inb = (ug > -0.5f) && (ug < (float)a.W - 0.5f) &&
                     (wg > -0.5f) && (wg < (float)a.H - 0.5f) && (hz > 0.0f);
    if (!inb) v = 0.0f;
  }
  out[(size_t)s * a.nL + l] = v;
}

extern "C" int emf_warp(const float* img, float* out, int H, int W, int nS,
                        int nL, float m00, float m01, float m02, float m10,
                        float m11, float m12, float m20, float m21, float m22,
                        float a0, float b0, float da, float db,
                        int grid_coords, int round_half, int mask_oob,
                        void* stream) {
  if (nS <= 0 || nL <= 0) return 0;
  EmfWarpArgs a = {m00, m01, m02, m10, m11, m12, m20, m21, m22,
                   a0,  b0,  da,  db,  H,   W,   nS,  nL,
                   grid_coords, round_half, mask_oob};
  const int block = 128;
  dim3 grid((nL + block - 1) / block, nS);
  emf_warp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, out, a);
  return (int)cudaGetLastError();
}
