// Helpers shared by the kernels: the rigid pose passed by value, and the
// trilinear volume sampling of the ψ sampler (sample.cu) and the raycast
// (raycast.cu).
//
// Same corner weighting and clipping as the plain versions
// (emfusion_tpu_torch/geometry/sampling.py, trilinear_cell and lerp8):
// the base corner is floor(v) clipped to [0, res-2] per axis, the
// fractions are taken against the unclipped floor, and the lerps run x,
// then y, then z. The
// kernels are built with --fmad=false, so each product and sum rounds as
// it does in the plain version and the results agree bit for bit.
#pragma once

#include <cuda_runtime.h>

// Items of one launch of the kernels that take a work table (K1 in
// fusion.cu, K2 in sample.cu, K3 in capture.cu): 17 items of ~120 bytes
// and their block offsets fit the 4 KB parameter bank. The host reads it through each of
// those libraries' emf_max_items().
#define EMF_MAX_ITEMS 17

// A rigid transform, rows of R then t, passed to a kernel by value.
struct EmfPose {
  float r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2;
};

// p -> R p + t, summed left to right as the plain versions do.
__device__ __forceinline__ void emf_apply(const EmfPose& P, float px,
                                          float py, float pz, float& wx,
                                          float& wy, float& wz) {
  wx = P.r00 * px + P.r01 * py + P.r02 * pz + P.t0;
  wy = P.r10 * px + P.r11 * py + P.r12 * pz + P.t1;
  wz = P.r20 * px + P.r21 * py + P.r22 * pz + P.t2;
}

struct EmfCell {
  size_t base;  // flat index of the clipped base corner
  float fx, fy, fz;
};

__device__ __forceinline__ int emf_clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ EmfCell emf_cell(int Z, int Y, int X, float vx,
                                            float vy, float vz) {
  int x0 = (int)floorf(vx);
  int y0 = (int)floorf(vy);
  int z0 = (int)floorf(vz);
  EmfCell c;
  c.fx = vx - (float)x0;
  c.fy = vy - (float)y0;
  c.fz = vz - (float)z0;
  int xc = emf_clampi(x0, 0, X - 2);
  int yc = emf_clampi(y0, 0, Y - 2);
  int zc = emf_clampi(z0, 0, Z - 2);
  c.base = ((size_t)zc * Y + yc) * X + xc;
  return c;
}

__device__ __forceinline__ float emf_lerp8(const EmfCell& c, float c000,
                                           float c001, float c010,
                                           float c011, float c100,
                                           float c101, float c110,
                                           float c111) {
  float c00 = c000 * (1.0f - c.fx) + c001 * c.fx;
  float c01 = c010 * (1.0f - c.fx) + c011 * c.fx;
  float c10 = c100 * (1.0f - c.fx) + c101 * c.fx;
  float c11 = c110 * (1.0f - c.fx) + c111 * c.fx;
  float c0 = c00 * (1.0f - c.fy) + c01 * c.fy;
  float c1 = c10 * (1.0f - c.fy) + c11 * c.fy;
  return c0 * (1.0f - c.fz) + c1 * c.fz;
}

__device__ __forceinline__ float emf_trilerp(const float* __restrict__ vol,
                                             int Z, int Y, int X, float vx,
                                             float vy, float vz) {
  EmfCell c = emf_cell(Z, Y, X, vx, vy, vz);
  const size_t sy = (size_t)X, sz = (size_t)Y * X;
  const float* p = vol + c.base;
  return emf_lerp8(c, __ldg(p), __ldg(p + 1), __ldg(p + sy),
                   __ldg(p + sy + 1), __ldg(p + sz), __ldg(p + sz + 1),
                   __ldg(p + sz + sy), __ldg(p + sz + sy + 1));
}
