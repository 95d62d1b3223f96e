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
//
// Volumes are float32 or bf16 (the background under
// Params.volume_dtype="bfloat16"). A bf16 voxel is kept as its raw 16 bits
// (emf_bf16) and loaded as the float32 with those bits on top, which is
// exact; arithmetic stays float32, and a kernel that stores a volume rounds
// once, to nearest even (emf_round), as the plain versions' float32 ->
// bf16 copy does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef unsigned short emf_bf16;  // the bits of a bfloat16

__device__ __forceinline__ float emf_ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float emf_ld(const emf_bf16* p) {
  return __uint_as_float((unsigned)__ldg(p) << 16);
}

// x rounded to nearest even into T's precision, as a float32.
template <typename T>
__device__ __forceinline__ float emf_round(float x) {
  return x;
}
template <>
__device__ __forceinline__ float emf_round<emf_bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Items of one launch of the kernels that take a work table (K1 in
// fusion.cu, K2 in sample.cu, K3 in capture.cu): 17 items of at most 128
// bytes and their block offsets fit the 4 KB parameter bank. The host reads it through each of
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

// The trilinear blend of the cell at p = vol + c.base, rows sy and sz
// elements apart; T is float or emf_bf16.
template <typename T>
__device__ __forceinline__ float emf_lerp_at(const EmfCell& c,
                                             const T* __restrict__ p,
                                             size_t sy, size_t sz) {
  return emf_lerp8(c, emf_ld(p), emf_ld(p + 1), emf_ld(p + sy),
                   emf_ld(p + sy + 1), emf_ld(p + sz), emf_ld(p + sz + 1),
                   emf_ld(p + sz + sy), emf_ld(p + sz + sy + 1));
}
