// K1: association-weighted projective TSDF fusion of one depth frame.
//
// Replaces the TPU kernel emfusion_tpu/ops/pallas/fusion_pencil_pallas.py
// (_kernel, entry integrate_tsdf_pencil_pallas). On the TPU the depth and
// association images were first warped onto a reference-plane grid so the
// kernel could read them with one-hot matmuls instead of gathers, at the
// cost of a nearest-in-grid-cell lookup. Hopper gathers directly, so this
// is the direct form of the reference's kernel_updateTSDF (TSDF.cu:327-427)
// and of ops/fusion.integrate_tsdf: one thread per voxel projects its
// centre, reads depth and association at the rounded (half to even)
// pixel, and applies the running weighted average with the weight cap,
// the -1/0 rules for unseen voxels and the carve rules (carve_dist, the
// carve weight cap and its contradiction margin).
//
// Bound on the card: bytes. At 512^3 f32 it reads and writes tsdf and
// weights, 4 x 537 MB = 2.15 GB, ~0.64 ms at 3.35 TB/s; the two images
// (2.4 MB) stay in L2. The design puts x on the thread index, so every
// warp reads and writes 128 contiguous bytes of each volume, updates in
// place (no second volume), and does each voxel's arithmetic in
// registers. Built with --fmad=false so the pixel rounding matches the
// plain version's separately rounded products.
#include <cuda_runtime.h>

#include "common.cuh"

struct EmfFuseArgs {
  int Z, Y, X, H, W;
  float fx, fy, cx, cy;
  float vs, trunc, max_w, carve_dist;
  int has_cap, has_margin;
  float cap, margin;
};

__device__ __forceinline__ float emf_sign(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

__global__ void emf_fusion_kernel(float* __restrict__ tsdf,
                                  float* __restrict__ wts,
                                  const float* __restrict__ depth,
                                  const float* __restrict__ assoc, EmfPose P,
                                  EmfFuseArgs a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y, z = blockIdx.z;
  if (x >= a.X) return;
  const size_t v = ((size_t)z * a.Y + y) * a.X + x;

  const float px = ((float)x - 0.5f * (float)(a.X - 1)) * a.vs;
  const float py = ((float)y - 0.5f * (float)(a.Y - 1)) * a.vs;
  const float pz = ((float)z - 0.5f * (float)(a.Z - 1)) * a.vs;
  float ccx, ccy, ccz;
  emf_apply(P, px, py, pz, ccx, ccy, ccz);

  // The nearest-pixel projective pick that the TPU path ran as a separate
  // warp kernel (K6, warp_pallas.py) onto its reference-plane grid: here
  // each voxel rounds its own projection and reads the pixel directly.
  const bool in_front = ccz > 0.0f;
  const float zsafe = in_front ? ccz : 1.0f;
  const int pix_x = __float2int_rn(ccx * a.fx / zsafe + a.cx);
  const int pix_y = __float2int_rn(ccy * a.fy / zsafe + a.cy);
  const bool in_frame =
      (pix_x >= 0) && (pix_x < a.W) && (pix_y >= 0) && (pix_y < a.H);
  const size_t pix = (size_t)emf_clampi(pix_y, 0, a.H - 1) * a.W +
                     emf_clampi(pix_x, 0, a.W - 1);
  const float depth_val = __ldg(depth + pix);
  const float assoc_val = __ldg(assoc + pix);
  const bool valid = in_front && in_frame && (depth_val > 0.0f);

  const float ux = ((float)pix_x - a.cx) / a.fx;
  const float uy = ((float)pix_y - a.cy) / a.fy;
  const float lam = sqrtf(ux * ux + uy * uy + 1.0f);
  const float norm_cam = sqrtf(ccx * ccx + ccy * ccy + ccz * ccz);
  const float sdf = depth_val - norm_cam / lam;

  const float t_old = tsdf[v];
  const float w_old = wts[v];
  const bool in_band = valid && (sdf >= -a.trunc);
  const float tsdf_meas = emf_sign(sdf) * fminf(1.0f, fabsf(sdf) / a.trunc);
  const bool carving = valid && (sdf >= a.carve_dist);
  const float new_w = carving ? 1.0f : assoc_val;
  float w_eff = w_old;
  if (a.has_cap) {
    bool capped = carving;
    if (a.has_margin) capped = carving && (tsdf_meas - t_old > a.margin);
    if (capped) w_eff = fminf(w_old, a.cap);
  }
  const float denom = w_eff + new_w;
  const bool do_update = in_band && (denom > 0.0f);
  float t_out = t_old, w_out = w_old;
  if (do_update) {
    t_out = (w_eff * t_old + new_w * tsdf_meas) / denom;
    w_out = fminf(denom, a.max_w);
  }
  if (valid && (sdf < -a.trunc) && (w_old == 0.0f)) t_out = -1.0f;
  if (w_old == 0.0f &&
      ((in_frame && in_front && depth_val <= 0.0f) || !in_front))
    t_out = 0.0f;
  tsdf[v] = t_out;
  wts[v] = w_out;
}

extern "C" int emf_fusion(float* tsdf, float* wts, const float* depth,
                          const float* assoc, int Z, int Y, int X, int H,
                          int W, float r00, float r01, float r02, float r10,
                          float r11, float r12, float r20, float r21,
                          float r22, float t0, float t1, float t2, float fx,
                          float fy, float cx, float cy, float vs, float trunc,
                          float max_w, float carve_dist, int has_cap,
                          float cap, int has_margin, float margin,
                          void* stream) {
  EmfPose P = {r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2};
  EmfFuseArgs a = {Z,  Y,     X,     H,          W,       fx,
                   fy, cx,    cy,    vs,         trunc,   max_w,
                   carve_dist, has_cap, has_margin, cap, margin};
  const int block = 128;
  dim3 grid((X + block - 1) / block, Y, Z);
  emf_fusion_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      tsdf, wts, depth, assoc, P, a);
  return (int)cudaGetLastError();
}
