// K2: the E-step's TSDF value ψ at each back-projected pixel point.
//
// Replaces the TPU kernel emfusion_tpu/ops/pallas/sweep_pallas.py
// (_sweep_kernel with with_pts, entry sweep_sample_psi_pallas), which
// streamed the whole volume through VMEM plane by plane because the TPU
// has no fast gather. Hopper has one, so this is the direct form of the
// reference's kernel_getVolumeVals (TSDF.cu:662-726) and of
// geometry/sampling.sample_volume_at_points: one thread per point, a
// rigid transform to grid coordinates, the margin rule, and an 8-corner
// trilinear gather. Invalid points (z <= 0, or outside [0, res-1-margin)
// on an axis) get exactly 0.0, the sentinel the E-step reads as invalid.
// Each thread writes its own pixel's ψ, so the TPU path's warp of the
// sweep's grid back onto the pixels (K6, warp_pallas.py) has no
// counterpart here.
//
// Bound on the card: latency. At 640x480 the function moves ~5 MB
// (points in, ψ out, the touched voxels), a few µs at 3.35 TB/s; the
// gathers are dependent loads, so the design keeps one point per thread
// with many warps in flight to hide them, and coalesces the point reads
// and ψ writes (component-first (3, N) points).
#include <cuda_runtime.h>

#include "common.cuh"

__global__ void emf_sample_kernel(const float* __restrict__ vol,
                                  const float* __restrict__ pts,
                                  float* __restrict__ out, int N, int Z,
                                  int Y, int X, EmfPose P, float vs,
                                  float margin) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float px = pts[i], py = pts[(size_t)N + i], pz = pts[2 * (size_t)N + i];
  float wx, wy, wz;
  emf_apply(P, px, py, pz, wx, wy, wz);
  float vx = wx / vs + 0.5f * (float)(X - 1);
  float vy = wy / vs + 0.5f * (float)(Y - 1);
  float vz = wz / vs + 0.5f * (float)(Z - 1);
  bool valid = (pz > 0.0f) && (vx >= 0.0f) && (vy >= 0.0f) &&
               (vz >= 0.0f) && (vx + margin < (float)X) &&
               (vy + margin < (float)Y) && (vz + margin < (float)Z);
  out[i] = valid ? emf_trilerp(vol, Z, Y, X, vx, vy, vz) : 0.0f;
}

extern "C" int emf_sample(const float* vol, const float* pts, float* out,
                          int N, int Z, int Y, int X, float r00, float r01,
                          float r02, float r10, float r11, float r12,
                          float r20, float r21, float r22, float t0, float t1,
                          float t2, float vs, int margin, void* stream) {
  if (N <= 0) return 0;
  EmfPose P = {r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2};
  const int block = 256;
  emf_sample_kernel<<<(N + block - 1) / block, block, 0,
                      (cudaStream_t)stream>>>(vol, pts, out, N, Z, Y, X, P,
                                              vs, (float)margin);
  return (int)cudaGetLastError();
}
