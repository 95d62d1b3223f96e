// K3: the camera LM's capture of each point's 6x6x6 voxel window.
//
// Replaces the two TPU kernels of emfusion_tpu/ops/pallas/band_pallas.py
// (_band_kernel, which resampled per-column z-bands of the volume, and
// _extract_kernel, which cut each point's window out of the bands; entry
// band_capture_pallas). They existed because the TPU has no fast gather,
// and the band's in-plane resample made the cached values deviate from
// exact voxel reads. Hopper gathers directly, so this is the exact form,
// geometry/capture.capture_neighborhoods: anchor = floor(v) - 2 per axis
// (unclipped, from the same grid transform as the samplers), and the
// window's voxel reads clipped to the volume, for tsdf and weights.
//
// Bound on the card: bytes. At 640x480, stride 1, the cache it writes is
// 307,200 x 2 x 216 x 4 B = 531 MB, ~0.16 ms at 3.35 TB/s; the voxel
// reads mostly hit L2, since neighbouring points share voxels. The cache
// is (C, 6, 6, 6, N) with points minor, so the design puts the point on
// the thread index (every store is coalesced) and one (dz, dy) window row
// on blockIdx.y, so 36 blocks per point range are in flight and each
// thread's six x reads sit in one or two cache lines.
#include <cuda_runtime.h>

#include "common.cuh"

#define EMF_WIN 6
#define EMF_ANCHOR_OFF 2

__global__ void emf_capture_kernel(const float* __restrict__ tsdf,
                                   const float* __restrict__ wts,
                                   const float* __restrict__ pts,
                                   float* __restrict__ cache,
                                   int* __restrict__ anchor, int N, int Z,
                                   int Y, int X, EmfPose P, float vs) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int row = blockIdx.y;  // dz * WIN + dy
  const int dz = row / EMF_WIN, dy = row % EMF_WIN;
  float px = pts[i], py = pts[(size_t)N + i], pz = pts[2 * (size_t)N + i];
  float wx, wy, wz;
  emf_apply(P, px, py, pz, wx, wy, wz);
  float vx = wx / vs + 0.5f * (float)(X - 1);
  float vy = wy / vs + 0.5f * (float)(Y - 1);
  float vz = wz / vs + 0.5f * (float)(Z - 1);
  int ax = (int)floorf(vx) - EMF_ANCHOR_OFF;
  int ay = (int)floorf(vy) - EMF_ANCHOR_OFF;
  int az = (int)floorf(vz) - EMF_ANCHOR_OFF;
  if (row == 0) {
    anchor[i] = ax;
    anchor[(size_t)N + i] = ay;
    anchor[2 * (size_t)N + i] = az;
  }
  const int zc = emf_clampi(az + dz, 0, Z - 1);
  const int yc = emf_clampi(ay + dy, 0, Y - 1);
  const size_t rowbase = ((size_t)zc * Y + yc) * X;
  const size_t ch = (size_t)EMF_WIN * EMF_WIN * EMF_WIN * N;
  float* out = cache + (size_t)row * EMF_WIN * N + i;
#pragma unroll
  for (int dx = 0; dx < EMF_WIN; ++dx) {
    size_t idx = rowbase + emf_clampi(ax + dx, 0, X - 1);
    out[(size_t)dx * N] = __ldg(tsdf + idx);
    out[ch + (size_t)dx * N] = __ldg(wts + idx);
  }
}

extern "C" int emf_capture(const float* tsdf, const float* wts,
                           const float* pts, float* cache, int* anchor, int N,
                           int Z, int Y, int X, float r00, float r01,
                           float r02, float r10, float r11, float r12,
                           float r20, float r21, float r22, float t0,
                           float t1, float t2, float vs, void* stream) {
  if (N <= 0) return 0;
  EmfPose P = {r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2};
  const int block = 256;
  dim3 grid((N + block - 1) / block, EMF_WIN * EMF_WIN);
  emf_capture_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      tsdf, wts, pts, cache, anchor, N, Z, Y, X, P, vs);
  return (int)cudaGetLastError();
}
