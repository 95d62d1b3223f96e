// K5: the preprocessing bilateral filter of the depth image.
//
// Replaces the TPU kernel emfusion_tpu/ops/pallas/bilateral_pallas.py
// (_kernel, entry bilateral_filter_pallas), which held the whole image in
// VMEM and built the taps from wrap-around rolls, so its border was zero
// padding. This is the reference's semantics (cv::cuda::bilateralFilter,
// EMFusion.cpp:296-298) as geometry/camera.bilateral_filter has them: a
// k x k window with a Gaussian in pixel distance and one in depth
// difference, reflect-101 borders, and zero-depth taps left out.
//
// Bound on the card: operations and latency. At 640x480 the image is
// 1.2 MB in and out (under 1 µs at 3.35 TB/s) while each pixel does 49
// exponentials; the design loads each 32x8 tile with its halo into shared
// memory once (the border reflected as it is loaded), so each tap is a
// shared-memory read, and takes the 49 spatial terms from a table the
// wrapper fills, so the kernel's sums match the plain version's.
#include <cuda_runtime.h>

#define EMF_TX 32
#define EMF_TY 8

__device__ __forceinline__ int emf_reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

__global__ void emf_bilateral_kernel(const float* __restrict__ depth,
                                     float* __restrict__ out,
                                     const float* __restrict__ spatial,
                                     int H, int W, int r, float inv2sd) {
  extern __shared__ float tile[];
  const int tw = EMF_TX + 2 * r, th = EMF_TY + 2 * r;
  const int x0 = blockIdx.x * EMF_TX - r, y0 = blockIdx.y * EMF_TY - r;
  for (int k = threadIdx.y * EMF_TX + threadIdx.x; k < tw * th;
       k += EMF_TX * EMF_TY) {
    const int gy = emf_reflect101(y0 + k / tw, H);
    const int gx = emf_reflect101(x0 + k % tw, W);
    tile[k] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? __ldg(depth + (size_t)gy * W + gx)
                  : 0.0f;
  }
  __syncthreads();
  const int x = blockIdx.x * EMF_TX + threadIdx.x;
  const int y = blockIdx.y * EMF_TY + threadIdx.y;
  if (x >= W || y >= H) return;
  const float* row = tile + (threadIdx.y + r) * tw + threadIdx.x + r;
  const float c = row[0];
  float num = 0.0f, den = 0.0f;
  int k = 0;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx, ++k) {
      const float s = row[dy * tw + dx];
      const float dv = s - c;
      float w = expf(__ldg(spatial + k) - dv * dv * inv2sd);
      w = s > 0.0f ? w : 0.0f;
      num = num + w * s;
      den = den + w;
    }
  }
  out[(size_t)y * W + x] = den > 0.0f ? num / den : 0.0f;
}

extern "C" int emf_bilateral(const float* depth, float* out,
                             const float* spatial, int H, int W, int r,
                             float inv2sd, void* stream) {
  dim3 block(EMF_TX, EMF_TY);
  dim3 grid((W + EMF_TX - 1) / EMF_TX, (H + EMF_TY - 1) / EMF_TY);
  const size_t smem = sizeof(float) * (EMF_TX + 2 * r) * (EMF_TY + 2 * r);
  emf_bilateral_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      depth, out, spatial, H, W, r, inv2sd);
  return (int)cudaGetLastError();
}
