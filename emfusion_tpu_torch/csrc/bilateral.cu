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
// Bound on the card: the special-function unit. At 640x480 the image is
// 1.2 MB in and out (under 1 µs at 3.35 TB/s) while each pixel takes 49
// accurate expf, one MUFU.EX2 each: 15 M a frame, ~3.6 µs at the SMs'
// 16 per clock at 1.98 GHz, beside ~20 other instructions a tap. The
// design:
// - each block loads its tile of 32x16 outputs with the halo into shared
//   memory once (the border reflected as it is loaded); each of its 256
//   threads computes two vertically adjacent outputs, so the 2r window
//   rows they share are read once for both, and the 600 blocks of a
//   640x480 image fit on the card in one wave (5 resident per SM);
// - the spatial terms travel in the kernel's parameter block, which the
//   card keeps in its constant bank: a tap's term is an operand of its
//   instruction in the unrolled path, a uniform constant-cache read in
//   the general one;
// - the configured radius (r = 3, a 7x7 window) has a fully unrolled
//   path; other radii up to EMF_MAX_R loop at run time.
// Every tap keeps the plain version's expf argument, tap order and
// summation order, so the result is bit-equal to it.
#include <cuda_runtime.h>

#define EMF_TX 32
#define EMF_TY 8                    // threads per block: 32 x 8
#define EMF_ROWS 2                  // outputs per thread, one below other
#define EMF_OY (EMF_TY * EMF_ROWS)  // output rows per block
#define EMF_MAX_R 7

// -(dx^2 + dy^2) / (2 sigma_s^2) per tap, row-major over (dy, dx)
struct EmfSpatial {
  float s[(2 * EMF_MAX_R + 1) * (2 * EMF_MAX_R + 1)];
};

__device__ __forceinline__ int emf_reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

__device__ __forceinline__ void emf_tap(float s, float c, float spatial,
                                        float inv2sd, float& num,
                                        float& den) {
  const float dv = s - c;
  float w = expf(spatial - dv * dv * inv2sd);
  w = s > 0.0f ? w : 0.0f;
  num = num + w * s;
  den = den + w;
}

// R > 0: the radius at compile time, every loop unrolled; R == 0: the
// radius r at run time.
template <int R>
__global__ void __launch_bounds__(EMF_TX* EMF_TY, 5)
    emf_bilateral_kernel(const float* __restrict__ depth,
                         float* __restrict__ out, const EmfSpatial sp, int H,
                         int W, int r_run, float inv2sd) {
  extern __shared__ float tile[];
  const int r = R > 0 ? R : r_run;
  const int n = 2 * r + 1;
  const int tw = EMF_TX + 2 * r, th = EMF_OY + 2 * r;
  const int x0 = blockIdx.x * EMF_TX - r, y0 = blockIdx.y * EMF_OY - r;
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
  const int y = blockIdx.y * EMF_OY + EMF_ROWS * threadIdx.y;
  if (x >= W || y >= H) return;
  // the window of output y starts at tile row EMF_ROWS * threadIdx.y,
  // that of output y + 1 one row lower
  const float* win = tile + EMF_ROWS * threadIdx.y * tw + threadIdx.x;
  const float c0 = win[r * tw + r], c1 = win[(r + 1) * tw + r];
  float num0 = 0.0f, den0 = 0.0f, num1 = 0.0f, den1 = 0.0f;
#pragma unroll
  for (int j = 0; j <= n; ++j) {
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float s = win[j * tw + i];
      if (j < n) emf_tap(s, c0, sp.s[j * n + i], inv2sd, num0, den0);
      if (j > 0) emf_tap(s, c1, sp.s[(j - 1) * n + i], inv2sd, num1, den1);
    }
  }
  out[(size_t)y * W + x] = den0 > 0.0f ? num0 / den0 : 0.0f;
  if (y + 1 < H)
    out[(size_t)(y + 1) * W + x] = den1 > 0.0f ? num1 / den1 : 0.0f;
}

extern "C" int emf_bilateral(const float* depth, float* out,
                             const float* spatial, int H, int W, int r,
                             float inv2sd, void* stream) {
  if (r < 0 || r > EMF_MAX_R) return (int)cudaErrorInvalidValue;
  EmfSpatial sp;
  const int taps = (2 * r + 1) * (2 * r + 1);
  for (int k = 0; k < taps; ++k) sp.s[k] = spatial[k];
  dim3 block(EMF_TX, EMF_TY);
  dim3 grid((W + EMF_TX - 1) / EMF_TX, (H + EMF_OY - 1) / EMF_OY);
  const size_t smem = sizeof(float) * (EMF_TX + 2 * r) * (EMF_OY + 2 * r);
  cudaStream_t s = (cudaStream_t)stream;
  if (r == 3)
    emf_bilateral_kernel<3><<<grid, block, smem, s>>>(depth, out, sp, H, W,
                                                      r, inv2sd);
  else
    emf_bilateral_kernel<0><<<grid, block, smem, s>>>(depth, out, sp, H, W,
                                                      r, inv2sd);
  return (int)cudaGetLastError();
}
