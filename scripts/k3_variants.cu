// K3 (emfusion_tpu_torch/csrc/capture.cu) at other layouts, for
// scripts/k3_variants.py, which builds this file as capture.cu beside the
// product's common.cuh, once for each EMF_CAPTURE_RPT it defines. The
// same function as the product's kernel (the same anchors and cache
// bits; the script holds each build against the plain capture), laid
// out so that:
//   - a bf16 item's thread copies two neighbouring points, each of its
//     stores one 32-bit word of two bf16 values (a warp writes 128 B an
//     instruction, as a float32 warp does; two 16-bit stores where the
//     pair is not 4-byte aligned, or a point has no neighbour);
//   - a thread copies EMF_CAPTURE_RPT consecutive (dz, dy) window rows of
//     its point(s), so it computes each anchor 36 / EMF_CAPTURE_RPT times
//     (the product: 36), and the grid has 36 / EMF_CAPTURE_RPT blocks in
//     y: 1 (the product's rows with paired stores), 6 (a block a dz) or
//     36 (a thread a point, all its rows).
#include <cuda_runtime.h>

#include "common.cuh"

#define EMF_WIN 6
#define EMF_ANCHOR_OFF 2
#define EMF_CAPTURE_BLOCK 256
#define EMF_CAPTURE_ROWS (EMF_WIN * EMF_WIN)   // (dz, dy) rows a window
#ifndef EMF_CAPTURE_RPT
#define EMF_CAPTURE_RPT 1   // window rows a thread copies: 1, 6 or 36
#endif

// One volume of the launch. Mirrored by kernels.CaptureArgs.
struct EmfCaptureItem {
  const void* tsdf;   // (Z, Y, X), float or emf_bf16
  const void* wts;    // (Z, Y, X), the same type
  const float* pts;   // (3, n) camera points
  void* cache;        // (2, 6, 6, 6, n), the volumes' type
  int* anchor;        // (3, n)
  int n, Z, Y, X;
  int bf16;           // 1: volumes and cache are bf16
  EmfPose P;          // camera -> volume
  float vs;
};

struct EmfCaptureTable {
  int n;
  int block_end[EMF_MAX_ITEMS];  // cumulative block counts
  EmfCaptureItem items[EMF_MAX_ITEMS];
};

// The points of a block: a thread's points (1, or 2 for a bf16 item)
// times its threads.
__host__ __device__ __forceinline__ int emf_capture_tile(int bf16) {
  return (bf16 ? 2 : 1) * EMF_CAPTURE_BLOCK;
}

// Point i's anchor (floor(v) - 2 per axis) into a, and into anchor[]
// (3, N) where `put`.
__device__ __forceinline__ void emf_capture_anchor(const EmfCaptureItem& it,
                                                   int i, int* a, bool put) {
  const size_t N = (size_t)it.n;
  const float px = it.pts[i], py = it.pts[N + i], pz = it.pts[2 * N + i];
  float wx, wy, wz;
  emf_apply(it.P, px, py, pz, wx, wy, wz);
  const float vx = wx / it.vs + 0.5f * (float)(it.X - 1);
  const float vy = wy / it.vs + 0.5f * (float)(it.Y - 1);
  const float vz = wz / it.vs + 0.5f * (float)(it.Z - 1);
  a[0] = (int)floorf(vx) - EMF_ANCHOR_OFF;
  a[1] = (int)floorf(vy) - EMF_ANCHOR_OFF;
  a[2] = (int)floorf(vz) - EMF_ANCHOR_OFF;
  if (put) {
    it.anchor[i] = a[0];
    it.anchor[N + i] = a[1];
    it.anchor[2 * N + i] = a[2];
  }
}

// The six voxels of window row (dz, dy) of the point anchored at a, from
// tsdf and weights, as they are stored (float or bf16 bits).
template <typename T>
__device__ __forceinline__ void emf_capture_row(const EmfCaptureItem& it,
                                                const int* a, int dz, int dy,
                                                T (&t)[EMF_WIN],
                                                T (&w)[EMF_WIN]) {
  const int X = it.X;
  const int zc = emf_clampi(a[2] + dz, 0, it.Z - 1);
  const int yc = emf_clampi(a[1] + dy, 0, it.Y - 1);
  const size_t row = ((size_t)zc * it.Y + yc) * X;
  const T* tsdf = static_cast<const T*>(it.tsdf) + row;
  const T* wts = static_cast<const T*>(it.wts) + row;
#pragma unroll
  for (int dx = 0; dx < EMF_WIN; ++dx) {
    const int x = emf_clampi(a[0] + dx, 0, X - 1);
    t[dx] = __ldg(tsdf + x);
    w[dx] = __ldg(wts + x);
  }
}

// Two neighbouring bf16 values at out[0], out[1]: one 32-bit store where
// out is 4-byte aligned and both exist, else one or two 16-bit stores.
__device__ __forceinline__ void emf_store_pair(emf_bf16* out, emf_bf16 lo,
                                               emf_bf16 hi, bool both) {
  if (both && !(reinterpret_cast<size_t>(out) & 3)) {
    *reinterpret_cast<unsigned*>(out) = (unsigned)lo | ((unsigned)hi << 16);
  } else {
    out[0] = lo;
    if (both) out[1] = hi;
  }
}

// Thread t of block (b, y) copies the window rows y * RPT .. y * RPT +
// RPT - 1 of its point (float32) or its two neighbouring points (bf16);
// the blocks of row 0 write the anchors.
__global__ void __launch_bounds__(EMF_CAPTURE_BLOCK)
    emf_capture_kernel(const __grid_constant__ EmfCaptureTable T) {
  const int b = blockIdx.x;
  int k = 0;
  while (b >= T.block_end[k]) ++k;
  const EmfCaptureItem& it = T.items[k];
  const int ppt = it.bf16 ? 2 : 1;
  const int i = ((b - (k ? T.block_end[k - 1] : 0)) * EMF_CAPTURE_BLOCK +
                 (int)threadIdx.x) * ppt;
  if (i >= it.n) return;
  const bool put = blockIdx.y == 0, both = it.bf16 && i + 1 < it.n;
  int a0[3], a1[3];
  emf_capture_anchor(it, i, a0, put);
  if (both) emf_capture_anchor(it, i + 1, a1, put);
  const size_t N = (size_t)it.n, ch = (size_t)EMF_CAPTURE_ROWS * EMF_WIN * N;
  for (int r = 0; r < EMF_CAPTURE_RPT; ++r) {
    const int row = blockIdx.y * EMF_CAPTURE_RPT + r;
    const int dz = row / EMF_WIN, dy = row % EMF_WIN;
    const size_t off = (size_t)row * EMF_WIN * N + i;
    if (it.bf16) {
      emf_bf16 t0[EMF_WIN], w0[EMF_WIN], t1[EMF_WIN] = {}, w1[EMF_WIN] = {};
      emf_capture_row(it, a0, dz, dy, t0, w0);
      if (both) emf_capture_row(it, a1, dz, dy, t1, w1);
      emf_bf16* o = static_cast<emf_bf16*>(it.cache) + off;
#pragma unroll
      for (int dx = 0; dx < EMF_WIN; ++dx) {
        emf_store_pair(o + (size_t)dx * N, t0[dx], t1[dx], both);
        emf_store_pair(o + ch + (size_t)dx * N, w0[dx], w1[dx], both);
      }
    } else {
      float t[EMF_WIN], w[EMF_WIN];
      emf_capture_row(it, a0, dz, dy, t, w);
      float* o = static_cast<float*>(it.cache) + off;
#pragma unroll
      for (int dx = 0; dx < EMF_WIN; ++dx) {
        o[(size_t)dx * N] = t[dx];
        o[ch + (size_t)dx * N] = w[dx];
      }
    }
  }
}

extern "C" int emf_max_items() { return EMF_MAX_ITEMS; }

// items: n host-side items (1 <= n <= EMF_MAX_ITEMS). Launches nothing
// when no item has a point. Returns a cudaError_t.
extern "C" int emf_capture(const EmfCaptureItem* items, int n,
                           void* stream) {
  if (n < 1 || n > EMF_MAX_ITEMS) return (int)cudaErrorInvalidValue;
  EmfCaptureTable T;
  T.n = n;
  long long blocks = 0;
  for (int k = 0; k < EMF_MAX_ITEMS; ++k) {
    if (k < n) {
      const EmfCaptureItem& it = items[k];
      if (it.n < 0) return (int)cudaErrorInvalidValue;
      T.items[k] = it;
      const int tile = emf_capture_tile(it.bf16);
      blocks += (it.n + tile - 1) / tile;
    } else {
      T.items[k] = EmfCaptureItem{};
    }
    T.block_end[k] = (int)blocks;
  }
  if (blocks == 0) return 0;
  const dim3 grid((unsigned)blocks, EMF_CAPTURE_ROWS / EMF_CAPTURE_RPT);
  emf_capture_kernel<<<grid, EMF_CAPTURE_BLOCK, 0, (cudaStream_t)stream>>>(
      T);
  return (int)cudaGetLastError();
}
