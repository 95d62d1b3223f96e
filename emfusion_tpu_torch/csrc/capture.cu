// K3: the LMs' capture of each point's 6x6x6 voxel window, for the camera
// (one item) or for every object slot of a batched LM stage in one launch.
//
// Replaces the two TPU kernels of emfusion_tpu/ops/pallas/band_pallas.py
// (_band_kernel, which resampled per-column z-bands of the volume, and
// _extract_kernel, which cut each point's window out of the bands; entry
// band_capture_pallas). They existed because the TPU has no fast gather,
// and the band's in-plane resample made the cached values deviate from
// exact voxel reads. Hopper gathers directly, so this is the exact form,
// geometry/capture.capture_neighborhoods: anchor = floor(v) - 2 per axis
// (unclipped, from the same grid transform as the samplers), and the
// window's voxel reads clipped to the volume, for tsdf and weights. The
// batched object LM (geometry/capture.capture_neighborhoods_batched, the
// JAX package's lane-window take over the stacked pool) is the same
// function per slot: each slot is an item of the launch's work table.
//
// A bf16 item (the background under Params.volume_dtype="bfloat16") reads
// bf16 volumes and writes its cache in bf16, the voxels' own bits, as the
// JAX package keeps a bf16 volume's LM cache (tracking.py:157-165); a
// float32 item is float32 throughout. That halves a bf16 cache's bytes.
//
// Bound on the card: bytes. At 640x480, stride 1, the cache it writes is
// 307,200 x 2 x 216 x 4 B = 531 MB, ~0.16 ms at 3.35 TB/s; the voxel
// reads mostly hit L2, since neighbouring points share voxels. The cache
// is (C, 6, 6, 6, N) with points minor, so the design puts the point on
// the thread index (every store is coalesced) and one (dz, dy) window row
// on blockIdx.y, so 36 blocks per point range are in flight and each
// thread's six x reads sit in one or two cache lines. A batched stage of
// S slots x 4096 points writes only S x 7 MB, so one launch for all slots
// (not one per slot) is the design there; the table is passed by value
// (__grid_constant__) and a block finds its item among the block offsets.
// Each (dz, dy) block recomputes its points' transform and anchor (some 30
// operations against 12 voxel reads and 12 stores). Layouts that compute
// an anchor once (a thread looping over one dz's 6 rows, or over all 36)
// keep 6 or 36 times fewer threads in flight and measured as fast to
// 240% slower on an H100, and a bf16 item's two points a thread with
// 32-bit stores
// gained nothing measurable (scripts/k3_variants.py, which carries those
// layouts). What keeps a bf16 cache's and a 2 x 4096 stage's rows under
// half their bound is suspected, not counted: a row's voxel reads in
// flight, each an L2 round trip.
#include <cuda_runtime.h>

#include "common.cuh"

#define EMF_WIN 6
#define EMF_ANCHOR_OFF 2
#define EMF_CAPTURE_BLOCK 256

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

// One window row: six x reads of tsdf and weights, copied to the cache as
// they are stored (float or bf16 bits).
template <typename T>
__device__ __forceinline__ void emf_capture_row(const T* __restrict__ tsdf,
                                                const T* __restrict__ wts,
                                                T* __restrict__ out,
                                                size_t rowbase, int ax, int X,
                                                int N) {
  const size_t ch = (size_t)EMF_WIN * EMF_WIN * EMF_WIN * N;
#pragma unroll
  for (int dx = 0; dx < EMF_WIN; ++dx) {
    const size_t idx = rowbase + emf_clampi(ax + dx, 0, X - 1);
    out[(size_t)dx * N] = __ldg(tsdf + idx);
    out[ch + (size_t)dx * N] = __ldg(wts + idx);
  }
}

__global__ void __launch_bounds__(EMF_CAPTURE_BLOCK)
    emf_capture_kernel(const __grid_constant__ EmfCaptureTable T) {
  const int b = blockIdx.x;
  int k = 0;
  while (b >= T.block_end[k]) ++k;
  const EmfCaptureItem& it = T.items[k];
  const int i = (b - (k ? T.block_end[k - 1] : 0)) * EMF_CAPTURE_BLOCK +
                threadIdx.x;
  const int N = it.n;
  if (i >= N) return;
  const int Z = it.Z, Y = it.Y, X = it.X;
  const int row = blockIdx.y;  // dz * WIN + dy
  const int dz = row / EMF_WIN, dy = row % EMF_WIN;
  const float px = it.pts[i], py = it.pts[(size_t)N + i],
              pz = it.pts[2 * (size_t)N + i];
  float wx, wy, wz;
  emf_apply(it.P, px, py, pz, wx, wy, wz);
  const float vx = wx / it.vs + 0.5f * (float)(X - 1);
  const float vy = wy / it.vs + 0.5f * (float)(Y - 1);
  const float vz = wz / it.vs + 0.5f * (float)(Z - 1);
  const int ax = (int)floorf(vx) - EMF_ANCHOR_OFF;
  const int ay = (int)floorf(vy) - EMF_ANCHOR_OFF;
  const int az = (int)floorf(vz) - EMF_ANCHOR_OFF;
  if (row == 0) {
    it.anchor[i] = ax;
    it.anchor[(size_t)N + i] = ay;
    it.anchor[2 * (size_t)N + i] = az;
  }
  const int zc = emf_clampi(az + dz, 0, Z - 1);
  const int yc = emf_clampi(ay + dy, 0, Y - 1);
  const size_t rowbase = ((size_t)zc * Y + yc) * X;
  const size_t off = (size_t)row * EMF_WIN * N + i;
  if (it.bf16)
    emf_capture_row(static_cast<const emf_bf16*>(it.tsdf),
                    static_cast<const emf_bf16*>(it.wts),
                    static_cast<emf_bf16*>(it.cache) + off, rowbase, ax, X,
                    N);
  else
    emf_capture_row(static_cast<const float*>(it.tsdf),
                    static_cast<const float*>(it.wts),
                    static_cast<float*>(it.cache) + off, rowbase, ax, X, N);
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
      blocks += (it.n + EMF_CAPTURE_BLOCK - 1) / EMF_CAPTURE_BLOCK;
    } else {
      T.items[k] = EmfCaptureItem{};
    }
    T.block_end[k] = (int)blocks;
  }
  if (blocks == 0) return 0;
  dim3 grid((unsigned)blocks, EMF_WIN * EMF_WIN);
  emf_capture_kernel<<<grid, EMF_CAPTURE_BLOCK, 0, (cudaStream_t)stream>>>(
      T);
  return (int)cudaGetLastError();
}
