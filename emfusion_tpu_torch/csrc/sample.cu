// K2: the E-step's TSDF value ψ at each back-projected pixel point, for the
// background and every object slot of an E-step in one launch, with each
// object's foreground probability at the same points.
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
// An object item also gathers its (2, Z, Y, X) fg/bg counts at the same
// cell and turns each corner into fg / max(fg + bg, 1e-30), or 0 where
// fg + bg is 0 (volume.fg_probs per corner, in its operation order)
// before the same trilinear blend: bit-equal to sampling a probability
// volume, which therefore is never built. The JAX pipeline samples the
// pool's slots with jax.vmap; here they are items of one launch.
//
// A volume is float32 or bf16 (each item its own: the bf16 background
// beside float32 object slots); a bf16 corner is loaded as float32, so the
// blend is the plain version's float32 arithmetic. Counts stay float32.
//
// Bound on the card: launches and latency. The background's 307,200
// points move ~5 MB (a few µs at 3.35 TB/s) and an object's culled 8,192
// points far less, so one launch per E-step instead of one per volume is
// the design; the gathers are dependent loads, so it keeps one point per
// thread with many warps in flight, and coalesces the point reads and the
// writes (component-first points, one packed output buffer). The work
// table is passed by value (__grid_constant__); a block finds its item
// among the <= EMF_MAX_ITEMS block offsets.
#include <cuda_runtime.h>

#include "common.cuh"

#define EMF_SAMPLE_BLOCK 256

// One volume of the launch. Mirrored by kernels.SampleArgs.
struct EmfSampleItem {
  const void* vol;      // (Z, Y, X) TSDF, float or emf_bf16
  const float* counts;  // (2, Z, Y, X) fg/bg counts, or null
  const float* pts;     // (3, n) camera points, rows `stride` floats apart
  float* out;           // (n) ψ
  float* out_fg;        // (n) fg probability, where counts
  int stride, n, Z, Y, X;
  int bf16;             // 1: vol is bf16
  EmfPose P;            // camera -> volume
  float vs, margin;
};

struct EmfSampleTable {
  int n;
  int block_end[EMF_MAX_ITEMS];  // cumulative block counts
  EmfSampleItem items[EMF_MAX_ITEMS];
};

__device__ __forceinline__ float emf_fg_prob(const float* fg, size_t bg_off,
                                             size_t o) {
  const float f = __ldg(fg + o);
  const float total = f + __ldg(fg + bg_off + o);
  return total > 0.0f ? f / fmaxf(total, 1e-30f) : 0.0f;
}

__global__ void __launch_bounds__(EMF_SAMPLE_BLOCK)
    emf_sample_kernel(const __grid_constant__ EmfSampleTable T) {
  const int b = blockIdx.x;
  int k = 0;
  while (b >= T.block_end[k]) ++k;
  const EmfSampleItem& it = T.items[k];
  const int i = (b - (k ? T.block_end[k - 1] : 0)) * EMF_SAMPLE_BLOCK +
                threadIdx.x;
  if (i >= it.n) return;
  const float px = it.pts[i], py = it.pts[(size_t)it.stride + i],
              pz = it.pts[2 * (size_t)it.stride + i];
  float wx, wy, wz;
  emf_apply(it.P, px, py, pz, wx, wy, wz);
  const float vx = wx / it.vs + 0.5f * (float)(it.X - 1);
  const float vy = wy / it.vs + 0.5f * (float)(it.Y - 1);
  const float vz = wz / it.vs + 0.5f * (float)(it.Z - 1);
  const bool valid = (pz > 0.0f) && (vx >= 0.0f) && (vy >= 0.0f) &&
                     (vz >= 0.0f) && (vx + it.margin < (float)it.X) &&
                     (vy + it.margin < (float)it.Y) &&
                     (vz + it.margin < (float)it.Z);
  float psi = 0.0f, fg = 0.0f;
  if (valid) {
    const EmfCell c = emf_cell(it.Z, it.Y, it.X, vx, vy, vz);
    const size_t sy = (size_t)it.X, sz = (size_t)it.Y * it.X;
    psi = it.bf16
              ? emf_lerp_at(c, static_cast<const emf_bf16*>(it.vol) + c.base,
                            sy, sz)
              : emf_lerp_at(c, static_cast<const float*>(it.vol) + c.base,
                            sy, sz);
    if (it.counts) {
      const float* q = it.counts + c.base;
      const size_t bg = sz * it.Z;
      fg = emf_lerp8(c, emf_fg_prob(q, bg, 0), emf_fg_prob(q, bg, 1),
                     emf_fg_prob(q, bg, sy), emf_fg_prob(q, bg, sy + 1),
                     emf_fg_prob(q, bg, sz), emf_fg_prob(q, bg, sz + 1),
                     emf_fg_prob(q, bg, sz + sy),
                     emf_fg_prob(q, bg, sz + sy + 1));
    }
  }
  it.out[i] = psi;
  if (it.counts) it.out_fg[i] = fg;
}

extern "C" int emf_max_items() { return EMF_MAX_ITEMS; }

// items: n host-side items (1 <= n <= EMF_MAX_ITEMS). Their blocks
// go in reverse order, so the objects' short items, whose points gather
// twice, start in the first wave beside the background's. Launches
// nothing when no item has a point. Returns a cudaError_t.
extern "C" int emf_sample(const EmfSampleItem* items, int n, void* stream) {
  if (n < 1 || n > EMF_MAX_ITEMS) return (int)cudaErrorInvalidValue;
  EmfSampleTable T;
  T.n = n;
  long long blocks = 0;
  for (int k = 0; k < EMF_MAX_ITEMS; ++k) {
    if (k < n) {
      const EmfSampleItem& it = items[n - 1 - k];
      if (it.n < 0) return (int)cudaErrorInvalidValue;
      T.items[k] = it;
      blocks += (it.n + EMF_SAMPLE_BLOCK - 1) / EMF_SAMPLE_BLOCK;
    } else {
      T.items[k] = EmfSampleItem{};
    }
    T.block_end[k] = (int)blocks;
  }
  if (blocks == 0) return 0;
  emf_sample_kernel<<<(unsigned)blocks, EMF_SAMPLE_BLOCK, 0,
                      (cudaStream_t)stream>>>(T);
  return (int)cudaGetLastError();
}
