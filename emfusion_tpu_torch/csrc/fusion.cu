// K1: association-weighted projective TSDF fusion of one depth frame into
// the background volume and every object volume that takes it, in one
// launch.
//
// Replaces the TPU kernel emfusion_tpu/ops/pallas/fusion_pencil_pallas.py
// (_kernel, entry integrate_tsdf_pencil_pallas). On the TPU the depth and
// association images were first warped onto a reference-plane grid so the
// kernel could read them with one-hot matmuls instead of gathers, at the
// cost of a nearest-in-grid-cell lookup. Hopper gathers directly, so this
// is the direct form of the reference's kernel_updateTSDF (TSDF.cu:327-427)
// and of ops/fusion.integrate_tsdf: each voxel projects its centre, reads
// depth and association at the rounded (half to even) pixel, and applies
// the running weighted average with the weight cap, the -1/0 rules for
// unseen voxels and the carve rules (carve_dist, the carve weight cap and
// its contradiction margin). The JAX pipeline fuses the pool's slots with
// jax.vmap; here the slots are items of one launch.
//
// Bound on the card: bytes, but only those a frame can change. A voxel is
// projected before any volume access, and falls in one of four classes:
//   - in front of the camera and outside the image: nothing can change, so
//     it loads and stores nothing;
//   - behind the camera, or in the image on a pixel without depth: only
//     the 0 rule can fire, so it loads its weight, and its tsdf only where
//     the weight is 0;
//   - valid but more than truncdist behind the surface: only the -1 rule,
//     loaded the same way;
//   - valid inside the band: the full update, both loaded.
// A value is stored only where its bits changed, so a warp whose voxels
// all skip touches no volume memory. At the default volume pose about a
// third of a 512^3 volume projects into a 640x480 image; the rest would
// still cost each voxel its projection, so a warp takes a whole row and
// first tests the ends of the row, then of each 32 V-voxel piece of it,
// passing over a piece whose two ends lie beyond the same image edge
// (exact by convexity, with a pixel of margin).
//
// Storage: each item is float32 or bf16 (the background under
// Params.volume_dtype="bfloat16", beside float32 object slots in the same
// launch). A bf16 voxel is loaded as float32, fused in float32 and rounded
// once to nearest even (emf_round); "changed" compares the rounded bits
// with the stored ones, so a voxel whose bf16 value does not move is not
// written. A bf16 lane moves its 4 voxels as 8 bytes.
//
// Slabs: an item may be the planes [z0, z0 + Z) of a volume Zg planes deep
// (the z-sharded background of emfusion_tpu_torch/distributed/, where each
// rank fuses only its slab). Voxel centres are formed from the global
// plane index z0 + z over the whole depth Zg, exactly as for the whole
// volume, so a slab fuses bit for bit as the same planes of one
// whole-volume launch; the row table covers the slab's rows only.
//
// Layout: a 1-D grid; each item's blocks are contiguous and a block finds
// its item among the <= EMF_MAX_ITEMS block offsets of the table, which
// is passed by value (__grid_constant__, read from the parameter bank).
// Blocks of 128 threads (4 rows), capped at 32 registers so that 16
// blocks fill an SM: 128 was faster than 256 threads, and the cap faster
// than none although it spills a few words. A lane takes 4 neighbouring voxels along x with 16-byte accesses
// where X is a multiple of 4 and the volumes are 16-byte aligned, else
// one voxel. Volume accesses are streaming (.cs) so the two images stay
// in L2. Built with --fmad=false so the pixel rounding and the average
// match the plain version's separately rounded products.
#include <cuda_runtime.h>

#include "common.cuh"

#define EMF_FUSE_BLOCK 128

// One volume of the launch. Mirrored by kernels.FuseArgs.
struct EmfFuseItem {
  void* tsdf;          // (Z, Y, X) float or emf_bf16
  void* wts;
  const float* assoc;  // (H, W) association weights of this volume
  int Z, Y, X;         // this item's planes (a z-slab: Z of them)
  int z0, Zg;          // a slab's first global plane, the whole depth
  int vec;             // 1: 4 voxels a lane, 16-byte (bf16: 8-byte) accesses
  int bf16;            // 1: tsdf and wts are bf16
  EmfPose P;           // volume -> camera
  float vs, trunc, max_w, carve_dist;
  int has_cap, has_margin;
  float cap, margin;
};

struct EmfFuseTable {
  const float* depth;
  int H, W, n;
  float fx, fy, cx, cy;
  int block_end[EMF_MAX_ITEMS];  // cumulative block counts
  EmfFuseItem items[EMF_MAX_ITEMS];
};

enum { CLS_SKIP = 0, CLS_ZERO = 1, CLS_NEG = 2, CLS_BAND = 3 };

__device__ __forceinline__ float emf_sign(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

template <int V>
__device__ __forceinline__ void emf_load(const float* p, float* o) {
  if (V == 4) {
    float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
  } else {
    o[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void emf_load(const emf_bf16* p, float* o) {
  if (V == 4) {
    uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
    o[0] = __uint_as_float(q.x << 16);
    o[1] = __uint_as_float(q.x & 0xffff0000u);
    o[2] = __uint_as_float(q.y << 16);
    o[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
    o[0] = __uint_as_float((unsigned)__ldcs(p) << 16);
  }
}

template <int V>
__device__ __forceinline__ void emf_store(float* p, const float* o) {
  if (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
  } else {
    __stcs(p, o[0]);
  }
}

// o holds values already rounded to bf16 (emf_round): their top 16 bits.
template <int V>
__device__ __forceinline__ void emf_store(emf_bf16* p, const float* o) {
  if (V == 4) {
    uint2 q;
    q.x = (__float_as_uint(o[0]) >> 16) | (__float_as_uint(o[1]) & 0xffff0000u);
    q.y = (__float_as_uint(o[2]) >> 16) | (__float_as_uint(o[3]) & 0xffff0000u);
    __stcs(reinterpret_cast<uint2*>(p), q);
  } else {
    __stcs(p, (unsigned short)(__float_as_uint(o[0]) >> 16));
  }
}

__device__ __forceinline__ bool emf_same(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// V voxels x0 .. x0+V-1 of row (y, z) of item `it`, flat index v0; S the
// storage type (float or emf_bf16).
template <int V, typename S>
__device__ __forceinline__ void emf_fuse(const EmfFuseTable& T,
                                         const EmfFuseItem& it, size_t v0,
                                         int x0, int y, int z) {
  S* const tsdf = static_cast<S*>(it.tsdf);
  S* const wts = static_cast<S*>(it.wts);
  const float py = ((float)y - 0.5f * (float)(it.Y - 1)) * it.vs;
  const float pz = ((float)(z + it.z0) - 0.5f * (float)(it.Zg - 1)) * it.vs;
  int cls[V];
  float sdf[V], tmeas[V], aval[V];
  bool any = false;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float px = ((float)(x0 + j) - 0.5f * (float)(it.X - 1)) * it.vs;
    float ccx, ccy, ccz;
    emf_apply(it.P, px, py, pz, ccx, ccy, ccz);
    // the nearest-pixel projective pick that the TPU path ran as a
    // separate warp kernel (K6, warp_pallas.py) onto its reference-plane
    // grid: here each voxel rounds its own projection
    const bool in_front = ccz > 0.0f;
    const float zsafe = in_front ? ccz : 1.0f;
    const int pix_x = __float2int_rn(ccx * T.fx / zsafe + T.cx);
    const int pix_y = __float2int_rn(ccy * T.fy / zsafe + T.cy);
    const bool in_frame =
        (pix_x >= 0) && (pix_x < T.W) && (pix_y >= 0) && (pix_y < T.H);
    cls[j] = in_front ? CLS_SKIP : CLS_ZERO;
    sdf[j] = tmeas[j] = aval[j] = 0.0f;
    if (in_front && in_frame) {
      const int pix = pix_y * T.W + pix_x;
      const float depth_val = __ldg(T.depth + pix);
      if (depth_val > 0.0f) {
        const float ux = ((float)pix_x - T.cx) / T.fx;
        const float uy = ((float)pix_y - T.cy) / T.fy;
        const float lam = sqrtf(ux * ux + uy * uy + 1.0f);
        const float norm_cam = sqrtf(ccx * ccx + ccy * ccy + ccz * ccz);
        const float s = depth_val - norm_cam / lam;
        sdf[j] = s;
        if (s >= -it.trunc) {
          cls[j] = CLS_BAND;
          tmeas[j] = emf_sign(s) * fminf(1.0f, fabsf(s) / it.trunc);
          aval[j] = __ldg(it.assoc + pix);
        } else if (s < -it.trunc) {
          cls[j] = CLS_NEG;
        }
      } else if (depth_val <= 0.0f) {
        cls[j] = CLS_ZERO;
      }
    }
    any |= cls[j] != CLS_SKIP;
  }
  if (!any) return;

  float w_old[V], t_old[V];
  emf_load<V>(wts + v0, w_old);
  bool need_t = false;
#pragma unroll
  for (int j = 0; j < V; ++j)
    need_t |= cls[j] == CLS_BAND ||
              (cls[j] != CLS_SKIP && w_old[j] == 0.0f);
  if (!need_t) return;
  emf_load<V>(tsdf + v0, t_old);

  float t_out[V], w_out[V];
  bool t_changed = false, w_changed = false;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    t_out[j] = t_old[j];
    w_out[j] = w_old[j];
    if (cls[j] == CLS_BAND) {
      const bool carving = sdf[j] >= it.carve_dist;
      const float new_w = carving ? 1.0f : aval[j];
      float w_eff = w_old[j];
      if (it.has_cap) {
        bool capped = carving;
        if (it.has_margin)
          capped = carving && (tmeas[j] - t_old[j] > it.margin);
        if (capped) w_eff = fminf(w_old[j], it.cap);
      }
      const float denom = w_eff + new_w;
      if (denom > 0.0f) {
        t_out[j] = (w_eff * t_old[j] + new_w * tmeas[j]) / denom;
        w_out[j] = fminf(denom, it.max_w);
      }
    } else if (cls[j] != CLS_SKIP && w_old[j] == 0.0f) {
      t_out[j] = cls[j] == CLS_NEG ? -1.0f : 0.0f;
    }
    t_out[j] = emf_round<S>(t_out[j]);
    w_out[j] = emf_round<S>(w_out[j]);
    t_changed |= !emf_same(t_out[j], t_old[j]);
    w_changed |= !emf_same(w_out[j], w_old[j]);
  }
  if (t_changed) emf_store<V>(tsdf + v0, t_out);
  if (w_changed) emf_store<V>(wts + v0, w_out);
}

// Which image edges voxel (x, y, z) of `it` projects more than one pixel
// beyond (bits 1, 2, 4, 8: left, right, top, bottom), with its camera z
// above EMF_NEAR; 0 otherwise. Each bit is a half-space of the volume
// frame, so if both ends of a row segment have a bit, every voxel centre
// between them has it: the real projection lies more than a pixel
// outside, and EMF_NEAR keeps the float rounding of the per-voxel pick
// (a few 1e-6 m on ccx, times fx / ccz) far below that pixel.
#define EMF_NEAR 0.05f
__device__ __forceinline__ int emf_edges(const EmfFuseTable& T,
                                         const EmfFuseItem& it, int x, int y,
                                         int z) {
  const float px = ((float)x - 0.5f * (float)(it.X - 1)) * it.vs;
  const float py = ((float)y - 0.5f * (float)(it.Y - 1)) * it.vs;
  const float pz = ((float)(z + it.z0) - 0.5f * (float)(it.Zg - 1)) * it.vs;
  float ccx, ccy, ccz;
  emf_apply(it.P, px, py, pz, ccx, ccy, ccz);
  if (!(ccz > EMF_NEAR)) return 0;
  const float u = ccx * T.fx, v = ccy * T.fy;
  return (u < (-1.5f - T.cx) * ccz ? 1 : 0) |
         (u > ((float)T.W + 0.5f - T.cx) * ccz ? 2 : 0) |
         (v < (-1.5f - T.cy) * ccz ? 4 : 0) |
         (v > ((float)T.H + 0.5f - T.cy) * ccz ? 8 : 0);
}

// Warp w of the item takes its row w: (y, z) = (w % Y, w / Y), 32 V
// voxels along x at a time, lane l voxels V l .. V l + V - 1 of them. A
// row or a piece of it whose two ends project beyond the same edge
// (emf_edges) cannot change and is passed over without the per-voxel
// projection. Index arithmetic is 32-bit: a 64-bit division costs more
// than a voxel's projection.
template <int V, typename S>
__device__ __forceinline__ void emf_fuse_row(const EmfFuseTable& T,
                                             const EmfFuseItem& it,
                                             unsigned row) {
  const unsigned X = it.X;
  const unsigned z = row / (unsigned)it.Y;
  const unsigned y = row - z * it.Y;
  if (emf_edges(T, it, 0, y, z) & emf_edges(T, it, X - 1, y, z)) return;
  const unsigned lane = threadIdx.x & 31;
  for (unsigned c = 0; c < X; c += 32 * V) {
    const unsigned last = min(c + 32 * V, X) - 1;
    if ((c > 0 || last < X - 1) &&
        (emf_edges(T, it, c, y, z) & emf_edges(T, it, last, y, z)))
      continue;
    const unsigned x0 = c + V * lane;
    if (x0 < X) emf_fuse<V, S>(T, it, (size_t)row * X + x0, x0, y, z);
  }
}

__global__ void __launch_bounds__(EMF_FUSE_BLOCK, 16)
    emf_fusion_kernel(const __grid_constant__ EmfFuseTable T) {
  const int b = blockIdx.x;
  int i = 0;
  while (b >= T.block_end[i]) ++i;
  const EmfFuseItem& it = T.items[i];
  const int first = i ? T.block_end[i - 1] : 0;
  const unsigned row =
      ((unsigned)(b - first) * EMF_FUSE_BLOCK + threadIdx.x) / 32;
  if (row >= (unsigned)(it.Z * it.Y)) return;
  if (it.bf16) {
    if (it.vec)
      emf_fuse_row<4, emf_bf16>(T, it, row);
    else
      emf_fuse_row<1, emf_bf16>(T, it, row);
  } else {
    if (it.vec)
      emf_fuse_row<4, float>(T, it, row);
    else
      emf_fuse_row<1, float>(T, it, row);
  }
}

extern "C" int emf_max_items() { return EMF_MAX_ITEMS; }

// items: n host-side items (1 <= n <= EMF_MAX_ITEMS). Returns a
// cudaError_t.
extern "C" int emf_fusion(const EmfFuseItem* items, int n, const float* depth,
                          int H, int W, float fx, float fy, float cx,
                          float cy, void* stream) {
  if (n < 1 || n > EMF_MAX_ITEMS) return (int)cudaErrorInvalidValue;
  EmfFuseTable T;
  T.depth = depth;
  T.H = H; T.W = W; T.n = n;
  T.fx = fx; T.fy = fy; T.cx = cx; T.cy = cy;
  long long blocks = 0;
  for (int i = 0; i < EMF_MAX_ITEMS; ++i) {
    if (i < n) {
      T.items[i] = items[i];
      const long long vox = (long long)items[i].Z * items[i].Y * items[i].X;
      if (vox < 1 || vox > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      const long long threads = 32LL * items[i].Z * items[i].Y;  // a row a warp
      blocks += (threads + EMF_FUSE_BLOCK - 1) / EMF_FUSE_BLOCK;
    } else {
      T.items[i] = EmfFuseItem{};
    }
    T.block_end[i] = (int)blocks;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  emf_fusion_kernel<<<(unsigned)blocks, EMF_FUSE_BLOCK, 0,
                      (cudaStream_t)stream>>>(T);
  return (int)cudaGetLastError();
}
