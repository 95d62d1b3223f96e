// The device-resident Levenberg-Marquardt loop of the gather sampler: the
// camera LM (one item) or every serial object LM (one item a slot) of a
// frame, iterated on the card with no host round trip inside the loop.
//
// Replaces the port's per-iteration host loop of the gather sampler
// (tracking._track_volume_host, kept as the comparison) on the card. Its
// counterpart in the JAX package is the XLA while_loop body of
// emfusion_tpu/tracking.py:242-322 (track_volume with sampler "gather"),
// not a Pallas kernel: the JAX package runs the whole loop (residual
// sampling, Jacobian, weights, the 6x6 normal equations, the accept /
// reject damping and the SE(3) update) inside one lax.while_loop with
// on-device convergence flags, and its object LMs as one lax.scan over the
// slots (pipeline.py:540-545). The
// reference (TSDF.cpp:274-282) and the port's host loop instead read the
// system back every iteration. Here an iteration is four launches, each
// over a work table of LMs, reading and writing a state record per item
// (tracking.LMRun; words SI_* and SF_* below):
//
//   emf_lm_system phase 0 (gather): per point the 27-corner gather of
//     geometry/sampling.sample_system_at_points (margin-1 psi and the
//     finite-difference gradient, every validity rule and clip), the
//     margin-1 integration weight, clamped to max_tsdf_weight, and the
//     Huber weight (x/0 = 0); stores them per point and reduces
//     max(0, max intw) into wmax.
//   emf_lm_system phase 1 (terms): per point w = huber * (intw / wmax) *
//     assoc, J = [g3, p x g3], and the 21 unique terms of J w J^T, the 6 of
//     J w psi and w psi^2, each formed in float32 and summed in float64.
//   emf_lm_step phase 0 (propose): A, b, err rounded to float32, the
//     gradient test, mu0, the 6x6 solve (Gaussian elimination with partial
//     pivoting), the step test against se3_log of the pose, se3_exp(-x)
//     and the trial pose.
//   emf_lm_trial: sum w psi(trial pose)^2 in float64 with the last
//     evaluation's w.
//   emf_lm_step phase 1 (decide): rho, accept or reject, the mu / nu
//     update, eval_grad and it += 1.
//
// An item whose LM has stopped (converged, or it >= max_iter), or that
// has nothing to do in a phase, returns at once, so the host may enqueue
// several iterations and read the state only between chunks of them.
//
// Sums: every block reduces its points' terms in a fixed order (warp
// shuffles, then the warps in order) into a float64 partial; the last
// block of an item to finish (an integer ticket, no float atomics) adds
// the item's partials in block order. A float64 sum of float32 terms
// rounds to the float32 of the exact sum in all but vanishingly rare ties,
// so the plain versions (tracking.lm_system_plain, lm_trial_plain), which
// sum in another order, agree to the last float32 bit, and the endpoint no
// longer moves with the order of the sum. The per-point values and the
// scalar steps are the plain versions' float32 arithmetic, operation for
// operation (built with --fmad=false), so they are bit-equal; sinf, cosf,
// acosf and sqrtf are CUDA's, which PyTorch's CUDA operators also call.
//
// Bound on the card: the gather's bytes (phase 0 reads 27 + 8 voxels and
// a point a point, mostly from L2, and writes 6 floats; phase 1 and the
// trial stream what phase 0 wrote); emf_lm_step's bound is its launch
// latency. Design: a thread takes EMF_LM_PPT points, a block's threads
// neighbouring points (coalesced), so a background item of 307,200 points
// takes 300 blocks and its ordered final pass 300 partials; a point that no
// validity rule admits skips its gather (its outputs are exactly 0, as in
// the plain version), which is most of an object's points.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

#define EMF_LM_BLOCK 256
#define EMF_LM_PPT 4
#define EMF_LM_SPAN (EMF_LM_BLOCK * EMF_LM_PPT)   // points a block
#define EMF_LM_WARPS (EMF_LM_BLOCK / 32)
#define EMF_LM_NSUM 28                             // A 21, b 6, err 1

// The state record of an item, mirrored by tracking.LM_SI / LM_SF.
enum { SI_IT = 0, SI_CONV = 1, SI_EVAL = 2, SI_FIRST = 3, SI_TRIAL = 4,
       SI_RAN = 5, SI_N = 8 };
enum { SF_R = 0, SF_T = 9, SF_RN = 12, SF_TN = 21, SF_X = 24, SF_MU = 30,
       SF_NU = 31, SF_MU0 = 32, SF_ERR = 33, SF_ERRN = 34, SF_A = 35,
       SF_B = 71, SF_N = 80 };

// One LM of a launch. Mirrored by kernels.LmItemArgs.
struct EmfLmItem {
  const void* tsdf;    // (Z, Y, X), float or emf_bf16
  const void* wts;     // (Z, Y, X), the same type
  const float* pts;    // (3, n) camera points, rows `stride` floats apart
  const float* assoc;  // (n) association weights
  int stride, n, Z, Y, X;
  int bf16;            // 1: tsdf and weights are bf16
  float vs;
  int p0;              // the item's first point in the packed buffers
};

// The state and the packed per-point buffers. Mirrored by
// kernels.LmBufsArgs.
struct EmfLmBufs {
  int* si;          // (S, SI_N)
  float* sf;        // (S, SF_N)
  double* sys;      // (S, EMF_LM_NSUM) the last evaluation's sums
  double* trial;    // (S) the trial error
  float* wmax;      // (S)
  float* w;         // (total) track weights of the last evaluation
  float* hub;       // (total) Huber weights of the last evaluation
  float* scratch;   // (5, total) psi, g3 x, y, z, clamped intw
  double* part;     // (blocks, EMF_LM_NSUM) block partials
  int* count;       // (S) tickets, 0 between launches
  int total;
};

// Mirrored by kernels.LmCfgArgs.
struct EmfLmCfg {
  float tau, eps1, eps2, nu_init, huber, max_w;
  int max_iter;
};

struct EmfLmTable {
  int n;
  int block_end[EMF_MAX_ITEMS];  // cumulative block counts
  EmfLmItem items[EMF_MAX_ITEMS];
};

__device__ __forceinline__ int emf_lm_item(const EmfLmTable& T, int b,
                                           int& b0) {
  int k = 0;
  while (b >= T.block_end[k]) ++k;
  b0 = k ? T.block_end[k - 1] : 0;
  return k;
}

__device__ __forceinline__ bool emf_lm_runs(const int* s, int max_iter) {
  return s[SI_IT] < max_iter && !s[SI_CONV];
}

__device__ __forceinline__ EmfPose emf_lm_pose(const float* f) {
  EmfPose P;
  P.r00 = f[0]; P.r01 = f[1]; P.r02 = f[2];
  P.r10 = f[3]; P.r11 = f[4]; P.r12 = f[5];
  P.r20 = f[6]; P.r21 = f[7]; P.r22 = f[8];
  P.t0 = f[9]; P.t1 = f[10]; P.t2 = f[11];
  return P;
}

__device__ __forceinline__ double emf_warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float emf_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// True in every thread of the item's last block to finish; the block's
// partials, written before the call, are then visible to that block.
__device__ __forceinline__ bool emf_lm_last(int* count, int nb) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count, 1) == nb - 1;
  __syncthreads();
  return last != 0;
}

// The trilerp of sample_system_at_points over the 3x3x3 corners c[dz][dy][dx]
// from corner (oz, oy, ox): x, then y, then z.
__device__ __forceinline__ float emf_tri(const float (&c)[3][3][3], int oz,
                                         int oy, int ox, float fx, float fy,
                                         float fz) {
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const float l00 = c[oz][oy][ox] * gx + c[oz][oy][ox + 1] * fx;
  const float l01 = c[oz][oy + 1][ox] * gx + c[oz][oy + 1][ox + 1] * fx;
  const float l10 = c[oz + 1][oy][ox] * gx + c[oz + 1][oy][ox + 1] * fx;
  const float l11 =
      c[oz + 1][oy + 1][ox] * gx + c[oz + 1][oy + 1][ox + 1] * fx;
  const float y0 = l00 * gy + l01 * fy;
  const float y1 = l10 * gy + l11 * fy;
  return y0 * gz + y1 * fz;
}

struct EmfLmPoint {
  float psi, gx, gy, gz, intw, hub;
};

// Point i's psi, gradient, clamped integration weight and Huber weight
// (tracking.lm_system_plain's first pass).
template <typename T>
__device__ __forceinline__ EmfLmPoint emf_lm_point(const EmfLmItem& it,
                                                   const EmfPose& P, int i,
                                                   const EmfLmCfg& C) {
  const T* vol = static_cast<const T*>(it.tsdf);
  const T* wts = static_cast<const T*>(it.wts);
  const size_t s = (size_t)it.stride;
  const float px = it.pts[i], py = it.pts[s + i], pz = it.pts[2 * s + i];
  float wx, wy, wz;
  emf_apply(P, px, py, pz, wx, wy, wz);
  const int X = it.X, Y = it.Y, Z = it.Z;
  const float fX = (float)X, fY = (float)Y, fZ = (float)Z;
  const float vx = wx / it.vs + 0.5f * (float)(X - 1);
  const float vy = wy / it.vs + 0.5f * (float)(Y - 1);
  const float vz = wz / it.vs + 0.5f * (float)(Z - 1);
  const bool front = pz > 0.0f;
  const bool inside = front && vx >= 0.0f && vy >= 0.0f && vz >= 0.0f;
  const bool valid1 =
      inside && vx + 1.0f < fX && vy + 1.0f < fY && vz + 1.0f < fZ;
  const bool valid2 =
      inside && vx + 2.0f < fX && vy + 2.0f < fY && vz + 2.0f < fZ;
  // each shifted trilerp's validity on its shifted coordinates
  const bool vsx = front && vx + 1.0f >= 0.0f && vy >= 0.0f && vz >= 0.0f &&
                   (vx + 1.0f) + 2.0f < fX && vy + 2.0f < fY &&
                   vz + 2.0f < fZ;
  const bool vsy = front && vx >= 0.0f && vy + 1.0f >= 0.0f && vz >= 0.0f &&
                   vx + 2.0f < fX && (vy + 1.0f) + 2.0f < fY &&
                   vz + 2.0f < fZ;
  const bool vsz = front && vx >= 0.0f && vy >= 0.0f && vz + 1.0f >= 0.0f &&
                   vx + 2.0f < fX && vy + 2.0f < fY &&
                   (vz + 1.0f) + 2.0f < fZ;
  EmfLmPoint r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (!(valid1 || vsx || vsy || vsz)) return r;  // every output is 0
  // every rule above bounds v to [-1, res), so the floors fit an int
  const int x0 = (int)floorf(vx), y0 = (int)floorf(vy), z0 = (int)floorf(vz);
  const float fx = vx - (float)x0, fy = vy - (float)y0, fz = vz - (float)z0;
  int xi[3], yi[3], zi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    xi[d] = emf_clampi(x0 + d, 0, X - 1);
    yi[d] = emf_clampi(y0 + d, 0, Y - 1);
    zi[d] = emf_clampi(z0 + d, 0, Z - 1);
  }
  float c[3][3][3];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const T* row = vol + ((size_t)zi[dz] * Y + yi[dy]) * X;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) c[dz][dy][dx] = emf_ld(row + xi[dx]);
    }
  const float base_val = emf_tri(c, 0, 0, 0, fx, fy, fz);
  r.psi = valid1 ? base_val : 0.0f;
  const float base = valid2 ? base_val : 0.0f;
  const float sx = vsx ? emf_tri(c, 0, 0, 1, fx, fy, fz) : 0.0f;
  const float sy = vsy ? emf_tri(c, 0, 1, 0, fx, fy, fz) : 0.0f;
  const float sz = vsz ? emf_tri(c, 1, 0, 0, fx, fy, fz) : 0.0f;
  r.gx = (sx - base) / it.vs;
  r.gy = (sy - base) / it.vs;
  r.gz = (sz - base) / it.vs;
  if (valid1) {
    // valid1 puts the floors in [0, res - 2]: the clipped cell is the cell
    EmfCell cell;
    cell.base = 0;
    cell.fx = fx;
    cell.fy = fy;
    cell.fz = fz;
    const size_t sy_ = (size_t)X, sz_ = (size_t)Y * X;
    r.intw = fminf(emf_lerp_at(cell, wts + ((size_t)z0 * Y + y0) * X + x0,
                               sy_, sz_),
                   C.max_w);
  }
  const float a = fabsf(r.psi);
  r.hub = a > 0.0f ? fminf(C.huber / fmaxf(a, 1e-30f), 1.0f) : 0.0f;
  return r;
}

// psi at margin 1 (kernel K2's sample) at point i.
template <typename T>
__device__ __forceinline__ float emf_lm_psi(const EmfLmItem& it,
                                            const EmfPose& P, int i) {
  const size_t s = (size_t)it.stride;
  const float px = it.pts[i], py = it.pts[s + i], pz = it.pts[2 * s + i];
  float wx, wy, wz;
  emf_apply(P, px, py, pz, wx, wy, wz);
  const float vx = wx / it.vs + 0.5f * (float)(it.X - 1);
  const float vy = wy / it.vs + 0.5f * (float)(it.Y - 1);
  const float vz = wz / it.vs + 0.5f * (float)(it.Z - 1);
  const bool valid = pz > 0.0f && vx >= 0.0f && vy >= 0.0f && vz >= 0.0f &&
                     vx + 1.0f < (float)it.X && vy + 1.0f < (float)it.Y &&
                     vz + 1.0f < (float)it.Z;
  if (!valid) return 0.0f;
  const EmfCell c = emf_cell(it.Z, it.Y, it.X, vx, vy, vz);
  return emf_lerp_at(c, static_cast<const T*>(it.tsdf) + c.base,
                     (size_t)it.X, (size_t)it.Y * it.X);
}

// ---------------------------------------------------------------------
// emf_lm_system phase 0: the per-point values and wmax.
__global__ void __launch_bounds__(EMF_LM_BLOCK)
    emf_lm_gather_kernel(const __grid_constant__ EmfLmTable T,
                         const EmfLmBufs B, const EmfLmCfg C) {
  int b0;
  const int k = emf_lm_item(T, blockIdx.x, b0);
  const int* s = B.si + k * SI_N;
  if (!(emf_lm_runs(s, C.max_iter) && s[SI_EVAL])) return;
  const EmfLmItem& it = T.items[k];
  const EmfPose P = emf_lm_pose(B.sf + k * SF_N + SF_R);
  const int bl = blockIdx.x - b0, nb = T.block_end[k] - b0;
  const size_t tot = (size_t)B.total;
  float m = 0.0f;
  for (int j = 0; j < EMF_LM_PPT; ++j) {
    const int i = bl * EMF_LM_SPAN + j * EMF_LM_BLOCK + threadIdx.x;
    if (i >= it.n) break;
    const EmfLmPoint r = it.bf16 ? emf_lm_point<emf_bf16>(it, P, i, C)
                                 : emf_lm_point<float>(it, P, i, C);
    const size_t o = (size_t)it.p0 + i;
    B.hub[o] = r.hub;
    B.scratch[o] = r.psi;
    B.scratch[tot + o] = r.gx;
    B.scratch[2 * tot + o] = r.gy;
    B.scratch[3 * tot + o] = r.gz;
    B.scratch[4 * tot + o] = r.intw;
    m = fmaxf(m, r.intw);
  }
  __shared__ float sm[EMF_LM_WARPS];
  m = emf_warp_max(m);
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.0f;
    for (int q = 0; q < EMF_LM_WARPS; ++q) v = fmaxf(v, sm[q]);
    B.part[(size_t)blockIdx.x * EMF_LM_NSUM] = (double)v;
  }
  if (emf_lm_last(B.count + k, nb) && threadIdx.x == 0) {
    float v = 0.0f;
    for (int q = 0; q < nb; ++q)
      v = fmaxf(v, (float)__ldcg(B.part + (size_t)(b0 + q) * EMF_LM_NSUM));
    B.wmax[k] = v;
    B.count[k] = 0;
  }
}

// emf_lm_system phase 1: w, J and the float64 sums of the system.
__global__ void __launch_bounds__(EMF_LM_BLOCK)
    emf_lm_terms_kernel(const __grid_constant__ EmfLmTable T,
                        const EmfLmBufs B, const EmfLmCfg C) {
  int b0;
  const int k = emf_lm_item(T, blockIdx.x, b0);
  const int* s = B.si + k * SI_N;
  if (!(emf_lm_runs(s, C.max_iter) && s[SI_EVAL])) return;
  const EmfLmItem& it = T.items[k];
  const EmfPose P = emf_lm_pose(B.sf + k * SF_N + SF_R);
  const int bl = blockIdx.x - b0, nb = T.block_end[k] - b0;
  const size_t tot = (size_t)B.total, st = (size_t)it.stride;
  const float wm = B.wmax[k];
  double acc[EMF_LM_NSUM];
#pragma unroll
  for (int q = 0; q < EMF_LM_NSUM; ++q) acc[q] = 0.0;
  for (int j = 0; j < EMF_LM_PPT; ++j) {
    const int i = bl * EMF_LM_SPAN + j * EMF_LM_BLOCK + threadIdx.x;
    if (i >= it.n) break;
    const size_t o = (size_t)it.p0 + i;
    const float psi = B.scratch[o];
    const float iw = wm > 0.0f ? B.scratch[4 * tot + o] / wm : 0.0f;
    const float w = B.hub[o] * iw * it.assoc[i];
    B.w[o] = w;
    float wx, wy, wz;
    emf_apply(P, it.pts[i], it.pts[st + i], it.pts[2 * st + i], wx, wy, wz);
    const float gx = B.scratch[tot + o], gy = B.scratch[2 * tot + o],
                gz = B.scratch[3 * tot + o];
    const float J[6] = {gx, gy, gz, wy * gz - wz * gy, wz * gx - wx * gz,
                        wx * gy - wy * gx};
    float jw[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) jw[a] = J[a] * w;
    int q = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int c = a; c < 6; ++c) acc[q++] += (double)(jw[a] * J[c]);
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += (double)(jw[a] * psi);
    acc[27] += (double)(w * psi * psi);
  }
  __shared__ double sh[EMF_LM_WARPS][EMF_LM_NSUM];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < EMF_LM_NSUM; ++q) {
    const double v = emf_warp_sum(acc[q]);
    if (lane == 0) sh[warp][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < EMF_LM_NSUM) {
    double v = 0.0;
    for (int q = 0; q < EMF_LM_WARPS; ++q) v += sh[q][threadIdx.x];
    B.part[(size_t)blockIdx.x * EMF_LM_NSUM + threadIdx.x] = v;
  }
  if (emf_lm_last(B.count + k, nb)) {
    if (threadIdx.x < EMF_LM_NSUM) {
      double v = 0.0;
      for (int q = 0; q < nb; ++q)
        v += __ldcg(B.part + (size_t)(b0 + q) * EMF_LM_NSUM + threadIdx.x);
      B.sys[k * EMF_LM_NSUM + threadIdx.x] = v;
    }
    if (threadIdx.x == 0) B.count[k] = 0;
  }
}

// emf_lm_trial: sum w psi^2 at the trial pose.
__global__ void __launch_bounds__(EMF_LM_BLOCK)
    emf_lm_trial_kernel(const __grid_constant__ EmfLmTable T,
                        const EmfLmBufs B, const EmfLmCfg C) {
  int b0;
  const int k = emf_lm_item(T, blockIdx.x, b0);
  if (!B.si[k * SI_N + SI_TRIAL]) return;
  const EmfLmItem& it = T.items[k];
  const EmfPose P = emf_lm_pose(B.sf + k * SF_N + SF_RN);
  const int bl = blockIdx.x - b0, nb = T.block_end[k] - b0;
  double acc = 0.0;
  for (int j = 0; j < EMF_LM_PPT; ++j) {
    const int i = bl * EMF_LM_SPAN + j * EMF_LM_BLOCK + threadIdx.x;
    if (i >= it.n) break;
    const float w = B.w[(size_t)it.p0 + i];
    if (w == 0.0f) continue;  // its term is exactly 0 (psi is finite)
    const float psi = it.bf16 ? emf_lm_psi<emf_bf16>(it, P, i)
                              : emf_lm_psi<float>(it, P, i);
    acc += (double)(w * psi * psi);
  }
  __shared__ double sh[EMF_LM_WARPS];
  acc = emf_warp_sum(acc);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double v = 0.0;
    for (int q = 0; q < EMF_LM_WARPS; ++q) v += sh[q];
    B.part[(size_t)blockIdx.x * EMF_LM_NSUM] = v;
  }
  if (emf_lm_last(B.count + k, nb) && threadIdx.x == 0) {
    double v = 0.0;
    for (int q = 0; q < nb; ++q)
      v += __ldcg(B.part + (size_t)(b0 + q) * EMF_LM_NSUM);
    B.trial[k] = v;
    B.count[k] = 0;
  }
}

// ---------------------------------------------------------------------
// SE(3) as geometry/se3.py computes it (and tracking._se3_exp_plain /
// _se3_log_plain spell it out), including its float32 cancellation, so
// the step test is the JAX package's. 3x3 matrices row-major; a product's
// entries sum their three terms left to right.
#define EMF_EPS 1e-8f
#define EMF_EPS2 1e-16f

__device__ __forceinline__ void emf_mm3(const float* a, const float* b,
                                        float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] +
                     a[3 * i + 2] * b[6 + j];
}

__device__ __forceinline__ void emf_skew(const float* w, float* K,
                                         float* K2) {
  K[0] = 0.0f;  K[1] = -w[2]; K[2] = w[1];
  K[3] = w[2];  K[4] = 0.0f;  K[5] = -w[0];
  K[6] = -w[1]; K[7] = w[0];  K[8] = 0.0f;
  emf_mm3(K, K, K2);
}

// (I + a K) + b K2, entry by entry
__device__ __forceinline__ void emf_poly(float a, const float* K, float b,
                                         const float* K2, float* o) {
#pragma unroll
  for (int q = 0; q < 9; ++q)
    o[q] = ((q % 4 == 0) ? 1.0f : 0.0f) + a * K[q] + b * K2[q];
}

__device__ __forceinline__ float emf_sum3sq(const float* w) {
  return w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
}

__device__ void emf_se3_exp(const float* xi, float* R, float* t) {
  const float* ups = xi;
  const float* om = xi + 3;
  const float th2 = emf_sum3sq(om);
  const float th = sqrtf(th2 + EMF_EPS2);
  float K[9], K2[9];
  emf_skew(om, K, K2);
  const bool small = th2 > EMF_EPS;
  const float a = small ? sinf(th) / th : 1.0f - th2 / 6.0f;
  const float b = small ? (1.0f - cosf(th)) / th2 : 0.5f - th2 / 24.0f;
  const float c = small ? (th - sinf(th)) / (th2 * th)
                        : (float)(1.0 / 6.0) - th2 / 120.0f;
  emf_poly(a, K, b, K2, R);
  float V[9];
  emf_poly(b, K, c, K2, V);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = V[3 * i] * ups[0] + V[3 * i + 1] * ups[1] + V[3 * i + 2] * ups[2];
}

__device__ void emf_so3_log(const float* R, float* w) {
  const float trace = R[0] + R[4] + R[8];
  const float ct = fminf(fmaxf((trace - 1.0f) * 0.5f, -1.0f), 1.0f);
  const float th = acosf(ct);
  const float v[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const float st = sinf(th);
  const bool small = fabsf(st) < 1e-6f;
  const float scale = small ? 0.5f + th * th / 12.0f
                            : th / (2.0f * (small ? 1.0f : st));
  const bool near_pi = th > 3.0f;
  const float diag[3] = {R[0], R[4], R[8]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float axis =
        sqrtf(fminf(fmaxf((diag[i] + 1.0f) * 0.5f, 0.0f), 1.0f));
    const float u = fabsf(v[i]) > 1e-12f ? v[i] : 1.0f;
    const float sg = u > 0.0f ? 1.0f : (u < 0.0f ? -1.0f : 0.0f);
    w[i] = near_pi ? axis * sg * th : v[i] * scale;
  }
}

__device__ void emf_se3_log(const float* R, const float* t, float* xi) {
  float* om = xi + 3;
  emf_so3_log(R, om);
  const float th2 = emf_sum3sq(om);
  const float th = sqrtf(th2 + EMF_EPS2);
  float K[9], K2[9];
  emf_skew(om, K, K2);
  const float ct = cosf(th), st = sinf(th);
  const float denom = 2.0f * (1.0f - ct);
  const float coef =
      th2 > 1e-8f
          ? (1.0f - th * st / (fabsf(denom) > 1e-12f ? denom : 1.0f)) / th2
          : (float)(1.0 / 12.0) + th2 / 720.0f;
  float Vi[9];
  emf_poly(-0.5f, K, coef, K2, Vi);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    xi[i] = Vi[3 * i] * t[0] + Vi[3 * i + 1] * t[1] + Vi[3 * i + 2] * t[2];
}

__device__ __forceinline__ float emf_norm6(const float* x) {
  float s = x[0] * x[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) s = s + x[i] * x[i];
  return sqrtf(s);
}

// (A + mu0 I) x = b by Gaussian elimination with partial pivoting (the
// first largest pivot), then back substitution.
__device__ void emf_solve6(const float* A, float mu0, const float* b,
                           float* x) {
  float M[6][7];
  for (int r = 0; r < 6; ++r) {
    for (int c = 0; c < 6; ++c) M[r][c] = A[6 * r + c];
    M[r][r] = A[6 * r + r] + mu0;
    M[r][6] = b[r];
  }
  for (int c = 0; c < 6; ++c) {
    int p = c;
    float best = fabsf(M[c][c]);
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(M[r][c]) > best) {
        best = fabsf(M[r][c]);
        p = r;
      }
    if (p != c)
      for (int j = 0; j < 7; ++j) {
        const float tmp = M[c][j];
        M[c][j] = M[p][j];
        M[p][j] = tmp;
      }
    for (int r = c + 1; r < 6; ++r) {
      const float f = M[r][c] / M[c][c];
      for (int j = c + 1; j < 7; ++j) M[r][j] = M[r][j] - f * M[c][j];
    }
  }
  for (int r = 5; r >= 0; --r) {
    float s = M[r][6];
    for (int j = r + 1; j < 6; ++j) s = s - M[r][j] * x[j];
    x[r] = s / M[r][r];
  }
}

// emf_lm_step: one block an item, its first thread working.
__global__ void emf_lm_step_kernel(const EmfLmBufs B, const EmfLmCfg C,
                                   int phase) {
  if (threadIdx.x != 0) return;
  const int k = blockIdx.x;
  int* s = B.si + k * SI_N;
  float* f = B.sf + k * SF_N;
  if (phase == 0) {
    s[SI_TRIAL] = 0;
    s[SI_RAN] = emf_lm_runs(s, C.max_iter);
    if (!s[SI_RAN]) return;
    if (s[SI_EVAL]) {
      const double* q = B.sys + k * EMF_LM_NSUM;
      int m = 0;
      for (int a = 0; a < 6; ++a)
        for (int c = a; c < 6; ++c) {
          const float v = (float)q[m++];
          f[SF_A + 6 * a + c] = v;
          f[SF_A + 6 * c + a] = v;
        }
      float g = 0.0f;
      for (int a = 0; a < 6; ++a) {
        f[SF_B + a] = (float)q[21 + a];
        g = fmaxf(g, fabsf(f[SF_B + a]));
      }
      f[SF_ERR] = (float)q[27];
      if (g < C.eps1) s[SI_CONV] = 1;
    }
    if (s[SI_CONV]) return;
    float mu0 = f[SF_MU];
    if (s[SI_FIRST]) {
      float d = f[SF_A];
      for (int a = 1; a < 6; ++a) d = fmaxf(d, f[SF_A + 7 * a]);
      mu0 = C.tau * d;
    }
    float x[6];
    emf_solve6(f + SF_A, mu0, f + SF_B, x);
    float rel[6];
    emf_se3_log(f + SF_R, f + SF_T, rel);
    s[SI_FIRST] = 0;
    if (emf_norm6(x) < C.eps2 * (emf_norm6(rel) + C.eps2)) {
      f[SF_MU] = mu0;
      s[SI_CONV] = 1;
      return;
    }
    float nx[6], dR[9], dt[3];
    for (int a = 0; a < 6; ++a) {
      nx[a] = -x[a];
      f[SF_X + a] = x[a];
    }
    emf_se3_exp(nx, dR, dt);
    emf_mm3(dR, f + SF_R, f + SF_RN);
    for (int i = 0; i < 3; ++i)
      f[SF_TN + i] = dR[3 * i] * f[SF_T] + dR[3 * i + 1] * f[SF_T + 1] +
                     dR[3 * i + 2] * f[SF_T + 2] + dt[i];
    f[SF_MU0] = mu0;
    s[SI_TRIAL] = 1;
    return;
  }
  if (!s[SI_RAN]) return;
  s[SI_IT] += 1;
  if (!s[SI_TRIAL]) return;
  s[SI_TRIAL] = 0;
  const float err_new = (float)B.trial[k];
  f[SF_ERRN] = err_new;
  const float mu0 = f[SF_MU0];
  float dot = 0.0f;
  for (int a = 0; a < 6; ++a) {
    const float xa = f[SF_X + a];
    const float v = xa * (mu0 * xa + f[SF_B + a]);
    dot = a ? dot + v : v;
  }
  const float gain = 0.5f * dot;
  const float rho =
      (f[SF_ERR] - err_new) / (fabsf(gain) > 1e-30f ? gain : 1e-30f);
  const bool accept = rho > 0.0f;
  if (accept) {
    for (int q = 0; q < 12; ++q) f[SF_R + q] = f[SF_RN + q];
    const float u = 2.0f * rho - 1.0f;
    f[SF_MU] = mu0 * fmaxf(1.0f - u * u * u, (float)(1.0 / 3.0));
    f[SF_NU] = C.nu_init;
  } else {
    f[SF_MU] = mu0 * f[SF_NU];
    f[SF_NU] = f[SF_NU] * C.nu_init;
  }
  s[SI_EVAL] = accept;
}

// ---------------------------------------------------------------------
extern "C" int emf_max_items() { return EMF_MAX_ITEMS; }

// The blocks of an item of n points: max(1, ceil(n / EMF_LM_SPAN)); the
// host sizes the block partials (EmfLmBufs.part) from it.
extern "C" int emf_lm_blocks(int n) {
  return n > EMF_LM_SPAN ? (n + EMF_LM_SPAN - 1) / EMF_LM_SPAN : 1;
}

// The launch's table and block count (emf_lm_blocks an item).
static int emf_lm_table(const EmfLmItem* items, int n, EmfLmTable& T,
                        long long& blocks) {
  if (n < 1 || n > EMF_MAX_ITEMS) return (int)cudaErrorInvalidValue;
  T.n = n;
  blocks = 0;
  for (int k = 0; k < EMF_MAX_ITEMS; ++k) {
    if (k < n) {
      if (items[k].n < 0) return (int)cudaErrorInvalidValue;
      T.items[k] = items[k];
      blocks += emf_lm_blocks(items[k].n);
    } else {
      T.items[k] = EmfLmItem{};
    }
    T.block_end[k] = (int)blocks;
  }
  return 0;
}

// phase 0: the per-point values and wmax; 1: w and the sums. Returns a
// cudaError_t.
extern "C" int emf_lm_system(const EmfLmItem* items, int n, int phase,
                             const EmfLmBufs* B, const EmfLmCfg* C,
                             void* stream) {
  EmfLmTable T;
  long long blocks;
  const int e = emf_lm_table(items, n, T, blocks);
  if (e) return e;
  if (phase == 0)
    emf_lm_gather_kernel<<<(unsigned)blocks, EMF_LM_BLOCK, 0,
                           (cudaStream_t)stream>>>(T, *B, *C);
  else
    emf_lm_terms_kernel<<<(unsigned)blocks, EMF_LM_BLOCK, 0,
                          (cudaStream_t)stream>>>(T, *B, *C);
  return (int)cudaGetLastError();
}

extern "C" int emf_lm_trial(const EmfLmItem* items, int n,
                            const EmfLmBufs* B, const EmfLmCfg* C,
                            void* stream) {
  EmfLmTable T;
  long long blocks;
  const int e = emf_lm_table(items, n, T, blocks);
  if (e) return e;
  emf_lm_trial_kernel<<<(unsigned)blocks, EMF_LM_BLOCK, 0,
                        (cudaStream_t)stream>>>(T, *B, *C);
  return (int)cudaGetLastError();
}

// phase 0: propose a step; 1: decide on it. n items, one block each.
extern "C" int emf_lm_step(int n, int phase, const EmfLmBufs* B,
                           const EmfLmCfg* C, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  emf_lm_step_kernel<<<(unsigned)n, 32, 0, (cudaStream_t)stream>>>(*B, *C,
                                                                   phase);
  return (int)cudaGetLastError();
}
