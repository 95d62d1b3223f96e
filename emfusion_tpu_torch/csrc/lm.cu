// The device-resident Levenberg-Marquardt loops: a table of LMs (the
// camera's, every serial object LM of a frame, or the batched object
// LM's slots) iterated on the card with no host round trip inside the
// loop, one kernel for each kind of item:
//   emf_lm_cluster (cache items, which read K3's windows, each of at most
//     EMF_LM_CLUSTER_MAX spans: the batched object LM's fixed-cache
//     stages, 4 spans a slot), one thread-block cluster an LM (below);
//   emf_lm_run (gather items: the gather sampler's LMs; and cache items
//     with a larger one: the capture sampler's camera LM, 34 spans at the
//     accelerator configuration's stride), one persistent, cooperative
//     launch over the whole table.
// Each runs up to `iters` iterations and returns early once every LM has
// stopped. Replaces the five launches an iteration of the split kernels
// below (emf_lm_system's two phases, emf_lm_step's two and
// emf_lm_trial), which only the pixel-sharded LM still launches. Their
// counterpart in the JAX package is the XLA while_loop body of
// emfusion_tpu/tracking.py:242-322 (track_volume with sampler "gather"),
// not a Pallas kernel: the JAX package runs the whole loop (residual
// sampling, Jacobian, weights, the 6x6 normal equations, the accept /
// reject damping and the SE(3) update) inside one lax.while_loop with
// on-device convergence flags, and its object LMs as one lax.scan over
// the slots (pipeline.py:540-545); a single launch is the nearest the
// card has to it. The reference (TSDF.cpp:274-282) and the port's host
// loop instead read the system back every iteration. Every launch reads
// and writes a state record per item (tracking.LMRun; words SI_* and SF_*
// below).
//
// An iteration is five phases with a barrier after each (emf_lm_run: the
// grid's, cooperative_groups::this_grid().sync(); emf_lm_cluster: the
// cluster's, this_cluster().sync()):
//   (a) gather: per point the 27-corner gather of
//     geometry/sampling.sample_system_at_points (margin-1 psi and the
//     finite-difference gradient, every validity rule and clip), the
//     margin-1 integration weight, clamped to max_tsdf_weight, and the
//     Huber weight (x/0 = 0), stored per point; each span's max(0, intw).
//   (b) terms: a block reduces the span maxima of each item it works on
//     itself (wmax; no extra barrier), then per point w = huber * (intw /
//     wmax) * assoc, J = [g3, p x g3], and the 21 unique terms of J w J^T,
//     the 6 of J w psi and w psi^2, each formed in float32 and summed in
//     float64 into the span's partials.
//   (c) propose (an item's lead block): the item's partials summed by the
//     fixed-order tree, then emf_lm_step's propose body on one thread: A,
//     b, err rounded to float32, the gradient test, mu0, the 6x6 solve
//     (Gaussian elimination with partial pivoting), the step test against
//     se3_log of the pose, se3_exp(-x) and the trial pose.
//   (d) trial: w psi(trial pose)^2 with the last evaluation's w, summed in
//     float64 into the span's partials.
//   (e) decide (the lead block): the trial error by the same tree, then
//     emf_lm_step's decide body: rho, accept or reject, the mu / nu
//     update, eval_grad and it += 1.
// After (e)'s barrier the next iteration's top reads the records: in
// emf_lm_run every block reads all S and the grid leaves the loop
// together once no LM runs, so no block misses a barrier (a cache LM that
// has left skips every phase until then); in emf_lm_cluster a cluster
// reads its own item's record and leaves on it alone. An item whose LM
// has stopped (converged, or it >= max_iter), or that has nothing to do
// in a phase, skips it.
//
// Work: a span is EMF_LM_SPAN consecutive points of one item (an item of
// n points has max(1, ceil(n / EMF_LM_SPAN)) spans); a thread takes
// EMF_LM_PPT points of it, a block's threads neighbouring points
// (coalesced). emf_lm_run's grid is min(spans, co-resident blocks) blocks;
// block b takes spans b, b + G, b + 2G, ... in every phase, and an
// item's lead block is the one holding its first span. emf_lm_cluster's
// cluster k runs item k with c = the table's most spans of an item (at
// most EMF_LM_CLUSTER_MAX) blocks; its block r takes the item's span r,
// and its block 0 leads. Either way a point's per-point values are
// written and read by one thread, and each span writes one row of
// partials, so no sum depends on the grid or the cluster size. A point
// that no validity rule admits skips its gather (its outputs are exactly
// 0, as in the plain version), which is most of an object's points.
//
// Sums: every block reduces a span's terms in a fixed order (warp
// shuffles, then the warps in order) into float64 partials; an item's
// partials are then summed by a fixed-order parallel tree (emf_lm_rows:
// lane l of a warp adds rows l, l + 32, ... in order, then a fixed
// shuffle tree; one warp a column). A float64 sum of float32 terms
// rounds to the float32 of the exact sum in all but vanishingly rare
// ties, so the plain versions (tracking.lm_system_plain, lm_trial_plain),
// which sum in another order, agree to the last float32 bit. The
// per-point values and the scalar steps are the plain versions' float32
// arithmetic, operation for operation (built with --fmad=false), so they
// are bit-equal; sinf, cosf, acosf and sqrtf are CUDA's, which PyTorch's
// CUDA operators also call.
//
// Bound on the card, emf_lm_run: the gather's bytes (27 + 8 voxels and
// a point a point, mostly from L2; the terms and the trial stream what
// the gather wrote) plus one grid barrier a phase, five an iteration.
// Against the split kernels it removes four launches an iteration and
// their host dispatch, the second transform and scratch read of
// emf_lm_system's second launch stay (L2-resident: 20 bytes a point),
// the serial last-block passes (one thread over ~300 partials for the
// max and the trial, 28 threads over them for the sums) become the
// parallel tree, and an LM table that has stopped costs no further
// launch. What limits it on an H100 is occupancy, not the barriers: 128
// registers a thread leave 2 blocks of 256 an SM, so a thread's points
// are a chain of memory round trips; a thread therefore starts its
// points' loads together and the single-thread step keeps its matrices
// in registers.
//
// Bound on the card, the cache items: a table's bytes take well under a
// microsecond an iteration (2 x 4096 points: ~0.1 us), so latency bounds
// it. Run cooperatively over the whole grid, every phase of a 2 x 4096
// stage took 5-9 us (scripts/lm_run_phases.py): a grid barrier over every
// block of the table, every block reading every item's record at the
// loop top, lead blocks taking several items' propose and decide in
// turn. emf_lm_cluster runs such a table as one cluster an LM, launched
// with cudaLaunchKernelEx and its cluster dimension (sizes above 8 are
// non-portable and allowed by attribute; cudaOccupancyMaxActiveClusters
// must find room for one), so a phase's barrier is the cluster's
// (barrier.cluster arrive and wait, in hardware within a GPC), a block
// reads one record (its words and pose loaded together), a lead leads
// one LM, and each LM leaves the loop on its own record while the others
// run on. Clusters need not be co-resident, so any table size launches.
// The span partials stay in B.part, written before a cluster barrier
// (its release) and read after it (its acquire) through L2 (__ldcg), as
// emf_lm_run reads them; distributed shared memory would save those L2
// reads, but the span functions, which emf_lm_run shares, write their
// rows to B.part, and a phase's tree read is one round trip against the
// span's several. What bounds it then: a span's own chain (a thread's
// four points in turn, ~4-7 us a phase) and the one-thread propose and
// decide. A cluster holds at most EMF_LM_CLUSTER_MAX blocks, so an item
// of more spans would take them two or more deep in a block (the
// capture camera's 34 spans on 16: 1.7x the cooperative grid's time an
// iteration, which gives each span its own block); a table with such an
// item runs in emf_lm_run, whose cache LMs also leave one by one (on[],
// below). The per-span functions, the partial rows, the tree and the step
// bodies are the two kernels' own, so a cache LM ends on the same bits in
// either kernel. An LM that leaves on a stop misses the later propose
// that would clear its SI_RAN, so its decide clears it in the iteration
// it stops (emf_lm_decide_cache; tracking.lm_step_plain does the same).
//
// The split kernels stay for the pixel-sharded LM (tracking.
// _run_lm_split), which all-reduces the weight maxima, the sums and the
// trial errors across ranks between the phases: there an item's last
// block to finish (an integer ticket, no float atomics) sums the item's
// partials with the same tree. They take gather items only and
// refuse a table with a cache item; emf_lm_run refuses a table of cache
// items that emf_lm_cluster takes, and emf_lm_cluster the others.
//
// Cache items (the batched object LM's fixed-cache stages, tracking.
// track_volumes_batched; the JAX package's _lm_fixed_cache while_loop
// body, emfusion_tpu/tracking.py:394-498, under vmap): an item may carry
// its points' 6^3 windows of tsdf and weight, captured by K3 (capture.cu)
// at the stage's start pose, as a (2, 6, 6, 6, cs) cache (float, or bf16
// bits, widened exactly) with (3, cs) int32 anchors, points minor. Its
// phases (a) and (d) then read the cache where a gather item reads the
// volume: geometry/capture.sample_system_from_cache and
// sample_value_from_cache, ψ at margin 1 and the finite-difference
// gradient at margin 2 with the per-shift validity rules, the margin-1
// weight from channel 1, and the window test (local coordinates in
// [0, 4] on each axis; a point that drifted out drops out of ψ, the
// weight and the trial), each sample the separable tent sum over the
// window, x first, then y, then z. The kernel sums only the taps that can
// have a nonzero tent: on an axis with local coordinate l those are
// floor(l), floor(l) + 1 and, for the +1-shifted tents of the gradient,
// floor(l) + 2; a tap outside the window counts as 0. The others' tents
// are exactly 0, so each product it leaves out is a zero, and the taps it
// keeps are summed in the plain version's left-to-right order: it ends on
// the plain version's bits (tracking.lm_system_plain, lm_trial_plain,
// which sum all six taps), up to the sign of a zero. A table holds
// cache items only or gather items only: emf_lm_run_kernel and the
// per-span functions are templates on the item kind (<true> and <false>),
// so the gather table's code is what it was.
//
// The empty-window guard (cache items only): a trial pose at which none of
// the points that carry weight (w > 0, the last evaluation's) samples a
// valid psi (inside its window and inside the volume) scores the error 0
// of an empty sum, which rho > 0 would accept; the JAX package's
// _lm_fixed_cache takes such a step, and a slot that had lost most of its
// points jumps tens of voxels. Phase (d) therefore also counts a span's
// weighted, valid trial points (partial column EMF_LM_P_INWIN, summed by
// the same tree into the state word SI_NIN), and decide rejects a trial
// whose count is 0 as it rejects rho <= 0 (tracking.lm_step_plain does
// the same). Gather items neither write nor read the count.
//
// Re-capturing cache items (the capture sampler's LM, tracking.
// track_volumes_capture; the JAX package's capture while_loop with its
// maybe_recapture lax.cond at the trial pose, emfusion_tpu/tracking.py:
// 224-240, 277-282): a table's re-capture budget is EmfLmCfg.recaps (0
// for the batched LM's fixed-cache stages, whose code path is then the one
// above, bit for bit). While a cache item has re-captures left (SI_RECAP <
// recaps), phase (d) also counts, over all its points, those relevant at
// the trial pose (in front of the camera, within a voxel of the volume)
// and those of them outside their windows (geometry/capture.drift_counts;
// partial columns 0 and 1, dead once propose has summed the system),
// summed by the same tree into SI_NREL and SI_NBAD. If more than
// EMF_DRIFT_TOL of the relevant points left (drift_within), decide does
// not decide: it flags the item (SI_PEND), counts the re-capture
// (SI_RECAP), leaves SI_IT and the trial as they are, and clears SI_EVAL.
// The item's LM leaves the loop after the iteration in which it was
// flagged (the loop top's test, from the launch's second iteration on);
// the other items run on to their stop or their own flag. The host reads
// the records once the launch has ended, captures the flagged items'
// windows at their trial poses with K3 (into the items' own caches) and
// launches again. There a flagged item skips (a)-(c) (no gradient to
// evaluate; propose leaves it alone), and (d) and (e) take its trial on
// the new windows, with no second drift test: the JAX order, which keeps
// the new windows even when the step is then rejected. A call reads the
// device at most 1 + re-captures times.
//
// A cache item reads per point its anchor
// (12 bytes) and at most 27 tsdf taps and 8 weight taps of its cache for
// the system and 8 tsdf taps for the trial; neighbouring points share a
// load only where they share a tap, since each point's taps lie in its
// own column of the point-minor cache.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define EMF_LM_BLOCK 256
#define EMF_LM_PPT 4
#define EMF_LM_SPAN (EMF_LM_BLOCK * EMF_LM_PPT)   // points a span
#define EMF_LM_WARPS (EMF_LM_BLOCK / 32)
#define EMF_LM_NSUM 28                             // A 21, b 6, err 1
// A span's row of partials: the 28 sums, the trial error, max(0, intw),
// and (cache items) the count of weighted trial points with a valid psi.
#define EMF_LM_PART 31
#define EMF_LM_P_TRIAL 28
#define EMF_LM_P_MAX 29
#define EMF_LM_P_INWIN 30
// (d) of a cache item that tests its drift: its relevant points and those
// outside their windows at the trial pose, in columns that hold the
// system's sums only until (c) has summed them
#define EMF_LM_P_NBAD 0
#define EMF_LM_P_NREL 1
#define EMF_DRIFT_TOL 0.01f   // geometry/capture.DRIFT_TOL
#define EMF_LM_ROWS_AHEAD 8   // partials a lane loads at once (emf_lm_rows)
#define EMF_LM_CLUSTER_MAX 16 // the most blocks of an emf_lm_cluster cluster

// The state record of an item, mirrored by tracking.SI_* / SF_*. Cache
// items: SI_NIN, the last trial's weighted points with a valid psi;
// SI_PEND, a trial that waits for a re-capture at its trial pose;
// SI_RECAP, the re-captures taken; SI_NBAD and SI_NREL, the last drift
// test's points outside their windows and relevant points. SI_N keeps a
// record 16-byte aligned (emf_lm_head).
enum { SI_IT = 0, SI_CONV = 1, SI_EVAL = 2, SI_FIRST = 3, SI_TRIAL = 4,
       SI_RAN = 5, SI_NIN = 6, SI_PEND = 7, SI_RECAP = 8, SI_NBAD = 9,
       SI_NREL = 10, SI_N = 12 };
enum { SF_R = 0, SF_T = 9, SF_RN = 12, SF_TN = 21, SF_X = 24, SF_MU = 30,
       SF_NU = 31, SF_MU0 = 32, SF_ERR = 33, SF_ERRN = 34, SF_A = 35,
       SF_B = 71, SF_N = 80 };

// One LM of a launch. Mirrored by kernels.LmItemArgs.
struct EmfLmItem {
  const void* tsdf;    // (Z, Y, X), float or emf_bf16 (gather items)
  const void* wts;     // (Z, Y, X), the same type
  const float* pts;    // (3, n) camera points, rows `stride` floats apart
  const float* assoc;  // (n) association weights
  const void* cache;   // cache items: (2, 6, 6, 6, cs), float or emf_bf16
  const int* anchor;   // cache items: (3, cs) int32 window anchors
  int stride, n, Z, Y, X;
  int bf16;            // 1: the volumes (gather) or the cache are bf16
  float vs;
  int p0;              // the item's first point in the packed buffers
  int cs;              // cache items: the point stride of cache and anchor
  int cached;          // 1: a cache item, 0: a gather item
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
  double* part;     // (spans, EMF_LM_PART) span partials
  int* count;       // (S) the split kernels' tickets, 0 between launches
  int total;
};

// Mirrored by kernels.LmCfgArgs.
struct EmfLmCfg {
  float tau, eps1, eps2, nu_init, huber, max_w;
  int max_iter;
  int recaps;   // cache items: the table's re-capture budget
};

struct EmfLmTable {
  int n;
  int span_end[EMF_MAX_ITEMS];  // cumulative span counts
  EmfLmItem items[EMF_MAX_ITEMS];
};

// The item of span s, and its first span in s0.
__device__ __forceinline__ int emf_lm_item(const EmfLmTable& T, int s,
                                           int& s0) {
  int k = 0;
  while (s >= T.span_end[k]) ++k;
  s0 = k ? T.span_end[k - 1] : 0;
  return k;
}

// State words are read through L2 (__ldcg): within emf_lm_run another
// block's writes, made visible by the grid barrier, must not be served
// from this SM's L1. A record's first four words (SI_IT, SI_CONV,
// SI_EVAL, SI_FIRST) come in one 16-byte load.
__device__ __forceinline__ int emf_lm_si(const EmfLmBufs& B, int k, int w) {
  return __ldcg(B.si + k * SI_N + w);
}

__device__ __forceinline__ int4 emf_lm_head(const EmfLmBufs& B, int k) {
  return __ldcg(reinterpret_cast<const int4*>(B.si + k * SI_N));
}

__device__ __forceinline__ bool emf_lm_running(const EmfLmBufs& B,
                                               const EmfLmCfg& C, int k) {
  const int4 h = emf_lm_head(B, k);
  return h.x < C.max_iter && !h.y;
}

// The LM runs and evaluates its system this iteration.
__device__ __forceinline__ bool emf_lm_evals(const EmfLmBufs& B,
                                             const EmfLmCfg& C, int k) {
  const int4 h = emf_lm_head(B, k);
  return h.x < C.max_iter && !h.y && h.z;
}

// Item k's pose at state word `at` (SF_R, or SF_RN for the trial pose).
__device__ __forceinline__ EmfPose emf_lm_pose(const EmfLmBufs& B, int k,
                                               int at) {
  const float* f = B.sf + k * SF_N + at;
  EmfPose P;
  P.r00 = __ldcg(f + 0); P.r01 = __ldcg(f + 1); P.r02 = __ldcg(f + 2);
  P.r10 = __ldcg(f + 3); P.r11 = __ldcg(f + 4); P.r12 = __ldcg(f + 5);
  P.r20 = __ldcg(f + 6); P.r21 = __ldcg(f + 7); P.r22 = __ldcg(f + 8);
  P.t0 = __ldcg(f + 9); P.t1 = __ldcg(f + 10); P.t2 = __ldcg(f + 11);
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

// The fixed-order tree over rows [r0, r0 + nr) of the span partials, in
// column `col`: lane l of the calling warp takes rows l, l + 32, ... in
// order, in float64, then a fixed shuffle tree; the sum, or with MAX the
// maximum (of values >= 0), lands in lane 0. Every lane of the warp calls
// it.
template <bool MAX>
__device__ __forceinline__ double emf_lm_rows(const double* part, int r0,
                                              int nr, int col) {
  const int lane = threadIdx.x & 31;
  const double* p = part + (size_t)r0 * EMF_LM_PART + col;
  double v = 0.0;
  // EMF_LM_ROWS_AHEAD loads in flight before they are added in order
  for (int r = lane; r < nr; r += 32 * EMF_LM_ROWS_AHEAD) {
    double x[EMF_LM_ROWS_AHEAD];
#pragma unroll
    for (int j = 0; j < EMF_LM_ROWS_AHEAD; ++j) {
      const int q = r + 32 * j;
      x[j] = q < nr ? __ldcg(p + (size_t)q * EMF_LM_PART) : 0.0;
    }
#pragma unroll
    for (int j = 0; j < EMF_LM_ROWS_AHEAD; ++j)
      if (r + 32 * j < nr) v = MAX ? fmax(v, x[j]) : v + x[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double y = __shfl_down_sync(0xffffffffu, v, o);
    v = MAX ? fmax(v, y) : v + y;
  }
  return v;
}

// Item k's 28 sums from its nr span rows from r0 into B.sys: warp w
// takes the columns w, w + 8, w + 16, w + 24, each as emf_lm_rows sums it
// (lane l adds rows l, l + 32, ... in order, then the shuffle tree), the
// columns' loads in flight together; visible to the whole block when it
// returns.
#define EMF_LM_COLS ((EMF_LM_NSUM + EMF_LM_WARPS - 1) / EMF_LM_WARPS)
__device__ __forceinline__ void emf_lm_sums(const EmfLmBufs& B, int k,
                                            int r0, int nr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double* p = B.part + (size_t)r0 * EMF_LM_PART + warp;
  double v[EMF_LM_COLS];
#pragma unroll
  for (int c = 0; c < EMF_LM_COLS; ++c) v[c] = 0.0;
  for (int r = lane; r < nr; r += 32 * EMF_LM_ROWS_AHEAD) {
    double x[EMF_LM_ROWS_AHEAD][EMF_LM_COLS];
#pragma unroll
    for (int j = 0; j < EMF_LM_ROWS_AHEAD; ++j)
#pragma unroll
      for (int c = 0; c < EMF_LM_COLS; ++c) {
        const int q = r + 32 * j;
        x[j][c] = q < nr && warp + EMF_LM_WARPS * c < EMF_LM_NSUM
                      ? __ldcg(p + (size_t)q * EMF_LM_PART +
                               EMF_LM_WARPS * c)
                      : 0.0;
      }
#pragma unroll
    for (int j = 0; j < EMF_LM_ROWS_AHEAD; ++j)
      if (r + 32 * j < nr)
#pragma unroll
        for (int c = 0; c < EMF_LM_COLS; ++c) v[c] = v[c] + x[j][c];
  }
#pragma unroll
  for (int c = 0; c < EMF_LM_COLS; ++c) {
    const double t = emf_warp_sum(v[c]);
    if (lane == 0 && warp + EMF_LM_WARPS * c < EMF_LM_NSUM)
      B.sys[k * EMF_LM_NSUM + warp + EMF_LM_WARPS * c] = t;
  }
  __syncthreads();
}

// True in every thread of the item's last block to finish (the split
// kernels); the block's partials, written before the call, are then
// visible to that block.
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

// The psi, gradient, clamped integration weight and Huber weight of the
// point (px, py, pz) (tracking.lm_system_plain's first pass).
template <typename T>
__device__ __forceinline__ EmfLmPoint emf_lm_point(const EmfLmItem& it,
                                                   const EmfPose& P,
                                                   float px, float py,
                                                   float pz,
                                                   const EmfLmCfg& C) {
  const T* vol = static_cast<const T*>(it.tsdf);
  const T* wts = static_cast<const T*>(it.wts);
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

// psi at margin 1 (kernel K2's sample) at the point (px, py, pz).
template <typename T>
__device__ __forceinline__ float emf_lm_psi(const EmfLmItem& it,
                                            const EmfPose& P, float px,
                                            float py, float pz) {
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
// Cache items: the samplers of geometry/capture.py on an item's windows.
#define EMF_WIN 6
#define EMF_WIN_HI 4.0f   // WIN - 2: the window test's upper bound

// tent(v - d) = max(0, 1 - |v - d|), the weight of window tap d
__device__ __forceinline__ float emf_tent(float v, int d) {
  return fmaxf(1.0f - fabsf(v - (float)d), 0.0f);
}

// The first tap that can carry a nonzero tent of v or of v + 1: floor(v),
// v clipped to [-4, 8] first (beyond it no candidate tap lies in the
// window, so the clip only keeps the floor in an int).
__device__ __forceinline__ int emf_tap0(float v) {
  return (int)floorf(fminf(fmaxf(v, -4.0f), 8.0f));
}

// The window's value at tap (z, y, x) of a (6, 6, 6, cs) channel, 0
// outside the window.
template <typename T>
__device__ __forceinline__ float emf_tap(const T* ch, size_t cs, size_t i,
                                         int z, int y, int x) {
  const bool in = (unsigned)z < EMF_WIN && (unsigned)y < EMF_WIN &&
                  (unsigned)x < EMF_WIN;
  return in ? emf_ld(ch + (size_t)((z * EMF_WIN + y) * EMF_WIN + x) * cs + i)
            : 0.0f;
}

// A channel's 2x2x2 taps from (fz, fy, fx), c[dz][dy][dx].
template <typename T>
__device__ __forceinline__ void emf_taps8(const T* ch, size_t cs, size_t i,
                                          int fz, int fy, int fx,
                                          float (&c)[2][2][2]) {
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
        c[dz][dy][dx] = emf_tap(ch, cs, i, fz + dz, fy + dy, fx + dx);
}

// The 2x2x2 tent sum of taps c with the tents t*[0..1]: x, then y, then
// z (sample_value_from_cache's order).
__device__ __forceinline__ float emf_sum8(const float (&c)[2][2][2],
                                          const float* tx, const float* ty,
                                          const float* tz) {
  float cy[2];
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    float cx[2];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
      cx[dy] = c[dz][dy][0] * tx[0] + c[dz][dy][1] * tx[1];
    cy[dz] = cx[0] * ty[0] + cx[1] * ty[1];
  }
  return cy[0] * tz[0] + cy[1] * tz[1];
}

// The 2x2x2 tent sum of a channel from taps (fz, fy, fx). Every tap lies
// in the window: the caller's point passed the window test.
template <typename T>
__device__ __forceinline__ float emf_win8(const T* ch, size_t cs, size_t i,
                                          int fz, int fy, int fx,
                                          const float* tx, const float* ty,
                                          const float* tz) {
  float c[2][2][2];
  emf_taps8(ch, cs, i, fz, fy, fx, c);
  return emf_sum8(c, tx, ty, tz);
}

// Point i's window anchor (x, y, z).
struct EmfAnchor {
  int x, y, z;
};

__device__ __forceinline__ EmfAnchor emf_anchor(const EmfLmItem& it, int i) {
  const size_t cs = (size_t)it.cs;
  return {__ldg(it.anchor + i), __ldg(it.anchor + cs + i),
          __ldg(it.anchor + 2 * cs + i)};
}

// The local window coordinates of the point anchored at a at grid
// coordinates (vx, vy, vz), and the window test.
__device__ __forceinline__ bool emf_local(const EmfAnchor& a, float vx,
                                          float vy, float vz, float& lx,
                                          float& ly, float& lz) {
  lx = vx - (float)a.x;
  ly = vy - (float)a.y;
  lz = vz - (float)a.z;
  return lx >= 0.0f && lx <= EMF_WIN_HI && ly >= 0.0f && ly <= EMF_WIN_HI &&
         lz >= 0.0f && lz <= EMF_WIN_HI;
}

// emf_lm_point for point i of a cache item, anchored at an:
// sample_system_from_cache's ψ and gradient, the margin-1 weight of
// sample_value_from_cache (channel 1), clamped, and the Huber weight. The
// validity rules are the gather's, with the window test on ψ (valid1), the
// gradient's base (valid2) and the weight; the shifted samples keep the
// gather's rules alone, as the plain version does. The weight's taps are
// loaded beside the tsdf taps (one round trip to memory, not two).
template <typename T>
__device__ __forceinline__ EmfLmPoint emf_lm_point_cache(
    const EmfLmItem& it, const EmfPose& P, float px, float py, float pz,
    int i, const EmfAnchor& an, const EmfLmCfg& C) {
  float wx, wy, wz;
  emf_apply(P, px, py, pz, wx, wy, wz);
  const float fX = (float)it.X, fY = (float)it.Y, fZ = (float)it.Z;
  const float vx = wx / it.vs + 0.5f * (float)(it.X - 1);
  const float vy = wy / it.vs + 0.5f * (float)(it.Y - 1);
  const float vz = wz / it.vs + 0.5f * (float)(it.Z - 1);
  const bool front = pz > 0.0f;
  const bool ahead = front && vx >= 0.0f && vy >= 0.0f && vz >= 0.0f;
  const bool in1 = ahead && vx + 1.0f < fX && vy + 1.0f < fY && vz + 1.0f < fZ;
  const bool in2 = ahead && vx + 2.0f < fX && vy + 2.0f < fY && vz + 2.0f < fZ;
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
  if (!(in1 || vsx || vsy || vsz)) return r;  // every output is 0
  float lx, ly, lz;
  const bool win = emf_local(an, vx, vy, vz, lx, ly, lz);
  const bool valid1 = in1 && win, valid2 = in2 && win;
  const int fx = emf_tap0(lx), fy = emf_tap0(ly), fz = emf_tap0(lz);
  const float lx1 = lx + 1.0f, ly1 = ly + 1.0f, lz1 = lz + 1.0f;
  float tx[3], tx1[3], ty[3], ty1[3], tz[3], tz1[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    tx[d] = emf_tent(lx, fx + d);
    tx1[d] = emf_tent(lx1, fx + d);
    ty[d] = emf_tent(ly, fy + d);
    ty1[d] = emf_tent(ly1, fy + d);
    tz[d] = emf_tent(lz, fz + d);
    tz1[d] = emf_tent(lz1, fz + d);
  }
  const size_t cs = (size_t)it.cs;
  const T* ch = static_cast<const T*>(it.cache);
  float c[3][3][3];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        c[dz][dy][dx] = emf_tap(ch, cs, (size_t)i, fz + dz, fy + dy, fx + dx);
  // the weight's taps: the window test puts floor(l) in [0, 4], so all 8
  // lie inside
  float wt[2][2][2];
  if (valid1)
    emf_taps8(ch + (size_t)EMF_WIN * EMF_WIN * EMF_WIN * cs, cs, (size_t)i,
              fz, fy, fx, wt);
  // x, then y, then z: cx (tents tx), cx1 (tx1); cy = cx . ty, cy1 = cx .
  // ty1, cyx1 = cx1 . ty; then the four samples along z
  float cy[3], cy1[3], cyx1[3];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
    float cx[3], cx1[3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      cx[dy] = c[dz][dy][0] * tx[0] + c[dz][dy][1] * tx[1] +
               c[dz][dy][2] * tx[2];
      cx1[dy] = c[dz][dy][0] * tx1[0] + c[dz][dy][1] * tx1[1] +
                c[dz][dy][2] * tx1[2];
    }
    cy[dz] = cx[0] * ty[0] + cx[1] * ty[1] + cx[2] * ty[2];
    cy1[dz] = cx[0] * ty1[0] + cx[1] * ty1[1] + cx[2] * ty1[2];
    cyx1[dz] = cx1[0] * ty[0] + cx1[1] * ty[1] + cx1[2] * ty[2];
  }
  const float base_val = cy[0] * tz[0] + cy[1] * tz[1] + cy[2] * tz[2];
  const float sx =
      vsx ? cyx1[0] * tz[0] + cyx1[1] * tz[1] + cyx1[2] * tz[2] : 0.0f;
  const float sy = vsy ? cy1[0] * tz[0] + cy1[1] * tz[1] + cy1[2] * tz[2] : 0.0f;
  const float sz = vsz ? cy[0] * tz1[0] + cy[1] * tz1[1] + cy[2] * tz1[2] : 0.0f;
  r.psi = valid1 ? base_val : 0.0f;
  const float base = valid2 ? base_val : 0.0f;
  r.gx = (sx - base) / it.vs;
  r.gy = (sy - base) / it.vs;
  r.gz = (sz - base) / it.vs;
  if (valid1) r.intw = fminf(emf_sum8(wt, tx, ty, tz), C.max_w);
  const float a = fabsf(r.psi);
  r.hub = a > 0.0f ? fminf(C.huber / fmaxf(a, 1e-30f), 1.0f) : 0.0f;
  return r;
}

// emf_lm_psi for point i of a cache item, anchored at an:
// sample_value_from_cache at margin 1 (channel 0), 0 outside the window;
// `valid` says whether the sample is inside the volume and the window.
template <typename T>
__device__ __forceinline__ float emf_lm_psi_cache(const EmfLmItem& it,
                                                  const EmfPose& P, float px,
                                                  float py, float pz, int i,
                                                  const EmfAnchor& an,
                                                  bool& valid) {
  valid = false;
  float wx, wy, wz;
  emf_apply(P, px, py, pz, wx, wy, wz);
  const float vx = wx / it.vs + 0.5f * (float)(it.X - 1);
  const float vy = wy / it.vs + 0.5f * (float)(it.Y - 1);
  const float vz = wz / it.vs + 0.5f * (float)(it.Z - 1);
  if (!(pz > 0.0f && vx >= 0.0f && vy >= 0.0f && vz >= 0.0f &&
        vx + 1.0f < (float)it.X && vy + 1.0f < (float)it.Y &&
        vz + 1.0f < (float)it.Z))
    return 0.0f;
  float lx, ly, lz;
  if (!emf_local(an, vx, vy, vz, lx, ly, lz)) return 0.0f;
  valid = true;
  const int fx = (int)floorf(lx), fy = (int)floorf(ly), fz = (int)floorf(lz);
  const float tx[2] = {emf_tent(lx, fx), emf_tent(lx, fx + 1)};
  const float ty[2] = {emf_tent(ly, fy), emf_tent(ly, fy + 1)};
  const float tz[2] = {emf_tent(lz, fz), emf_tent(lz, fz + 1)};
  return emf_win8(static_cast<const T*>(it.cache), (size_t)it.cs, (size_t)i,
                  fz, fy, fx, tx, ty, tz);
}

// geometry/capture.drift_counts for a point of a cache item, anchored at
// an, at the pose P: adds 1 to nrel if the point is relevant (in front of
// the camera and within a voxel of the volume) and, if so, 1 to nbad if
// it lies outside its window (a local coordinate outside [0, WIN - 2]).
__device__ __forceinline__ void emf_lm_drift(const EmfLmItem& it,
                                             const EmfPose& P, float px,
                                             float py, float pz,
                                             const EmfAnchor& an, int& nrel,
                                             int& nbad) {
  float wx, wy, wz;
  emf_apply(P, px, py, pz, wx, wy, wz);
  const float vx = wx / it.vs + 0.5f * (float)(it.X - 1);
  const float vy = wy / it.vs + 0.5f * (float)(it.Y - 1);
  const float vz = wz / it.vs + 0.5f * (float)(it.Z - 1);
  if (!(pz > 0.0f && vx >= -1.0f && vy >= -1.0f && vz >= -1.0f &&
        vx < (float)it.X && vy < (float)it.Y && vz < (float)it.Z))
    return;
  ++nrel;
  float lx, ly, lz;
  if (!emf_local(an, vx, vy, vz, lx, ly, lz)) ++nbad;
}

// ---------------------------------------------------------------------
// A span's work in each phase, for the block that holds span s (the
// item's span bl). Every thread of the block calls these; each ends with
// a barrier of the block, so the next span may reuse its shared memory.

// (a) the per-point values into scratch and hub, the span's max(0, intw)
// into its partials. A thread loads its points' coordinates together.
// CACHE: the items are cache items (emf_lm_point_cache), whose anchors a
// thread loads with the coordinates.
template <bool CACHE>
__device__ void emf_lm_gather_span(const EmfLmItem& it, const EmfPose& P,
                                   const EmfLmBufs& B, const EmfLmCfg& C,
                                   int s, int bl) {
  const size_t tot = (size_t)B.total, st = (size_t)it.stride;
  const int i0 = bl * EMF_LM_SPAN + threadIdx.x;
  float px[EMF_LM_PPT], py[EMF_LM_PPT], pz[EMF_LM_PPT];
  [[maybe_unused]] EmfAnchor a[EMF_LM_PPT];
#pragma unroll
  for (int j = 0; j < EMF_LM_PPT; ++j) {
    const int i = i0 + j * EMF_LM_BLOCK;
    const bool in = i < it.n;
    px[j] = in ? it.pts[i] : 0.0f;
    py[j] = in ? it.pts[st + i] : 0.0f;
    pz[j] = in ? it.pts[2 * st + i] : 0.0f;
    if constexpr (CACHE) a[j] = in ? emf_anchor(it, i) : EmfAnchor{0, 0, 0};
  }
  float m = 0.0f;
  for (int j = 0; j < EMF_LM_PPT; ++j) {
    const int i = i0 + j * EMF_LM_BLOCK;
    if (i >= it.n) break;
    EmfLmPoint r;
    if constexpr (CACHE)
      r = it.bf16 ? emf_lm_point_cache<emf_bf16>(it, P, px[j], py[j], pz[j],
                                                 i, a[j], C)
                  : emf_lm_point_cache<float>(it, P, px[j], py[j], pz[j], i,
                                              a[j], C);
    else
      r = it.bf16 ? emf_lm_point<emf_bf16>(it, P, px[j], py[j], pz[j], C)
                  : emf_lm_point<float>(it, P, px[j], py[j], pz[j], C);
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
    B.part[(size_t)s * EMF_LM_PART + EMF_LM_P_MAX] = (double)v;
  }
  __syncthreads();
}

// (b) w, J and the span's float64 sums of the system, with the item's
// weight maximum wm. A thread loads all its points' inputs first, then
// forms their terms in order; a point whose w is 0 adds nothing (its 28
// terms are exactly 0: J and psi are finite), which is most of an
// object's points.
__device__ void emf_lm_terms_span(const EmfLmItem& it, const EmfPose& P,
                                  const EmfLmBufs& B, float wm, int s,
                                  int bl) {
  const size_t tot = (size_t)B.total, st = (size_t)it.stride;
  const int i0 = bl * EMF_LM_SPAN + threadIdx.x;
  float in_[EMF_LM_PPT][10];   // psi, g3, intw, hub, assoc, p
#pragma unroll
  for (int j = 0; j < EMF_LM_PPT; ++j) {
    const int i = i0 + j * EMF_LM_BLOCK;
    const size_t o = (size_t)it.p0 + i;
    const bool in = i < it.n;
#pragma unroll
    for (int c = 0; c < 5; ++c)
      in_[j][c] = in ? B.scratch[c * tot + o] : 0.0f;
    in_[j][5] = in ? B.hub[o] : 0.0f;
    in_[j][6] = in ? it.assoc[i] : 0.0f;
    in_[j][7] = in ? it.pts[i] : 0.0f;
    in_[j][8] = in ? it.pts[st + i] : 0.0f;
    in_[j][9] = in ? it.pts[2 * st + i] : 0.0f;
  }
  double acc[EMF_LM_NSUM];
#pragma unroll
  for (int q = 0; q < EMF_LM_NSUM; ++q) acc[q] = 0.0;
  float wv[EMF_LM_PPT];
#pragma unroll
  for (int j = 0; j < EMF_LM_PPT; ++j) {
    wv[j] = 0.0f;
    if (i0 + j * EMF_LM_BLOCK >= it.n) continue;
    const float* v = in_[j];
    const float psi = v[0];
    const float iw = wm > 0.0f ? v[4] / wm : 0.0f;
    const float w = v[5] * iw * v[6];
    wv[j] = w;
    if (w == 0.0f) continue;
    float wx, wy, wz;
    emf_apply(P, v[7], v[8], v[9], wx, wy, wz);
    const float gx = v[1], gy = v[2], gz = v[3];
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
#pragma unroll
  for (int j = 0; j < EMF_LM_PPT; ++j) {
    const int i = i0 + j * EMF_LM_BLOCK;
    if (i < it.n) B.w[(size_t)it.p0 + i] = wv[j];
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
    B.part[(size_t)s * EMF_LM_PART + threadIdx.x] = v;
  }
  __syncthreads();
}

// (d) the span's sum of w psi^2 at the trial pose Pn. A thread loads its
// points' weights, then the coordinates of those weighted, then samples
// them; a point of weight 0 adds nothing (its term is exactly 0, psi is
// finite). CACHE: the items are cache items (emf_lm_psi_cache; a thread
// loads its points' anchors with their weights), and the span also
// counts its points with w > 0 and a valid psi (EMF_LM_P_INWIN); with
// `drift`, also its relevant points and those outside their windows
// (emf_lm_drift, over every point: EMF_LM_P_NREL, EMF_LM_P_NBAD).
template <bool CACHE>
__device__ void emf_lm_trial_span(const EmfLmItem& it, const EmfPose& Pn,
                                  const EmfLmBufs& B, int s, int bl,
                                  [[maybe_unused]] bool drift) {
  const size_t st = (size_t)it.stride;
  const int i0 = bl * EMF_LM_SPAN + threadIdx.x;
  float w[EMF_LM_PPT], px[EMF_LM_PPT], py[EMF_LM_PPT], pz[EMF_LM_PPT];
  [[maybe_unused]] EmfAnchor a[EMF_LM_PPT];
#pragma unroll
  for (int j = 0; j < EMF_LM_PPT; ++j) {
    const int i = i0 + j * EMF_LM_BLOCK;
    w[j] = i < it.n ? B.w[(size_t)it.p0 + i] : 0.0f;
    if constexpr (CACHE)
      a[j] = i < it.n ? emf_anchor(it, i) : EmfAnchor{0, 0, 0};
  }
#pragma unroll
  for (int j = 0; j < EMF_LM_PPT; ++j) {
    const int i = i0 + j * EMF_LM_BLOCK;
    bool use = w[j] != 0.0f;
    if constexpr (CACHE) use = use || (drift && i < it.n);
    px[j] = use ? it.pts[i] : 0.0f;
    py[j] = use ? it.pts[st + i] : 0.0f;
    pz[j] = use ? it.pts[2 * st + i] : 0.0f;
  }
  double acc = 0.0;
  [[maybe_unused]] int nin = 0, nrel = 0, nbad = 0;
#pragma unroll
  for (int j = 0; j < EMF_LM_PPT; ++j) {
    if constexpr (CACHE)
      if (drift && i0 + j * EMF_LM_BLOCK < it.n)
        emf_lm_drift(it, Pn, px[j], py[j], pz[j], a[j], nrel, nbad);
    if (w[j] == 0.0f) continue;
    float psi;
    if constexpr (CACHE) {
      bool ok;
      psi = it.bf16 ? emf_lm_psi_cache<emf_bf16>(it, Pn, px[j], py[j], pz[j],
                                                 i0 + j * EMF_LM_BLOCK, a[j],
                                                 ok)
                    : emf_lm_psi_cache<float>(it, Pn, px[j], py[j], pz[j],
                                              i0 + j * EMF_LM_BLOCK, a[j], ok);
      nin += ok && w[j] > 0.0f;
    } else {
      psi = it.bf16 ? emf_lm_psi<emf_bf16>(it, Pn, px[j], py[j], pz[j])
                    : emf_lm_psi<float>(it, Pn, px[j], py[j], pz[j]);
    }
    acc += (double)(w[j] * psi * psi);
  }
  __shared__ double sh[EMF_LM_WARPS];
  acc = emf_warp_sum(acc);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = acc;
  if constexpr (CACHE) {
    // the counts: integers, exact in float64 in any order
    __shared__ double shn[3][EMF_LM_WARPS];
    const double c = emf_warp_sum((double)nin);
    double r = 0.0, b = 0.0;
    if (drift) {  // the item's flag: uniform across the block
      r = emf_warp_sum((double)nrel);
      b = emf_warp_sum((double)nbad);
    }
    if ((threadIdx.x & 31) == 0) {
      shn[0][threadIdx.x >> 5] = c;
      shn[1][threadIdx.x >> 5] = r;
      shn[2][threadIdx.x >> 5] = b;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double v[3] = {0.0, 0.0, 0.0};
      for (int q = 0; q < EMF_LM_WARPS; ++q)
        for (int m = 0; m < 3; ++m) v[m] += shn[m][q];
      double* row = B.part + (size_t)s * EMF_LM_PART;
      row[EMF_LM_P_INWIN] = v[0];
      if (drift) {
        row[EMF_LM_P_NREL] = v[1];
        row[EMF_LM_P_NBAD] = v[2];
      }
    }
  } else {
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    double v = 0.0;
    for (int q = 0; q < EMF_LM_WARPS; ++q) v += sh[q];
    B.part[(size_t)s * EMF_LM_PART + EMF_LM_P_TRIAL] = v;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------
// The split kernels (the pixel-sharded LM), one block a span.

// emf_lm_system phase 0: the per-point values and wmax.
__global__ void __launch_bounds__(EMF_LM_BLOCK)
    emf_lm_gather_kernel(const __grid_constant__ EmfLmTable T,
                         const EmfLmBufs B, const EmfLmCfg C) {
  int s0;
  const int k = emf_lm_item(T, blockIdx.x, s0);
  if (!emf_lm_evals(B, C, k)) return;
  const int nb = T.span_end[k] - s0;
  emf_lm_gather_span<false>(T.items[k], emf_lm_pose(B, k, SF_R), B, C,
                            blockIdx.x, blockIdx.x - s0);
  if (emf_lm_last(B.count + k, nb) && threadIdx.x < 32) {
    const double v = emf_lm_rows<true>(B.part, s0, nb, EMF_LM_P_MAX);
    if (threadIdx.x == 0) {
      B.wmax[k] = (float)v;
      B.count[k] = 0;
    }
  }
}

// emf_lm_system phase 1: w, J and the float64 sums of the system.
__global__ void __launch_bounds__(EMF_LM_BLOCK)
    emf_lm_terms_kernel(const __grid_constant__ EmfLmTable T,
                        const EmfLmBufs B, const EmfLmCfg C) {
  int s0;
  const int k = emf_lm_item(T, blockIdx.x, s0);
  if (!emf_lm_evals(B, C, k)) return;
  const int nb = T.span_end[k] - s0;
  emf_lm_terms_span(T.items[k], emf_lm_pose(B, k, SF_R), B, B.wmax[k],
                    blockIdx.x, blockIdx.x - s0);
  if (emf_lm_last(B.count + k, nb)) {
    emf_lm_sums(B, k, s0, nb);
    if (threadIdx.x == 0) B.count[k] = 0;
  }
}

// emf_lm_trial: sum w psi^2 at the trial pose.
__global__ void __launch_bounds__(EMF_LM_BLOCK)
    emf_lm_trial_kernel(const __grid_constant__ EmfLmTable T,
                        const EmfLmBufs B, const EmfLmCfg C) {
  int s0;
  const int k = emf_lm_item(T, blockIdx.x, s0);
  if (!emf_lm_si(B, k, SI_TRIAL)) return;
  const int nb = T.span_end[k] - s0;
  emf_lm_trial_span<false>(T.items[k], emf_lm_pose(B, k, SF_RN), B,
                           blockIdx.x, blockIdx.x - s0, false);
  if (emf_lm_last(B.count + k, nb) && threadIdx.x < 32) {
    const double v = emf_lm_rows<false>(B.part, s0, nb, EMF_LM_P_TRIAL);
    if (threadIdx.x == 0) {
      B.trial[k] = v;
      B.count[k] = 0;
    }
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

__device__ __forceinline__ void emf_se3_exp(const float* xi, float* R,
                                            float* t) {
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

__device__ __forceinline__ void emf_so3_log(const float* R, float* w) {
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

__device__ __forceinline__ void emf_se3_log(const float* R, const float* t,
                                            float* xi) {
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
// first largest pivot), then back substitution. Every index is known at
// compile time (the pivot row is swapped in by a comparison with each
// candidate), so the matrix stays in registers.
__device__ __forceinline__ void emf_solve6(const float* A, float mu0,
                                           const float* b, float* x) {
  float M[6][7];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = 0; c < 6; ++c) M[r][c] = A[6 * r + c];
    M[r][r] = A[6 * r + r] + mu0;
    M[r][6] = b[r];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int p = c;
    float best = fabsf(M[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(M[r][c]) > best) {
        best = fabsf(M[r][c]);
        p = r;
      }
#pragma unroll
    for (int r = c + 1; r < 6; ++r)
      if (r == p)
#pragma unroll
        for (int j = 0; j < 7; ++j) {
          const float tmp = M[c][j];
          M[c][j] = M[r][j];
          M[r][j] = tmp;
        }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float f = M[r][c] / M[c][c];
#pragma unroll
      for (int j = c + 1; j < 7; ++j) M[r][j] = M[r][j] - f * M[c][j];
    }
  }
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    float s = M[r][6];
#pragma unroll
    for (int j = r + 1; j < 6; ++j) s = s - M[r][j] * x[j];
    x[r] = s / M[r][r];
  }
}

// The step of item k, run by one thread. Propose: after an evaluation
// (A, b, err) rounded from the sums and the gradient test; then mu0, the
// solve, the step test and the trial pose. The record's words are read
// into registers first and the results written at the end. CACHE: a trial
// that waited for a re-capture (SI_PEND) is left as it is, for (d).
template <bool CACHE>
__device__ void emf_lm_propose(const EmfLmBufs& B, const EmfLmCfg& C,
                               int k) {
  int* s = B.si + k * SI_N;
  float* f = B.sf + k * SF_N;
  if constexpr (CACHE)
    if (s[SI_PEND]) return;
  const int it = s[SI_IT], conv = s[SI_CONV], eval = s[SI_EVAL],
            first = s[SI_FIRST];
  s[SI_TRIAL] = 0;
  s[SI_RAN] = it < C.max_iter && !conv;
  if (!(it < C.max_iter && !conv)) return;
  float A[36], b[6], P[12];
  const float mu = f[SF_MU];
#pragma unroll
  for (int q = 0; q < 12; ++q) P[q] = f[SF_R + q];
  if (eval) {
    const double* q = B.sys + k * EMF_LM_NSUM;
    int m = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int c = a; c < 6; ++c) {
        const float v = (float)q[m++];
        A[6 * a + c] = v;
        A[6 * c + a] = v;
      }
    float g = 0.0f;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      b[a] = (float)q[21 + a];
      g = fmaxf(g, fabsf(b[a]));
    }
#pragma unroll
    for (int q2 = 0; q2 < 36; ++q2) f[SF_A + q2] = A[q2];
#pragma unroll
    for (int a = 0; a < 6; ++a) f[SF_B + a] = b[a];
    f[SF_ERR] = (float)q[27];
    if (g < C.eps1) {
      s[SI_CONV] = 1;
      return;
    }
  } else {
#pragma unroll
    for (int q2 = 0; q2 < 36; ++q2) A[q2] = f[SF_A + q2];
#pragma unroll
    for (int a = 0; a < 6; ++a) b[a] = f[SF_B + a];
  }
  float mu0 = mu;
  if (first) {
    float d = A[0];
#pragma unroll
    for (int a = 1; a < 6; ++a) d = fmaxf(d, A[7 * a]);
    mu0 = C.tau * d;
  }
  float x[6];
  emf_solve6(A, mu0, b, x);
  float rel[6];
  emf_se3_log(P, P + 9, rel);
  s[SI_FIRST] = 0;
  if (emf_norm6(x) < C.eps2 * (emf_norm6(rel) + C.eps2)) {
    f[SF_MU] = mu0;
    s[SI_CONV] = 1;
    return;
  }
  float nx[6], dR[9], dt[3], Rn[9];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    nx[a] = -x[a];
    f[SF_X + a] = x[a];
  }
  emf_se3_exp(nx, dR, dt);
  emf_mm3(dR, P, Rn);
#pragma unroll
  for (int q2 = 0; q2 < 9; ++q2) f[SF_RN + q2] = Rn[q2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    f[SF_TN + i] = dR[3 * i] * P[9] + dR[3 * i + 1] * P[10] +
                   dR[3 * i + 2] * P[11] + dt[i];
  f[SF_MU0] = mu0;
  s[SI_TRIAL] = 1;
}

// Decide: it += 1 where the LM ran; for a trial, rho, accept or reject,
// the damping and eval_grad. CACHE: a cache item's trial whose count of
// weighted points with a valid psi (SI_NIN) is 0 is rejected; a trial that
// tested its drift (re-captures left, not itself a re-captured trial) and
// failed it (drift_within) is not decided but flagged for a re-capture at
// its trial pose (SI_PEND, SI_RECAP; no gradient to evaluate on resuming).
template <bool CACHE>
__device__ void emf_lm_decide(const EmfLmBufs& B, const EmfLmCfg& C,
                              int k) {
  int* s = B.si + k * SI_N;
  float* f = B.sf + k * SF_N;
  if (!s[SI_RAN]) return;
  if constexpr (CACHE) {
    if (s[SI_TRIAL] && !s[SI_PEND] && s[SI_RECAP] < C.recaps &&
        !((float)s[SI_NBAD] <=
          EMF_DRIFT_TOL * fmaxf((float)s[SI_NREL], 1.0f))) {
      s[SI_PEND] = 1;
      s[SI_RECAP] += 1;
      s[SI_EVAL] = 0;
      return;
    }
    s[SI_PEND] = 0;
  }
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
  bool accept = rho > 0.0f;
  if constexpr (CACHE) accept = accept && s[SI_NIN] > 0;
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

// emf_lm_step (the split kernels): one block an item, its first thread
// working; phase 0 proposes, 1 decides.
__global__ void emf_lm_step_kernel(const EmfLmBufs B, const EmfLmCfg C,
                                   int phase) {
  if (threadIdx.x != 0) return;
  if (phase == 0)
    emf_lm_propose<false>(B, C, blockIdx.x);
  else
    emf_lm_decide<false>(B, C, blockIdx.x);
}

// ---------------------------------------------------------------------
// A cache item tests its drift in (d) while it has re-captures left and
// is not a re-captured trial (the condition decide reads again).
__device__ __forceinline__ bool emf_lm_drifts(const EmfLmBufs& B,
                                              const EmfLmCfg& C, int k) {
  return !emf_lm_si(B, k, SI_PEND) && emf_lm_si(B, k, SI_RECAP) < C.recaps;
}

// A cache item's decide. Its LM leaves its kernel's loop once it stops,
// before a later propose would clear its SI_RAN, so an LM that stopped
// here has it cleared now (tracking.lm_step_plain does the same).
__device__ void emf_lm_decide_cache(const EmfLmBufs& B, const EmfLmCfg& C,
                                    int k) {
  emf_lm_decide<true>(B, C, k);
  int* st = B.si + k * SI_N;
  if (!(st[SI_IT] < C.max_iter && !st[SI_CONV])) st[SI_RAN] = 0;
}

// A record's words 4-7 (SI_TRIAL, SI_RAN, SI_NIN, SI_PEND).
__device__ __forceinline__ int4 emf_lm_head2(const EmfLmBufs& B, int k) {
  return __ldcg(reinterpret_cast<const int4*>(B.si + k * SI_N) + 1);
}

// A cache item's LM runs this iteration (h, h2: its record's words 0-3
// and 4-7): it has not stopped and, after the launch's first iteration,
// is not flagged for a re-capture (the host captures its windows once
// the launch has ended).
__device__ __forceinline__ bool emf_lm_stays(int4 h, int4 h2,
                                             const EmfLmCfg& C, int iter) {
  return h.x < C.max_iter && !h.y && !(iter > 0 && h2.w);
}

// emf_lm_run: up to `iters` iterations of every LM of the table in one
// cooperative launch (see the top of the file). An item's lead block is
// the block that holds its first span.
__device__ __forceinline__ bool emf_lm_lead(const EmfLmTable& T, int k) {
  return (k ? T.span_end[k - 1] : 0) % gridDim.x == blockIdx.x;
}

// CACHE: a table of cache items with an item of more spans than a
// cluster holds blocks (emf_lm_cluster runs the others); the two
// instantiations differ in phases (a) and (d), in the cache items' drift
// test and re-capture flag, and in each cache LM leaving on its own
// (on[k], from the loop's top: a left LM skips every phase).
template <bool CACHE>
__global__ void __launch_bounds__(EMF_LM_BLOCK, 2)
    emf_lm_run_kernel(const __grid_constant__ EmfLmTable T,
                      const EmfLmBufs B, const EmfLmCfg C, int iters) {
  cg::grid_group grid = cg::this_grid();
  const int S = T.n, NS = T.span_end[S - 1], G = gridDim.x;
  const int warp = threadIdx.x >> 5;
  __shared__ float wm[EMF_MAX_ITEMS];
  [[maybe_unused]] __shared__ bool on[EMF_MAX_ITEMS];
  for (int iter = 0; iter < iters; ++iter) {
    bool any = false;
    for (int k = 0; k < S; ++k) {
      if constexpr (CACHE) {
        const bool run =
            emf_lm_stays(emf_lm_head(B, k), emf_lm_head2(B, k), C, iter);
        if (threadIdx.x == 0) on[k] = run;
        any = any || run;
      } else {
        any = any || emf_lm_running(B, C, k);
      }
    }
    if (!any) break;  // every block read the same records: all leave
    if constexpr (CACHE) __syncthreads();
    // (a) gather (a span's pose is loaded beside its item's flags)
    for (int s = blockIdx.x; s < NS; s += G) {
      int s0;
      const int k = emf_lm_item(T, s, s0);
      const EmfPose P = emf_lm_pose(B, k, SF_R);
      if (emf_lm_evals(B, C, k))
        emf_lm_gather_span<CACHE>(T.items[k], P, B, C, s, s - s0);
    }
    grid.sync();
    // (b) every item's weight maximum (a warp an item), then the terms
    for (int k = warp; k < S; k += EMF_LM_WARPS) {
      if (!emf_lm_evals(B, C, k)) continue;
      const int s0 = k ? T.span_end[k - 1] : 0;
      const double v =
          emf_lm_rows<true>(B.part, s0, T.span_end[k] - s0, EMF_LM_P_MAX);
      if ((threadIdx.x & 31) == 0) {
        wm[k] = (float)v;
        if (emf_lm_lead(T, k)) B.wmax[k] = (float)v;
      }
    }
    __syncthreads();
    for (int s = blockIdx.x; s < NS; s += G) {
      int s0;
      const int k = emf_lm_item(T, s, s0);
      const EmfPose P = emf_lm_pose(B, k, SF_R);
      if (emf_lm_evals(B, C, k))
        emf_lm_terms_span(T.items[k], P, B, wm[k], s, s - s0);
    }
    grid.sync();
    // (c) propose, in each item's lead block
    for (int k = 0; k < S; ++k) {
      if (!emf_lm_lead(T, k)) continue;
      if constexpr (CACHE)
        if (!on[k]) continue;
      const bool ev = emf_lm_evals(B, C, k);
      __syncthreads();  // every thread has read the record it changes
      if (ev) {
        const int s0 = k ? T.span_end[k - 1] : 0;
        emf_lm_sums(B, k, s0, T.span_end[k] - s0);
      }
      if (threadIdx.x == 0) emf_lm_propose<CACHE>(B, C, k);
      __syncthreads();
    }
    grid.sync();
    // (d) trial
    for (int s = blockIdx.x; s < NS; s += G) {
      int s0;
      const int k = emf_lm_item(T, s, s0);
      const EmfPose P = emf_lm_pose(B, k, SF_RN);
      if constexpr (CACHE) {
        if (on[k] && emf_lm_si(B, k, SI_TRIAL))
          emf_lm_trial_span<true>(T.items[k], P, B, s, s - s0,
                                  emf_lm_drifts(B, C, k));
      } else {
        if (emf_lm_si(B, k, SI_TRIAL))
          emf_lm_trial_span<false>(T.items[k], P, B, s, s - s0, false);
      }
    }
    grid.sync();
    // (e) decide, in each item's lead block
    for (int k = 0; k < S; ++k) {
      if (!emf_lm_lead(T, k)) continue;
      if constexpr (CACHE)
        if (!on[k]) continue;
      if (warp == 0 && emf_lm_si(B, k, SI_TRIAL)) {
        const int s0 = k ? T.span_end[k - 1] : 0;
        const double v = emf_lm_rows<false>(B.part, s0, T.span_end[k] - s0,
                                            EMF_LM_P_TRIAL);
        if (threadIdx.x == 0) B.trial[k] = v;
        if constexpr (CACHE) {
          const int nr = T.span_end[k] - s0;
          const double c = emf_lm_rows<false>(B.part, s0, nr, EMF_LM_P_INWIN);
          if (threadIdx.x == 0) B.si[k * SI_N + SI_NIN] = (int)c;
          if (emf_lm_drifts(B, C, k)) {
            const double r = emf_lm_rows<false>(B.part, s0, nr, EMF_LM_P_NREL);
            const double b = emf_lm_rows<false>(B.part, s0, nr, EMF_LM_P_NBAD);
            if (threadIdx.x == 0) {
              B.si[k * SI_N + SI_NREL] = (int)r;
              B.si[k * SI_N + SI_NBAD] = (int)b;
            }
          }
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        if constexpr (CACHE)
          emf_lm_decide_cache(B, C, k);
        else
          emf_lm_decide<false>(B, C, k);
      }
      __syncthreads();
    }
    grid.sync();
  }
}

// emf_lm_cluster: up to `iters` iterations of every LM of a table of
// cache items, one thread-block cluster an LM (see the top of the file).
// Cluster k runs item k; its block r takes the item's span r (a cluster
// has the table's most spans of an item as blocks), and its block 0 (the
// lead) proposes and decides. A cluster leaves its loop on its own item's
// record, read by all its blocks after (e)'s barrier.
__global__ void __launch_bounds__(EMF_LM_BLOCK, 2)
    emf_lm_cluster_kernel(const __grid_constant__ EmfLmTable T,
                          const EmfLmBufs B, const EmfLmCfg C, int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int k = (int)blockIdx.x / c;
  const int s0 = k ? T.span_end[k - 1] : 0, ns = T.span_end[k] - s0;
  const EmfLmItem& it = T.items[k];
  const bool lead = r == 0;
  __shared__ float wm;
  for (int iter = 0; iter < iters; ++iter) {
    // the record's words 0-7 and the pose, their loads in flight together
    const int4 h = emf_lm_head(B, k), h2 = emf_lm_head2(B, k);
    const EmfPose P = emf_lm_pose(B, k, SF_R);
    if (!emf_lm_stays(h, h2, C, iter))
      break;  // every block of the cluster read the same record
    const bool ev = h.z != 0;
    // (a) gather
    if (ev) {
      if (r < ns)
        emf_lm_gather_span<true>(it, P, B, C, s0 + r, r);
    }
    cluster.sync();
    // (b) the item's weight maximum, then the terms
    if (ev) {
      if (threadIdx.x < 32) {
        const double v = emf_lm_rows<true>(B.part, s0, ns, EMF_LM_P_MAX);
        if (threadIdx.x == 0) {
          wm = (float)v;
          if (lead) B.wmax[k] = (float)v;
        }
      }
      __syncthreads();
      if (r < ns)
        emf_lm_terms_span(it, P, B, wm, s0 + r, r);
    }
    cluster.sync();
    // (c) propose, in the lead block
    if (lead) {
      if (ev) emf_lm_sums(B, k, s0, ns);
      if (threadIdx.x == 0) emf_lm_propose<true>(B, C, k);
    }
    cluster.sync();
    // (d) trial (the flags and the trial pose loaded together)
    {
      const bool trial = emf_lm_si(B, k, SI_TRIAL);
      const bool drift = emf_lm_drifts(B, C, k);
      const EmfPose Pn = emf_lm_pose(B, k, SF_RN);
      if (trial)
        if (r < ns)
          emf_lm_trial_span<true>(it, Pn, B, s0 + r, r, drift);
    }
    cluster.sync();
    // (e) decide, in the lead block
    if (lead) {
      if (threadIdx.x < 32 && emf_lm_si(B, k, SI_TRIAL)) {
        const double v = emf_lm_rows<false>(B.part, s0, ns, EMF_LM_P_TRIAL);
        const double n = emf_lm_rows<false>(B.part, s0, ns, EMF_LM_P_INWIN);
        if (threadIdx.x == 0) {
          B.trial[k] = v;
          B.si[k * SI_N + SI_NIN] = (int)n;
        }
        if (emf_lm_drifts(B, C, k)) {
          const double nr = emf_lm_rows<false>(B.part, s0, ns, EMF_LM_P_NREL);
          const double nb = emf_lm_rows<false>(B.part, s0, ns, EMF_LM_P_NBAD);
          if (threadIdx.x == 0) {
            B.si[k * SI_N + SI_NREL] = (int)nr;
            B.si[k * SI_N + SI_NBAD] = (int)nb;
          }
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) emf_lm_decide_cache(B, C, k);
    }
    cluster.sync();
  }
}

// ---------------------------------------------------------------------
extern "C" int emf_max_items() { return EMF_MAX_ITEMS; }

// The spans of an item of n points: max(1, ceil(n / EMF_LM_SPAN)); the
// host sizes the span partials (EmfLmBufs.part) from it.
extern "C" int emf_lm_spans(int n) {
  return n > EMF_LM_SPAN ? (n + EMF_LM_SPAN - 1) / EMF_LM_SPAN : 1;
}

// The launch's table and span count (emf_lm_spans an item); `cache`
// says whether its items are cache items. A table of both kinds is
// refused.
static int emf_lm_table(const EmfLmItem* items, int n, EmfLmTable& T,
                        long long& spans, bool& cache) {
  if (n < 1 || n > EMF_MAX_ITEMS) return (int)cudaErrorInvalidValue;
  T.n = n;
  spans = 0;
  cache = items[0].cached != 0;
  for (int k = 0; k < EMF_MAX_ITEMS; ++k) {
    if (k < n) {
      if (items[k].n < 0 || (items[k].cached != 0) != cache)
        return (int)cudaErrorInvalidValue;
      T.items[k] = items[k];
      spans += emf_lm_spans(items[k].n);
    } else {
      T.items[k] = EmfLmItem{};
    }
    T.span_end[k] = (int)spans;
  }
  return 0;
}

// phase 0: the per-point values and wmax; 1: w and the sums. Returns a
// cudaError_t; a table of cache items is refused.
extern "C" int emf_lm_system(const EmfLmItem* items, int n, int phase,
                             const EmfLmBufs* B, const EmfLmCfg* C,
                             void* stream) {
  EmfLmTable T;
  long long spans;
  bool cache;
  const int e = emf_lm_table(items, n, T, spans, cache);
  if (e) return e;
  if (cache) return (int)cudaErrorInvalidValue;
  if (phase == 0)
    emf_lm_gather_kernel<<<(unsigned)spans, EMF_LM_BLOCK, 0,
                           (cudaStream_t)stream>>>(T, *B, *C);
  else
    emf_lm_terms_kernel<<<(unsigned)spans, EMF_LM_BLOCK, 0,
                          (cudaStream_t)stream>>>(T, *B, *C);
  return (int)cudaGetLastError();
}

extern "C" int emf_lm_trial(const EmfLmItem* items, int n,
                            const EmfLmBufs* B, const EmfLmCfg* C,
                            void* stream) {
  EmfLmTable T;
  long long spans;
  bool cache;
  const int e = emf_lm_table(items, n, T, spans, cache);
  if (e) return e;
  if (cache) return (int)cudaErrorInvalidValue;
  emf_lm_trial_kernel<<<(unsigned)spans, EMF_LM_BLOCK, 0,
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

// The blocks of an emf_lm_cluster cluster for a table of cache items
// whose largest item has `spans` spans: that many (a block a span), or 0
// if that is more than EMF_LM_CLUSTER_MAX (a cluster's most blocks;
// emf_lm_run then runs the table, a block a span of every item).
extern "C" int emf_lm_cluster_size(int spans) {
  return spans <= EMF_LM_CLUSTER_MAX ? (spans < 1 ? 1 : spans) : 0;
}

// The most spans of an item of the table.
static int emf_lm_most_spans(const EmfLmItem* items, int n) {
  int most = 0;
  for (int k = 0; k < n; ++k) {
    const int m = emf_lm_spans(items[k].n);
    most = m > most ? m : most;
  }
  return most;
}

// The blocks of emf_lm_run that device `dev` holds at once (its
// occupancy times its SMs) for a table of gather items (cache 0) or of
// cache items (cache 1), read once a device and kind; 0 if a query fails.
// The occupancy query reads the current device, so it runs with `dev`
// made current and the caller's device restored.
extern "C" int emf_lm_run_blocks(int dev, int cache) {
  static int cap[64][2];  // by device ordinal and kind; 0: not read yet
  if (dev < 0 || dev >= 64) return 0;
  const int kind = cache ? 1 : 0;
  if (!cap[dev][kind]) {
    int prev = 0, per_sm = 0, sms = 0;
    if (cudaGetDevice(&prev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
      return 0;
    const bool ok =
        (kind ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, emf_lm_run_kernel<true>, EMF_LM_BLOCK, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, emf_lm_run_kernel<false>, EMF_LM_BLOCK, 0)) ==
            cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess;
    if (cudaSetDevice(prev) != cudaSuccess || !ok) return 0;
    cap[dev][kind] = per_sm * sms;
  }
  return cap[dev][kind];
}

// `iters` LM iterations of the table in one cooperative launch of `grid`
// blocks (1 .. emf_lm_run_blocks(dev, cache); the host passes min(spans,
// that)) of the instantiation for the table's kind of item on the
// current device, which the caller has made the tables' device. Returns
// a cudaError_t: a grid the device cannot hold at once is refused, and
// so is a table of cache items that fits a cluster (emf_lm_cluster_size
// above 0: emf_lm_cluster runs it).
extern "C" int emf_lm_run(const EmfLmItem* items, int n, int iters,
                          const EmfLmBufs* B, const EmfLmCfg* C, int grid,
                          void* stream) {
  EmfLmTable T;
  long long spans;
  bool cache;
  const int e = emf_lm_table(items, n, T, spans, cache);
  if (e) return e;
  if (iters < 1 || grid < 1 ||
      (cache && emf_lm_cluster_size(emf_lm_most_spans(items, n)) > 0))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return (int)got;
  if (grid > emf_lm_run_blocks(dev, cache))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  EmfLmBufs b = *B;
  EmfLmCfg c = *C;
  void* args[] = {&T, &b, &c, &iters};
  const void* fn = cache ? (const void*)emf_lm_run_kernel<true>
                         : (const void*)emf_lm_run_kernel<false>;
  return (int)cudaLaunchCooperativeKernel(
      fn, dim3((unsigned)grid), dim3(EMF_LM_BLOCK), args, 0,
      (cudaStream_t)stream);
}

// The launch configuration of emf_lm_cluster: `clusters` clusters of `c`
// blocks; `attr` holds its cluster dimension.
static cudaLaunchConfig_t emf_lm_cluster_config(int clusters, int c,
                                                cudaLaunchAttribute* attr,
                                                void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * c));
  cfg.blockDim = dim3(EMF_LM_BLOCK);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of `c` blocks (1 .. EMF_LM_CLUSTER_MAX) of emf_lm_cluster
// that device `dev` holds at once (cudaOccupancyMaxActiveClusters, with
// the kernel's non-portable sizes, above 8, allowed first), read once a
// device and size; 0 if none fits or a query fails. Queried with `dev`
// made current and the caller's device restored.
static int emf_lm_cluster_fit(int dev, int c) {
  static int fit[64][EMF_LM_CLUSTER_MAX + 1];  // 0: not read yet
  if (dev < 0 || dev >= 64 || c < 1 || c > EMF_LM_CLUSTER_MAX) return 0;
  if (!fit[dev][c]) {
    int prev = 0, got = 0;
    if (cudaGetDevice(&prev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
      return 0;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = emf_lm_cluster_config(1, c, &attr, 0);
    const void* fn = (const void*)emf_lm_cluster_kernel;
    const bool ok =
        cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) == cudaSuccess &&
        cudaOccupancyMaxActiveClusters(&got, fn, &cfg) == cudaSuccess;
    if (cudaSetDevice(prev) != cudaSuccess || !ok) return 0;
    fit[dev][c] = got;
  }
  return fit[dev][c];
}

// `iters` LM iterations of a table of cache items on the current device
// (the caller has made it the tables' device): one cluster of
// emf_lm_cluster_size(the largest item's spans) blocks an item, launched
// with cudaLaunchKernelExC. Returns a cudaError_t: a table of gather
// items is refused, and so are a table with an item of more spans than
// a cluster holds blocks (emf_lm_run runs it) and a cluster the device
// cannot hold (emf_lm_cluster_fit 0).
extern "C" int emf_lm_cluster(const EmfLmItem* items, int n, int iters,
                              const EmfLmBufs* B, const EmfLmCfg* C,
                              void* stream) {
  EmfLmTable T;
  long long spans;
  bool cache;
  const int e = emf_lm_table(items, n, T, spans, cache);
  if (e) return e;
  const int c = emf_lm_cluster_size(emf_lm_most_spans(items, n));
  if (!cache || iters < 1 || c < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return (int)got;
  if (emf_lm_cluster_fit(dev, c) < 1)
    return (int)cudaErrorLaunchOutOfResources;
  EmfLmBufs b = *B;
  EmfLmCfg cf = *C;
  void* args[] = {&T, &b, &cf, &iters};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = emf_lm_cluster_config(n, c, &attr, stream);
  return (int)cudaLaunchKernelExC(&cfg, (const void*)emf_lm_cluster_kernel,
                                  args);
}
