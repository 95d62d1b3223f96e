"""The batched object LM as tables of cache items (``tracking.
track_volumes_batched``: per stage one capture, one ``lm_run`` over the
slots' window caches and one read) against the JAX package on the CPU,
where ``lm_run`` runs the plain iteration: the cache phase's per-point
values (``tracking.lm_system_plain`` and ``lm_trial_plain`` on a cache
item) against the JAX package's ``sample_system_from_cache`` /
``sample_value_from_cache``, from a float32 and a bf16 cache, and the
whole two-stage LM against JAX ``track_volumes_batched``.

``lm.cu``'s cache phase itself (its per-point code, which the card runs)
is compiled here as host C++ with stub CUDA headers and
``-ffp-contract=off`` (no fused multiply-adds, as ``nvcc --fmad=false``)
and held against the plain versions bit for bit, and the ctypes mirror of
its item against the C struct.

The scene is analytic: a 32^3 TSDF at 1 cm of a sphere joined to a box
(so no rotation is unobservable), observed weights where the signed
distance exceeds minus the truncation, and 1,000 points on the union's
surface facing a camera half a metre in front of it. Tolerances are
those of ``tests/test_torch_batched_lm.py``: the port sums its systems in
float64 and JAX in float32, so the iterates differ in the last bits.
"""

import ctypes
import os
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.geometry import se3 as jse3
from emfusion_tpu.geometry.capture import (
    sample_system_from_cache as jax_system_from_cache,
)
from emfusion_tpu.geometry.capture import (
    sample_value_from_cache as jax_value_from_cache,
)
from emfusion_tpu.tracking import TrackConfig as JaxTrackConfig
from emfusion_tpu.tracking import track_volumes_batched as jax_batched
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch import tracking as tr
from emfusion_tpu_torch.geometry.capture import (
    capture_neighborhoods_plain, drift_counts, out_of_window_count,
)
from emfusion_tpu_torch.tracking import TrackConfig, track_volumes_batched
from test_torch_batched_lm import angle

torch.set_num_threads(2)

RES, VS, TRUNC = 32, 0.01, 0.03
SPHERE = (np.array([0.03, -0.01, 0.0]), 0.07)
BOX = (np.array([-0.05, 0.03, 0.0]), np.array([0.04, 0.03, 0.05]))
CAM_Z = -0.5        # the camera's z in the volume frame
MAX_ITER = 60       # stages of 30
# The whole LMs stop on the step test at 1e-6 (the default 1e-8 is met
# only once rejected steps have driven the damping up at the float32
# noise floor, where the port's float64 sums and the JAX package's float32
# sums reject different steps: this scene's far slot then stops 9
# iterations apart); at 1e-6 the steps still shrink geometrically there.
EPS2 = 1e-6


def union_sdf(p):
    """The signed distance of (3, ...) volume-frame points to the sphere
    joined to the box."""
    c, r = SPHERE
    s1 = np.linalg.norm(p - c.reshape((3,) + (1,) * (p.ndim - 1)),
                        axis=0) - r
    centre, half = BOX
    shape = (3,) + (1,) * (p.ndim - 1)
    q = np.abs(p - centre.reshape(shape)) - half.reshape(shape)
    s2 = np.linalg.norm(np.maximum(q, 0), axis=0) + np.minimum(q.max(0), 0)
    return np.minimum(s1, s2)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def make_scene():
    """The volumes, the camera points, the association weights and the
    true camera-to-volume transform."""
    c = (np.arange(RES) - (RES - 1) / 2) * VS
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    sdf = union_sdf(np.stack([x, y, z]))
    tsdf = np.clip(sdf / TRUNC, -1, 1).astype(np.float32)
    wts = np.where(sdf > -TRUNC, 12.0, 0.0).astype(np.float32)
    rng = np.random.RandomState(1)
    n = rng.normal(size=(3, 4000))
    n /= np.linalg.norm(n, axis=0)
    n = n[:, n[2] < -0.25]
    on_sphere = SPHERE[0][:, None] + SPHERE[1] * n
    u, v = rng.uniform(-1, 1, (2, 1500))
    (bx, by, bz), (hx, hy, hz) = BOX
    on_box = np.stack([bx + hx * u, by + hy * v, np.full_like(u, bz - hz)])
    pv = np.concatenate([on_sphere, on_box], 1)
    pv = pv[:, np.abs(union_sdf(pv)) < 1e-6]      # the union's surface
    pv = pv[:, rng.permutation(pv.shape[1])[:1000]]
    pts = np.ascontiguousarray(pv - np.array([0.0, 0.0, CAM_Z])[:, None],
                               np.float32)
    truth = np.eye(4, dtype=np.float32)
    truth[2, 3] = CAM_Z
    assoc = rng.uniform(0.5, 1.0, pts.shape[1]).astype(np.float32)
    return dict(tsdf=tsdf, wts=wts, pts=pts, assoc=assoc, truth=truth)


def moved(scene, xi):
    """The true transform moved by the twist ``xi`` (translation in
    voxels, rotation in radians)."""
    xi = np.asarray(xi, np.float32) * np.array([VS] * 3 + [1] * 3,
                                               np.float32)
    return (np.asarray(jse3.se3_exp(jnp.asarray(xi))) @ scene["truth"]
            ).astype(np.float32)


# slot 1 starts 3.2 voxels off: more than half its points leave the
# windows captured there before the LM reaches the surface
START_NEAR = [1.0, -0.6, 0.4, 0.02, -0.02, 0.01]
START_FAR = [2.6, 1.5, -1.0, 0.03, 0.02, -0.03]


def cache_item(scene, dtype, start, at):
    """A one-item table of a cache item captured at ``start`` (volumes
    in ``dtype``), its state's pose set to ``at``; the cache and anchors
    as numpy arrays."""
    vols = [torch.tensor(scene[k]).to(dtype) for k in ("tsdf", "wts")]
    pts = torch.tensor(scene["pts"])
    cache, anchor = capture_neighborhoods_plain(
        vols, pts, torch.tensor(start[:3, :3]), torch.tensor(start[:3, 3]),
        VS)
    assert cache.dtype == dtype
    item = tr.LMItem(vols[0], vols[1], VS, pts, torch.tensor(scene["assoc"]),
                     torch.tensor(start), cache=cache, anchor=anchor)
    run = tr.LMRun([item], TrackConfig())
    run.sf[0, tr.SF_R:tr.SF_R + 9] = torch.tensor(at[:3, :3]).reshape(9)
    run.sf[0, tr.SF_T:tr.SF_T + 3] = torch.tensor(at[:3, 3])
    run.sf[0, tr.SF_RN:tr.SF_RN + 9] = torch.tensor(at[:3, :3]).reshape(9)
    run.sf[0, tr.SF_TN:tr.SF_TN + 3] = torch.tensor(at[:3, 3])
    return run, cache.float().numpy(), anchor.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_phase_matches_jax_samplers(scene, dtype):
    """``lm_system_plain`` and ``lm_trial_plain`` on a cache item, its
    windows captured at the far start and evaluated at the true pose
    (where part of the points have left them): per point ψ, the gradient,
    the clamped margin-1 weight and the Huber weight against the JAX
    package's cache samplers within 1e-6, and the trial error
    ``sum(w ψ^2)`` at that pose against JAX's within 1e-6 relative; from
    a float32 cache and from a bf16 one (the JAX samplers given the same
    bf16 values)."""
    cfg = TrackConfig()
    start, at = moved(scene, START_FAR), scene["truth"]
    run, cache, anchor = cache_item(scene, dtype, start, at)
    before = dict(kernels.launches)
    tr.lm_system_plain(run, cfg)
    assert kernels.launches == before
    jcache = jnp.asarray(cache).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    args = (jnp.asarray(anchor), jnp.asarray(scene["pts"]),
            jnp.asarray(at[:3, :3]), jnp.asarray(at[:3, 3]), VS,
            scene["tsdf"].shape)
    psi, g3 = jax_system_from_cache(jcache[0], *args)
    intw = np.minimum(np.asarray(jax_value_from_cache(
        jcache[1:2], *args, margin=1))[0], cfg.max_tsdf_weight)
    psi = np.asarray(psi)
    a = np.abs(psi)
    hub = np.where(a > 0, np.minimum(cfg.huber_thresh / np.maximum(a, 1e-30),
                                     1.0), 0.0)
    ref = np.stack([psi, *np.asarray(g3), intw])
    np.testing.assert_allclose(run.scratch.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(run.hub.numpy(), hub, rtol=0, atol=1e-6)
    out = out_of_window_count(torch.tensor(anchor), torch.tensor(
        scene["pts"]), torch.tensor(at[:3, :3]), torch.tensor(at[:3, 3]), VS,
        scene["tsdf"].shape)
    assert 0 < int(out) < len(psi)                 # partly out of windows
    assert np.count_nonzero(psi) > 100 and np.count_nonzero(intw) > 100
    # the trial error at the same pose, with the weights just formed
    w = np.asarray(run.hub) * np.where(intw.max() > 0, intw / intw.max(),
                                       0.0) * scene["assoc"]
    run.w.copy_(torch.tensor(w.astype(np.float32)))
    run.si[0, tr.SI_TRIAL] = 1
    tr.lm_trial_plain(run, cfg)
    psi_t = np.asarray(jax_value_from_cache(jcache[0:1], *args, margin=1))[0]
    want = float(np.sum(w.astype(np.float64) * psi_t * psi_t))
    assert abs(float(run.trial[0]) - want) <= 1e-6 * abs(want) and want > 0


def batched_args(scene):
    """Four slots of the scene: 0 starts near the truth and converges in
    stage 1, 1 starts far (its points drift out of the first windows; it
    runs into stage 2), 2 has no association weight (it converges at its
    first evaluation), 3 is inactive."""
    S = 4
    rels = np.stack([moved(scene, START_NEAR), moved(scene, START_FAR),
                     moved(scene, [0.5, 0, 0, 0.01, 0, 0]),
                     moved(scene, [0.2, 0, 0, 0, 0, 0])])
    assoc = np.stack([scene["assoc"]] * 2 + [np.zeros_like(scene["assoc"])]
                     + [scene["assoc"]])
    return ([np.stack([scene[k]] * S) for k in ("tsdf", "wts")]
            + [np.full(S, VS, np.float32), np.stack([scene["pts"]] * S),
               assoc, rels], np.array([True, True, True, False]))


@pytest.fixture(scope="module")
def batched(scene):
    args, active = batched_args(scene)
    ref, ref_st = jax_batched(*map(jnp.asarray, args),
                              JaxTrackConfig(max_iter=MAX_ITER, eps2=EPS2),
                              jnp.asarray(active))
    before = dict(kernels.launches)
    out, st = track_volumes_batched(*map(torch.tensor, args),
                                    TrackConfig(max_iter=MAX_ITER, eps2=EPS2),
                                    torch.tensor(active))
    assert kernels.launches == before          # the CPU: plain versions
    return dict(args=args, ref=np.asarray(ref),
                ref_st={k: np.asarray(v) for k, v in ref_st.items()},
                out=out.numpy(), st=st)


def test_batched_lm_matches_jax(batched):
    """Both packages' ``track_volumes_batched`` (``eps2`` 1e-6, 60
    iterations): final translations within 0.01 voxel and rotations
    within 1e-4 rad, the same converged flags and re-captures, iterations
    within 3, the last weights within 1e-5; the inactive slot keeps its
    pose with 0 iterations and zero weights."""
    out, ref, st, rs = (batched["out"], batched["ref"], batched["st"],
                        batched["ref_st"])
    for s in range(len(out)):
        assert np.linalg.norm(out[s, :3, 3] - ref[s, :3, 3]) < 0.01 * VS, s
        assert angle(out[s], ref[s]) < 1e-4, s
    np.testing.assert_array_equal(st["converged"].numpy(), rs["converged"])
    np.testing.assert_array_equal(st["recaptures"].numpy(), rs["recaptures"])
    it = st["iterations"].numpy()
    assert np.abs(it - rs["iterations"]).max() <= 3, (it, rs["iterations"])
    for key in ("track_weights", "huber_weights"):
        np.testing.assert_allclose(st[key].numpy(), rs[key], rtol=0,
                                   atol=1e-5)
    half = MAX_ITER // 2
    assert it[0] < half < it[1] and it[2] == 1 and it[3] == 0
    assert st["recaptures"].tolist() == [0, 1, 0, 0]
    assert st["converged"].tolist()[2:] == [True, True]
    np.testing.assert_array_equal(out[3], batched["args"][5][3])
    assert not st["track_weights"][2:].any()
    assert (st["huber_weights"][:2] != 0).sum(dim=1).min() > 300


def test_batched_lm_reads_twice(batched, scene):
    """Two stages that ran: two reads of the state (one a stage), and the
    iterations of the two tables (each its longest LM's) summed: stage 1
    ran to its budget (slot 1), stage 2 held slot 1 alone. Slot 1's
    points left its first windows (more than a tenth, not all of them);
    every slot's dropped points are counted at its final pose."""
    st, args = batched["st"], batched["args"]
    assert st["host_reads"] == 2
    it = st["iterations"].numpy()
    assert st["loop_iterations"] == it[1]
    rel = args[5][1]
    _, anchor = capture_neighborhoods_plain(
        [torch.tensor(scene["tsdf"]), torch.tensor(scene["wts"])],
        torch.tensor(scene["pts"]), torch.tensor(rel[:3, :3]),
        torch.tensor(rel[:3, 3]), VS)
    final = torch.tensor(batched["out"][1])
    left = int(out_of_window_count(anchor, torch.tensor(scene["pts"]),
                                   final[:3, :3], final[:3, 3], VS,
                                   scene["tsdf"].shape))
    assert 100 < left < 900, left
    dropped = st["dropped_points"]
    assert dropped.shape == (4,) and int(dropped[3]) == 0
    assert int(dropped.min()) >= 0


def test_batched_lm_one_stage_one_read(scene):
    """Slots that all converge in stage 1 (no association weight, and an
    inactive one): one read, no second capture or table; no active slot:
    no read at all, the poses kept."""
    args, active = batched_args(scene)
    args[4][:] = 0.0
    t_args = list(map(torch.tensor, args))
    out, st = track_volumes_batched(*t_args, TrackConfig(max_iter=MAX_ITER),
                                    torch.tensor(active))
    assert st["host_reads"] == 1 and st["loop_iterations"] == 1
    assert st["iterations"].tolist() == [1, 1, 1, 0]
    assert st["recaptures"].tolist() == [0, 0, 0, 0]
    out, st = track_volumes_batched(*t_args, TrackConfig(max_iter=MAX_ITER),
                                    torch.zeros(4, dtype=torch.bool))
    assert st["host_reads"] == 0 and st["loop_iterations"] == 0
    np.testing.assert_array_equal(out.numpy(), args[5])
    assert st["converged"].all() and not st["iterations"].any()


def test_more_slots_than_a_table_takes(scene):
    """18 active slots, one more than a launch's table takes
    (``LM_MAX_ITEMS``): each stage runs two tables, read once each; the
    last slot, alone in its tables, ends on the bits it has when tracked
    alone."""
    args, _ = batched_args(scene)
    S = tr.LM_MAX_ITEMS + 1
    many = [np.stack([a[1]] * S) for a in args]
    many[4][:-1] = 0.0              # every slot but the last converges at 1
    cfg = TrackConfig(max_iter=8)
    out, st = track_volumes_batched(*map(torch.tensor, many), cfg,
                                    torch.ones(S, dtype=torch.bool))
    alone, st1 = track_volumes_batched(*[torch.tensor(a[-1:]) for a in many],
                                       cfg, torch.ones(1, dtype=torch.bool))
    assert st["iterations"].tolist() == [1] * (S - 1) + [8]
    assert st["host_reads"] == 3 and st1["host_reads"] == 2
    assert torch.equal(out[-1], alone[0])
    for key in ("iterations", "converged", "recaptures"):
        assert torch.equal(st[key][-1:], st1[key]), key
    for key in ("track_weights", "huber_weights"):
        assert torch.equal(st[key][-1:], st1[key]), key


def test_table_holds_one_kind(scene):
    """A table of a cache item and a gather item is refused."""
    start = moved(scene, START_NEAR)
    run, _, _ = cache_item(scene, torch.float32, start, start)
    it = run.items[0]
    gather = tr.LMItem(it.tsdf, it.weights, VS, it.points, it.assoc,
                       it.rel_pose)
    with pytest.raises(ValueError):
        tr.LMRun([it, gather], TrackConfig())


# ---------------------------------------------------------------------
# lm.cu's cache phase compiled for the host: the CUDA qualifiers and
# intrinsics it uses as plain C++, launches, cooperative groups and the
# cluster API (cudaLaunchKernelExC and its configuration) as no-ops
# (only the per-point functions are called)
HOST_CUDA = r"""
#pragma once
#include <math.h>
#include <string.h>
#include <stddef.h>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
struct emf_dim3 { unsigned x, y, z; };
static emf_dim3 threadIdx, blockIdx, blockDim, gridDim;
inline void __syncthreads() {}
inline void __threadfence() {}
template <class T> T __shfl_down_sync(unsigned, T v, int) { return v; }
inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
struct int4 { int x, y, z, w; };
inline float __uint_as_float(unsigned u) {
  float f; memcpy(&f, &u, 4); return f;
}
inline float __bfloat162float(float x) { return x; }
inline float __float2bfloat16_rn(float x) { return x; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorCooperativeLaunchTooLarge = 2,
       cudaDevAttrMultiProcessorCount = 3,
       cudaErrorLaunchOutOfResources = 4,
       cudaLaunchAttributeClusterDimension = 5,
       cudaFuncAttributeNonPortableClusterSizeAllowed = 6 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaSetDevice(int) { return 0; }
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, int) {
  *n = 1; return 0;
}
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
struct dim3 { dim3(unsigned = 1, unsigned = 1, unsigned = 1) {} };
inline int cudaLaunchCooperativeKernel(const void*, dim3, dim3, void**, int,
                                       void*) { return 0; }
struct cudaLaunchAttribute {
  int id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline int cudaFuncSetAttribute(const void*, int, int) { return 0; }
inline int cudaOccupancyMaxActiveClusters(int* n, const void*,
                                          const cudaLaunchConfig_t*) {
  *n = 1; return 0;
}
inline int cudaLaunchKernelExC(const cudaLaunchConfig_t*, const void*,
                               void**) { return 0; }
inline int cudaGetLastError() { return 0; }
namespace cooperative_groups {
struct grid_group { void sync() {} };
inline grid_group this_grid() { return {}; }
struct cluster_group {
  void sync() {}
  unsigned num_blocks() { return 1; }
  unsigned block_rank() { return 0; }
};
inline cluster_group this_cluster() { return {}; }
}
"""

HARNESS = r"""
template <typename T>
static void emf_points(const EmfLmItem* it, const float* pose,
                       const EmfLmCfg* C, float* out, int trial) {
  EmfPose P;
  memcpy(&P, pose, sizeof(P));
  const size_t st = (size_t)it->stride, n = (size_t)it->n;
  for (int i = 0; i < it->n; ++i) {
    const float px = it->pts[i], py = it->pts[st + i],
                pz = it->pts[2 * st + i];
    const EmfAnchor a = emf_anchor(*it, i);
    if (trial == 2) {  // drift_counts' flags: relevant, then outside
      int rel = 0, bad = 0;
      emf_lm_drift(*it, P, px, py, pz, a, rel, bad);
      out[i] = (float)rel;
      out[n + i] = (float)bad;
      continue;
    }
    if (trial) {  // the trial psi, then whether it is valid
      bool valid;
      out[i] = emf_lm_psi_cache<T>(*it, P, px, py, pz, i, a, valid);
      out[n + i] = valid ? 1.0f : 0.0f;
      continue;
    }
    const EmfLmPoint r = emf_lm_point_cache<T>(*it, P, px, py, pz, i, a, *C);
    const float v[6] = {r.psi, r.gx, r.gy, r.gz, r.intw, r.hub};
    for (int c = 0; c < 6; ++c) out[c * n + i] = v[c];
  }
}
extern "C" void emf_host_points(const EmfLmItem* it, const float* pose,
                                const EmfLmCfg* C, float* out, int trial) {
  if (it->bf16)
    emf_points<emf_bf16>(it, pose, C, out, trial);
  else
    emf_points<float>(it, pose, C, out, trial);
}
extern "C" int emf_host_item_size() { return (int)sizeof(EmfLmItem); }
"""


@pytest.fixture(scope="module")
def host_lm(tmp_path_factory):
    """``csrc/lm.cu`` with its launches' ``<<<...>>>`` taken out, built for
    the host with the stub CUDA header and the harness above."""
    cxx = next((shutil.which(c) for c in (os.environ.get("CXX"), "c++",
                                          "g++", "clang++")
                if c and shutil.which(c)), None)
    if cxx is None:
        raise RuntimeError("no C++ compiler: lm.cu's host build needs one")
    d = tmp_path_factory.mktemp("host_lm")
    with open(os.path.join(kernels.CSRC, "lm.cu")) as f:
        src = f.read()
    src = re.sub(r"<<<.*?>>>", "", src, flags=re.S)
    src = src.replace("#include <cooperative_groups.h>",
                      '#include "host_cuda.h"')
    for name, text in (("host_cuda.h", HOST_CUDA), ("cuda_runtime.h", ""),
                       ("cuda_bf16.h", ""), ("lm_host.cpp", src + HARNESS)):
        (d / name).write_text(text)
    so = str(d / "lm_host.so")
    kernels.compile_shared([("lm_host", [
        cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
        "-I", str(d), "-I", kernels.CSRC, "-x", "c++",
        str(d / "lm_host.cpp")], so)])
    lib = ctypes.CDLL(so)
    lib.emf_host_points.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    lib.emf_host_points.restype = None
    return lib


def test_item_mirror_matches_the_struct(host_lm):
    """``kernels.LmItemArgs`` names ``EmfLmItem``'s fields in its order,
    and the two have one size."""
    with open(os.path.join(kernels.CSRC, "lm.cu")) as f:
        body = re.search(r"struct EmfLmItem \{(.*?)\};", f.read(),
                         re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [n for decl in body.split(";") if decl.strip()
             for n in re.findall(r"\*?\s*(\w+)\s*(?:,|$)",
                                 decl.strip().split(None, 1)[1]
                                 if decl.strip().split()[0] != "const"
                                 else decl.strip().split(None, 2)[2])]
    assert names == [f[0] for f in kernels.LmItemArgs._fields_]
    assert host_lm.emf_host_item_size() == ctypes.sizeof(kernels.LmItemArgs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_kernel_code_matches_plain(scene, host_lm, dtype):
    """``lm.cu``'s ``emf_lm_point_cache`` and ``emf_lm_psi_cache`` (the
    cache phase of ``lm_run``: the candidate taps only, summed in the
    plain order), run on the host, against ``tracking._cache_system`` /
    ``_cache_psi`` (all six taps an axis): ψ, the gradient, the clamped
    weight, the Huber weight and the trial ψ bit for bit (``torch.equal``:
    a left-out zero product may change only the sign of a zero), and the
    trial ψ's validity, which the empty-window guard counts, at poses
    where part of the points lie outside their windows and some behind
    the camera; float32 and bf16 caches."""
    cfg = TrackConfig()
    rng = np.random.RandomState(5)
    start = moved(scene, START_FAR)
    outside = []
    for f in (0.95, 0.6, 0.3, 0.0):      # 0.2 to 3.2 voxels from the start
        at = moved(scene, np.array(START_FAR) * f + rng.normal(0, 0.1, 6)
                   * [1, 1, 1, 0.01, 0.01, 0.01])
        run, _, _ = cache_item(scene, dtype, start, at)
        it = run.items[0]
        it.points[2, :20] = -0.1                 # behind the camera
        R = torch.tensor(at[:3, :3])
        t = torch.tensor(at[:3, 3])
        psi, g3, intw = tr._cache_system(it, R, t, cfg)
        a = psi.abs()
        hub = torch.where(a > 0, torch.clamp(
            torch.tensor(cfg.huber_thresh) / torch.clamp(a, min=1e-30),
            max=1.0), 0.0)
        n = it.points.shape[1]
        args = kernels.LmItemArgs(
            it.tsdf.data_ptr(), it.weights.data_ptr(), it.points.data_ptr(),
            it.assoc.data_ptr(), it.cache.data_ptr(), it.anchor.data_ptr(),
            it.points.stride(0), n, *it.tsdf.shape,
            int(dtype == torch.bfloat16), VS, 0, n, 1)
        c = kernels.LmCfgArgs(cfg.tau, cfg.eps1, cfg.eps2, cfg.nu_init,
                              cfg.huber_thresh, cfg.max_tsdf_weight,
                              cfg.max_iter)
        pose = torch.cat([R.reshape(9), t]).contiguous()
        out = torch.zeros((6, n))
        trial = torch.zeros((2, n))
        for buf, flag in ((out, 0), (trial, 1)):
            host_lm.emf_host_points(ctypes.addressof(args), pose.data_ptr(),
                                    ctypes.addressof(c), buf.data_ptr(),
                                    flag)
        assert torch.equal(out, torch.stack([psi, *g3, intw, hub]))
        psi_t, valid = tr._cache_psi(it, R, t)
        assert torch.equal(trial[0], psi_t)
        assert torch.equal(trial[1] != 0, valid)
        assert (psi != 0).sum() > 100 and valid.sum() > 100
        outside.append(int(out_of_window_count(it.anchor, it.points, R, t,
                                               VS, scene["tsdf"].shape)))
    assert outside[0] == 0 and outside[-1] > 100, outside


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_drift_kernel_code_matches_drift_counts(scene, host_lm, dtype):
    """``lm.cu``'s ``emf_lm_drift`` (a re-capturing cache item's drift
    test at its trial pose, summed over the points by ``lm_run``'s trial
    phase), run on the host: per point relevant and outside its window,
    summed, equal to ``geometry.capture.drift_counts`` at poses 0.2 to
    3.2 voxels from the windows' capture, with points behind the camera
    and outside the volume."""
    cfg = TrackConfig()
    rng = np.random.RandomState(6)
    start = moved(scene, START_FAR)
    counts = []
    for f in (0.95, 0.6, 0.3, 0.0):
        at = moved(scene, np.array(START_FAR) * f + rng.normal(0, 0.1, 6)
                   * [1, 1, 1, 0.01, 0.01, 0.01])
        run, _, _ = cache_item(scene, dtype, start, at)
        it = run.items[0]
        it.points[2, :20] = -0.1                 # behind the camera
        it.points[0, 20:40] += 0.16 + 0.002 * torch.arange(20.0)
        n = it.points.shape[1]
        args = kernels.LmItemArgs(
            it.tsdf.data_ptr(), it.weights.data_ptr(), it.points.data_ptr(),
            it.assoc.data_ptr(), it.cache.data_ptr(), it.anchor.data_ptr(),
            it.points.stride(0), n, *it.tsdf.shape,
            int(dtype == torch.bfloat16), VS, 0, n, 1)
        c = kernels.LmCfgArgs(cfg.tau, cfg.eps1, cfg.eps2, cfg.nu_init,
                              cfg.huber_thresh, cfg.max_tsdf_weight,
                              cfg.max_iter, cfg.max_recaptures)
        R, t = torch.tensor(at[:3, :3]), torch.tensor(at[:3, 3])
        pose = torch.cat([R.reshape(9), t]).contiguous()
        flags = torch.zeros((2, n))
        host_lm.emf_host_points(ctypes.addressof(args), pose.data_ptr(),
                                ctypes.addressof(c), flags.data_ptr(), 2)
        nbad, nrel = drift_counts(it.anchor, it.points, R, t, VS,
                                  scene["tsdf"].shape)
        assert float(flags[0].sum()) == float(nrel)
        assert float(flags[1].sum()) == float(nbad)
        assert not bool((flags[1] > flags[0]).any())   # bad only if relevant
        counts.append((int(nrel), int(nbad)))
    # some points not relevant; from 0.2 voxels only the moved points out
    # of their windows, from 3.2 voxels half of them
    assert all(r < 1000 for r, _ in counts)
    assert counts[0][1] < 20 and counts[-1][1] > 100, counts
