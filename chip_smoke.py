#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``emfusion_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--only distributed]

(``chip_smoke.py --serve-rank OUT AT ARGV...`` is a rank of step 9c
under ``torchrun``.)

1. Builds the port's CUDA kernels from ``emfusion_tpu_torch/csrc``.
2. Fuses an analytic scene, with depth noise drawn from ``--seed``
   (default 0), at the reference's published size
   (``configs/default.cfg``: 640x480, 512^3 at 1 cm) and holds every
   kernel against its plain PyTorch version on the card, at the shapes of
   the main path. A kernel's time is its device time: a CUDA graph of
   back-to-back calls, replayed between CUDA events. The plain version is
   timed by CUDA events around back-to-back calls. Also reports the
   raycast's march (steps per ray, lane use of 32-ray warps, shares of
   zero-corner and weight samples) from its plain version's counts, and
   the fusion's voxel classes (in the image, behind the camera, changed)
   from which its bound is counted. The device-resident LM's kernels
   (``csrc/lm.cu``: the counterpart of the JAX package's
   ``lax.while_loop`` body, not of a Pallas kernel) are held over the
   camera LM of the next frame (307,200 points on 512^3): the split
   kernels (``lm_system``, ``lm_trial``, ``lm_step``) phase by phase, and
   the cooperative ``lm_run`` iteration by iteration against the plain
   iteration until the LM stops: per-point values and int words exact,
   float64 sums within a float32 ulp once rounded, the poses within 1e-5;
   one launch of ``max_iter`` iterations must end on the same bits, and
   the plain iteration run alone on the same int words and within 1e-5.
   ``lm_run``'s ms is an iteration's device time within a launch that
   runs the LM to its end, its bound this run's (per iteration the LMs
   that evaluate and those that trial) over its iterations, and the split
   kernels are timed over the same iterations; a launch of one iteration
   and one once every LM has stopped are timed too.
3. Runs the main path, ``EMFusionPipeline.process_frame`` without
   objects, over 24 frames of a smooth ground-truth camera path with the
   default LM sampler (gather, the exact path, its LM on the device);
   fails unless every kernel of the path was launched in that run
   (``lm_run`` too, and none of the split LM kernels), K1 once per
   fusion and K2 once per E-step, the camera ATE is under 1 voxel, and
   every LM call read the device at most once a table (one ``lm_run`` of
   ``max_iter`` iterations). Prints the camera LM's iterations a call, ms an iteration,
   device reads a call, re-captures and dropped points. Then (after step
   4) runs the same frames with the capture sampler (its LM on the device
   too: K3 and ``lm_run`` launch, and a call may read the device once
   and once more a re-capture; its ``track_camera`` printed beside the
   host loop's 185.918 ms, ``PERF.md`` section 5), with the gather LM in the
   per-iteration host loop, and with the
   device LM as the split kernels (``tracking._run_lm_split``, 4
   iterations between reads), and prints each against ``lm_run``:
   iterations, ms an iteration, ``track_camera`` ms, device reads a call
   and the largest camera pose gap (the split kernels' must be within
   1e-5). Then times the camera LM whole at chunks of 4, 8, 16 and
   ``max_iter`` iterations a launch of ``lm_run`` (the path's).
4. Profiles three more frames with ``torch.profiler``: the device's busy
   share of the wall time and the device ops that took most of it (the
   full table goes to ``chiprun_out/profile_ops.txt``).
5. Runs the object path (gather sampler): the pipeline with a mask provider
   over 40 frames of the scene with two moving spheres (r 0.15 and 0.12 m, 1.3
   and 1.5 m away, 5 mm a frame along x), ground-truth masks on the mask frames
   0 and 30 (spawn, then match). Prints its phase times, e2e, peak memory,
   launches per frame and LM iterations; fails if an object is lost, if an
   object's x-motion recovers less than 0.35 or more than 2.0 of the truth, if
   the camera ATE reaches 1 voxel, if a kernel of the path never ran, if K1, K2,
   K4 and ``lm_run`` never ran at the object shape, if a split LM kernel
   ran, unless K1 launched once
   per fusion and K2 once per E-step, or if an LM call (the camera's, or the
   table of every serial object LM) read the device more than once.
6. Holds K1 and K2 against their plain versions over the object path's
   final work tables (the background and both slots, as the pipeline
   builds them), K3-K4 at an object's shapes (its 64^3 volume at its
   own voxel size, fg-masked weights for K4) and the LM kernels over the
   serial object LMs' table of both slots, held and timed as in step 2;
   then
   profiles three more frames of the object path as in step 4
   (``chiprun_out/object_profile_ops.txt``).
7. Fills every slot of that pipeline's pool (``max_objects``, 16) with a
   copy of one of its two objects, centred on a grid across the image,
   and holds K1 and K2 over the background and all 16 slots, and the LM
   kernels over a table of the 16 slots' LMs.
8. Runs the accelerator path: the object path's scene and masks over
   40 frames under the JAX package's accelerator tracking configuration
   (``tracking_stride=3``, ``estep_scale=2``, ``motion_model="constvel"``,
   ``capture_backend="band"``: one batched LM over both objects' top 4096
   points, and the camera LM with the capture sampler, which the
   configuration's ``auto`` sampler resolves to, as the JAX package's
   ``auto`` picks on a chip). The batched LM runs each of its two
   fixed-cache stages as one K3 launch and one ``lm_cluster`` launch
   over the slots' window caches (cache items, a thread-block cluster a
   slot), then one read; the camera LM is one re-capturing cache item
   (``tracking.track_volumes_capture``: a K3 launch at its start,
   ``lm_run`` until its trial leaves the windows, a read, K3 at the
   trial pose, ``lm_run`` again: its 34 spans are more than a cluster's
   16 blocks, so the cooperative launch takes its table). Prints its phases,
   ``track_objects`` and ``track_camera`` beside the batched LM's and the
   camera LM's times as host loops on the same card model
   (``HOST_LOOP_TRACK_OBJECTS_MS``, ``HOST_LOOP_TRACK_CAMERA_MS``), LM
   iterations (camera and batched), device reads per batched LM and
   camera call, the camera calls that spent the whole re-capture budget
   and their dropped points, peak memory and launches; fails as the
   object path does (``lm_cluster`` must have run at the object shape,
   and no ``lm_run`` there: no cooperative launch takes a stage's
   table), and
   also if a frame launched K3 or ``lm_cluster`` at the object shape more
   than twice (once per LM stage, every slot in one launch), a batched
   LM call read the device more than twice or a camera call more than
   1 + its re-captures times. Then runs the path's first
   ``HOST_LOOP_CALLS`` camera calls again, each also through the host
   loop on the same inputs, and prints re-captures, iterations and the
   pose gap of the two (``capture_vs_host_loop``).
   Holds K3 over that path's final two-slot table (2 x 4096 points),
   over the camera's stride-3 points, and over a full pool (16 x 4096,
   the pool of step 7), and ``lm_cluster`` over the cache items of a first
   stage's table of the two slots (``lm_run_cache``), of the full pool
   (``lm_run_cache_pool``) and of the two slots with their volumes cast
   to bf16 (``lm_run_cache_bf16``, a bf16 cache; no path runs one yet),
   as ``hold_lm_run`` holds the gather tables (no split kernels: they
   take gather items only), and ``lm_run`` over the camera LM's
   capture item (34,240 points) from 3 voxels off its start, so that it
   re-captures (``lm_run_capture``, ``hold_lm_capture``: in lockstep
   with the plain iteration, K3 at each flagged trial pose against the
   plain capture, then the whole call, which must end on the same bits
   and read at most 1 + its re-captures times); profiles three frames
   of the path
   (``chiprun_out/accel_profile_ops.txt``). Then holds fault F2's guard:
   ``lm_cluster`` over a table of two cache items on a 16^3 slope whose
   first undamped step carries the first item's 24 points 7 voxels out
   of their windows (the JAX package's fixed-cache LM accepts that step,
   its error being an empty sum) and the second's 1.5 voxels, one launch
   of one iteration against the plain iteration: the records bit for
   bit, the first item's trial counted with no weighted point in its
   windows and rejected, its pose kept, the second's accepted; then the
   table held to its stop as ``hold_lm_run`` holds it.
8b. Runs the same 40 frames and masks again with ``volume_dtype="bfloat16"``
   (the JAX package's accelerator storage: the background pair in bf16)
   and prints its e2e ms a frame, peak memory, ATE, recovery, launches
   and LM counts beside step 8's float32 run; fails as step 8 does. Then
   holds the bf16 forms on its final state: K1 over the fusion table (the
   bf16 background and both float32 slots, one launch), K2 over the
   E-step's table, K3 over the camera's stride-3 points (a bf16 cache)
   and K4 on the bf16 background, each at max abs error 0 with its bound
   recounted for bf16 bytes, and ``lm_run`` over the camera's capture
   LM with a bf16 cache (``lm_run_capture_bf16``); then the host-loop
   comparison of step 8 on this path's first camera calls.
9. Runs the CLI path: writes a 40-frame 640x480 TUM-format sequence of
   the object path's scene (with ground truth, calibration and ``.plk``
   masks at frames 0 and 30), its PNGs with libpng's adaptive filters
   (per row the filter type of least absolute sum, as cv2, the JAX native
   writer and so real TUM files have them; the rgb frame the depth shaded
   to grey with sensor noise and a black border), and fails unless rows
   of all five filter types occur. Prints the decode ms a frame (rgb +
   depth) of the numpy plain decoder on frame 0 and of the C unfilter
   path over 10 frames (equal pixels), and the ``NativePrefetcher``'s
   frames a second over the sequence with 1 and 4 worker threads, and
   the same design on spawned processes with shared-memory slots (the
   alternative measured against it, which lives only in this script).
   Runs ``apps.run_emfusion.main`` on the card (its reader
   decoding through the prefetcher) over frames 0-19 with a checkpoint,
   then ``--resume --frame-meshes 10`` over frames 20-39, then
   ``apps.evaluate``; loads the final checkpoint and times the 512^3
   sparse mesh extraction, ``write_results`` and a checkpoint save, and
   fails unless the frame-40 ``--frame-meshes`` files (written by the
   CLI's ``AsyncWriter`` thread) equal byte for byte those that
   ``write_frame_meshes`` writes synchronously from that state. Prints
   the CLI's steady ms/frame and run seconds (beside those of the single
   reader thread on Up-only PNGs), the launches per frame, the ATE, the objects' recovery and the
   mesh; fails on a camera ATE of 1 cm or more, a lost object, a recovery
   outside 0.35-2.0, a missing export directory, an empty mesh, or a
   background mesh whose median distance to the scene's surfaces is half
   a voxel or more. Its files live in ``chip_smoke_work/``, removed at
   the end.
9b. The viewers: ``apps.run_emfusion --serve PORT --turntable 3`` over 4
   frames of that sequence (a thread polls ``/status`` while it runs; the
   three views must decode, the brightest lit: a view from behind the
   scene sees back faces, which K4 culls); then ``viz_server.LiveViewer`` on
   loopback and a free port over the CLI path's final state: every
   endpoint answers (two ``/stream`` parts; ``/frame.png`` and
   ``/view.png`` decoded by the port's decoder, lit; ``/mesh.bin``
   parsed), 12 turntable views timed, ``encode_jpeg`` of a 640x480 frame
   timed, and K4 held at an orbit pose from outside the volume
   (``raycast_orbit``, with the K4 launches of this step).
9c. The sharded viewer: a 6-frame 160x120 TUM sequence of the object
   path's scene (128^3, 32^3 objects) through ``apps.run_emfusion
   --serve --turntable 3``, on this card alone and on 2 gloo ranks
   sharing it (``--nprocs``'s rank body, ``distributed.mesh.launch``),
   each run's service step wrapped (:class:`ServeProbe`): at the last
   frame but one a ``/view.png`` alone, at the last every endpoint that
   a sharded run answers (``/frame.png``, ``/status``, ``/view.png``,
   ``/mesh.bin``, ``/mesh.ply``), then a request after the last step;
   fails unless every answer and turntable PNG is byte-equal to the
   one-card run's, the late request is answered on one card and refused
   with a 503 by the ranks, and every rank exits 0. Prints the service
   step's ms with nothing queued, the view's round trip and the
   turntable's ms a view, sharded beside one card.
10. Runs a small scene through the pipeline on the card and on the CPU
   (plain versions) and compares the camera poses; then a small object
   scene, comparing the live objects and the camera and object poses.
11. The distributed path (``emfusion_tpu_torch.distributed``). First
   (in step 6) K1's slab form, ``fusion_slab``: the object path's
   background cut into its two z-slabs, each fused alone, held at max
   abs error 0 against the plain slab and against the same planes of one
   whole-volume launch, its bound counted from the slab's voxel
   classes. Then ``distributed.mesh.launch`` starts 4 ranks as a (2, 2)
   (obj, z) mesh: with one card they share it under gloo, every
   collective staged through host memory (printed as the transport);
   with 4 or more cards, NCCL, a rank a card. They run (a) the stress
   scene: step 7's 16-slot pool, sharded, over 4 frames that render the
   pool's spheres, each followed by the z-sharded background mesh and
   the object meshes written, while rank 0 runs the one-card pipeline on
   the same frames and compares the E-step images, composite, poses,
   volumes and host mirrors bit for bit (object poses to 1e-4) and the
   sharded mesh against ``extract_mesh`` of its read copy (vertex set
   and triangle count); (b) the read copy's refresh alone, timed; (c)
   the pixel-sharded ``track_volume`` on a frame's 307,200 points
   against the one-rank LM (1e-4; whether within 1e-5 is printed beside
   the one-rank LM's own spread over reordered sums; it must launch the
   split LM kernels and not ``lm_run``); (d) the object
   path's frames 0-31 (spawn, match) against step 5's poses (camera
   1e-5, objects 1e-4), failing as the object path does. Prints the
   frames' ms beside the one-card pipeline's, the collectives a frame
   per kind (calls, MB, ms), the refresh's GB/s, the all-reduces an LM
   iteration and each rank's peak memory. ``--only distributed`` runs
   this step alone, after a one-card run of the object path's first 32
   frames as its reference; with two or more cards it first runs the
   object path's first 2 frames and a table of its object LMs on
   ``cuda:1`` while ``cuda:0`` stays current, and fails unless every
   kernel ran there and poses, volumes and the LMs' results equal the
   same run on ``cuda:0`` bit for bit (every launch runs on its
   tensors' card); after step 11 it runs step 9c at full width (640x480,
   512^3, ``configs/default.cfg``) on 4 ranks: under ``torchrun`` (the
   CLI's own entry) with NCCL on 4 cards, or as 4 gloo ranks sharing one
   card.
12. Object deletion and slot re-use at full width (``configs/default.cfg``
   as published, 40 frames): movers A (r 0.10 m, leaving the view to the
   left at 1.2 cm a frame, out of it from frame 13) and B (the object
   path's second mover) spawn at frame 0; A is deleted once the raycast
   sees too little of it; C (r 0.13 m) enters at the mask frame 30 and
   spawns into the first free slot, A's. Prints the lifecycle frame by
   frame (live ids and slots, A's true pixels, each slot's visible
   pixels, the object raycasts and object LMs, slot 0's largest weight,
   ms), e2e ms a frame and peak memory; fails if A is not deleted, is
   deleted by another rule than the not-visible one, or before it is
   leaving the view (fewer than twice ``visibilityThresh`` of its true
   pixels inside the boundary), if B is lost, if B's or C's x-motion
   recovers outside 0.35-2.0 of the truth, if C does not take slot 0, if
   slot 0 is not zero at C's spawn or holds a weight above one frame's
   after C's first fusion, if the camera ATE reaches a voxel, if a
   frame's K4 object raycasts and object LMs do not follow the slots
   live at its start (one fewer after A's deletion, one more after C's
   spawn), if a kernel of the path never ran, or on a NaN in a live
   volume.
13. The same scene at ``tests/test_torch_pipeline_objects.py``'s
   ``SMALL`` size (160x120, 96^3 at 3 cm, masks every third frame), every
   other frame, on the card and on the CPU (plain versions): fails unless
   A is deleted and C takes slot 0, the live ids and slots are equal
   after every frame, the camera within 0.1 background voxel, and each
   object within 0.1 object voxel at its sphere's centre and 0.5 at its
   volume's origin (a sphere's rotation about its centre is
   unobservable; step 10's bound).
14. ``configs/room4.cfg`` (1.5 cm voxels, ``volumePose`` z 3.84, its
   intrinsics: fx 564.3, principal point (480, 270)) through the CLI: a
   40-frame TUM sequence of the object path's scene seen through that
   camera, ``apps.run_emfusion`` with its masks and a checkpoint, then
   ``apps.evaluate`` and the checkpoint's 512^3 background mesh; fails on
   a camera ATE of 1.5 cm or more or a mesh whose median distance to the
   scene's surfaces is half a voxel or more.

Kernel K6 (the projective warp) is not on either path: the port's
fusion kernel makes its nearest-pixel pick per voxel. Step 2 holds it
against its plain version at the main path's image and grid sizes, and
times it beside ``emf_warp_floor``, an empty kernel on its grid and
block (the ``floor_ms`` of its rows).

Prints the card's name and power limit, one JSON line with the numbers
of every kernel (K6 with 0 launches; ``fusion_slab`` with rank 0's
slab launches in step 11's stress scene; the ``*_object`` rows are the
object-path holds of step 6 and the ``*_pool`` rows those of step 7,
both with the object path's launches that touched an object volume; the
``capture_*_accel`` rows are step 8's, with the accelerator path's K3
launches at the camera's or the objects' shape; the ``*_bf16`` rows are
step 8b's, with its launches at the background's shape (K2 and K1 with
all their launches); ``raycast_orbit`` is step 9b's; the other rows carry the
background-only main path's, except K3's: the exact paths' LMs gather,
so the ``capture`` row carries the main path's capture run's launches
and ``capture_object`` the accelerator path's at the object shape; the
K1 rows also carry ``bound_all_ms``, the bound if every voxel were read
and written), the ``lm_*`` rows: the LM kernels at the background's
shape, over the object path's two-slot table (``*_objects``) and a full
pool (``*_pool``): ``lm_run`` with the main path's launches (the
object path's at the object shape), the ``lm_run_cache*`` rows
``lm_cluster``'s over cache items with the accelerator path's at the
object shape, 0 for the bf16 cache; the ``lm_run_capture`` rows
``lm_run``'s with steps 8's and 8b's at the background's shape, the
camera LM's; the split kernels with the launches
of rank 0's pixel-sharded LM in step 11 (the only path that runs them; 0
at the object shape), its ``bound_ms`` this run's per-iteration bound:
``lm_system``'s over the LMs that evaluate plus ``lm_trial``'s over
those that trial, summed over the run to its stop, over its
iterations; and as its last line
``{"ok": true, "device": ...}``.
Exits non-zero, without that line, when there is no CUDA device or any
phase fails. A fuller report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM published memory rate
F32_OPS_PER_S = 67e12         # H100 SXM published float32 rate (no TC)
# special-function unit: 16 results per clock per SM (Hopper white paper),
# 132 SMs at the 1.98 GHz boost clock; an accurate expf takes one
SFU_PER_S = 16 * 132 * 1.98e9
VOXEL_CUT = 0.01              # ATE limit: one voxel of the 1 cm volume
N_FRAMES = 24                 # frames of the main path run
OBJ_FRAMES = 40               # frames of the object path run
ACCEL_FRAMES = 40             # frames of the accelerator path run
CLI_FRAMES = 40               # frames of the CLI path's sequence
CLI_SPLIT = 20                # the CLI path resumes from its checkpoint here
CLI_MESH_EVERY = 10           # its second run's --frame-meshes
PROFILE_FRAMES = 3            # frames of the profiled window
GRID = (600, 896)             # K6's reference-plane grid at 640x480

# (row name, kernel source, TPU kernel it replaces, kernel launched)
KERNEL_ROWS = [
    ("fusion", "emfusion_tpu_torch/csrc/fusion.cu",
     "emfusion_tpu/ops/pallas/fusion_pencil_pallas.py:388", "fusion"),
    ("sample", "emfusion_tpu_torch/csrc/sample.cu",
     "emfusion_tpu/ops/pallas/sweep_pallas.py:246", "sample"),
    ("capture", "emfusion_tpu_torch/csrc/capture.cu",
     "emfusion_tpu/ops/pallas/band_pallas.py:307", "capture"),  # + :132
    ("raycast", "emfusion_tpu_torch/csrc/raycast.cu",
     "emfusion_tpu/ops/pallas/sweep_pallas.py:246", "raycast"),
    ("bilateral", "emfusion_tpu_torch/csrc/bilateral.cu",
     "emfusion_tpu/ops/pallas/bilateral_pallas.py:74", "bilateral"),
    ("warp_to_grid", "emfusion_tpu_torch/csrc/warp.cu",
     "emfusion_tpu/ops/pallas/warp_pallas.py:180", "warp"),
    ("warp_to_pixels", "emfusion_tpu_torch/csrc/warp.cu",
     "emfusion_tpu/ops/pallas/warp_pallas.py:180", "warp"),
]
# the device-resident LM of the gather sampler (csrc/lm.cu): the
# counterpart of the JAX package's lax.while_loop body (tracking.py:
# 242-322), not of a pallas_call; held at the background's shape, the
# object path's two-slot table and a full pool's. lm_run (a chunk of
# iterations a cooperative launch) runs the exact paths' LMs; the split
# kernels the pixel-sharded LM's
LM_RUN = "lm_run"
# lm_cluster runs the tables of cache items whose items fit a cluster (at
# most 16 spans: the batched object LM's stages), one thread-block
# cluster an LM; lm_run the others (the capture camera LM's 34 spans)
LM_CLUSTER = "lm_cluster"
LM_SPLIT_KERNELS = ["lm_system", "lm_trial", "lm_step"]
LM_KERNELS = [LM_RUN] + LM_SPLIT_KERNELS
SPLIT_CHUNK = 4               # the split loop's iterations between reads


def one_read(iterations, recaptures):
    """Reads of the device an LM call of ``lm_run`` may take: one a
    table (a launch of ``max_iter`` iterations, then one read)."""
    return 1


def capture_reads(iterations, recaptures):
    """Reads a capture sampler's LM call may take: one, and one more for
    each re-capture of its table (the launch ends when an LM must be
    captured again at its trial pose)."""
    return 1 + recaptures


def split_reads(iterations, recaptures):
    """Reads a call of the split loop may take: one a chunk of
    ``SPLIT_CHUNK`` iterations, and one more where the last chunk ended
    on the stop."""
    return -(-iterations // SPLIT_CHUNK) + 1
LM_ROWS = [(f"{k}{suffix}", "emfusion_tpu_torch/csrc/lm.cu",
            "emfusion_tpu/tracking.py:242", k)
           for suffix in ("", "_objects", "_pool") for k in LM_KERNELS]
# lm_run over cache items (the batched object LM's fixed-cache stages: the
# JAX package's _lm_fixed_cache while_loop body, tracking.py:394-498): at
# the accelerator path's stage table of both objects, a full pool's, and
# the objects' table with bf16 volumes (a bf16 cache)
LM_CACHE_ROWS = [(f"lm_run_cache{suffix}", "emfusion_tpu_torch/csrc/lm.cu",
                  "emfusion_tpu/tracking.py:394", LM_CLUSTER)
                 for suffix in ("", "_pool", "_bf16")]
# lm_run over re-capturing cache items (the capture sampler's LM: the JAX
# package's capture while_loop, tracking.py:224-352, its re-capture
# lax.cond at :224-240): the accelerator path's camera LM (stride-3
# points of the 512^3 background), float32 and bf16
LM_CAPTURE_ROWS = [(f"lm_run_capture{suffix}",
                    "emfusion_tpu_torch/csrc/lm.cu",
                    "emfusion_tpu/tracking.py:224", LM_RUN)
                   for suffix in ("", "_bf16")]
# a start this many voxels off the camera's (along x) in those holds, so
# that the LM re-captures
CAPTURE_HOLD_OFFSET = 3.0
# track_camera ms a call with the capture sampler's LM as the host loop it
# replaced, on one NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 5):
# the accelerator path float32 and bf16, the background path's capture
# run
HOST_LOOP_TRACK_CAMERA_MS = {"float32": 137.191, "bf16": 232.659,
                             "background": 185.918}
# the accelerator paths' first camera calls also run through the host loop
# on the same inputs (capture_vs_host_loop)
HOST_LOOP_CALLS = 10
# track_objects ms a call of the accelerator path's batched object LM as
# the host loop it replaced (each pass read the card twice), on one NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md, section 5): float32, bf16 backgrounds
HOST_LOOP_TRACK_OBJECTS_MS = {"float32": 156.079, "bf16": 214.039}
# K6 (warp) is not on the main path: the fusion kernel makes its pick;
# K3 (capture) is on the paths whose LMs run the capture sampler (the
# main path's capture run, the accelerator path; their LMs on the device,
# lm_run), not on the exact paths, whose LMs gather (the default sampler)
# on the device (lm_*), or in the host loop (the main path's comparison
# run)
HOST_LOOP_KERNELS = [row[3] for row in KERNEL_ROWS
                     if row[3] not in ("warp", "capture")]
PATH_KERNELS = HOST_LOOP_KERNELS + [LM_RUN]
CAPTURE_PATH_KERNELS = PATH_KERNELS + ["capture"]
BATCHED_PATH_KERNELS = CAPTURE_PATH_KERNELS + [LM_CLUSTER]
SPLIT_PATH_KERNELS = HOST_LOOP_KERNELS + LM_SPLIT_KERNELS
# the same kernels held at an object's shapes (object_kernel_phases), and
# K1 and K2 over a full pool (pool_kernel_phases)
OBJECT_ROWS = [(f"{name}_object", src, replaces, kernel)
               for name, src, replaces, kernel in KERNEL_ROWS
               if kernel in ("fusion", "sample", "capture", "raycast")]
POOL_ROWS = [(f"{name}_pool", src, replaces, kernel)
             for name, src, replaces, kernel in KERNEL_ROWS
             if kernel in ("fusion", "sample")]
# K3 on the accelerator path: the camera's stride-3 capture, a batched LM
# stage's table of both objects, and of a full pool
ACCEL_ROWS = [(f"capture_{what}_accel",) + KERNEL_ROWS[2][1:]
              for what in ("camera", "objects", "pool")]
# the bf16 forms on the accelerator path with bf16 volumes (step 8b), and
# K4 from an orbit camera (step 9b)
BF16_ROWS = [("fusion_bf16",) + KERNEL_ROWS[0][1:],
             ("sample_bf16",) + KERNEL_ROWS[1][1:],
             ("capture_camera_bf16",) + KERNEL_ROWS[2][1:],
             ("raycast_bf16",) + KERNEL_ROWS[3][1:]]
VIEW_ROWS = [("raycast_orbit",) + KERNEL_ROWS[3][1:]]
TURNTABLE_VIEWS = 12          # views of the viewer step's turntable
# the JAX package's accelerator tracking configuration: what its `auto`
# knobs resolve to on a chip (pipeline.py:167-176, 261-264, 387-411),
# volumes kept float32
ACCEL = dict(tracking_stride=3, estep_scale=2, motion_model="constvel",
             capture_backend="band")
# the small card-vs-CPU object scene: 160x120, 2 cm background voxels,
# 32^3 objects, masks every third frame, thresholds for its small masks
SECOND_CARD_FRAMES = 2   # a spawn, then the objects tracked
SMALL_OBJECTS = dict(globalVolumeDims=(128, 128, 128), globalVoxelSize=0.02,
                     volumePose=(0.0, 0.0, 1.28), objVolumeDims=(32, 32, 32),
                     maxTrackingIter=50, raycast_max_steps=256, max_objects=4,
                     maskRCNNFrames=3, visibilityThresh=60,
                     mask_min_pixels=60, boundary=5)
STEP_EDGES = [0] + [2 ** i for i in range(13)]   # march-step histogram
# step 11: K1's slab form held at the background's two z-slabs, and the
# distributed path: DIST_RANKS ranks as a (2, 2) mesh, the stress scene's
# frames, and the object path's first LIFE_FRAMES frames (spawn, match)
SLAB_ROWS = [("fusion_slab",) + KERNEL_ROWS[0][1:]]
DIST_RANKS = 4
DIST_FRAMES = 4
LIFE_FRAMES = 32
DIST_TIMEOUT_S = 420.0
LM_POSE_TOL = 1e-4            # the pixel-sharded LM against one rank
DIST_WORK = os.path.join(HERE, "chip_smoke_dist")
# fault F2's scene (tests/test_torch_lm_escape.py): a 16^3 slope at 1 cm,
# 24 points on the plane x = 10.5 voxels; the LM's undamped first step
# (tau 1e-6) moves them to the slope's zero crossing, ESCAPE_ZEROS[0]: 7
# voxels, out of every window and into free space; ESCAPE_ZEROS[1]: 1.5
ESCAPE_RES, ESCAPE_VS, ESCAPE_N = 16, 0.01, 24
ESCAPE_ZEROS = (3.5, 9.0)
# the sharded viewer (step 9c; --only distributed at full width): CLI runs
# of SERVE_FRAMES frames with --serve and --turntable, their service step
# wrapped (ServeProbe): SERVE_VIEW alone at the last frame but one, then
# every path of SERVE_PATHS at the last (SERVE_QUEUED of them need every
# rank), SERVE_LATE after the last step
SERVE_WORK = os.path.join(HERE, "chip_smoke_serve")
SERVE_FRAMES = 6
SERVE_PATHS = ("/frame.png", "/status",
               "/view.png?yaw=3.1&pitch=-0.25&dist=0.9", "/mesh.bin",
               "/mesh.ply")
SERVE_QUEUED = 3
SERVE_VIEW = "/view.png?yaw=2.8&pitch=-0.3&dist=1.0"
SERVE_LATE = "/view.png?yaw=2.0"
SERVE_TURNTABLE = 3
SERVE_RANKS = 2               # on one card (gloo)
SERVE_TIMEOUT_S = 300.0
# the small scene's configuration (step 10's SMALL_OBJECTS, 160x120)
SERVE_SMALL_CONFIG = """[Params]
frameSize = 160 120
globalVolumeDims = 128 128 128
globalVoxelSize = 0.02
volumePose = 0.0 0.0 1.28
objVolumeDims = 32 32 32
maxTrackingIter = 50
raycast_max_steps = 256
max_objects = 4
maskRCNNFrames = 3
visibilityThresh = 60
mask_min_pixels = 60
boundary = 5
"""


# ---------------------------------------------------------------------
# analytic scene: a numpy copy of the tests' ray-sphere/plane renderer
class Scene:
    def __init__(self, H, W, f, spheres, planes, max_depth=4.0, cx=None,
                 cy=None):
        self.H, self.W, self.f = H, W, f
        self.cx = W / 2 - 0.5 if cx is None else cx
        self.cy = H / 2 - 0.5 if cy is None else cy
        self.spheres = spheres          # [(centre (3,), radius)]
        self.planes = planes            # [(unit normal (3,), point (3,))]
        self.max_depth = max_depth

    def render(self, cam_pose, objects=()):
        """Depth (H, W) float32 of the scene seen from camera-to-world
        ``cam_pose``; 0 where nothing is hit within ``max_depth``.
        ``objects``: extra (centre, radius) spheres; with them, also
        returns each one's mask (where it is the nearest surface)."""
        Tinv = np.linalg.inv(cam_pose)
        R, t = Tinv[:3, :3], Tinv[:3, 3]
        ys, xs = np.mgrid[0:self.H, 0:self.W]
        d = np.stack([(xs - self.cx) / self.f, (ys - self.cy) / self.f,
                      np.ones_like(xs, np.float64)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)

        def sphere_t(c_w, r):
            c = R @ c_w + t
            b = -2 * (d @ c)
            disc = b * b - 4 * (c @ c - r * r)
            ts = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / 2,
                          np.inf)
            return np.where(ts > 0, ts, np.inf)

        best = np.full((self.H, self.W), np.inf)
        for c_w, r in self.spheres:
            best = np.minimum(best, sphere_t(c_w, r))
        for n_w, p_w in self.planes:
            n_c, p_c = R @ n_w, R @ p_w + t
            den = d @ n_c
            tp = np.where(np.abs(den) > 1e-9, (p_c @ n_c) / den, np.inf)
            best = np.minimum(best, np.where(tp > 0, tp, np.inf))
        t_obj = [sphere_t(np.asarray(c_w), r) for c_w, r in objects]
        for to in t_obj:
            best = np.minimum(best, to)
        depth = np.where(np.isfinite(best), best * d[..., 2], 0.0)
        depth = np.where(depth > self.max_depth, 0.0, depth).astype(
            np.float32)
        if not objects:
            return depth
        return depth, [np.isfinite(to) & (to <= best) for to in t_obj]


def sensor_depth(depth, rng):
    """Depth as a structured-light sensor gives it: axial noise growing
    with range (sigma = 1.2 mm + 1.9 mm (z - 0.4 m)^2, Nguyen et al.,
    3DIMPVT 2012) and 1% of the pixels dropped."""
    sigma = 0.0012 + 0.0019 * (depth - 0.4) ** 2
    noisy = depth + sigma * rng.standard_normal(depth.shape)
    keep = (depth > 0) & (rng.random(depth.shape) >= 0.01)
    return np.where(keep, noisy, 0.0).astype(np.float32)


def make_scene(H, W, f, cx=None, cy=None):
    """The analytic scene seen through a camera of focal length ``f``
    (pixels) and principal point (``cx``, ``cy``), the image centre by
    default."""
    return Scene(H, W, f, cx=cx, cy=cy,
                 spheres=[(np.array([-0.45, 0.05, 1.4]), 0.35),
                          (np.array([0.5, -0.3, 1.7]), 0.3),
                          (np.array([0.1, 0.35, 2.3]), 0.4)],
                 planes=[(np.array([0.0, 1.0, 0.0]),
                          np.array([0.0, 0.8, 0.0])),
                         (np.array([0.0, 0.0, 1.0]),
                          np.array([0.0, 0.0, 3.4]))])


def gt_pose(i):
    """Smooth camera path: yaw 0.25 deg, 6 mm sideways, 3 mm down and
    4 mm forward per frame (camera-to-world, world = frame-0 camera)."""
    th = 0.0044 * i
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, s, 0.006 * i],
                     [0, 1, 0, -0.003 * i],
                     [-s, 0, c, 0.004 * i],
                     [0, 0, 0, 1]], np.float32)


# the object path's two moving spheres: (centre at frame 0, radius,
# motion per frame), 1.3 and 1.5 m away, clear of the scene's spheres
MOVERS = [(np.array([-0.05, -0.35, 1.3]), 0.15, np.array([0.005, 0, 0])),
          (np.array([0.2, 0.3, 1.5]), 0.12, np.array([-0.005, 0, 0]))]


# steps 12-13, the respawn scene: (centre at frame 0, radius, motion per
# frame) of mover A, which leaves the view to the left (out of it from
# frame 13) and is deleted, B (the object path's second mover), and C,
# which enters the scene at RESPAWN_C, a mask frame, and spawns into A's
# freed slot; RESPAWN_FROM: the frame each enters the scene
RESPAWN_MOVERS = [
    (np.array([-0.5, -0.42, 1.3]), 0.10, np.array([-0.012, 0.0, 0.0])),
    MOVERS[1],
    (np.array([-0.1, -0.35, 1.3]), 0.13, np.array([0.005, 0.0, 0.0]))]
RESPAWN_FROM = (0, 0, 30)
RESPAWN_C = RESPAWN_FROM[2]
RESPAWN_FRAMES = 40
# step 13: the scene at tests/test_torch_pipeline_objects.py's SMALL size,
# every RESPAWN_SMALL_STEP-th frame, on the card and on the CPU
RESPAWN_SMALL = dict(frameSize=(160, 120), fx=120.0, fy=120.0, cx=79.5,
                     cy=59.5, globalVolumeDims=(96, 96, 96),
                     globalVoxelSize=0.03, volumePose=(0.0, 0.0, 1.4),
                     objVolumeDims=(32, 32, 32), maxTrackingIter=30,
                     maskRCNNFrames=3, visibilityThresh=60,
                     mask_min_pixels=60, raycast_max_steps=384,
                     max_objects=4)
RESPAWN_SMALL_STEP = 2
RESPAWN_SMALL_FRAMES = 18
ROOM4_FRAMES = 40             # step 14: configs/room4.cfg through the CLI


def movers_at(i, movers=MOVERS):
    return [(c + i * v, r) for c, r, v in movers]


def mask_provider(masks):
    """The port's ``CallableMaskProvider`` handing out the ground-truth
    masks ``masks[frame]`` (one detection each, class 'car')."""
    from emfusion_tpu_torch.segmentation import (
        CallableMaskProvider, Detection, make_score_vector,
    )

    def detect(rgb, frame):
        return [Detection(mask=m, scores=make_score_vector(3, 0.9))
                for m in masks.get(frame, [])]
    return CallableMaskProvider(detect)


# ---------------------------------------------------------------------
def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(build_log):
    """One line per compiled kernel function from ``-Xptxas=-v``: its
    registers and its stack and spills."""
    lines = []
    for name, log in build_log.items():
        entry, spill = "?", ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                regs = line.split(":", 1)[1].strip()
                lines.append(f"{name} {entry}: {regs}; {spill}")
    return lines


def time_ms(torch, fn, iters, warmup=2):
    """Mean ms per call over ``iters`` back-to-back calls, from CUDA
    events: the host's work between launches counts."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters):
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed between CUDA events, so the host's work per call (argument
    packing, the ctypes call, output allocation) is not in the time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bound(bytes_moved, ops):
    t_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def distinct(torch, idx):
    return int(torch.unique(idx.reshape(-1)).numel())


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------
# holding one kernel against its plain version: each returns its row
def sample_ops(n, n_fg):
    """The float32 operations K2's function needs: per point 40 (the
    rigid transform 15, the grid coordinates 6, the margin test 9, the
    cell 6 and the blend's weights 3, its sentinel 1), and per valid
    point of an object 56 more (per corner fg + bg, its test, the clamp
    and the division: 32; the blend 24)."""
    return 40 * n + 56 * n_fg


def hold_sample(torch, items, library=False):
    """K2 over the work table ``items`` in one launch (exact: the same
    arithmetic in the same order, built without FMA contraction; the
    same zeros). With ``library``, a one-item table's ``grid_sample``."""
    from emfusion_tpu_torch.geometry.sampling import (
        SampleItem, sample_items, sample_items_plain, transform_to_grid,
        trilinear_cell,
    )
    k = sample_items(items)
    plain = [SampleItem(it.vol, it.points, it.rot.cuda(), it.trans.cuda(),
                        it.voxel_size, it.counts, it.margin) for it in items]
    q = sample_items_plain(plain)
    err, zero_mismatch, points = 0.0, 0, 0
    nbytes, ops = 0, 0
    for it, (kp, kf), (qp, qf) in zip(plain, k, q):
        zero_mismatch += int(((kp == 0) != (qp == 0)).sum())
        err = max(err, max_err(kp, qp),
                  0.0 if kf is None else max_err(kf, qf))
        Z, Y, X = it.vol.shape
        flat = it.points.reshape(3, -1)
        N = flat.shape[1]
        points += N
        vx, vy, vz, _ = transform_to_grid(flat, it.rot, it.trans,
                                          it.voxel_size, (Z, Y, X))
        ok = qp.reshape(-1) != 0
        base, _, _, _ = trilinear_cell((Z, Y, X), vx[ok], vy[ok], vz[ok])
        corners = torch.cat([base + (dz * Y + dy) * X + dx
                             for dz in (0, 1) for dy in (0, 1)
                             for dx in (0, 1)])
        fg = it.counts is not None
        n_vox = distinct(torch, corners) if N else 0
        nbytes += (16 * N + it.vol.element_size() * n_vox
                   + (4 * N + 8 * n_vox if fg else 0))
        ops += sample_ops(N, int(ok.sum()) if fg else 0)
    lib = None
    if library:
        it = plain[0]
        Z, Y, X = it.vol.shape
        vx, vy, vz, _ = transform_to_grid(it.points.reshape(3, -1), it.rot,
                                          it.trans, it.voxel_size, (Z, Y, X))
        grid = torch.stack([vx / (X - 1) * 2 - 1, vy / (Y - 1) * 2 - 1,
                            vz / (Z - 1) * 2 - 1], -1).reshape(1, 1, 1, -1, 3)
        vol5 = it.vol[None, None]
        lib = graph_ms(torch, lambda: torch.nn.functional.grid_sample(
            vol5, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True), 50)
    return dict(
        max_abs_err=err if zero_mismatch == 0 else float("inf"), tol=0.0,
        zero_mismatch=zero_mismatch, items=len(items), points=points,
        shapes=[list(it.vol.shape) for it in items],
        ms=graph_ms(torch, lambda: sample_items(items), 50),
        plain_ms=time_ms(torch, lambda: sample_items_plain(plain), 5),
        bound=bound(nbytes, ops), library_ms=lib)


def window_voxels(torch, anchor, shape):
    """The distinct voxels of a volume of ``shape`` that the 6^3 windows
    at the (3, N) anchors read (clipped), marked in chunks of points."""
    Z, Y, X = shape
    ax, ay, az = anchor[0].long(), anchor[1].long(), anchor[2].long()
    win = torch.arange(6, device=ax.device)
    zc = torch.clamp(az[:, None] + win, 0, Z - 1)
    yc = torch.clamp(ay[:, None] + win, 0, Y - 1)
    xc = torch.clamp(ax[:, None] + win, 0, X - 1)
    seen = torch.zeros(Z * Y * X, dtype=torch.bool, device=ax.device)
    for c0 in range(0, ax.numel(), 32768):
        sl = slice(c0, c0 + 32768)
        idx = ((zc[sl, :, None, None] * Y + yc[sl, None, :, None]) * X
               + xc[sl, None, None, :])
        seen[idx.reshape(-1)] = True
    return int(seen.sum())


def capture_bound(n_points, n_vox, es=4):
    """K3's bound: per point its 12 bytes read, its 2 x 216 cache values
    (``es`` bytes each: 4, or 2 for a bf16 volume) and 3 anchors (12
    bytes) written, each window voxel's tsdf and weight read once; 20
    float32 operations a point (the rigid transform, the grid coordinates
    and the floors)."""
    return bound(12 * n_points + 2 * 216 * es * n_points + 12 * n_points
                 + 2 * es * n_vox, 20 * n_points)


def hold_capture(torch, vols, pts, R, t, vs):
    """K3 (exact: the same voxel reads and the same anchors)."""
    from emfusion_tpu_torch.geometry.capture import (
        capture_neighborhoods, capture_neighborhoods_plain,
    )
    Rd, td = R.cuda(), t.cuda()
    kc, ka = capture_neighborhoods(vols, pts, R, t, vs)
    qc, qa = capture_neighborhoods_plain(vols, pts, Rd, td, vs)
    anchor_mismatch = int((ka != qa).sum())
    err = max_err(kc, qc) if anchor_mismatch == 0 else float("inf")
    del kc, qc
    N = pts.shape[1]
    return dict(
        max_abs_err=err, tol=0.0, anchor_mismatch=anchor_mismatch,
        points=N,
        ms=graph_ms(torch, lambda: capture_neighborhoods(
            vols, pts, R, t, vs), 10),
        plain_ms=time_ms(torch, lambda: capture_neighborhoods_plain(
            vols, pts, Rd, td, vs), 3),
        bound=capture_bound(N, window_voxels(torch, qa, vols[0].shape),
                            vols[0].element_size()),
        library_ms=None)


def hold_capture_batched(torch, tsdfs, weights, pts, rel, vs):
    """K3 over a batched LM stage's table, every slot in one launch
    (exact, as :func:`hold_capture`): ``pts`` (S, 3, M), ``rel`` (S, 4,
    4) camera-to-object, ``vs`` (S,)."""
    from emfusion_tpu_torch.geometry.capture import (
        capture_neighborhoods_batched, capture_neighborhoods_batched_plain,
    )
    R, t = rel[:, :3, :3], rel[:, :3, 3]
    Rd, td = R.cuda(), t.cuda()
    kc, ka = capture_neighborhoods_batched(tsdfs, weights, pts, R, t, vs)
    qc, qa = capture_neighborhoods_batched_plain(tsdfs, weights, pts, Rd, td,
                                                 vs)
    anchor_mismatch = int((ka != qa).sum())
    err = max_err(kc, qc) if anchor_mismatch == 0 else float("inf")
    del kc, qc
    S, _, M = pts.shape
    n_vox = sum(window_voxels(torch, qa[s], tsdfs[s].shape)
                for s in range(S))
    return dict(
        max_abs_err=err, tol=0.0, anchor_mismatch=anchor_mismatch,
        points=S * M, items=S, shapes=[list(v.shape) for v in tsdfs],
        ms=graph_ms(torch, lambda: capture_neighborhoods_batched(
            tsdfs, weights, pts, R, t, vs), 10),
        plain_ms=time_ms(torch, lambda: capture_neighborhoods_batched_plain(
            tsdfs, weights, pts, Rd, td, vs), 3),
        bound=capture_bound(S * M, n_vox, tsdfs[0].element_size()),
        library_ms=None)


def hold_raycast(torch, tsdf, weights, R, t, intr, vs, td, H, W, max_steps,
                 report=None):
    """K4 (mask agreeing on >= 99.99% of pixels; raylengths, vertices and
    normals within 1e-4 where both hit: the same arithmetic, but a ray's
    outcome is a chain of hundreds of dependent steps). With ``report``,
    also K4's march from the plain version's counts."""
    from emfusion_tpu_torch.geometry.sampling import trilinear_cell
    from emfusion_tpu_torch.ops.raycast import (
        raycast_volume, raycast_volume_plain,
    )
    Z, Y, X = tsdf.shape
    HW = H * W
    Rd, tdv = R.cuda(), t.cuda()
    kr = raycast_volume(tsdf, weights, R, t, intr, vs, td, H, W, max_steps)
    st = {}
    qr = raycast_volume_plain(tsdf, weights, Rd, tdv, intr, vs, td, H, W,
                              max_steps, stats=st)
    both = kr["mask"] & qr["mask"]
    mask_mismatch = int((kr["mask"] != qr["mask"]).sum())
    err = max(max_err(kr["raylengths"][both], qr["raylengths"][both]),
              max_err(kr["vertices"][:, both], qr["vertices"][:, both]),
              max_err(kr["normals"][:, both], qr["normals"][:, both]))
    hits = qr["mask"].reshape(-1)
    vstar = [(pt / vs + (n - 1) / 2.0) for pt, n in
             zip((qr["vertices"].reshape(3, -1)[:, hits].T @ Rd.T
                  + tdv).T, (X, Y, Z))]
    base, _, _, _ = trilinear_cell((Z, Y, X), *vstar)
    corners = torch.cat([base + (dz * Y + dy) * X + dx for dz in (0, 1)
                         for dy in (0, 1) for dx in (0, 1)])
    if report is not None:
        report["raycast_march"] = march_stats(st)
    return dict(
        max_abs_err=err if mask_mismatch <= 1e-4 * HW else float("inf"),
        tol=1e-4, mask_mismatch=mask_mismatch, hits=int(hits.sum()),
        ms=graph_ms(torch, lambda: raycast_volume(
            tsdf, weights, R, t, intr, vs, td, H, W, max_steps), 20),
        plain_ms=time_ms(torch, lambda: raycast_volume_plain(
            tsdf, weights, Rd, tdv, intr, vs, td, H, W, max_steps), 1,
            warmup=0),
        bound=bound(29 * HW + 2 * tsdf.element_size()
                    * distinct(torch, corners),
                    raycast_ops(st, HW, int(hits.sum()))),
        library_ms=None)


def copy_items(items, copy):
    """Fusion items with their volumes replaced by ``copy`` of them."""
    return [dataclasses.replace(it, tsdf=copy(it.tsdf),
                                weights=copy(it.weights)) for it in items]


def fusion_traffic(torch, items, after, depth, intr):
    """What K1's function needs for this frame, from its voxel classes
    (``ops.fusion.voxel_classes``, the plain version's projection) and the
    plain result ``after`` per item. Bytes: the depth image once; per
    item its association image; 8 per ``BAND`` voxel (tsdf and weight
    read), 4 per ``BEHIND``, ``HOLE`` or ``NEG`` voxel (the weight) and 4
    more where that weight is 0 (the tsdf), 4 per stored value that
    changed; nothing for a ``SKIP`` voxel (half of each of those for a
    bf16 item). Float32 operations: per voxel
    28 (its centre, the rigid transform, the pixel's two divisions,
    products and sums, the in-image test), per ``NEG`` or ``BAND`` voxel
    18 more (the ray factor, the distance and the sdf), per ``BAND`` voxel
    12 more (the truncated measurement and the weighted average). Also
    the all-voxel count, every voxel read and written and 50 operations
    each (``bound_all``), and the class shares."""
    from emfusion_tpu_torch.ops.fusion import (
        BAND, BEHIND, HOLE, NEG, SKIP, voxel_classes,
    )
    HW = depth.numel()
    nbytes, ops, n_all, all_bytes = 4 * HW, 0, 0, 0
    c = dict(voxels=0, skip=0, behind=0, hole=0, neg=0, band=0,
             tsdf_changed=0, weights_changed=0, any_changed=0)
    for it, (qt, qw) in zip(items, after):
        cls = voxel_classes(it.tsdf.shape, depth, it.rot, it.trans, intr,
                            it.voxel_size, it.truncdist, it.z0, it.Z)
        n = {name: int((cls == code).sum()) for name, code in (
            ("skip", SKIP), ("behind", BEHIND), ("hole", HOLE),
            ("neg", NEG), ("band", BAND))}
        rule = (cls == BEHIND) | (cls == HOLE) | (cls == NEG)
        rule_w0 = int((rule & (it.weights == 0)).sum())
        del cls, rule
        es = it.tsdf.element_size()
        bits = torch.int16 if es == 2 else torch.int32
        t_ch = qt.view(bits) != it.tsdf.view(bits)
        w_ch = qw.view(bits) != it.weights.view(bits)
        V = it.tsdf.numel()
        c["voxels"] += V
        for name, v in n.items():
            c[name] += v
        n_changed = int(t_ch.sum()) + int(w_ch.sum())
        c["tsdf_changed"] += int(t_ch.sum())
        c["weights_changed"] += int(w_ch.sum())
        c["any_changed"] += int((t_ch | w_ch).sum())
        del t_ch, w_ch
        nbytes += (4 * HW + 2 * es * n["band"]
                   + es * (n["behind"] + n["hole"] + n["neg"])
                   + es * rule_w0 + es * n_changed)
        ops += 28 * V + 18 * (n["neg"] + n["band"]) + 12 * n["band"]
        n_all += V
        all_bytes += 4 * es * V + 8 * HW
    V = c["voxels"]
    shares = dict(in_image=(c["hole"] + c["neg"] + c["band"]) / V,
                  behind=c["behind"] / V, changed=c["any_changed"] / V)
    return bound(nbytes, ops), bound(all_bytes, 50 * n_all), c, shares


def hold_fusion(torch, items, depth, intr):
    """K1 over the work table ``items`` in one launch, on copies of the
    volumes, against the plain version per item (exact: the same
    arithmetic, no FMA contraction, a value stored only where its bits
    changed)."""
    from emfusion_tpu_torch.ops import fusion
    kit = copy_items(items, lambda v: v.clone())
    fusion.integrate_tsdf_batched(kit, depth, intr)
    qit = copy_items(items, lambda v: v.clone())

    def plain():
        for it in qit:
            fusion.integrate_tsdf_plain(
                it.tsdf, it.weights, depth, it.assoc, it.rot, it.trans,
                intr, it.voxel_size, it.truncdist, it.max_weight,
                it.carve_dist, it.carve_weight_cap, it.carve_margin)

    plain()
    err = max(max(max_err(k.tsdf, q.tsdf), max_err(k.weights, q.weights))
              for k, q in zip(kit, qit))
    (b, b_all, counts, shares) = fusion_traffic(
        torch, items, [(q.tsdf, q.weights) for q in qit], depth, intr)
    row = dict(
        max_abs_err=err, tol=0.0, items=len(items),
        shapes=[list(it.tsdf.shape) for it in items], voxels=counts,
        shares=shares, bound_all=b_all,
        ms=graph_ms(torch, lambda: fusion.integrate_tsdf_batched(
            kit, depth, intr), 10),
        plain_ms=time_ms(torch, plain, 2, warmup=1),
        bound=b, library_ms=None)
    del kit, qit
    torch.cuda.empty_cache()
    return row


def lm_cells(torch, it, R, t):
    """Per point of LM item ``it`` at the pose (R, t): the flat indices
    of the 27 clipped corners of the points that ``lm_system`` gathers (a
    validity rule of ψ or of a shifted trilerp admits them) and of the 8
    corners of those with a valid (margin-1) ψ and weight, and the valid
    points' mask."""
    from emfusion_tpu_torch.geometry.sampling import transform_to_grid
    Z, Y, X = it.tsdf.shape
    vx, vy, vz, pz = transform_to_grid(it.points, R, t, it.voxel_size,
                                       (Z, Y, X))

    def ok(ex, ey, ez, m):
        return ((pz > 0) & (vx + ex >= 0) & (vy + ey >= 0) & (vz + ez >= 0)
                & (vx + ex + m < X) & (vy + ey + m < Y) & (vz + ez + m < Z))

    v1 = ok(0, 0, 0, 1)
    adm = v1 | ok(1, 0, 0, 2) | ok(0, 1, 0, 2) | ok(0, 0, 1, 2)
    x0, y0, z0 = (torch.floor(v).long() for v in (vx, vy, vz))
    d = (0, 1, 2)
    c27 = torch.cat([((z0[adm] + dz).clamp(0, Z - 1) * Y
                      + (y0[adm] + dy).clamp(0, Y - 1)) * X
                     + (x0[adm] + dx).clamp(0, X - 1)
                     for dz in d for dy in d for dx in d])
    c8 = torch.cat([((z0[v1] + dz) * Y + y0[v1] + dy) * X + x0[v1] + dx
                    for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)])
    return c27, c8, v1


def lm_system_bound(torch, items, run, only=None):
    """``lm_system``'s bound for this state (over the LMs ``only``, or
    all), charging only what the function needs: per point its 12 bytes of coordinates read and its
    track and Huber weights written; the 4 bytes of its association
    weight only where the other factors of its track weight (Huber and
    integration weight) are not 0; each distinct voxel of the tsdf
    corners and weight cells it reads once; and the sums. Float32
    operations: per point 56 (the transform 18, the grid coordinates 6,
    the validity rules 31, the weight maximum 1), per gathered point 175
    more (four trilerps from the 27 corners, the weight's, the gradient,
    the Huber weight), per point whose Huber and integration weights are
    not 0, 3 more (its track weight), and per point whose track weight
    is not 0, 72 more (J and the 28 terms, each float64 addition counted
    as one). A table of cache items: :func:`lm_cache_system_bound`."""
    from emfusion_tpu_torch.tracking import SF_R, SF_T
    if run.cached:
        return lm_cache_system_bound(torch, items, run, only)
    nbytes = ops = 0
    for k, it in enumerate(items):
        if only is not None and k not in only:
            continue
        c27, c8, _ = lm_cells(torch, it, run.sf[k, SF_R:SF_R + 9].reshape(
            3, 3), run.sf[k, SF_T:SF_T + 3])
        sl = run.point_slice(k)
        factors = int(((run.hub[sl] != 0) & (run.scratch[4, sl] != 0))
                      .sum())
        terms = int((run.w[sl] != 0).sum())
        n = it.points.shape[1]
        nbytes += (20 * n + 4 * factors + it.tsdf.element_size() * (
            distinct(torch, c27) + distinct(torch, c8)) + 8 * 29)
        ops += 56 * n + 175 * (c27.numel() // 27) + 3 * factors + 72 * terms
    return bound(nbytes, ops)


def lm_trial_bound(torch, items, run):
    """``lm_trial``'s bound for the LMs with a trial step (the others
    return at once), charging only what the function needs: per point
    the 4 bytes of its track weight read (a point whose weight is 0 adds
    a term of exactly 0); per point whose weight is not 0 its 12 bytes of
    coordinates; the distinct voxels of the cells of those points that
    are valid at the trial pose, once; a sum written. Float32
    operations: 1 a point (the weight's test), 34 a point whose weight is
    not 0 (the transform 18, the grid coordinates 6, the validity 10) and
    27 more a sampled one (the trilerp and the term). A table of cache
    items: :func:`lm_cache_trial_bound`."""
    from emfusion_tpu_torch.tracking import SF_RN, SF_TN, SI_TRIAL
    if run.cached:
        return lm_cache_trial_bound(torch, items, run)
    nbytes = ops = 0
    for k, it in enumerate(items):
        if not int(run.si[k, SI_TRIAL]):
            continue
        R = run.sf[k, SF_RN:SF_RN + 9].reshape(3, 3)
        t = run.sf[k, SF_TN:SF_TN + 3]
        weighted = run.w[run.point_slice(k)] != 0
        _, _, v1 = lm_cells(torch, it, R, t)
        use = v1 & weighted
        c8 = lm_cells(torch, dataclasses.replace(
            it, points=it.points[:, use]), R, t)[1]
        n, nw = it.points.shape[1], int(weighted.sum())
        nbytes += (4 * n + 12 * nw + it.tsdf.element_size() * distinct(
            torch, c8) + 8)
        ops += n + 34 * nw + 27 * int(use.sum())
    return bound(nbytes, ops)


def cache_needs(torch, it, R, t):
    """Per point of cache item ``it`` at the pose (R, t), what
    ``lm_system``'s cache phase needs: (the window values of channel 0
    that carry a nonzero tent product in a sample the point's validity
    rules keep: ψ and the gradient's base, and each shifted sample; the
    values of channel 1 of the margin-1 weight; the points a validity
    rule admits, which read their anchors; the points with a valid ψ),
    the first two counted over all points."""
    from emfusion_tpu_torch import tracking as tr
    Z, Y, X = it.tsdf.shape
    (vx, vy, vz), pz, (lx, ly, lz), win = tr._cache_grid(it, R, t)

    def ok(ex, ey, ez, m):
        return ((pz > 0) & (vx + ex >= 0) & (vy + ey >= 0) & (vz + ez >= 0)
                & (vx + ex + m < X) & (vy + ey + m < Y) & (vz + ez + m < Z))

    in1 = ok(0, 0, 0, 1)
    vsx, vsy, vsz = ok(1, 0, 0, 2), ok(0, 1, 0, 2), ok(0, 0, 1, 2)
    valid1 = in1 & win

    def taps(v):
        return torch.stack(tr._tents(v)) != 0          # (6, N)

    tx, ty, tz = taps(lx), taps(ly), taps(lz)
    tx1, ty1, tz1 = taps(lx + 1.0), taps(ly + 1.0), taps(lz + 1.0)

    def cube(a, b, c):                                  # (z, y, x, N)
        return a[:, None, None] & b[None, :, None] & c[None, None, :]

    base = cube(tz, ty, tx) & valid1
    need = (base | (cube(tz, ty, tx1) & vsx) | (cube(tz, ty1, tx) & vsy)
            | (cube(tz1, ty, tx) & vsz))
    return (int(need.sum()), int(base.sum()),
            int((in1 | vsx | vsy | vsz).sum()), valid1)


def lm_cache_system_bound(torch, items, run, only=None):
    """:func:`lm_system_bound` for a table of cache items, charging only
    what the function needs: per point its 12 bytes of coordinates read
    and its track and Huber weights written, the 4 bytes of its
    association weight where its Huber and integration weights are not 0,
    its 12 bytes of anchors where a validity rule admits it, the window
    values :func:`cache_needs` counts (4 bytes each, 2 in a bf16 cache),
    and the sums. Float32 operations: per point 56 (as the gather's), per
    admitted point 255 more (the window test 9, 18 tents of 3 operations,
    the x sums 90, the y sums 45, the z sums 20, the gradient 6, the
    weight's tent sum 21, the Huber weight 4, the clamp 1, the rest
    conversions), 3 per point whose factors are not 0 and 72 per point
    whose track weight is not 0."""
    from emfusion_tpu_torch.tracking import SF_R, SF_T
    nbytes = ops = 0
    for k, it in enumerate(items):
        if only is not None and k not in only:
            continue
        taps, wtaps, admitted, _ = cache_needs(
            torch, it, run.sf[k, SF_R:SF_R + 9].reshape(3, 3),
            run.sf[k, SF_T:SF_T + 3])
        sl = run.point_slice(k)
        factors = int(((run.hub[sl] != 0) & (run.scratch[4, sl] != 0))
                      .sum())
        terms = int((run.w[sl] != 0).sum())
        n = it.points.shape[1]
        nbytes += (20 * n + 4 * factors + 12 * admitted
                   + it.cache.element_size() * (taps + wtaps) + 8 * 29)
        ops += 56 * n + 255 * admitted + 3 * factors + 72 * terms
    return bound(nbytes, ops)


def lm_cache_trial_bound(torch, items, run, drift=()):
    """:func:`lm_trial_bound` for a table of cache items: per point the 4
    bytes of its track weight; per point whose weight is not 0 its 12
    bytes of coordinates; per such point valid at the trial pose (inside
    its window) its 12 bytes of anchors and the values of channel 0 with
    a nonzero tent product; a sum written. Float32 operations: 1 a point,
    34 a weighted point, 43 more a sampled one (the window test 9, 6
    tents of 3 operations, the tent sum 14, the term 2). The items of
    ``drift`` also count their drift at the trial pose in the same pass,
    charged only for what the trial does not already do: per point of
    weight 0 its 12 bytes of coordinates and 34 operations (the
    transform 18, the grid coordinates 6, the relevance test 10), and per
    relevant point that is not sampled its 12 bytes of anchors and 9
    operations (the window test)."""
    from emfusion_tpu_torch.geometry import capture as cap
    from emfusion_tpu_torch.tracking import SF_RN, SF_TN, SI_TRIAL
    nbytes = ops = 0
    for k, it in enumerate(items):
        if not int(run.si[k, SI_TRIAL]):
            continue
        R = run.sf[k, SF_RN:SF_RN + 9].reshape(3, 3)
        t = run.sf[k, SF_TN:SF_TN + 3]
        weighted = run.w[run.point_slice(k)] != 0
        sub = dataclasses.replace(it, points=it.points[:, weighted],
                                  anchor=it.anchor[:, weighted],
                                  cache=it.cache[..., weighted])
        _, wtaps, _, valid1 = cache_needs(torch, sub, R, t)
        n, nw = it.points.shape[1], int(weighted.sum())
        nbytes += (4 * n + 12 * nw + 12 * int(valid1.sum())
                   + it.cache.element_size() * wtaps + 8)
        ops += n + 34 * nw + 43 * int(valid1.sum())
        if k in drift:
            shape = tuple(it.tsdf.shape)
            grid, local = cap._local_coords(it.anchor, it.points, R, t,
                                            it.voxel_size, shape)
            sampled = weighted & cap._cache_valid(grid, local, shape, 1)
            rest = int((cap._relevant(*grid, shape) & ~sampled).sum())
            nbytes += 12 * (n - nw) + 12 * rest
            ops += 34 * (n - nw) + 9 * rest
    return bound(nbytes, ops)


def sums_gap(torch, a, b):
    """The float64 sums ``a`` (kernel) and ``b`` (plain), rounded to
    float32: (their largest gap, or inf where one is more than a float32
    ulp apart; the largest ulp); then ``b`` takes ``a``'s values, so both
    runs go on from one state."""
    af, bf = a.float(), b.float()
    ulp = (torch.nextafter(bf, torch.full_like(bf, float("inf"))) - bf).abs()
    ok = bool(((af - bf).abs() <= ulp).all())
    gap, top = float((af - bf).abs().max()), float(ulp.max())
    b.copy_(a)
    return (gap if ok else float("inf")), top


def plain_iteration(tr, run, cfg):
    """One LM iteration of the plain versions on ``run``'s device."""
    tr.lm_system_plain(run, cfg)
    tr.lm_step_plain(run, cfg, 0)
    tr.lm_trial_plain(run, cfg)
    tr.lm_step_plain(run, cfg, 1)


def hold_lm_run(torch, items, cfg, reps=20):
    """``lm_run`` over the table ``items`` with the LM constants ``cfg``,
    from a fresh state, against the plain iteration
    (:func:`plain_iteration`) on the card, three ways:
    (1) a launch an iteration in lockstep with the plain iteration until
    every LM has stopped: the per-point values (ψ, gradient, clamped
    weight, Huber and track weights), the weight maxima and the int words
    of the records exactly, the float64 sums and trial errors within a
    float32 ulp once rounded, the poses within 1e-5 (``max_abs_err``,
    ``tol``) and the other float words within 1e-5 relative; the plain
    run takes the kernel's state after each iteration;
    (2) one launch of ``max_iter`` iterations (what the path launches),
    which must end on (1)'s last state bit for bit (records, sums,
    per-point values; ``whole_equal``);
    (3) the plain iteration alone to its stop, whose int words must equal
    (2)'s and its poses lie within 1e-5 of them (``whole_gap``).
    ``bound``: this run's, per iteration of (1) ``lm_system``'s bound
    over the LMs that evaluate in it plus ``lm_trial``'s over those that
    trial, summed over the run (``bound_run``) and divided by its
    iterations (``run_iterations``, the longest LM's); ``bound_first``
    that of the first iteration, where every LM evaluates. Times (CUDA
    events around a launch, the fresh state restored before each; medians
    of ``reps``): ``run_ms`` the launch of (2) and ``ms`` that over the
    iterations; ``split_ms`` the split kernels over the same iterations
    from the same state (one CUDA graph of the run, the restore in it),
    over the iterations; ``launch_ms`` a launch of one iteration and
    ``stopped_ms`` a launch once every LM has stopped (both with the
    host's launch in them: the card waits for it); ``plain_ms`` the first
    iteration of the plain versions. Returns the row."""
    from emfusion_tpu_torch import tracking as tr
    k, q = tr.LMRun(items, cfg), tr.LMRun(items, cfg)
    si0, sf0 = k.si.clone(), k.sf.clone()
    ok, gap, iters = True, 0.0, 0
    spent = {"bytes": 0.0, "operations": 0.0}
    first = None
    while iters < cfg.max_iter and bool(q.running(q.si, cfg).any()):
        evaluating = tr._items_with(q, cfg, tr.SI_EVAL)
        tr.lm_run(k, cfg, 1)
        tr.lm_system_plain(q, cfg)
        b_sys = lm_system_bound(torch, items, q, evaluating)
        tr.lm_step_plain(q, cfg, 0)
        b_trial = lm_trial_bound(torch, items, q)
        tr.lm_trial_plain(q, cfg)
        tr.lm_step_plain(q, cfg, 1)
        for t, by in (b_sys, b_trial):
            spent[by] += t
        if first is None:
            first = b_sys[0] + b_trial[0]
        torch.cuda.synchronize()
        ok &= all(torch.equal(a, b) for a, b in (
            (k.w, q.w), (k.hub, q.hub), (k.scratch, q.scratch),
            (k.wmax, q.wmax), (k.si, q.si)))
        for a, b in ((k.sys, q.sys), (k.trial, q.trial)):
            g, ulp = sums_gap(torch, a, b)
            ok &= g <= ulp
        rel = float(((k.sf - q.sf).abs() / q.sf.abs().clamp(min=1.0)).max())
        ok &= rel <= 1e-5
        gap = max(gap, max_err(k.sf[:, :tr.SF_X], q.sf[:, :tr.SF_X]))
        q.si.copy_(k.si)
        q.sf.copy_(k.sf)
        iters += 1
    words = ("si", "sf", "sys", "trial", "w", "hub", "scratch", "wmax")
    chain = {n: getattr(k, n).clone() for n in words}

    def restore(run):
        run.si.copy_(si0)
        run.sf.copy_(sf0)

    restore(k)
    tr.lm_run(k, cfg, cfg.max_iter)
    torch.cuda.synchronize()
    whole_equal = all(torch.equal(getattr(k, n), v) for n, v in chain.items())
    restore(q)
    for _ in range(cfg.max_iter):
        if not bool(q.running(q.si, cfg).any()):
            break
        plain_iteration(tr, q, cfg)
    torch.cuda.synchronize()
    whole_gap = (max_err(k.sf[:, :tr.SF_X], q.sf[:, :tr.SF_X])
                 if torch.equal(k.si, q.si) else float("inf"))
    ok &= whole_equal and whole_gap <= 1e-5

    def launch_ms(n, fresh=True):
        times = []
        for _ in range(reps):
            if fresh:
                restore(k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tr.lm_run(k, cfg, n)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    one = launch_ms(1)
    whole = launch_ms(cfg.max_iter)

    def split_run():
        restore(k)
        for _ in range(iters):
            tr.lm_iteration(k, cfg)

    split = split_gap = None      # the split kernels take gather items only
    if not k.cached:
        split = graph_ms(torch, split_run, 1) / max(iters, 1)
        split_gap = max_err(k.sf[:, :tr.SF_X], chain["sf"][:, :tr.SF_X])
    k.si[:, tr.SI_CONV] = 1
    stopped = launch_ms(cfg.max_iter, fresh=False)
    by = max(spent, key=spent.get)
    n = max(iters, 1)
    row = dict(
        items=len(items), points=sum(k.n),
        shapes=[list(it.tsdf.shape) for it in items],
        max_abs_err=max(gap, whole_gap) if ok else float("inf"), tol=1e-5,
        whole_equal=whole_equal, whole_gap=whole_gap,
        bound=(sum(spent.values()) / n, by), bound_run=sum(spent.values()),
        bound_first=first, ms=whole / n, launch_ms=one, run_ms=whole,
        run_iterations=iters, split_ms=split, split_pose_gap=split_gap,
        stopped_ms=stopped, grid=k.grid, spans=k.part.shape[0],
        kernel=k.kernel, cluster=k.cluster,
        plain_ms=time_ms(torch, lambda: (restore(q), plain_iteration(
            tr, q, cfg)), 2, warmup=1), library_ms=None)
    del k, q
    torch.cuda.empty_cache()
    return row


def hold_lm_capture(torch, item, cfg, reps=5):
    """``lm_run`` over one re-capturing cache item (the capture sampler's
    LM: ``tracking.capture_table``, budget ``max_recaptures``) from
    ``item``'s start pose, its windows captured there by K3, against the
    plain versions on the card, three ways:
    (1) a launch an iteration in lockstep with the plain iteration until
    the LM stops, and after an iteration that flagged a re-capture, K3 at
    the trial pose into the card form's windows and the plain capture
    into the plain form's: the windows and anchors exactly, and after
    every iteration the per-point values, the weight maximum and the int
    words (the drift counts, the flag and the re-captures among them)
    exactly, the float64 sums within a float32 ulp once rounded, the
    poses within 1e-5 (``max_abs_err``, ``tol``) and the other float
    words within 1e-5 relative; the plain run takes the card's state
    after each iteration;
    (2) ``tracking.capture_table`` from the start (what the path runs:
    launches of ``max_iter`` iterations, K3 between them, a read after
    each), whose state must equal (1)'s last bit for bit and whose reads
    are at most 1 + its re-captures (``whole_equal``);
    (3) the plain versions alone from the start, re-capturing with the
    plain capture: the same int words as (2), poses within 1e-5
    (``whole_gap``).
    Fails unless the LM re-captured at least once. ``call_ms``: (2) whole
    on the host's clock around a synchronised call (launches, K3 and
    reads), median of ``reps``; ``ms`` that over its iterations. ``bound``:
    per iteration of (1) ``lm_system``'s bound if it evaluated, the
    trial's with its drift test where it ran (one pass,
    :func:`lm_cache_trial_bound`) and K3's for a re-capture, summed over
    the run and divided by its iterations. ``plain_ms``: the plain
    versions' first iteration.
    Returns the row."""
    from emfusion_tpu_torch import tracking as tr
    from emfusion_tpu_torch.geometry.capture import (
        capture_into, capture_neighborhoods_plain,
    )
    budget = cfg.max_recaptures
    (start,) = tr.capture_items([item])
    pose0 = torch.as_tensor(item.rel_pose, dtype=torch.float32)
    vols = (item.tsdf, item.weights)
    qc, qa = capture_neighborhoods_plain(vols, start.points,
                                         pose0[:3, :3].cuda(),
                                         pose0[:3, 3].cuda(), item.voxel_size)
    ok = torch.equal(qc, start.cache) and torch.equal(qa, start.anchor)
    cache0, anchor0 = start.cache.clone(), start.anchor.clone()

    def copy(cache=cache0, anchor=anchor0):
        return dataclasses.replace(start, cache=cache.clone(),
                                   anchor=anchor.clone())

    ki, qi = copy(), copy(qc, qa)
    k = tr.LMRun([ki], cfg, recaps=budget)
    q = tr.LMRun([qi], cfg, recaps=budget)

    def recapture(it, run, plain):
        pose = run.sf[0, tr.SF_RN:tr.SF_RN + 12].cpu()
        R, t = pose[:9].reshape(3, 3), pose[9:]
        if not plain:
            capture_into([(it.tsdf, it.weights, it.points, R, t,
                           it.voxel_size, it.cache, it.anchor)])
            return None
        c, a = capture_neighborhoods_plain(vols, it.points, R.cuda(),
                                           t.cuda(), it.voxel_size)
        return c, a

    gap, steps, recaps = 0.0, 0, 0
    spent = {"bytes": 0.0, "operations": 0.0}
    while (steps < cfg.max_iter + budget + 1
           and bool(q.running(q.si, cfg).any())):
        evaluating = tr._items_with(q, cfg, tr.SI_EVAL)
        tr.lm_run(k, cfg, 1)
        tr.lm_system_plain(q, cfg)
        parts = [lm_system_bound(torch, [qi], q, evaluating)]
        tr.lm_step_plain(q, cfg, 0)
        drift = bool(q.si[0, tr.SI_TRIAL]) and tr._drifts(q, 0)
        parts.append(lm_cache_trial_bound(torch, [qi], q,
                                          (0,) if drift else ()))
        tr.lm_trial_plain(q, cfg)
        tr.lm_step_plain(q, cfg, 1)
        torch.cuda.synchronize()
        ok &= all(torch.equal(a, b) for a, b in (
            (k.w, q.w), (k.hub, q.hub), (k.scratch, q.scratch),
            (k.wmax, q.wmax), (k.si, q.si)))
        for a, b in ((k.sys, q.sys), (k.trial, q.trial)):
            g, ulp = sums_gap(torch, a, b)
            ok &= g <= ulp
        rel = float(((k.sf - q.sf).abs() / q.sf.abs().clamp(min=1.0)).max())
        ok &= rel <= 1e-5
        gap = max(gap, max_err(k.sf[:, :tr.SF_X], q.sf[:, :tr.SF_X]))
        q.si.copy_(k.si)
        q.sf.copy_(k.sf)
        if int(k.si[0, tr.SI_PEND]):
            recaps += 1
            recapture(ki, k, False)
            c, a = recapture(qi, q, True)
            ok &= torch.equal(c, ki.cache) and torch.equal(a, ki.anchor)
            qi.cache.copy_(c)
            qi.anchor.copy_(a)
            parts.append(capture_bound(
                k.n[0], window_voxels(torch, a, item.tsdf.shape),
                item.tsdf.element_size()))
        for t, by in parts:
            spent[by] += t
        steps += 1
    chain = {n: getattr(k, n).clone() for n in
             ("si", "sf", "sys", "trial", "w", "hub", "scratch", "wmax")}
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        it = copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run, _ = tr.capture_table([it], cfg)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    whole_equal = all(torch.equal(getattr(run, n), v)
                      for n, v in chain.items())
    iters = int(run.si[0, tr.SI_IT])
    reads_ok = run.reads <= 1 + int(run.si[0, tr.SI_RECAP])
    alone_it = copy(qc, qa)
    alone = tr.LMRun([alone_it], cfg, recaps=budget)
    for _ in range(cfg.max_iter + budget + 1):
        if not bool(alone.running(alone.si, cfg).any()):
            break
        plain_iteration(tr, alone, cfg)
        if int(alone.si[0, tr.SI_PEND]):
            c, a = recapture(alone_it, alone, True)
            alone_it.cache.copy_(c)
            alone_it.anchor.copy_(a)
    torch.cuda.synchronize()
    whole_gap = (max_err(run.sf[:, :tr.SF_X], alone.sf[:, :tr.SF_X])
                 if torch.equal(run.si, alone.si) else float("inf"))
    ok &= whole_equal and reads_ok and whole_gap <= 1e-5
    if recaps == 0:
        raise RuntimeError(f"hold_lm_capture: the LM took no re-capture "
                           f"from its start ({iters} iterations)")
    fresh = tr.LMRun([copy(qc, qa)], cfg, recaps=budget)
    si0, sf0 = fresh.si.clone(), fresh.sf.clone()

    def plain_first():
        fresh.si.copy_(si0)
        fresh.sf.copy_(sf0)
        plain_iteration(tr, fresh, cfg)

    by = max(spent, key=spent.get)
    n = max(iters, 1)
    call = float(np.median(times))
    row = dict(
        items=1, points=k.n[0], shapes=[list(item.tsdf.shape)],
        max_abs_err=max(gap, whole_gap) if ok else float("inf"), tol=1e-5,
        whole_equal=whole_equal, whole_gap=whole_gap, reads=run.reads,
        recaptures=int(run.si[0, tr.SI_RECAP]), run_iterations=iters,
        cache_dtype=str(start.cache.dtype), kernel=k.kernel, grid=k.grid,
        bound=(sum(spent.values()) / n, by), bound_run=sum(spent.values()),
        ms=call / n, call_ms=call,
        plain_ms=time_ms(torch, plain_first, 2, warmup=1), library_ms=None)
    del k, q, run, alone, fresh
    torch.cuda.empty_cache()
    return row


def hold_lm(torch, items, cfg):
    """The device-resident LM's kernels over the table ``items`` (one LM
    an item, as the pipeline builds them) against their plain versions:
    ``lm_run`` as :func:`hold_lm_run` holds it, and the split kernels
    phase after phase on one state (the plain run takes the kernel's
    state after each comparison): ``lm_system``'s per-point values (ψ,
    gradient, clamped weight, Huber and track weights) and weight maxima
    exactly (tol 0) and its float64 sums, rounded to float32, within a
    float32 ulp (a tie); ``lm_trial``'s sums within a float32 ulp (its
    tol); ``lm_step``'s records after both phases: the int words exactly,
    the poses within 1e-5 (its max_abs_err and tol: sinf, cosf and acosf
    against PyTorch's CUDA operators) and the other words within 1e-5
    relative. Device times from CUDA graphs (``lm_step``'s a launch's, over
    alternating phases); the LMs run with an unreachable ``max_iter`` so
    that repeated calls keep working. ``stopped_ms``: each kernel's time
    once every LM has stopped (what an iteration enqueued past the end
    of a chunk costs). Returns the four rows."""
    from emfusion_tpu_torch import tracking as tr
    run_cfg = cfg
    cfg = dataclasses.replace(cfg, max_iter=10 ** 6)
    k, q = tr.LMRun(items, cfg), tr.LMRun(items, cfg)
    n_pts = sum(k.n)

    def step_gap(phase):
        tr.lm_step(k, cfg, phase)
        tr.lm_step_plain(q, cfg, phase)
        torch.cuda.synchronize()
        rel = float(((k.sf - q.sf).abs() / q.sf.abs().clamp(min=1.0)).max())
        gap = max_err(k.sf[:, :tr.SF_X], q.sf[:, :tr.SF_X])
        ok = torch.equal(k.si, q.si) and rel <= 1e-5
        q.si.copy_(k.si)
        q.sf.copy_(k.sf)
        return gap if ok else float("inf")

    what = dict(items=len(items), points=n_pts,
                shapes=[list(it.tsdf.shape) for it in items])
    tr.lm_system(k, cfg)
    tr.lm_system_plain(q, cfg)
    torch.cuda.synchronize()
    per_point = max(max_err(a, b) for a, b in (
        (k.w, q.w), (k.hub, q.hub), (k.scratch, q.scratch),
        (k.wmax, q.wmax)))
    sys_gap, sys_ulp = sums_gap(torch, k.sys, q.sys)
    rows = {"lm_system": dict(
        what, max_abs_err=per_point if sys_gap <= sys_ulp else float("inf"),
        tol=0.0, sums_max_abs_err=sys_gap, sums_ulp=sys_ulp,
        bound=lm_system_bound(torch, items, k),
        ms=graph_ms(torch, lambda: tr.lm_system(k, cfg), 10),
        plain_ms=time_ms(torch, lambda: tr.lm_system_plain(q, cfg), 2,
                         warmup=1), library_ms=None)}
    q.sys.copy_(k.sys)
    g0 = step_gap(0)
    tr.lm_trial(k, cfg)
    tr.lm_trial_plain(q, cfg)
    torch.cuda.synchronize()
    t_gap, t_ulp = sums_gap(torch, k.trial, q.trial)
    rows["lm_trial"] = dict(
        what, max_abs_err=t_gap, tol=t_ulp,
        bound=lm_trial_bound(torch, items, k),
        ms=graph_ms(torch, lambda: tr.lm_trial(k, cfg), 10),
        plain_ms=time_ms(torch, lambda: tr.lm_trial_plain(q, cfg), 2,
                         warmup=1), library_ms=None)
    q.trial.copy_(k.trial)
    g1 = step_gap(1)
    S = len(items)
    # a launch reads and writes its LMs' records and reads their sums;
    # ~600 operations an LM (the solve, se3_log, se3_exp, the products)
    step_bound = bound(S * (2 * 4 * (tr.SI_N + tr.SF_N) + 8 * 29), 600 * S)

    def pair(step):
        step(k, cfg, 0)
        step(k, cfg, 1)

    rows["lm_step"] = dict(
        what, max_abs_err=max(g0, g1), tol=1e-5, bound=step_bound,
        ms=graph_ms(torch, lambda: pair(tr.lm_step), 10) / 2,
        plain_ms=time_ms(torch, lambda: pair(tr.lm_step_plain), 2,
                         warmup=1) / 2, library_ms=None)
    k.si[:, tr.SI_CONV] = 1
    k.si[:, tr.SI_TRIAL] = 0
    for name, fn in (("lm_system", lambda: tr.lm_system(k, cfg)),
                     ("lm_trial", lambda: tr.lm_trial(k, cfg)),
                     ("lm_step", lambda: pair(tr.lm_step))):
        rows[name]["stopped_ms"] = graph_ms(torch, fn, 10) / (
            2 if name == "lm_step" else 1)
    del k, q
    torch.cuda.empty_cache()
    rows[LM_RUN] = hold_lm_run(torch, items, run_cfg)
    return rows


def print_row(name, r):
    """One line of a kernel row: its check, times, bound and, for the
    batched kernels, its table and (K1) the all-voxel bound and the
    class shares."""
    what = ""
    if "items" in r:
        what = f" ({r['items']} volumes {r['shapes'][:2]}..)"
    elif "shape" in r:
        what = f" ({r['shape']} at {r['voxel_size'] * 1e3:.2f} mm)"
    extra = ""
    if "bound_all" in r:
        extra = (f", all-voxel bound {r['bound_all'][0]:.4f} ms; in image "
                 f"{r['shares']['in_image']:.3f}, behind "
                 f"{r['shares']['behind']:.3f}, changed "
                 f"{r['shares']['changed']:.3f}")
    if "stopped_ms" in r:
        extra = f", once every LM has stopped {r['stopped_ms']:.4f} ms"
    if "floor_ms" in r:
        extra = f", the empty kernel on its grid {r['floor_ms']:.4f} ms"
    if "call_ms" in r:
        extra += (f"; a whole call {r['call_ms']:.4f} ms (its launches, K3 "
                  f"and reads) over {r['run_iterations']} iterations with "
                  f"{r['recaptures']} re-captures and {r['reads']} reads, "
                  f"the run's bound {r['bound_run']:.5f} ms, the call equal "
                  f"to the chain: {r['whole_equal']}, plain run alone "
                  f"{r['whole_gap']:.3e} away; {r['cache_dtype']} cache")
    if "run_ms" in r:
        split = ("cache items: no split kernels" if r["split_ms"] is None
                 else f"the split kernels {r['split_ms']:.4f} ms an "
                 f"iteration over the same, pose gap "
                 f"{r['split_pose_gap']:.3e}")
        extra += (f"; ms an iteration of a whole LM ({r['run_ms']:.4f} ms "
                  f"over {r['run_iterations']} iterations; {split}), the "
                  f"run's "
                  f"bound {r['bound_run']:.5f} ms (its first iteration "
                  f"{r['bound_first']:.5f}), one launch equal to the "
                  f"chain: {r['whole_equal']}, plain run alone "
                  f"{r['whole_gap']:.3e} away; a launch of one iteration "
                  f"{r['launch_ms']:.4f} ms, {r['grid']} blocks over "
                  f"{r['spans']} spans")
    print(f"{name}{what}: max_abs_err {r['max_abs_err']:.3e} (tol "
          f"{r['tol']:.0e}), {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} "
          f"ms, bound {r['bound'][0]:.5f} ms ({r['bound'][1]}){extra}",
          flush=True)


def kernel_phases(torch, pipe, depth_raw, report):
    """Every kernel against its plain version at the main path's shapes,
    on the state ``pipe`` has fused so far. Returns the kernel rows."""
    from emfusion_tpu_torch.geometry.camera import (
        bilateral_filter, bilateral_filter_plain,
    )
    from emfusion_tpu_torch.geometry.se3 import pose_inverse

    p = pipe.params
    s = pipe.state
    H, W = pipe.H, pipe.W
    HW = H * W
    vs, td = pipe.voxel, pipe.trunc
    rows = {}
    raw = torch.as_tensor(depth_raw).cuda()

    # K5 bilateral (tolerance 1e-5 m: both sum the same 49 taps in the
    # same order with the same expf; any difference is a fault)
    args = (p.bilateral_kernel_size, p.bilateral_sigma_depth,
            p.bilateral_sigma_spatial)
    k = bilateral_filter(raw, *args)
    q = bilateral_filter_plain(raw, *args)
    taps = p.bilateral_kernel_size ** 2
    rows["bilateral"] = dict(
        max_abs_err=max_err(k, q), tol=1e-5,
        ms=graph_ms(torch, lambda: bilateral_filter(raw, *args), 50),
        plain_ms=time_ms(torch, lambda: bilateral_filter_plain(raw, *args),
                         5),
        bound=bound(8 * HW + 4 * taps, 12 * taps * HW), library_ms=None)
    # one expf per tap on the special-function unit: the kernel's floor
    report["bilateral_expf_floor_ms"] = 1e3 * taps * HW / SFU_PER_S

    depth, points = pipe.preprocess(depth_raw)
    rel = pose_inverse(s.bg_pose) @ s.cam_pose
    R, t = rel[:3, :3], rel[:3, 3]
    rows["sample"] = hold_sample(torch, pipe.estep_items(points, [])[0],
                                 library=True)
    rows["capture"] = hold_capture(torch, (s.bg_tsdf, s.bg_weights),
                                   points.reshape(3, -1), R, t, vs)
    rows["raycast"] = hold_raycast(torch, s.bg_tsdf, s.bg_weights, R, t,
                                   pipe.intr, vs, td, H, W,
                                   p.raycast_max_steps, report)
    rows["fusion"] = hold_fusion(torch, pipe.fusion_items(), depth,
                                 pipe.intr)
    # the camera LM of the next frame, as track_camera builds it
    rows.update(hold_lm(torch, [pipe.camera_lm_item(points)],
                        pipe.track_cfg))
    rows.update(hold_warp(torch, *warp_inputs(torch, pipe, depth), report))
    return rows


def warp_inputs(torch, pipe, depth):
    """K6's inputs at the main path's sizes, as the TPU fusion and
    raycast use the warp: the filtered ``depth`` and the homography of
    the volume's centre slice (voxel indices -> pixels) at the state's
    camera pose, with the slice's plane."""
    from emfusion_tpu_torch.geometry.se3 import pose_inverse

    s = pipe.state
    Z, Y, X = s.bg_tsdf.shape
    inv = pose_inverse(s.cam_pose) @ s.bg_pose
    Bmat = centre_slice_homography(torch, inv[:3, :3], inv[:3, 3],
                                   pipe.intr, pipe.voxel, (Z, Y, X))
    return depth, Bmat, (-0.5, -0.5, float(X), float(Y))


def warp_floor_ms(torch, img, M, nS, nL, plane, round_half, mask_oob):
    """Device ms of ``emf_warp_floor``: an empty kernel on K6's grid and
    block with K6's arguments (timed as K6 is, not counted as a
    launch)."""
    from emfusion_tpu_torch import kernels
    from emfusion_tpu_torch.ops.warp import _homography_args

    out = torch.empty((nS, nL), dtype=torch.float32, device=img.device)
    H, W = img.shape
    args = (img.data_ptr(), out.data_ptr(), H, W, nS, nL,
            *_homography_args(M, plane), int(plane is not None),
            int(round_half), int(mask_oob))
    fn = kernels.library("warp").emf_warp_floor

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"emf_warp_floor: cudaError {err}")
    return graph_ms(torch, call, 50)


def hold_warp(torch, depth, Bmat, plane, report=None):
    """K6 both ways against its plain version (exact: the same picks of
    the same float32 values): ``depth`` onto the ``GRID`` reference-plane
    grid of ``plane`` through ``Bmat`` (as the TPU fusion warps it), and
    that grid back onto the pixels (as the TPU raycast warps its t* grid
    back). Each row also has ``floor_ms``, the empty kernel on K6's grid
    and block. Returns the ``warp_to_grid`` and ``warp_to_pixels``
    rows."""
    from emfusion_tpu_torch.ops.warp import (
        grid_index_homography, select_grid_at_pixels, warp_homography_plain,
        warp_image_to_grid,
    )

    H, W = depth.shape
    HW = H * W
    nS, nL = GRID
    rows = {}
    kg = warp_image_to_grid(depth, Bmat, H, W, *plane, nS, nL)
    qg = warp_homography_plain(depth, Bmat, nS, nL, plane)
    rows["warp_to_grid"] = dict(
        max_abs_err=max_err(kg, qg), tol=0.0,
        ms=graph_ms(torch, lambda: warp_image_to_grid(
            depth, Bmat, H, W, *plane, nS, nL), 50),
        floor_ms=warp_floor_ms(torch, depth, Bmat, nS, nL, plane, True,
                               True),
        plain_ms=time_ms(torch, lambda: warp_homography_plain(
            depth, Bmat, nS, nL, plane), 20),
        bound=bound(4 * HW + 4 * nS * nL, 25 * nS * nL), library_ms=None)
    Binv = torch.linalg.inv(Bmat)
    M = grid_index_homography(Binv, *plane, nS, nL)
    kp = select_grid_at_pixels(kg, Binv, *plane, H, W)
    qp = warp_homography_plain(kg, M, H, W, None, round_half=False,
                               mask_oob=False)
    rows["warp_to_pixels"] = dict(
        max_abs_err=max_err(kp, qp), tol=0.0,
        ms=graph_ms(torch, lambda: select_grid_at_pixels(
            kg, Binv, *plane, H, W), 50),
        floor_ms=warp_floor_ms(torch, kg, M, H, W, None, False, False),
        plain_ms=time_ms(torch, lambda: warp_homography_plain(
            kg, M, H, W, None, round_half=False, mask_oob=False), 20),
        bound=bound(4 * nS * nL + 4 * HW, 20 * HW), library_ms=None)
    if report is not None:
        report["warp_grid_cells_seen"] = float((qg > 0).float().mean())
    return rows


def object_kernel_phases(torch, pipe, depth_raw):
    """K1-K4 against their plain versions at an object's shapes, on the
    object path's final state: K1 over the frame's fusion table and K2
    over an E-step's table (the background and every live slot, its
    culled points, its fg/bg counts), as the pipeline builds them; K3 and
    K4 on the first live slot's 64^3 volume at its own voxel size (all
    tracking points; the raycast with fg-masked weights); the LM kernels
    over the serial object LMs' table of the live slots. Returns the
    rows."""
    from emfusion_tpu_torch.geometry.se3 import pose_inverse
    from emfusion_tpu_torch.volume import fg_probs

    p = pipe.params
    s, o = pipe.state, pipe.state.objs
    live = [int(k) for k in np.nonzero(pipe._h_active)[0]]
    k = live[0]
    depth, points = pipe.preprocess(depth_raw)
    rel = pose_inverse(o.pose[k]) @ s.cam_pose
    R, t = rel[:3, :3], rel[:3, 3]
    vs, td = float(o.voxel_size[k]), float(o.truncdist[k])
    ptsf = points.reshape(3, -1)
    rows = {
        "capture_object": hold_capture(torch, (o.tsdf[k], o.weights[k]),
                                       ptsf, R, t, vs),
        "raycast_object": hold_raycast(
            torch, o.tsdf[k],
            torch.where(fg_probs(o.fg_counts[k]) > 0.5, o.weights[k], 0.0),
            R, t, pipe.intr, vs, td, pipe.H, pipe.W, p.raycast_max_steps),
    }
    for r in rows.values():
        r.update(voxel_size=vs, shape=list(o.tsdf[k].shape))
    rows["sample_object"] = hold_sample(
        torch, pipe.estep_items(points, live)[0])
    rows["fusion_object"] = hold_fusion(torch, pipe.fusion_items(), depth,
                                        pipe.intr)
    # the serial object LMs' table, as track_objects builds it
    for name, r in hold_lm(torch, pipe.object_lm_items(points, live),
                           pipe.track_cfg).items():
        rows[f"{name}_objects"] = r
    return rows


def fill_pool(torch, pipe):
    """Replaces ``pipe``'s pool with a full one: every one of the
    ``max_objects`` slots live and visible, each a copy of one of the
    pool's live object volumes (in turn), its centre moved to a point of
    a grid spread across the image at the object's depth, its orientation
    kept. Returns each copy's sphere (centre, radius) in the world: its
    source's mover (the nearest at the pipeline's last frame), moved with
    the copy."""
    from emfusion_tpu_torch.geometry.se3 import pose_inverse
    from emfusion_tpu_torch.pipeline import empty_pool

    src = pipe.state.objs
    live = [int(k) for k in np.nonzero(pipe._h_active)[0]]
    movers = movers_at(pipe.frame - 1)
    near = {k: min(movers, key=lambda m: np.linalg.norm(
        m[0] - src.pose[k, :3, 3].numpy())) for k in live}
    spheres = []
    K, cam = pipe.K, pipe.state.cam_pose
    pool = empty_pool(K, pipe.obj_res, pipe.H, pipe.W, pipe.device)
    side = int(np.ceil(np.sqrt(K)))
    for j in range(K):
        k = live[j % len(live)]
        for key in ("tsdf", "weights", "fg_counts", "assoc"):
            getattr(pool, key)[j] = getattr(src, key)[k]
        pool.voxel_size[j], pool.truncdist[j] = (src.voxel_size[k],
                                                  src.truncdist[k])
        rel = pose_inverse(cam) @ src.pose[k]         # object -> camera
        z = float(rel[2, 3])
        gx, gy = (j % side) / (side - 1) - 0.5, (j // side) / (side - 1) - 0.5
        rel[0, 3] = 1.1 * gx * z * pipe.W / (2 * pipe.params.fx)
        rel[1, 3] = 1.1 * gy * z * pipe.H / (2 * pipe.params.fy)
        pool.pose[j] = cam @ rel
        c, r = near[k]
        spheres.append((pool.pose[j, :3, 3].numpy()
                        + (c - src.pose[k, :3, 3].numpy()), r))
    pool.active[:] = True
    pool.visible[:] = True
    pool.object_id[:] = torch.arange(1, K + 1, dtype=torch.int32)
    pipe.state.objs = pool
    return spheres


def pool_kernel_phases(torch, pipe, depth_raw):
    """K1, K2 and the LM kernels at a full pool (:func:`fill_pool`, which
    replaces ``pipe``'s pool); the tables are the pipeline's own
    (``fusion_items``, ``estep_items``, ``object_lm_items``). Returns the
    rows and the pool's spheres."""
    K = pipe.K
    spheres = fill_pool(torch, pipe)
    depth, points = pipe.preprocess(depth_raw)
    rows = {"sample_pool": hold_sample(
                torch, pipe.estep_items(points, list(range(K)))[0]),
            "fusion_pool": hold_fusion(torch, pipe.fusion_items(), depth,
                                       pipe.intr)}
    for name, r in hold_lm(torch, pipe.object_lm_items(points, list(
            range(K))), pipe.track_cfg).items():
        rows[f"{name}_pool"] = r
    return rows, spheres


def raycast_ops(st, n_rays, n_hits):
    """The float32 operations K4's function needs on this run's data, from
    the plain version's counts (a division, a floor, a compare or a square
    root counts one; integer index arithmetic and work fixed per launch
    are left out, as are the steps and crossings not counted below, so
    this is a lower bound):
    - per ray, 56: ux, uy (4), R (u, v, 1) (15), its norm (6) and the
      three divisions by it, the slab test (safe directions 6, entry and
      exit 15, max/min 4) and t, t_max and alive (3);
    - per phase-1 step, 23: grid_at (12: o + d t, / vs, + (res-1)/2 per
      axis), the margin test (9), the budget test and t + truncdist;
    - per phase-2 step, 2: t + step and the budget test; and for each of
      them that samples, 58 more: grid_at (12), the margin test (9), the
      cell (6: floor and fraction per axis), one trilinear sample (24:
      three 1 - f and seven lerps of two products and a sum), |nxt| < 1,
      < 0.8 (3), the back-face and crossing signs (4);
    - per back-face test that needs the weights, 25: one sample in the
      same cell and w > 0;
    - per hit, 209: its crossing (t*: 6, grid_at, margin test, cell, the
      weight sample and its test: 58) and the outputs (grid_at and cell
      at t* 18, the 8 corners' forward differences 24, three trilinear
      samples 66, the gradient's norm 7 and 3 divisions, the vertex 3,
      two rotations by R^T 30)."""
    return (56 * n_rays + 23 * int(st["steps_phase1"].sum())
            + 2 * st["steps"] + 58 * st["samples"]
            + 25 * st["weight_samples"] + 209 * n_hits)


def march_stats(st):
    """K4's march on this state, from the plain version's counts: steps
    per ray of each phase (mean, percentiles, max, histogram over
    ``STEP_EDGES``), and the shares of the phase-2 samples that read 8
    zero corners and that needed the weight sample. Prints one line."""
    out = {"steps": st["steps"], "hist_edges": STEP_EDGES}
    for ph in ("phase1", "phase2"):
        s = st[f"steps_{ph}"].reshape(-1).cpu().numpy()
        p50, p90, p99 = np.percentile(s, [50, 90, 99])
        out[ph] = dict(mean=float(s.mean()), p50=float(p50),
                       p90=float(p90), p99=float(p99), max=int(s.max()),
                       hist=np.histogram(s, STEP_EDGES)[0].tolist())
    # a warp of 32 neighbouring rays in a row runs as long as its longest
    s2 = st["steps_phase2"].reshape(-1, st["steps_phase2"].shape[-1])
    rows = np.pad(s2.cpu().numpy(), ((0, 0), (0, -s2.shape[1] % 32)))
    longest = rows.reshape(rows.shape[0], -1, 32).max(-1).sum()
    n = max(st["samples"], 1)
    out.update(samples=st["samples"], zero_share=st["zero_samples"] / n,
               weight_share=st["weight_samples"] / n,
               warp_lane_use=float(rows.sum() / max(32 * longest, 1)))
    print("raycast march, steps per ray: " + "; ".join(
        f"phase {ph[-1]} mean {out[ph]['mean']:.2f} p50 {out[ph]['p50']:.0f}"
        f" p90 {out[ph]['p90']:.0f} p99 {out[ph]['p99']:.0f} max "
        f"{out[ph]['max']}" for ph in ("phase1", "phase2"))
        + f"; samples {st['samples']}, 8 zero corners "
        f"{100 * out['zero_share']:.2f}%, weight needed "
        f"{100 * out['weight_share']:.5f}%; lane use of 32-ray row warps "
        f"{100 * out['warp_lane_use']:.1f}%", flush=True)
    return out


def centre_slice_homography(torch, rel_rot_oc, rel_trans_oc, intr, vs,
                            shape):
    """Voxel indices (x, y, 1) of the volume's centre z-slice -> the
    homogeneous pixel, ``K [r1 vs, r2 vs, t - vs (r1 ox + r2 oy)]``: the
    reference plane of the TPU fusion (``fusion_pencil._pencil_setup``)."""
    Z, Y, X = shape
    K = torch.as_tensor(intr, dtype=torch.float32)
    r1, r2 = rel_rot_oc[:, 0], rel_rot_oc[:, 1]
    t0 = rel_trans_oc - vs * (r1 * (X - 1) / 2.0 + r2 * (Y - 1) / 2.0)
    return K @ torch.stack([r1 * vs, r2 * vs, t0], dim=1)


def run_frames(torch, pipe, frames):
    """Drive ``pipe`` over ``frames`` through ``process_frame``: per-frame
    host ms around a synchronised frame, the kernel launches of exactly
    this run (per kernel, and per kernel and volume shape), the peak
    device memory, per frame the LM iterations (camera, then each
    tracked object), and per frame its launches per kernel and volume
    shape, the batched object LM's counts (``last_batched_lm``, or None)
    and the LMs' iterations, re-captures and dropped points
    (``lm_counts``)."""
    from emfusion_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    e2e, lm_iters, per_frame = [], [], []
    for i, depth in enumerate(frames):
        before = dict(kernels.launches_by_shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.process_frame(None, depth, timestamp=float(i))
        torch.cuda.synchronize()
        e2e.append(1e3 * (time.perf_counter() - t0))
        per_frame.append(dict(
            by_shape={k: v - before.get(k, 0)
                      for k, v in kernels.launches_by_shape.items()},
            batched_lm=pipe.last_batched_lm if i > 0 else None,
            lm=pipe.lm_counts() if i > 0 else None,
            reads=lm_reads(pipe) if i > 0 else None))
        if i > 0:
            lm_iters.append([pipe.last_track_stats["iterations"]] + [
                st["iterations"]
                for st in pipe.last_obj_track_stats.values()])
    return (e2e, dict(kernels.launches), dict(kernels.launches_by_shape),
            torch.cuda.max_memory_allocated(), lm_iters, per_frame)


def lm_reads(pipe):
    """The last frame's LMs' reads of the device, iterations and
    re-captures: the camera LM's, and the serial object LMs' (one table:
    its reads, its longest LM's iterations, its re-captures), where they
    count them."""
    cam = pipe.last_track_stats or {}
    obj = list(pipe.last_obj_track_stats.values())
    return dict(camera=(cam.get("host_reads"), cam.get("iterations"),
                        cam.get("recaptures") or 0),
                objects=(max((st.get("host_reads") or 0 for st in obj),
                             default=None),
                         max((st["iterations"] for st in obj),
                             default=None),
                         sum(int(st.get("recaptures") or 0) for st in obj)))


def check_reads(name, per_frame, most):
    """The camera's and the object tables' mean reads of the device a
    call (where the LMs count them); with ``most`` (the LMs run on the
    device: the reads a call may take, given its iterations and
    re-captures) fails if a call read the device more often."""
    means = {}
    for who in ("camera", "objects"):
        calls = [f["reads"][who] for f in per_frame
                 if f["reads"] and f["reads"][who][0]]
        bad = [c for c in calls if most and c[0] > most(c[1], c[2])]
        if bad:
            raise RuntimeError(f"{name}: the {who} LM read the device "
                               f"more often than it may (reads, "
                               f"iterations, re-captures): {bad[:5]}")
        means[who] = (float(np.mean([c[0] for c in calls])) if calls
                      else None)
    return means


def camera_ate(pipe, n_frames):
    from emfusion_tpu_torch.eval.ate import evaluate_ate
    poses = {float(f): q for f, q in pipe.poses.items()}
    gt = {float(i): gt_pose(i) for i in range(n_frames)}
    return evaluate_ate(poses, gt, max_difference=0.5)


def check_launches(name, launches, kernels_of_path, timer=None,
                   forbidden=()):
    """Fails if a kernel of the path never ran, or a kernel of
    ``forbidden`` ran (the split LM kernels on an exact one-card path,
    ``lm_run`` where the split kernels run its LMs); with the path's
    ``PhaseTimer``, also unless K1 launched once per fusion (once a
    frame) and K2 once per E-step."""
    missing = [k for k in kernels_of_path if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"{name} never launched kernels {missing}")
    ran = [k for k in forbidden if launches.get(k, 0) > 0]
    if ran:
        raise RuntimeError(f"{name} launched kernels {ran}, which its LMs "
                           "do not run")
    if timer is not None:
        esteps = sum(n for ph, n in timer.counts.items()
                     if ph.startswith("estep"))
        want = {"fusion": timer.counts["integrate"], "sample": esteps}
        got = {k: launches[k] for k in want}
        if got != want:
            raise RuntimeError(f"{name}: launches {got}, expected one per "
                               f"fusion and per E-step {want}")


def lm_summary(per_frame):
    """The LMs' re-captures and dropped points over a run's frames (per
    LM call): the camera's and, pooled, the objects'; and the calls that
    spent the whole re-capture budget (``TrackConfig.max_recaptures``:
    past it the capture LM's windows stay fixed) with their dropped
    points."""
    from emfusion_tpu_torch.tracking import TrackConfig
    budget = TrackConfig().max_recaptures
    cam = [f["lm"]["camera"] for f in per_frame if f["lm"]]
    obj = [st for f in per_frame if f["lm"]
           for st in f["lm"]["objects"].values()]

    def agg(calls):
        spent = [c["dropped_points"] or 0 for c in calls
                 if (c["recaptures"] or 0) >= budget]
        return dict(calls=len(calls), budget_spent_calls=len(spent),
                    budget_spent_dropped=spent,
                    recaptures_total=int(sum(c["recaptures"] or 0
                                             for c in calls)),
                    recaptures_max=int(max((c["recaptures"] or 0
                                            for c in calls), default=0)),
                    dropped_points_total=int(sum(c["dropped_points"] or 0
                                                 for c in calls)),
                    dropped_points_max=int(max((c["dropped_points"] or 0
                                                for c in calls),
                                               default=0)))
    return dict(camera=agg(cam), objects=agg(obj))


def print_lm_summary(name, summ):
    print(f"{name} LM re-captures / dropped points per call: " + "; ".join(
        f"{who} ({s['calls']} calls): re-captures total "
        f"{s['recaptures_total']}, max {s['recaptures_max']}; dropped "
        f"points total {s['dropped_points_total']}, max "
        f"{s['dropped_points_max']}; the whole budget spent in "
        f"{s['budget_spent_calls']} calls, their dropped points "
        f"{s['budget_spent_dropped']}"
        for who, s in summ.items() if s["calls"]), flush=True)


@contextlib.contextmanager
def split_lm_loop():
    """Within the block the gather sampler's LMs run as the split kernels
    (``tracking._run_lm_split``, ``SPLIT_CHUNK`` iterations between two
    reads) in place of ``lm_run``: the comparison run of the background
    path."""
    from emfusion_tpu_torch import tracking
    run = tracking.run_lm_items
    tracking.run_lm_items = functools.partial(tracking._run_lm_split,
                                              chunk=SPLIT_CHUNK)
    try:
        yield
    finally:
        tracking.run_lm_items = run


@contextlib.contextmanager
def host_lm_loop():
    """Within the block the pipeline's camera LM runs in the port's per-
    iteration host loop (``tracking._track_volume_host``, the device
    LM's reference) in place of ``tracking.track_volume``: the
    comparison run of the background path."""
    from emfusion_tpu_torch import pipeline, tracking
    pipeline.track_volume = tracking._track_volume_host
    try:
        yield
    finally:
        pipeline.track_volume = tracking.track_volume


def main_path(torch, params, frames, report, sampler=None,
              key="main_path", loop="device"):
    """The port's main path without objects, through the entry points a
    user calls, over ``frames`` with the LM sampler ``sampler`` (None:
    the default, gather) and the gather LM's ``loop``: ``device``
    (``lm_run``, the default), ``split`` (:func:`split_lm_loop`) or
    ``host`` (:func:`host_lm_loop`), the last two comparisons. Reports
    its LM's iterations a call, ms an iteration (``track_camera`` ms over
    iterations) and reads of the device a call (on the device at most one
    a call, and one more a re-capture with the capture sampler), and
    keeps the camera poses."""
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    n_frames = len(frames)
    pipe = EMFusionPipeline(params, sampler=sampler)
    with {"device": contextlib.nullcontext, "split": split_lm_loop,
          "host": host_lm_loop}[loop]():
        e2e, launches, _, peak, lm_iters, per_frame = run_frames(
            torch, pipe, frames)
    ate = camera_ate(pipe, n_frames)
    phases = pipe.timer.ms_per_call()
    it = float(np.mean([i[0] for i in lm_iters]))
    lm = lm_summary(per_frame)
    capture = pipe.sampler == "capture"
    reads = check_reads(key, per_frame, {
        "device": capture_reads if capture else one_read,
        "split": split_reads}.get(loop))
    report[key] = dict(
        frames=n_frames, sampler=pipe.sampler, loop=loop,
        camera_lm_host_reads_mean=reads["camera"],
        poses={f: q.tolist() for f, q in pipe.poses.items()},
        e2e_ms_per_frame=float(np.mean(e2e[1:])),
        e2e_ms_frame0=e2e[0], phase_ms_per_call=phases,
        max_memory_allocated=peak, launches=launches, ate=ate,
        camera_lm_iterations_mean=it,
        camera_lm_ms_per_iteration=phases["track_camera"] / it,
        lm_iterations=[i[0] for i in lm_iters], lm=lm,
        lm_last=pipe.last_track_stats and {
            k: v for k, v in pipe.last_track_stats.items()
            if not torch.is_tensor(v)})
    print(f"{key}: {n_frames} frames 640x480 into 512^3, LM sampler "
          f"{pipe.sampler}, e2e {np.mean(e2e[1:]):.3f} ms/frame (frames "
          f"1..), frame 0 {e2e[0]:.3f} ms", flush=True)
    print("phase ms per call: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), flush=True)
    print(f"{key} camera LM: {it:.2f} iterations a call, "
          f"{phases['track_camera']:.3f} ms a call, "
          f"{phases['track_camera'] / it:.4f} ms an iteration, "
          f"{reads['camera']:.2f} device reads a call ({loop} loop)"
          + (f"; as the host loop (PERF.md, section 5): "
             f"{HOST_LOOP_TRACK_CAMERA_MS['background']:.3f} ms a call"
             if capture else ""), flush=True)
    print_lm_summary(key, lm)
    print(f"peak memory {peak / 2**30:.3f} GiB; launches {launches}; "
          f"ATE rmse {ate['rmse'] * 1e3:.3f} mm", flush=True)
    check_launches(key, launches, {
        "device": CAPTURE_PATH_KERNELS if capture else PATH_KERNELS,
        "split": SPLIT_PATH_KERNELS, "host": HOST_LOOP_KERNELS}[loop],
        pipe.timer, forbidden={
            "device": LM_SPLIT_KERNELS + [LM_CLUSTER],
            "split": [LM_RUN, LM_CLUSTER]}.get(loop,
                                              LM_KERNELS + [LM_CLUSTER]))
    if not ate["rmse"] < VOXEL_CUT:
        raise RuntimeError(f"{key}: ATE {ate['rmse']} m >= {VOXEL_CUT} m")
    return launches, pipe


LM_CHUNKS = (4, 8, 16)   # chunk sizes of lm_chunk_sweep, and max_iter


def lm_chunk_sweep(torch, pipe, depth_raw, report, repeats=5):
    """The camera LM of the next frame on ``pipe``'s state, run whole
    with launches of ``lm_run`` of each chunk of ``LM_CHUNKS`` iterations
    (``tracking._run_tables``, a read of the state after each) and as the
    path runs it (``tracking.run_lm_items``: one launch of ``max_iter``),
    in turns: host ms a call (a synchronised host clock; the median of
    ``repeats``), reads and iterations. Every chunk must end on the same
    pose bits."""
    from emfusion_tpu_torch import tracking as tr

    _, points = pipe.preprocess(depth_raw)
    item = pipe.camera_lm_item(points)
    cfg = pipe.track_cfg
    chunks = LM_CHUNKS + (cfg.max_iter,)
    ms = {c: [] for c in chunks}
    res = {}

    def run(c):
        if c == cfg.max_iter:
            return tr.run_lm_items([item], cfg)[0]
        return tr._run_tables([item], cfg, c,
                              lambda r, n: tr.lm_run(r, cfg, n))[0]

    for _ in range(repeats):
        for c in chunks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[c] = run(c)
            ms[c].append(1e3 * (time.perf_counter() - t0))
    poses = {c: r["pose"] for c, r in res.items()}
    if any(not torch.equal(p, poses[chunks[0]]) for p in poses.values()):
        raise RuntimeError("the device LM's pose depends on its chunk")
    out = {c: dict(ms=float(np.median(ms[c])), ms_all=ms[c],
                   reads=res[c]["host_reads"],
                   iterations=res[c]["iterations"]) for c in chunks}
    report["lm_chunk_sweep"] = out
    print("camera LM by chunk (iterations a launch, between reads): " + ", ".join(
        f"k={c} {r['ms']:.3f} ms ({r['reads']} reads, {r['iterations']} "
        "iterations)" for c, r in out.items()), flush=True)


def object_scene(scene, params, n_frames, rng, step=1):
    """Depth frames of the scene with ``MOVERS``, camera and movers at
    frame ``step * i`` for frame ``i``, and the movers' ground-truth masks
    on the mask frames (every ``maskRCNNFrames``)."""
    frames, masks = [], {}
    for i in range(n_frames):
        depth, ms = scene.render(gt_pose(step * i), movers_at(step * i))
        frames.append(sensor_depth(depth, rng))
        if i % params.maskRCNNFrames == 0:
            masks[i] = ms
    return frames, masks


def anchored_track(traj, offsets):
    """Per frame, the world position of the object-frame point that was
    the object's origin at its spawn: a resize recentres the volume
    (``pose <- pose T(o)``, ``o`` logged in ``ObjectMeta.pose_offsets``),
    after which that point sits at ``-sum(o)``."""
    out = {}
    for f in sorted(traj):
        o = sum((v for r, v in offsets.items() if r <= f), np.zeros(3))
        out[f] = traj[f][:3, :3] @ (-o) + traj[f][:3, 3]
    return out


def motion_recovery(pipe, step=1, movers=MOVERS):
    """For each live object: the mover of ``movers`` it was spawned on
    (the nearest centre), and its x-motion from spawn to the last frame
    over the mover's true x-motion (the JAX object gate's measure,
    ``tests/test_accuracy_gate_objects.py:134-146``)."""
    out = {}
    for oid in pipe.active_object_ids:
        track = anchored_track(pipe.obj_poses[oid],
                               pipe.meta[oid].pose_offsets)
        fs = sorted(track)
        j = int(np.argmin([np.linalg.norm(track[fs[0]] - c) for c, _ in
                           movers_at(step * fs[0], movers)]))
        true = (movers_at(step * fs[-1], movers)[j][0][0]
                - movers_at(step * fs[0], movers)[j][0][0])
        out[oid] = dict(mover=j, frames=[fs[0], fs[-1]],
                        dx_est=float(track[fs[-1]][0] - track[fs[0]][0]),
                        dx_true=float(true))
        out[oid]["recovery"] = out[oid]["dx_est"] / out[oid]["dx_true"]
    return out


def object_path(torch, params, scene, n_frames, rng, report):
    """The port's object path: ``EMFusionPipeline.process_frame`` with a
    mask provider over ``n_frames`` frames of the scene with two moving
    spheres, their ground-truth masks handed out on the mask frames.
    Fails if an object is lost, if an object's x-motion recovers less
    than 0.35 or more than 2.0 of the truth (the JAX gate's band), if the
    camera ATE reaches a voxel, or if a kernel of the path never ran."""
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    frames, masks = object_scene(scene, params, n_frames, rng)
    pipe = EMFusionPipeline(params, mask_provider(masks))
    e2e, launches, by_shape, peak, lm_iters, per_frame_lm = run_frames(
        torch, pipe, frames)
    lm = lm_summary(per_frame_lm)
    ate = camera_ate(pipe, n_frames)
    phases = pipe.timer.ms_per_call()
    rec = motion_recovery(pipe)
    per_frame = {k: v / n_frames for k, v in launches.items()}
    # the launches at the objects' volume shape (the background's apart)
    obj_shape = tuple(pipe.state.objs.tsdf.shape[1:])
    obj_launches = {k: by_shape.get((k, obj_shape), 0) for k in launches}
    cam_it = float(np.mean([it[0] for it in lm_iters]))
    obj_it = [n for it in lm_iters for n in it[1:]]
    report["object_path"] = dict(
        frames=n_frames, mask_frames=sorted(masks),
        e2e_ms_per_frame=float(np.mean(e2e[1:])), e2e_ms_frame0=e2e[0],
        e2e_ms=e2e, phase_ms_per_call=phases,
        phase_calls=dict(pipe.timer.counts), max_memory_allocated=peak,
        launches=launches, launches_per_frame=per_frame,
        object_shape=list(obj_shape), object_shape_launches=obj_launches,
        ate=ate,
        camera_lm_iterations_mean=cam_it,
        object_lm_iterations_mean=float(np.mean(obj_it)),
        object_lm_at_max_iter=int(sum(n >= params.maxTrackingIter
                                      for n in obj_it)),
        object_lms=len(obj_it), lm_iterations=lm_iters, lm=lm,
        sampler=pipe.sampler, live_objects=pipe.active_object_ids,
        recovery=rec,
        voxel_sizes={oid: float(pipe.state.objs.voxel_size[pipe._slot_of(
            oid)]) for oid in pipe.active_object_ids})
    print(f"object path: {n_frames} frames 640x480 into 512^3 with "
          f"{len(MOVERS)} moving objects (masks at frames {sorted(masks)}), "
          f"e2e {np.mean(e2e[1:]):.3f} ms/frame (frames 1..), frame 0 "
          f"{e2e[0]:.3f} ms", flush=True)
    print("object path phase ms per call: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), flush=True)
    print("object path launches per frame (of them at the object shape "
          f"{list(obj_shape)}): " + ", ".join(
              f"{k} {v:.2f} ({obj_launches[k] / n_frames:.2f})"
              for k, v in per_frame.items()), flush=True)
    print(f"object path LM iterations per call: camera {cam_it:.1f}, "
          f"object {np.mean(obj_it):.1f} ({len(obj_it)} object LMs, "
          f"{sum(n >= params.maxTrackingIter for n in obj_it)} at the "
          f"{params.maxTrackingIter}-iteration cap), sampler "
          f"{pipe.sampler}", flush=True)
    print_lm_summary("object path", lm)
    reads = check_reads("object path", per_frame_lm, one_read)
    report["object_path"]["lm_host_reads_mean"] = reads
    print(f"object path LM device reads a call: camera "
          f"{reads['camera']:.2f}, object table {reads['objects']:.2f}",
          flush=True)
    print(f"object path: peak memory {peak / 2**30:.3f} GiB; live objects "
          f"{pipe.active_object_ids}; camera ATE rmse "
          f"{ate['rmse'] * 1e3:.3f} mm; x-motion recovery " + ", ".join(
              f"object {oid} {r['dx_est'] * 1e3:.2f} / "
              f"{r['dx_true'] * 1e3:.2f} mm = {r['recovery']:.3f}"
              for oid, r in rec.items()), flush=True)
    check_objects("object path", pipe, launches, obj_launches, rec, ate)
    return obj_launches, pipe, frames, masks


def check_objects(name, pipe, launches, obj_launches, rec, ate):
    """Fails if a kernel of the path never ran (or K1 and K2 not once per
    fusion and per E-step), if K1, K2, K4 and ``lm_run`` (where the LMs
    capture also K3; the batched LM's stages take ``lm_cluster`` in place
    of ``lm_run``) never ran at the object shape, if a split LM kernel
    ran, or ``lm_cluster`` where no table fits a cluster (the exact
    paths) and ``lm_run`` at the object shape of the batched LM, if an
    object is lost, if an
    object's x-motion recovers less than 0.35 or more than 2.0 of the
    truth (the JAX gate's band), or if the camera ATE reaches a voxel."""
    batched = pipe.object_lm == "batched"
    capture = pipe.sampler == "capture" or batched
    check_launches(name, launches,
                   BATCHED_PATH_KERNELS if batched else
                   CAPTURE_PATH_KERNELS if capture else PATH_KERNELS,
                   pipe.timer, forbidden=LM_SPLIT_KERNELS + (
                       [] if capture else [LM_CLUSTER]))
    check_launches(f"{name} at the object shape", obj_launches,
                   [row[3] for row in OBJECT_ROWS
                    if capture or row[3] != "capture"]
                   + [LM_CLUSTER if batched else LM_RUN],
                   forbidden=[LM_RUN] if batched else [])
    if len(rec) != len(MOVERS) or \
            sorted(r["mover"] for r in rec.values()) != list(
                range(len(MOVERS))):
        raise RuntimeError(f"{name}: object lost: live objects {rec}")
    bad = {o: r for o, r in rec.items() if not 0.35 < r["recovery"] < 2.0}
    if bad:
        raise RuntimeError(f"{name}: object motion not recovered: {bad}")
    if not ate["rmse"] < VOXEL_CUT:
        raise RuntimeError(f"{name}: ATE {ate['rmse']} m >= {VOXEL_CUT} m")


def accel_path(torch, params, frames, masks, report, key="accel_path",
               volume_dtype="auto"):
    """The accelerator path: the object path's scene's ``frames`` and
    ``masks`` under the JAX package's accelerator tracking configuration
    (``ACCEL``), its volumes stored in ``volume_dtype``. Fails as the
    object path does (:func:`check_objects`), and also if a frame
    launched K3 or ``lm_cluster`` at the object shape more than twice (once
    per batched LM stage), a call of the batched LM read the device
    more than twice (once a stage) or a camera LM call (the capture
    sampler's, on the device) more than 1 + its re-captures times.
    Prints ``track_objects`` and ``track_camera`` beside the host loops'
    times (``HOST_LOOP_TRACK_OBJECTS_MS``, ``HOST_LOOP_TRACK_CAMERA_MS``).
    Returns the path's launches (all of them, K3's at the camera's and at
    the objects' shape, ``lm_cluster``'s at the objects' and ``lm_run``'s
    at the camera's), and the pipeline."""
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    n_frames = len(frames)
    params = dataclasses.replace(params, volume_dtype=volume_dtype, **ACCEL)
    pipe = EMFusionPipeline(params, mask_provider(masks))
    name = key.replace("_", " ")
    if (pipe.object_lm, pipe.escale, pipe.motion_model, pipe.sampler) != (
            "batched", 2, "constvel", "capture"):
        raise RuntimeError(f"{name}: the configuration did not resolve")
    e2e, launches, by_shape, peak, lm_iters, per_frame = run_frames(
        torch, pipe, frames)
    ate = camera_ate(pipe, n_frames)
    phases = pipe.timer.ms_per_call()
    rec = motion_recovery(pipe)
    obj_shape = tuple(pipe.state.objs.tsdf.shape[1:])
    bg_shape = tuple(pipe.state.bg_tsdf.shape)
    obj_launches = {k: by_shape.get((k, obj_shape), 0) for k in launches}
    k3_obj = [f["by_shape"].get(("capture", obj_shape), 0) for f in per_frame]
    lm_obj = [f["by_shape"].get((LM_CLUSTER, obj_shape), 0)
              for f in per_frame]
    lms = [f["batched_lm"] for f in per_frame if f["batched_lm"]]
    if len(lms) != n_frames - 1:
        raise RuntimeError(f"{name}: the batched object LM ran in "
                           f"{len(lms)} of {n_frames - 1} frames")
    reads = [lm["host_reads"] for lm in lms]
    cam_reads = check_reads(name, per_frame, capture_reads)["camera"]
    cam_it = float(np.mean([it[0] for it in lm_iters]))
    obj_it = [n for it in lm_iters for n in it[1:]]
    loop_it = [lm["loop_iterations"] for lm in lms]
    lm_counts = lm_summary(per_frame)
    report[key] = dict(
        frames=n_frames, config=ACCEL, mask_frames=sorted(masks),
        volume_dtype=str(pipe.vol_dtype),
        e2e_ms_per_frame=float(np.mean(e2e[1:])), e2e_ms_frame0=e2e[0],
        e2e_ms=e2e, phase_ms_per_call=phases,
        phase_calls=dict(pipe.timer.counts), max_memory_allocated=peak,
        launches=launches, object_shape_launches=obj_launches,
        k3_object_shape_launches_per_frame=k3_obj,
        lm_cluster_object_shape_launches_per_frame=lm_obj,
        k3_camera_shape_launches=by_shape.get(("capture", bg_shape), 0),
        ate=ate, camera_lm_iterations_mean=cam_it,
        object_lm_iterations_mean=float(np.mean(obj_it)),
        batched_lm_loop_iterations_mean=float(np.mean(loop_it)),
        batched_lm_points=[lm["points"] for lm in lms],
        host_reads_per_batched_call_mean=float(np.mean(reads)),
        host_reads_per_batched_call_max=int(max(reads)),
        camera_lm_host_reads_mean=cam_reads,
        track_objects_host_loop_ms=HOST_LOOP_TRACK_OBJECTS_MS[
            "bf16" if volume_dtype == "bfloat16" else "float32"],
        track_camera_host_loop_ms=HOST_LOOP_TRACK_CAMERA_MS[
            "bf16" if volume_dtype == "bfloat16" else "float32"],
        lm_iterations=lm_iters, lm=lm_counts,
        live_objects=pipe.active_object_ids, recovery=rec)
    print(f"{name}: {n_frames} frames {params.width}x{params.height} "
          f"into {params.globalVolumeDims[0]}^3 ({pipe.vol_dtype}) with "
          f"{len(MOVERS)} moving objects under {ACCEL}, e2e "
          f"{np.mean(e2e[1:]):.3f} ms/frame (frames 1..), frame 0 "
          f"{e2e[0]:.3f} ms", flush=True)
    print(f"{name} phase ms per call: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), flush=True)
    print(f"{name} launches per frame: " + ", ".join(
        f"{k} {v / n_frames:.2f}" for k, v in launches.items())
        + f"; K3 at the object shape {list(obj_shape)} per frame: max "
        f"{max(k3_obj)}, total {sum(k3_obj)}; lm_cluster there: max "
        f"{max(lm_obj)}, total {sum(lm_obj)}", flush=True)
    print(f"{name} LM iterations per call: camera {cam_it:.1f}, "
          f"batched stages {np.mean(loop_it):.1f} (per object "
          f"{np.mean(obj_it):.1f}, {lms[-1]['points']} points a slot); "
          f"device reads per batched call mean {np.mean(reads):.3f}, "
          f"max {max(reads)}; camera device reads a call {cam_reads:.3f}",
          flush=True)
    print(f"{name}: track_objects {phases['track_objects']:.3f} ms a call "
          f"(the batched LM as a host loop: "
          f"{report[key]['track_objects_host_loop_ms']:.3f} ms on an H100 "
          f"80GB HBM3 at 700 W), track_camera "
          f"{phases['track_camera']:.3f} ms (the capture LM as a host "
          f"loop: {report[key]['track_camera_host_loop_ms']:.3f} ms, "
          f"on an H100 80GB HBM3 at 700 W)", flush=True)
    print_lm_summary(name, lm_counts)
    print(f"{name}: peak memory {peak / 2**30:.3f} GiB; live objects "
          f"{pipe.active_object_ids}; camera ATE rmse "
          f"{ate['rmse'] * 1e3:.3f} mm; x-motion recovery " + ", ".join(
              f"object {oid} {r['recovery']:.3f}"
              for oid, r in rec.items()), flush=True)
    check_objects(name, pipe, launches, obj_launches, rec, ate)
    for what, per in (("K3", k3_obj), (LM_CLUSTER, lm_obj)):
        if max(per) > 2:
            raise RuntimeError(f"{name}: {what} launched {max(per)} times "
                               "at the object shape in a frame (at most 2)")
    if max(reads) > 2:
        raise RuntimeError(f"{name}: a batched LM call read the device "
                           f"{max(reads)} times (at most 2)")
    bg_launches = {k: by_shape.get((k, bg_shape), 0) for k in launches}
    return dict(camera=report[key]["k3_camera_shape_launches"],
                objects=obj_launches["capture"],
                lm_objects=obj_launches[LM_CLUSTER],
                lm_camera=bg_launches[LM_RUN], all=launches,
                background=bg_launches), pipe


def capture_vs_host_loop(torch, params, frames, masks, report, key,
                         volume_dtype="auto"):
    """The accelerator path's first ``HOST_LOOP_CALLS`` camera LM calls
    (frames 1.. of ``frames`` and ``masks``, the pipeline as
    :func:`accel_path` builds it, so the same inputs as that path's
    first calls): each call runs the device capture LM (whose result the
    pipeline keeps) and the host loop it replaced
    (``tracking._track_volume_host``) on the same inputs. Reports per
    call both forms' re-captures, iterations, reads and dropped points
    and their pose gap, the calls where the counts agree and the largest
    gap."""
    from emfusion_tpu_torch import pipeline as pl
    from emfusion_tpu_torch import tracking as tr
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    params = dataclasses.replace(params, volume_dtype=volume_dtype, **ACCEL)
    pipe = EMFusionPipeline(params, mask_provider(masks))
    calls = []

    def both(*args):
        pose, st = tr.track_volume(*args)
        hpose, hst = tr._track_volume_host(*args)
        calls.append({k: (int(st[k]), int(hst[k])) for k in (
            "recaptures", "iterations", "host_reads", "dropped_points")})
        calls[-1]["pose_gap"] = float((pose - hpose).abs().max())
        return pose, st

    pl.track_volume = both
    try:
        for i, depth in enumerate(frames[:HOST_LOOP_CALLS + 1]):
            pipe.process_frame(None, depth, timestamp=float(i))
    finally:
        pl.track_volume = tr.track_volume
    out = dict(calls=calls, same_recaptures=sum(
        c["recaptures"][0] == c["recaptures"][1] for c in calls),
        same_iterations=sum(c["iterations"][0] == c["iterations"][1]
                            for c in calls),
        max_pose_gap=max(c["pose_gap"] for c in calls))
    report[key] = out
    print(f"{key.replace('_', ' ')}: {len(calls)} camera calls, device LM "
          f"/ host loop on the same inputs: re-captures equal in "
          f"{out['same_recaptures']}, iterations equal in "
          f"{out['same_iterations']}, largest pose gap "
          f"{out['max_pose_gap']:.3e}; per call (re-captures, iterations, "
          f"reads, dropped points, gap): " + "; ".join(
              f"{c['recaptures']} {c['iterations']} {c['host_reads']} "
              f"{c['dropped_points']} {c['pose_gap']:.1e}" for c in calls),
          flush=True)
    del pipe
    torch.cuda.empty_cache()
    return out


def stage_table(torch, pipe, points, slots, dtype=None):
    """The batched object LM's first-stage table of ``slots``, as
    ``tracking.track_volumes_batched`` builds it (one K3 launch): cache
    items over :meth:`EMFusionPipeline.batched_lm_inputs`, the slots'
    volumes cast to ``dtype`` where given (a cache of that type), and the
    stage's LM constants (``max(max_iter // 2, 1)`` iterations)."""
    from emfusion_tpu_torch.tracking import stage_items
    tsdfs, wts, vs, pts, asc, rel, _, _ = pipe.batched_lm_inputs(points,
                                                                 slots)
    if dtype is not None:
        tsdfs = [v.to(dtype) for v in tsdfs]
        wts = [v.to(dtype) for v in wts]
    cfg = pipe.track_cfg
    cfg = dataclasses.replace(cfg, max_iter=max(cfg.max_iter // 2, 1))
    vs = torch.as_tensor(vs, dtype=torch.float32).cpu()
    return stage_items(tsdfs, wts, vs, pts, asc, rel[:, :3, :3],
                       rel[:, :3, 3], range(len(slots))), cfg


def accel_kernel_phases(torch, pipe, depth_raw):
    """K3 against its plain version on the accelerator path's final
    state: the camera's capture of its stride-3 points at the constant-
    velocity start, and a batched LM stage's table of the live slots
    (:meth:`EMFusionPipeline.batched_lm_inputs`); ``lm_run`` over that
    stage's cache items (:func:`hold_lm_run`), from float32 volumes
    (``lm_run_cache``) and from the slots' volumes cast to bf16
    (``lm_run_cache_bf16``, a bf16 cache), and over the camera LM as the
    capture sampler runs it (``lm_run_capture``,
    :func:`hold_camera_capture`). Returns the rows."""
    from emfusion_tpu_torch.geometry.se3 import pose_inverse, reorthonormalize

    s = pipe.state
    _, points = pipe.preprocess(depth_raw)
    k = pipe.stride
    delta = pipe.motion_delta()
    rel = reorthonormalize(pose_inverse(s.bg_pose) @ s.cam_pose @ delta)
    live = [int(j) for j in np.nonzero(pipe._h_active)[0]]
    tsdfs, wts, vs, pts, _, rel_o, _, _ = pipe.batched_lm_inputs(points,
                                                                 live)
    rows = {
        "capture_camera_accel": hold_capture(
            torch, (s.bg_tsdf, s.bg_weights),
            points[:, ::k, ::k].reshape(3, -1), rel[:3, :3], rel[:3, 3],
            pipe.voxel),
        "capture_objects_accel": hold_capture_batched(torch, tsdfs, wts, pts,
                                                      rel_o, vs)}
    for name, dtype in (("lm_run_cache", None),
                        ("lm_run_cache_bf16", torch.bfloat16)):
        rows[name] = hold_lm_run(torch, *stage_table(torch, pipe, points,
                                                     live, dtype))
    rows["lm_run_capture"] = hold_camera_capture(torch, pipe, points)
    return rows


def hold_camera_capture(torch, pipe, points):
    """:func:`hold_lm_capture` over the camera LM of ``pipe`` (its
    stride-3 points and the background's volumes, a cache of their type)
    from ``CAPTURE_HOLD_OFFSET`` voxels along x off its constant-velocity
    start, so that it re-captures."""
    it = pipe.camera_lm_item(points)
    start = torch.as_tensor(it.rel_pose, dtype=torch.float32).clone()
    start[0, 3] += CAPTURE_HOLD_OFFSET * pipe.voxel
    return hold_lm_capture(torch, dataclasses.replace(it, rel_pose=start),
                           pipe.track_cfg)


def bf16_kernel_phases(torch, pipe, depth_raw):
    """The bf16 forms against their plain versions on the bf16
    accelerator path's final state: K1 over the frame's fusion table (the
    bf16 background and every visible float32 slot, one launch), K2 over
    the E-step's table (the bf16 background and every live slot), K3 over
    the camera's stride-3 points at the constant-velocity start (a bf16
    cache), K4 on the bf16 background at the camera, and ``lm_run`` over
    the camera's capture LM on the bf16 background (a bf16 cache,
    ``lm_run_capture_bf16``, :func:`hold_camera_capture`). Returns the
    rows."""
    from emfusion_tpu_torch.geometry.se3 import pose_inverse, reorthonormalize

    p, s = pipe.params, pipe.state
    if s.bg_tsdf.dtype != torch.bfloat16:
        raise RuntimeError("bf16 holds: the background is not bf16")
    depth, points = pipe.preprocess(depth_raw)
    live = [int(j) for j in np.nonzero(pipe._h_active)[0]]
    k = pipe.stride
    rel = reorthonormalize(pose_inverse(s.bg_pose) @ s.cam_pose
                           @ pipe.motion_delta())
    cam = pose_inverse(s.bg_pose) @ s.cam_pose
    return {
        "fusion_bf16": hold_fusion(torch, pipe.fusion_items(), depth,
                                   pipe.intr),
        "sample_bf16": hold_sample(torch,
                                   pipe.estep_items(points, live)[0]),
        "capture_camera_bf16": hold_capture(
            torch, (s.bg_tsdf, s.bg_weights),
            points[:, ::k, ::k].reshape(3, -1), rel[:3, :3], rel[:3, 3],
            pipe.voxel),
        "raycast_bf16": hold_raycast(
            torch, s.bg_tsdf, s.bg_weights, cam[:3, :3], cam[:3, 3],
            pipe.intr, pipe.voxel, pipe.trunc, pipe.H, pipe.W,
            p.raycast_max_steps),
        "lm_run_capture_bf16": hold_camera_capture(torch, pipe, points)}


def compare_accel(report):
    """Step 8b beside step 8: e2e, peak memory, ATE, recovery, launches a
    frame and the LMs' counts of the float32 and the bf16 run."""
    a, b = report["accel_path"], report["accel_path_bf16"]
    n = a["frames"]
    lines = [
        ("e2e ms a frame (frames 1..)", a["e2e_ms_per_frame"],
         b["e2e_ms_per_frame"]),
        ("peak memory GiB", a["max_memory_allocated"] / 2 ** 30,
         b["max_memory_allocated"] / 2 ** 30),
        ("camera ATE mm", a["ate"]["rmse"] * 1e3, b["ate"]["rmse"] * 1e3),
        ("camera LM iterations a call", a["camera_lm_iterations_mean"],
         b["camera_lm_iterations_mean"]),
        ("batched LM stage iterations a frame",
         a["batched_lm_loop_iterations_mean"],
         b["batched_lm_loop_iterations_mean"]),
        ("batched LM reads a call", a["host_reads_per_batched_call_mean"],
         b["host_reads_per_batched_call_mean"]),
        ("track_objects ms a call", a["phase_ms_per_call"]["track_objects"],
         b["phase_ms_per_call"]["track_objects"])]
    for who in ("camera", "objects"):
        for what in ("recaptures_total", "dropped_points_total"):
            lines.append((f"{who} {what}", a["lm"][who][what],
                          b["lm"][who][what]))
    for line in lines:
        print(f"accel path float32 / bf16: {line[0]} {line[1]:.4f} / "
              f"{line[2]:.4f}", flush=True)
    print("accel path float32 / bf16: recovery " + "; ".join(
        f"{r['recovery']:.4f} / {q['recovery']:.4f}" for r, q in zip(
            a["recovery"].values(), b["recovery"].values()))
        + "; launches a frame " + ", ".join(
            f"{k} {a['launches'][k] / n:.3f} / {b['launches'][k] / n:.3f}"
            for k in a["launches"]), flush=True)
    report["accel_float32_vs_bf16"] = {line[0]: [line[1], line[2]]
                                       for line in lines}


def accel_pool_phase(torch, pipe, depth_raw):
    """K3 over a batched LM stage's table at a full pool (:func:`fill_pool`,
    which replaces ``pipe``'s pool): 16 slots of their top 4096 points;
    and ``lm_run`` over that stage's cache items. Returns the two rows."""
    fill_pool(torch, pipe)
    _, points = pipe.preprocess(depth_raw)
    slots = list(range(pipe.K))
    tsdfs, wts, vs, pts, _, rel_o, _, _ = pipe.batched_lm_inputs(
        points, slots)
    return {"capture_pool_accel": hold_capture_batched(
                torch, tsdfs, wts, pts, rel_o, vs),
            "lm_run_cache_pool": hold_lm_run(
                torch, *stage_table(torch, pipe, points, slots))}


def escape_items(torch, dev):
    """Fault F2's two cache items (``ESCAPE_*``), captured at the identity
    by one K3 launch (``tracking.stage_items``)."""
    from emfusion_tpu_torch.tracking import stage_items
    R, N, vs = ESCAPE_RES, ESCAPE_N, ESCAPE_VS
    x = np.arange(R, dtype=np.float32)
    tsdfs = [torch.tensor(np.broadcast_to(
        np.where(x >= 8, 0.1 * (x - z), 1.0).astype(np.float32),
        (R, R, R)).copy(), device=dev) for z in ESCAPE_ZEROS]
    wts = [torch.ones((R, R, R), device=dev) for _ in ESCAPE_ZEROS]
    rng = np.random.RandomState(0)
    v = np.stack([np.full(N, 10.5), rng.uniform(4.3, 11.7, N),
                  rng.uniform(8.3, 12.7, N)])
    pts = torch.tensor(((v - (R - 1) / 2) * vs).astype(np.float32),
                       device=dev)
    S = len(ESCAPE_ZEROS)
    return stage_items(tsdfs, wts, torch.full((S,), vs),
                       pts.expand(S, 3, N).contiguous(),
                       torch.ones((S, N), device=dev),
                       torch.eye(3).expand(S, 3, 3), torch.zeros(S, 3),
                       range(S))


def hold_lm_escape(torch, report):
    """Fault F2's guard on the card: ``lm_cluster`` over the two cache items
    of :func:`escape_items` (one table), one launch of one iteration,
    against the plain iteration on the same tensors: the state records
    bit for bit, the first item's trial counted with no weighted point in
    its windows and rejected (its pose kept, no gradient next), the
    second's 24 points counted and its step accepted; then the table held
    to its stop as :func:`hold_lm_run` holds it. Fails otherwise."""
    from emfusion_tpu_torch import kernels
    from emfusion_tpu_torch import tracking as tr
    cfg = tr.TrackConfig(tau=1e-6, max_iter=30)
    items = escape_items(torch, "cuda")
    k, q = tr.LMRun(items, cfg), tr.LMRun(items, cfg)
    start = k.sf[:, :tr.SF_RN].clone()          # the poses R, t
    kernels.reset_launches()
    tr.lm_run(k, cfg, 1)
    plain_iteration(tr, q, cfg)
    torch.cuda.synchronize()
    launched = kernels.launches.get(LM_CLUSTER, 0)
    equal = all(torch.equal(a, b) for a, b in (
        (k.si, q.si), (k.sf, q.sf), (k.w, q.w), (k.scratch, q.scratch)))
    nin = k.si[:, tr.SI_NIN].tolist()
    ev = k.si[:, tr.SI_EVAL].tolist()
    kept = torch.equal(k.sf[0, :tr.SF_RN], start[0])
    moved = not torch.equal(k.sf[1, :tr.SF_RN], start[1])
    row = hold_lm_run(torch, items, cfg, reps=3)
    out = dict(first_iteration_equal=equal, counted=nin, eval_next=ev,
               rejected_kept_pose=kept, accepted_moved=moved,
               lm_cluster_launches=launched, run_iterations=row[
                   "run_iterations"], max_abs_err=row["max_abs_err"],
               whole_equal=row["whole_equal"])
    report["lm_escape"] = out
    print(f"F2 guard on the card (lm_cluster, 2 cache items, {ESCAPE_N} points "
          f"each): first iteration card == plain {equal}; weighted points "
          f"with a valid psi at the trial poses {nin}; gradient next {ev}; "
          f"escaping item's pose kept {kept}, the other's moved {moved}; "
          f"held to the stop ({row['run_iterations']} iterations): max abs "
          f"err {row['max_abs_err']:.3e}, one launch == the chain "
          f"{row['whole_equal']}", flush=True)
    if not (equal and nin == [0, ESCAPE_N] and ev == [0, 1] and kept
            and moved and launched == 1 and row["max_abs_err"] <= row["tol"]):
        raise RuntimeError(f"F2 guard: the card or the plain version took "
                           f"the escape, or they disagree: {out}")
    return out


# the export tree of tests/test_pipeline.py::test_export_tree
EXPORT_TREE = ("output", "masks", "assoc_weights/bg/preTrack",
               "assoc_weights/bg/postTrack", "assoc_weights/{oid}/preTrack",
               "assoc_weights/{oid}/postTrack", "track_weights/bg",
               "track_weights/{oid}", "huber_weights/bg",
               "huber_weights/{oid}", "fg_probs/{oid}")


def encode_png_adaptive(img):
    """(H, W) uint16 or (H, W, 3) uint8 -> PNG bytes with libpng's
    adaptive filter choice (what cv2 and the JAX native writer write, and
    so real TUM and Co-Fusion files): per row, of None, Sub, Up, Average
    and Paeth, the filtered bytes whose sum of absolute values, read as
    signed bytes, is least (the first on a tie); deflate level 6.
    Returns (the bytes, the rows' filter types)."""
    import struct
    import zlib

    h, w = img.shape[:2]
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, bpp = 16, 0, 2
        x = img.astype(">u2").view(np.uint8).reshape(h, 2 * w)
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, ctype, bpp = 8, 2, 3
        x = img.reshape(h, 3 * w)
    else:
        raise ValueError(f"encode_png_adaptive: {img.dtype} {img.shape}")
    x = x.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]                  # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                            # up
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]               # up-left
    pr = a + b - c
    pa, pb, pc = np.abs(pr - a), np.abs(pr - b), np.abs(pr - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 255
    cost = np.minimum(cand, 256 - cand).sum(axis=2)           # (5, h)
    ftype = np.argmin(cost, axis=0)
    rows = np.concatenate([ftype[:, None], cand[ftype, np.arange(h)]],
                          1).astype(np.uint8)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b"")), ftype


def grey_image(depth, rng):
    """The rgb frame of the CLI path's sequence: the depth shaded to grey
    with sensor noise (1.5 grey levels), the top 12 rows black (the
    border an undistorted image has)."""
    grey = 255 - depth * 60 + rng.normal(0, 1.5, depth.shape)
    grey[:12] = 0
    return np.stack([np.clip(np.rint(grey), 0, 255).astype(np.uint8)] * 3,
                    -1)


def write_tum_sequence(root, params, scene, n_frames, rng):
    """The object path's scene as a TUM-format directory, its PNGs written
    with libpng's adaptive filters (:func:`encode_png_adaptive`):
    ``rgb/`` (:func:`grey_image`), ``depth/`` (x5000 uint16),
    ``associations.txt``, ``groundtruth.txt`` (``gt_pose``),
    ``calibration.txt`` and ``masks/Mask%04d.plk`` on the mask frames.
    Returns the frames' timestamps and the count of rows of each filter
    type (None, Sub, Up, Average, Paeth)."""
    from emfusion_tpu_torch.io.writers import _rot_to_quat
    from emfusion_tpu_torch.segmentation import (
        Detection, make_score_vector, save_detections,
    )

    frames, masks = object_scene(scene, params, n_frames, rng)
    for sub in ("rgb", "depth", "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    stamps, assoc, gt = [], [], []
    filters = np.zeros(5, np.int64)
    for i, depth in enumerate(frames):
        ts = f"{1000 + i / 30:.6f}"
        for sub, img in (("rgb", grey_image(depth, rng)),
                         ("depth", np.round(depth * 5000).astype(
                             np.uint16))):
            data, ftype = encode_png_adaptive(img)
            filters += np.bincount(ftype, minlength=5)
            with open(os.path.join(root, sub, f"{ts}.png"), "wb") as f:
                f.write(data)
        T = gt_pose(i)
        q = _rot_to_quat(T[:3, :3])
        assoc.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png\n")
        gt.append(f"{ts} {T[0, 3]} {T[1, 3]} {T[2, 3]} "
                  f"{q[0]} {q[1]} {q[2]} {q[3]}\n")
        stamps.append(float(ts))
    for f, ms in masks.items():
        save_detections(os.path.join(root, "masks", f"Mask{f:04d}.plk"),
                        [Detection(mask=m, scores=make_score_vector(3, 0.9))
                         for m in ms])
    for name, lines in (
            ("associations.txt", assoc), ("groundtruth.txt", gt),
            ("calibration.txt", [f"{params.fx} {params.fy} {params.cx} "
                                 f"{params.cy}\n"])):
        with open(os.path.join(root, name), "w") as f:
            f.writelines(lines)
    return stamps, filters


def _decode_into_slots(jobs, size, scale, clamp, buf, capacity, todo,
                       done):
    """A decode process of :func:`process_prefetch`: frame indices from
    ``todo`` (None ends it), each frame decoded into slot ``i % capacity``
    of the shared ``buf``, then ``(i, None)`` or ``(i, error)`` on
    ``done``."""
    from emfusion_tpu_torch.native import decode_frame

    h, w = size
    slots = np.frombuffer(buf, np.uint8).reshape(capacity, -1)
    while (i := todo.get()) is not None:
        try:
            rgb, depth = decode_frame(*jobs[i], scale, clamp, size)
            slots[i % capacity, :h * w * 3] = rgb.reshape(-1)
            slots[i % capacity, h * w * 3:].view(np.float32)[:] = \
                depth.reshape(-1)
            done.put((i, None))
        except Exception as e:
            done.put((i, f"{e}"))


def process_prefetch(jobs, size, scale, clamp, n_workers, capacity=30):
    """The prefetcher's design on spawned processes instead of threads,
    the alternative that step 9 measures against it (threads won, so the
    package has only them): frame ``i`` is sent once fewer than
    ``capacity`` frames are out, decoded into shared-memory slot ``i %
    capacity`` and copied out here. Yields (rgb, depth) in order; the
    processes are ended when the generator is."""
    import ctypes
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    h, w = size
    buf = ctx.RawArray(ctypes.c_uint8, capacity * h * w * 7)
    slots = np.frombuffer(buf, np.uint8).reshape(capacity, -1)
    todo, done = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_decode_into_slots, daemon=True,
                         args=(jobs, size, scale, clamp, buf, capacity,
                               todo, done)) for _ in range(n_workers)]
    for p in procs:
        p.start()
    for i in range(min(capacity, len(jobs))):
        todo.put(i)
    ready = {}
    try:
        for i in range(len(jobs)):
            while i not in ready:
                j, err = done.get(timeout=120)
                ready[j] = err
            if (err := ready.pop(i)) is not None:
                raise RuntimeError(f"cli path: a decode process: {err}")
            slot = slots[i % capacity]
            yield (slot[:h * w * 3].reshape(h, w, 3).copy(),
                   slot[h * w * 3:].view(np.float32).reshape(h, w).copy())
            if i + capacity < len(jobs):
                todo.put(i + capacity)
    finally:
        for p in procs:
            p.terminate()
            p.join()


def decode_step(seq, report):
    """Step 9's decode numbers on the adaptive-filtered sequence ``seq``:
    ms a frame (rgb + depth) of the numpy plain decoder
    (``codecs.decode_png_plain``) on frame 0 and of the C unfilter path
    (``native.decode_frame``, one thread) over 10 frames, equal pixels
    on frame 0; then the prefetcher (threads) and :func:`process_prefetch`
    over every frame with 1 and 4 workers (capacity 30): frames a second
    from its construction to the last frame, and after the first frame.
    Returns the C path's ms a frame."""
    from emfusion_tpu_torch.io import codecs
    from emfusion_tpu_torch.io.readers import TUMReader
    from emfusion_tpu_torch.native import NativePrefetcher, decode_frame

    reader = TUMReader(seq)
    reader.init()
    reader.close()
    paths = [reader._paths(i) for i in range(reader.num_frames)]
    scale, clamp = reader.DEPTH_SCALE, reader.DEPTH_CLAMP
    t0 = time.perf_counter()
    plain = [codecs.decode_png_plain(open(p, "rb").read()) for p in paths[0]]
    plain_ms = 1e3 * (time.perf_counter() - t0)
    n_dec = min(10, len(paths))
    t0 = time.perf_counter()
    for i in range(n_dec):
        rgb, depth = decode_frame(*paths[i], scale, clamp)
        if i == 0:
            same = np.array_equal(rgb, plain[0]) and np.array_equal(
                depth, plain[1].astype(np.float32) * np.float32(scale))
    c_ms = 1e3 * (time.perf_counter() - t0) / n_dec
    if not same:
        raise RuntimeError("cli path: the C unfilter and the plain decoder "
                           "disagree on frame 0")

    def thread_frames(n):
        pf = NativePrefetcher([p[0] for p in paths], [p[1] for p in paths],
                              n_workers=n, capacity=30, depth_scale=scale,
                              depth_clamp=clamp)
        try:
            while (frame := pf.next()) is not None:
                yield frame[:2]
        finally:
            pf.close()

    rates = {}
    for workers in ("threads", "processes"):
        for n in (1, 4):
            t0 = time.perf_counter()
            frames = thread_frames(n) if workers == "threads" else \
                process_prefetch(paths, rgb.shape[:2], scale, clamp, n)
            got, first = 0, None
            for rgb_i, depth_i in frames:
                if got == 0 and not np.array_equal(rgb_i, plain[0]):
                    raise RuntimeError(f"cli path: {workers} gave another "
                                       f"frame 0")
                got += 1
                first = first or time.perf_counter()
            end = time.perf_counter()
            if got != len(paths):
                raise RuntimeError(f"cli path: the prefetcher gave {got} of "
                                   f"{len(paths)} frames")
            rates[f"{workers}_{n}"] = dict(
                fps=got / (end - t0), fps_after_first=(got - 1) / (
                    end - first), first_frame_s=first - t0)
    report["cli_path_decode"] = dict(plain_ms_per_frame=plain_ms,
                                     c_ms_per_frame=c_ms, prefetcher=rates)
    print(f"cli path: decode of an adaptive-filtered 640x480 rgb + depth "
          f"pair: numpy plain {plain_ms:.3f} ms (frame 0), C unfilter "
          f"{c_ms:.3f} ms/frame ({n_dec} frames, one thread)", flush=True)
    print("cli path: prefetcher frames/s over the sequence (after the first "
          "frame; first frame s): " + "; ".join(
              f"{k} {r['fps']:.2f} ({r['fps_after_first']:.2f}; "
              f"{r['first_frame_s']:.3f})" for k, r in rates.items()),
          flush=True)
    return c_ms


def run_cli(module, argv):
    """``module.main(argv)``, its standard output captured and echoed;
    fails unless it returns 0. Returns (output, seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"  | {line}", flush=True)
    if rc != 0:
        raise RuntimeError(f"{module.__name__} {argv} exited {rc}")
    return out, secs


def check_frame_meshes(pipe, run_dir, sync_dir):
    """The ``--frame-meshes`` files the CLI's writer thread wrote at the
    final frame against ``write_frame_meshes`` run synchronously on the
    final checkpoint's state: the same names, byte for byte; and files at
    every multiple of ``CLI_MESH_EVERY`` after the resume. Returns the
    names and sizes checked."""
    from emfusion_tpu_torch.io.writers import write_frame_meshes

    t0 = time.perf_counter()
    write_frame_meshes(pipe, sync_dir, pipe.frame)
    sync_s = time.perf_counter() - t0
    names = sorted(os.listdir(run_dir))
    last = sorted(n for n in names if n.endswith(f"_{pipe.frame:04d}.ply"))
    want = sorted(os.listdir(sync_dir))
    same = [n for n in want if n in last and open(
        os.path.join(run_dir, n), "rb").read() == open(
            os.path.join(sync_dir, n), "rb").read()]
    frames = sorted({int(n[-8:-4]) for n in names})
    print(f"cli path: --frame-meshes files at frames {frames}; at frame "
          f"{pipe.frame} {len(same)} of {len(want)} equal to the synchronous "
          f"writer's byte for byte ({sync_s:.3f} s to write them on the "
          f"frame loop)", flush=True)
    if last != want or len(same) != len(want) or \
            f"mesh_bg_{pipe.frame:04d}.ply" not in want or frames != list(range(CLI_SPLIT + CLI_MESH_EVERY,
                                         CLI_FRAMES + 1, CLI_MESH_EVERY)):
        raise RuntimeError(f"cli path: --frame-meshes files {last} differ "
                           f"from the synchronous writer's {want} (equal: "
                           f"{same}; frames {frames})")
    return dict(frames=frames, files=want, sync_write_s=sync_s,
                bytes={n: os.path.getsize(os.path.join(sync_dir, n))
                       for n in want})


def scene_distance(scene, pts, objects):
    """Each point's distance to the nearest surface of the scene's
    spheres and planes and the ``objects`` spheres (unsigned)."""
    d = np.full(len(pts), np.inf)
    for c, r in list(scene.spheres) + list(objects):
        d = np.minimum(d, np.abs(np.linalg.norm(pts - c, axis=1) - r))
    for n, p0 in scene.planes:
        d = np.minimum(d, np.abs((pts - p0) @ n))
    return d


def cli_path(torch, params, scene, rng, report, config, then=None):
    """Step 9, the CLI path: a TUM-format sequence of the object path's
    scene through ``apps.run_emfusion.main`` on the card, frames 0-19
    with a checkpoint, then ``--resume`` for frames 20-39 (a checkpoint
    at the end too), then ``apps.evaluate``; then the final checkpoint
    loaded, its 512^3 background meshed, ``write_results`` and a
    checkpoint save timed. Fails on a camera ATE of 1 cm or more, a lost
    object, an x-motion recovery outside 0.35-2.0, a missing export
    directory, an empty mesh, or a background mesh whose median distance
    to the scene's surfaces is half a voxel or more. ``then(pipe, seq,
    masks)``, if given, runs on the final state before the files go.
    Returns the launches of both runs and what ``then`` returned."""
    import shutil

    from emfusion_tpu_torch import kernels
    from emfusion_tpu_torch.apps import evaluate, run_emfusion
    from emfusion_tpu_torch.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from emfusion_tpu_torch.eval.ate import load_trajectory
    from emfusion_tpu_torch.io.writers import (
        background_mesh, read_volume_bin, write_results,
    )
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    work = os.path.join(HERE, "chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        seq, ck = os.path.join(work, "seq"), os.path.join(work, "ck.npz")
        out1, out2 = os.path.join(work, "out1"), os.path.join(work, "out2")
        t0 = time.perf_counter()
        stamps, filters = write_tum_sequence(seq, params, scene, CLI_FRAMES,
                                             rng)
        write_s = time.perf_counter() - t0
        print(f"cli path: {CLI_FRAMES}-frame TUM sequence written in "
              f"{write_s:.3f} s with libpng's adaptive filters: rows of "
              f"None, Sub, Up, Average, Paeth {filters.tolist()}",
              flush=True)
        if not filters.all():
            raise RuntimeError(f"cli path: a filter type is missing from the "
                               f"sequence: {filters.tolist()}")
        decode_ms = decode_step(seq, report)

        common = ["-t", seq, "-m", os.path.join(seq, "masks"), "-c",
                  config, "--checkpoint", ck,
                  "--checkpoint-every", str(CLI_SPLIT)]
        torch.cuda.synchronize()
        kernels.reset_launches()
        text1, run1_s = run_cli(run_emfusion, common + [
            "-e", out1, "--frames", str(CLI_SPLIT)])
        text2, run2_s = run_cli(run_emfusion, common + [
            "-e", out2, "--resume", "--frame-meshes", str(CLI_MESH_EVERY)])
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        steady = [float(line.split()[1]) for line in
                  (text1 + text2).splitlines()
                  if line.startswith("steady-state:")]
        ev, _ = run_cli(evaluate, [out2, os.path.join(seq,
                                                      "groundtruth.txt"),
                                   "--json"])
        ate = json.loads(ev)["camera"]

        # the state at frame 40: load, mesh, write, save
        pipe = EMFusionPipeline(params)
        t0 = time.perf_counter()
        load_checkpoint(pipe, ck)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if pipe.frame != CLI_FRAMES:
            raise RuntimeError(f"cli path: the final checkpoint is at frame "
                               f"{pipe.frame}, not {CLI_FRAMES}")
        t0 = time.perf_counter()
        verts, norms, tris = background_mesh(pipe)
        mesh_s = time.perf_counter() - t0
        frame_meshes = check_frame_meshes(pipe, os.path.join(out2,
                                                             "frame_meshes"),
                                          os.path.join(work, "sync"))
        t0 = time.perf_counter()
        write_results(pipe, os.path.join(work, "out3"), export_volumes=True)
        results_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_checkpoint(pipe, os.path.join(work, "ck2.npz"))
        save_s = time.perf_counter() - t0
        ck_mb = os.path.getsize(ck) / 2 ** 20
        vol, _, _ = read_volume_bin(os.path.join(work, "out3", "tsdfs",
                                                 "bg_tsdf.bin"))
        if not np.array_equal(vol, pipe.state.bg_tsdf.cpu().numpy()):
            raise RuntimeError("cli path: tsdfs/bg_tsdf.bin does not hold "
                               "the background volume")
        world = verts @ pipe.state.bg_pose[:3, :3].numpy().T \
            + pipe.state.bg_pose[:3, 3].numpy()
        dist = scene_distance(scene, world, movers_at(CLI_FRAMES - 1))
        med = float(np.median(dist)) if len(dist) else float("inf")

        live = sorted(int(f[5:-4]) for f in os.listdir(out2)
                      if f.startswith("mesh_") and f[5:-4].isdigit())
        missing = [sub.format(oid=oid) for oid in live
                   for sub in EXPORT_TREE
                   if not (os.path.isdir(os.path.join(out2, sub.format(
                       oid=oid))) and os.listdir(os.path.join(
                           out2, sub.format(oid=oid))))]
        frame_of = {s: i for i, s in enumerate(stamps)}
        rec = {}
        for oid in live:
            traj = load_trajectory(os.path.join(
                out2, f"poses-{oid}-corrected.txt"))
            fs = sorted(frame_of[s] for s in traj)
            first, last = (traj[stamps[fs[0]]][:3, 3],
                           traj[stamps[fs[-1]]][:3, 3])
            j = int(np.argmin([np.linalg.norm(first - c)
                               for c, _ in movers_at(fs[0])]))
            true = movers_at(fs[-1])[j][0][0] - movers_at(fs[0])[j][0][0]
            rec[oid] = dict(mover=j, frames=[fs[0], fs[-1]],
                            dx_est=float(last[0] - first[0]),
                            dx_true=float(true))
            rec[oid]["recovery"] = rec[oid]["dx_est"] / rec[oid]["dx_true"]
        obj_verts = {}
        for oid in live:
            with open(os.path.join(out2, f"mesh_{oid}.ply")) as f:
                for line in f:
                    if line.startswith("element vertex"):
                        obj_verts[oid] = int(line.split()[-1])
                        break
        report["cli_path"] = dict(
            frames=CLI_FRAMES, resumed_at=CLI_SPLIT,
            sequence_write_s=write_s, png_filter_rows=filters.tolist(),
            png_decode_ms_per_frame=decode_ms, frame_meshes=frame_meshes,
            run_s=[run1_s, run2_s], steady_ms_per_frame=steady,
            launches=launches,
            launches_per_frame={k: v / CLI_FRAMES
                                for k, v in launches.items()},
            ate=ate, live_objects=live, recovery=rec,
            checkpoint_load_s=load_s, checkpoint_save_s=save_s,
            checkpoint_mb=ck_mb, mesh_extract_s=mesh_s,
            mesh_vertices=len(verts), mesh_triangles=len(tris),
            mesh_median_scene_distance_m=med, object_mesh_vertices=obj_verts,
            write_results_s=results_s, missing_exports=missing)
        print(f"cli path: frames 0-{CLI_SPLIT - 1} {run1_s:.3f} s, resumed "
              f"{CLI_SPLIT}-{CLI_FRAMES - 1} (with --frame-meshes "
              f"{CLI_MESH_EVERY}) {run2_s:.3f} s; steady-state {steady} "
              f"ms/frame (one reader thread on Up-only PNGs, H100 80GB "
              f"HBM3 at 700 W: 55.876 / 52.215); "
              f"launches per frame " + ", ".join(
                  f"{k} {v / CLI_FRAMES:.2f}" for k, v in launches.items()),
              flush=True)
        print(f"cli path: camera ATE rmse {ate['ate_rmse'] * 1e3:.3f} mm "
              f"({ate['pairs']} pairs); live objects {live}; x-motion "
              "recovery " + ", ".join(f"object {o} {r['recovery']:.3f}"
                                      for o, r in rec.items()), flush=True)
        print(f"cli path: checkpoint {ck_mb:.1f} MiB, load {load_s:.3f} s, "
              f"save {save_s:.3f} s; 512^3 sparse extraction {mesh_s:.3f} s, "
              f"{len(verts)} vertices, {len(tris)} triangles, median "
              f"distance to the scene {med * 1e3:.3f} mm; object meshes "
              f"{obj_verts} vertices; write_results (with volumes) "
              f"{results_s:.3f} s", flush=True)
        after = then(pipe, seq, os.path.join(seq, "masks")) if then else None
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check_launches("cli path", launches, PATH_KERNELS,
                   forbidden=LM_SPLIT_KERNELS)
    if not ate["ate_rmse"] < VOXEL_CUT:
        raise RuntimeError(f"cli path: ATE {ate['ate_rmse']} m >= "
                           f"{VOXEL_CUT} m")
    if len(rec) != len(MOVERS) or sorted(
            r["mover"] for r in rec.values()) != list(range(len(MOVERS))):
        raise RuntimeError(f"cli path: object lost: live objects {rec}")
    bad = {o: r for o, r in rec.items() if not 0.35 < r["recovery"] < 2.0}
    if bad:
        raise RuntimeError(f"cli path: object motion not recovered: {bad}")
    if missing:
        raise RuntimeError(f"cli path: missing exports {missing}")
    if not len(verts) or not all(obj_verts.values()):
        raise RuntimeError("cli path: an empty mesh")
    if not med < 0.5 * params.globalVoxelSize:
        raise RuntimeError(f"cli path: the background mesh lies {med} m "
                           "(median) from the scene")
    return launches, after


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_get(port, path, timeout=300):
    """(status, content type, body) of a GET on the loopback viewer."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def stream_parts(port, n, publish):
    """``n`` parts of ``/stream``, publishing a new frame after each part
    but the last; each part's bytes."""
    import urllib.request
    parts = []
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stream",
                                timeout=120) as r:
        for i in range(n):
            head = [r.readline() for _ in range(4)]
            if head[0] != b"--emf\r\n":
                raise RuntimeError(f"viewer: /stream part {i}: {head}")
            parts.append(r.read(int(head[2].split(b":")[1])))
            r.readline()
            if i < n - 1:
                publish()
    return parts


def lit(img) -> float:
    return float((np.asarray(img).max(-1) > 0).mean())


def viewer_step(torch, pipe, seq, masks_dir, config, report):
    """Step 9b: ``apps.run_emfusion --serve --turntable`` over 4 frames of
    the CLI sequence (a thread polls ``/status`` while it runs), then
    ``LiveViewer`` over ``pipe`` (the CLI path's final state): every
    endpoint, two ``/stream`` parts, 12 turntable views and
    ``encode_jpeg`` timed, and K4 held at an orbit pose. Fails if an
    endpoint does not answer as it should, an image is unlit, or the
    CLI's viewer never answered. Returns the ``raycast_orbit`` row and
    the step's K4 launches."""
    import threading

    from emfusion_tpu_torch import kernels
    from emfusion_tpu_torch.apps import run_emfusion
    from emfusion_tpu_torch.geometry.se3 import pose_inverse
    from emfusion_tpu_torch.io.codecs import decode_png, encode_jpeg
    from emfusion_tpu_torch.viz import (
        orbit_pose, render_orbit_view, render_turntable,
    )
    from emfusion_tpu_torch.viz_server import LiveViewer

    out = dict()
    # the CLI with the live viewer and the turntable
    port, polled, stop = free_port(), [], threading.Event()

    def poll():
        while not stop.is_set():
            try:
                st, _, body = http_get(port, "/status", timeout=5)
                if st == 200:
                    polled.append(json.loads(body)["frame"])
            except OSError:          # not up yet, or closed at the end
                pass
            stop.wait(0.2)

    tt_out = os.path.join(os.path.dirname(seq), "out_viewer")
    poller = threading.Thread(target=poll)
    poller.start()
    try:
        _, cli_s = run_cli(run_emfusion, [
            "-t", seq, "-m", masks_dir, "-c", config, "-e", tt_out,
            "--frames", "4", "--serve", str(port), "--turntable", "3"])
    finally:
        stop.set()
        poller.join()
    views = [decode_png(open(os.path.join(tt_out, "turntable",
                                          f"view{i:03d}.png"), "rb").read())
             for i in range(3)]
    out.update(cli_serve_turntable_s=cli_s, cli_status_frames_seen=polled,
               cli_turntable_lit=[lit(v) for v in views])
    if not polled:
        raise RuntimeError("viewer: the CLI's live viewer never answered")
    # a view from behind the scene sees mostly back faces, which K4 culls
    if max(out["cli_turntable_lit"]) < 0.05:
        raise RuntimeError(f"viewer: the CLI turntable views are unlit "
                           f"{out['cli_turntable_lit']}")

    # LiveViewer over the CLI path's final state
    torch.cuda.synchronize()
    kernels.reset_launches()
    front = np.pi                    # the side the scene was seen from
    viewer = LiveViewer(pipe, port=0)
    times = {}
    try:
        frame = render_orbit_view(pipe, front)
        viewer.publish(frame)
        for path, want in (("/", "text/html"), ("/frame.png", "image/png"),
                           (f"/view.png?yaw={front}&pitch=-0.25&dist=0.9",
                            "image/png"), ("/scene", "text/html"),
                           ("/mesh.bin", "application/octet-stream"),
                           ("/mesh.ply", "application/octet-stream"),
                           ("/status", "application/json")):
            t0 = time.perf_counter()
            st, ctype, body = http_get(viewer.port, path)
            times[path.split("?")[0]] = time.perf_counter() - t0
            if st != 200 or ctype != want:
                raise RuntimeError(f"viewer: GET {path} -> {st} {ctype}")
            if path == "/frame.png":
                img = decode_png(body)
                out["frame_png_lit"] = lit(img)
                if not np.array_equal(img, frame) or lit(img) < 0.05:
                    raise RuntimeError(
                        f"viewer: /frame.png is not the published frame, "
                        f"or unlit ({out['frame_png_lit']})")
            elif path.startswith("/view.png"):
                out["view_png_lit"] = lit(decode_png(body))
                if out["view_png_lit"] < 0.05:
                    raise RuntimeError("viewer: /view.png is unlit")
            elif path == "/mesh.bin":
                nm, off, sizes = struct_unpack(body)
                out["mesh_bin"] = dict(meshes=nm, bytes=len(body),
                                       vertices=sizes)
                if nm != 1 + len(pipe.active_object_ids) or off != len(body):
                    raise RuntimeError(f"viewer: /mesh.bin holds {nm} "
                                       "meshes or does not parse")
            elif path == "/mesh.ply" and not body.startswith(b"ply"):
                raise RuntimeError("viewer: /mesh.ply is no PLY")
            elif path == "/status":
                out["status"] = json.loads(body)
        t0 = time.perf_counter()
        parts = stream_parts(viewer.port, 2, viewer.publish)
        times["/stream (2 parts)"] = time.perf_counter() - t0
        if any(p[:2] != b"\xff\xd8" or p[-2:] != b"\xff\xd9"
               for p in parts):
            raise RuntimeError("viewer: /stream parts are no JPEG")
        st, _, _ = http_get(viewer.port, "/nope")
        if st != 404:
            raise RuntimeError(f"viewer: GET /nope -> {st}, not 404")
    finally:
        viewer.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tt = render_turntable(pipe, TURNTABLE_VIEWS)
    torch.cuda.synchronize()
    view_ms = 1e3 * (time.perf_counter() - t0) / TURNTABLE_VIEWS
    launches = dict(kernels.launches)
    out.update(endpoint_s=times, turntable_ms_per_view=view_ms,
               turntable_lit=[lit(v) for v in tt], launches=launches)
    if max(out["turntable_lit"]) < 0.05:
        raise RuntimeError(f"viewer: the turntable views are unlit "
                           f"{out['turntable_lit']}")
    t0 = time.perf_counter()
    for _ in range(5):
        encode_jpeg(tt[0], 85)
    out["encode_jpeg_ms"] = 1e3 * (time.perf_counter() - t0) / 5
    # K4 from the orbit camera, outside the volume
    s = pipe.state
    rel = pose_inverse(s.bg_pose) @ torch.from_numpy(orbit_pose(pipe,
                                                                front))
    row = hold_raycast(torch, s.bg_tsdf, s.bg_weights, rel[:3, :3],
                       rel[:3, 3], pipe.intr, pipe.voxel, pipe.trunc, pipe.H,
                       pipe.W, pipe.params.raycast_max_steps)
    out["raycast_orbit_hits"] = row["hits"]
    report["viewer"] = out
    print(f"viewer: CLI --serve --turntable 3 over 4 frames {cli_s:.3f} s, "
          f"/status answered at frames {sorted(set(polled))}; endpoints "
          + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
          + f"; {TURNTABLE_VIEWS} turntable views {view_ms:.3f} ms a view "
          f"(lit {min(out['turntable_lit']):.3f}-"
          f"{max(out['turntable_lit']):.3f}); encode_jpeg 640x480 "
          f"{out['encode_jpeg_ms']:.3f} ms; launches {launches}",
          flush=True)
    return row, launches["raycast"]


def struct_unpack(body):
    """(meshes, bytes parsed, vertices per mesh) of a ``/mesh.bin``."""
    import struct
    nm = struct.unpack_from("<I", body, 0)[0]
    off, sizes = 4, []
    for _ in range(nm):
        nv, nt = struct.unpack_from("<II", body, off)
        tris = np.frombuffer(body, "<u4", nt * 3, off + 8 + nv * 24)
        if nt and tris.max() >= nv:
            raise RuntimeError("viewer: /mesh.bin indexes a missing vertex")
        sizes.append(nv)
        off += 8 + nv * 24 + nt * 12
    return nm, off, sizes


class ServeProbe:
    """Wraps ``viz_server.serve_step`` and ``viz.render_turntable`` in
    this process's CLI run with ``--serve`` (one card, or a rank): each
    step's ms and requests; at pipeline frame ``at - 1`` a GET of
    ``SERVE_VIEW`` alone, at ``at`` a GET of every path of
    ``SERVE_PATHS`` (each on its own thread, their round trips timed; on
    a mesh the step runs once the ``SERVE_QUEUED`` requests that need
    every rank are queued), so each is answered at its frame; after the
    last step (``serve_close``'s) a GET of ``SERVE_LATE``, which a
    sharded run's closing answers with a 503; the turntable's ms a
    view."""

    def __init__(self, at: int):
        from emfusion_tpu_torch import viz, viz_server
        self.mods = (viz_server, viz)
        self.real = (viz_server.serve_step, viz.render_turntable)
        viz_server.serve_step, viz.render_turntable = self.step, self.views
        self.at, self.last = at, None
        self.answers, self.get_s, self.steps, self.late = {}, {}, [], {}
        self.threads = []
        self.turntable_ms = None

    def restore(self) -> None:
        self.mods[0].serve_step, self.mods[1].render_turntable = self.real

    def _get(self, port, paths):
        import threading

        def one(p):
            t0 = time.perf_counter()
            st, _, body = http_get(port, p, timeout=SERVE_TIMEOUT_S)
            self.get_s[p] = time.perf_counter() - t0
            (self.late if p == SERVE_LATE else self.answers)[p] = (st, body)
        ts = [threading.Thread(target=one, args=(p,)) for p in paths]
        for t in ts:
            t.start()
        return ts

    @staticmethod
    def _wait_queued(pipe, viewer, n):
        end = time.monotonic() + SERVE_TIMEOUT_S
        while pipe.mesh is not None and viewer.queued() < n:
            if time.monotonic() > end:
                raise RuntimeError(f"sharded viewer: {viewer.queued()} of "
                                   f"{n} requests queued")
            time.sleep(0.002)

    def step(self, pipe, viewer=None):
        final = pipe.frame == self.last
        self.last = pipe.frame
        ts = []
        if viewer is not None and not final and pipe.frame in (self.at - 1,
                                                               self.at):
            paths = [SERVE_VIEW] if pipe.frame < self.at else SERVE_PATHS
            ts = self._get(viewer.port, paths)
            self._wait_queued(pipe, viewer, 1 if pipe.frame < self.at
                              else SERVE_QUEUED)
        t0 = time.perf_counter()
        n = self.real[0](pipe, viewer)
        self.steps.append((1e3 * (time.perf_counter() - t0), n, final))
        for t in ts:
            t.join()
        if final and viewer is not None:
            self.threads = self._get(viewer.port, [SERVE_LATE])
            if pipe.mesh is None:          # answered under the lock, now
                self.threads[0].join()
            self._wait_queued(pipe, viewer, 1)
        return n

    def views(self, pipe, *a, **k):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.real[1](pipe, *a, **k)
        torch.cuda.synchronize()
        self.turntable_ms = 1e3 * (time.perf_counter() - t0) / len(out)
        return out

    def result(self, code: int) -> dict:
        for t in self.threads:
            t.join()
        return dict(code=code, answers=self.answers, get_s=self.get_s,
                    steps=self.steps, late=self.late.get(SERVE_LATE),
                    turntable_ms=self.turntable_ms)


def serve_rank(mesh, argv, at):
    """A rank of ``apps.run_emfusion`` (``--nprocs``'s rank body) under a
    :class:`ServeProbe`."""
    from emfusion_tpu_torch.apps import run_emfusion
    probe = ServeProbe(at)
    return probe.result(run_emfusion._rank_main(mesh, argv))


def serve_rank_main(argv) -> int:
    """``chip_smoke.py --serve-rank OUT AT ARGV...``: a rank of
    ``apps.run_emfusion.main(ARGV)`` under ``torchrun`` (its group joined
    from ``WORLD_SIZE`` > 1) and a :class:`ServeProbe`; the probe's result
    goes to ``OUT.rank<RANK>``."""
    import pickle

    from emfusion_tpu_torch.apps import run_emfusion
    out, at = argv[0], int(argv[1])
    probe = ServeProbe(at)
    res = probe.result(run_emfusion.main(argv[2:]))
    with open(f"{out}.rank{os.environ['RANK']}", "wb") as f:
        pickle.dump(res, f)
    return 0


def sharded_viewer(torch, params, scene, rng, report, key, config, ranks,
                   backend, via):
    """Step 9c: ``apps.run_emfusion --serve --turntable`` on ``ranks``
    ranks (``backend``; ``via``: ``launch``, the ``--nprocs`` rank body,
    or ``torchrun``, the CLI's entry under it) against one card, over a
    ``SERVE_FRAMES``-frame TUM sequence of the object path's scene at
    ``params``' size, each run under a :class:`ServeProbe`: every pinned
    answer, the view alone a frame earlier and the ``--turntable`` PNGs
    byte for byte; the late request answered (one card) or refused with a
    503 (the ranks); every rank exits 0. Prints the service step's ms
    with nothing queued, the view's round trip and the turntable's ms a
    view, sharded beside one card. ``config``: a config file's path or
    text. Fails on a difference."""
    import pickle

    from emfusion_tpu_torch.apps import run_emfusion
    from emfusion_tpu_torch.distributed.mesh import launch

    shutil.rmtree(SERVE_WORK, ignore_errors=True)
    os.makedirs(SERVE_WORK)
    try:
        seq = os.path.join(SERVE_WORK, "seq")
        write_tum_sequence(seq, params, scene, SERVE_FRAMES, rng)
        if not os.path.exists(config):
            with open(os.path.join(SERVE_WORK, "config.cfg"), "w") as f:
                f.write(config)
            config = os.path.join(SERVE_WORK, "config.cfg")

        def argv(name):
            return ["-t", seq, "-m", os.path.join(seq, "masks"), "-c",
                    config, "-e", os.path.join(SERVE_WORK, name),
                    "--frames", str(SERVE_FRAMES), "--serve",
                    str(free_port()), "--turntable", str(SERVE_TURNTABLE)]

        t0 = time.perf_counter()
        probe = ServeProbe(SERVE_FRAMES)
        try:
            run_cli(run_emfusion, argv("one"))
        finally:
            probe.restore()
        one = probe.result(0)
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if via == "launch":
            res = launch("chip_smoke:serve_rank", ranks,
                         args=(argv("ranks"), SERVE_FRAMES), device="cuda",
                         backend=backend, timeout_s=SERVE_TIMEOUT_S)
        else:
            out = os.path.join(SERVE_WORK, "probe")
            subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(ranks),
                 os.path.join(HERE, "chip_smoke.py"), "--serve-rank", out,
                 str(SERVE_FRAMES)] + argv("ranks"),
                env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                    [p for p in sys.path if p]
                    + [os.environ.get("PYTHONPATH", "")])),
                check=True, timeout=SERVE_TIMEOUT_S)
            res = []
            for r in range(ranks):
                with open(f"{out}.rank{r}", "rb") as f:
                    res.append(pickle.load(f))
        ranks_s = time.perf_counter() - t0
        r0 = res[0]
        paths = list(SERVE_PATHS) + [SERVE_VIEW]
        differ = [p for p in paths
                  if r0["answers"].get(p) != one["answers"].get(p)
                  or one["answers"][p][0] != 200]
        tt = [os.path.join("turntable", f"view{i:03d}.png")
              for i in range(SERVE_TURNTABLE)]
        for name in tt:
            a, b = (open(os.path.join(SERVE_WORK, w, name), "rb").read()
                    for w in ("one", "ranks"))
            if a != b:
                differ.append(name)
        idle = [ms for ms, n, final in r0["steps"] if n == 0 and not final]
        busy = {n: ms for ms, n, final in r0["steps"] if n}
        out = dict(
            via=via, ranks=ranks, backend=backend, frames=SERVE_FRAMES,
            size=[params.width, params.height],
            volume=list(params.globalVolumeDims), differ=differ,
            codes=[r["code"] for r in res],
            late=[one["late"][0], r0["late"][0] if r0["late"] else None],
            status=json.loads(one["answers"]["/status"][1]),
            idle_step_ms=idle, step_ms_by_requests=busy,
            view_get_s=[one["get_s"][SERVE_VIEW], r0["get_s"][SERVE_VIEW]],
            turntable_ms_per_view=[one["turntable_ms"], r0["turntable_ms"]],
            one_card_s=one_s, ranks_s=ranks_s,
            bytes={p: len(one["answers"][p][1]) for p in SERVE_PATHS})
        report[key] = out
        print(f"sharded viewer ({via}, {ranks} ranks, {backend}, "
              f"{params.width}x{params.height}, "
              f"{params.globalVolumeDims[0]}^3, {SERVE_FRAMES} frames): "
              f"answers equal to one card's: {not differ} (differ "
              f"{differ}); live objects {out['status']['objects']}; late "
              f"request {out['late'][0]} / {out['late'][1]}; service step "
              f"with nothing queued {np.median(idle):.3f} ms (median of "
              f"{len(idle)}, max {max(idle):.3f}); steps with requests "
              f"{ {k: round(v, 3) for k, v in busy.items()} } ms; "
              f"/view.png round trip {1e3 * out['view_get_s'][0]:.3f} / "
              f"{1e3 * out['view_get_s'][1]:.3f} ms (one card / ranks); "
              f"turntable {out['turntable_ms_per_view'][0]:.3f} / "
              f"{out['turntable_ms_per_view'][1]:.3f} ms a view; runs "
              f"{one_s:.1f} / {ranks_s:.1f} s", flush=True)
        if differ or out["codes"] != [0] * ranks or out["late"] != [200, 503] \
                or not out["status"]["objects"]:
            raise RuntimeError(f"sharded viewer: {out}")
        return out
    finally:
        shutil.rmtree(SERVE_WORK, ignore_errors=True)


def profile_frames(torch, pipe, frames, report, key):
    """torch.profiler over ``frames`` continuing ``pipe``'s run: the
    device's busy share of the wall time, and the device ops that took
    most of it (into ``report[key]``; the full table goes to
    ``chiprun_out/<key>_ops.txt``). Only the device's activity is traced:
    the host's hundreds of thousands of op events a frame cost minutes to
    gather and say nothing about the device."""
    from torch.profiler import ProfilerActivity, profile

    n = len(frames)
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for depth in frames:
            pipe.process_frame(None, depth)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    ev = prof.key_averages()
    phases = set(pipe.timer.counts)

    def dev_ms(e):
        return e.self_device_time_total / 1e3 / n       # us -> ms/frame

    # device-side rows: kernels and copies (a phase's range also shows on
    # the device, as an annotation; it is not work)
    work = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key not in phases]
    busy = sum(dev_ms(e) for e in work)
    ops = sum(e.count for e in work) / n
    top = sorted(((dev_ms(e), e.key, e.count / n) for e in work),
                 reverse=True)[:6]
    prof_s = time.perf_counter() - t_prof
    report[key] = dict(frames=n, wall_ms_per_frame=wall_ms,
                       device_busy_ms_per_frame=busy,
                       device_busy_share=busy / wall_ms,
                       device_ops_per_frame=ops, top_device_ops=top,
                       profile_s=prof_s)
    print(f"{key}: {n} frames, wall {wall_ms:.3f} ms/frame (the profiler "
          f"slows the host), device busy {busy:.3f} ms/frame "
          f"({100 * busy / wall_ms:.1f}%) in {ops:.0f} kernels and copies "
          f"per frame; the profile took {prof_s:.1f} s", flush=True)
    for ms, op, calls in top:
        print(f"  {ms:8.3f} ms/frame {calls:7.1f} calls/frame  {op[:70]}",
              flush=True)
    with open(os.path.join(HERE, "chiprun_out", f"{key}_ops.txt"),
              "w") as f:
        f.write(ev.table(sort_by="self_device_time_total", row_limit=60))


def small_reference(torch, rng, report):
    """The same small scenes through the pipeline on the card (kernels)
    and on the CPU (plain versions), with depth noise from ``rng``.
    Without objects: per-frame camera positions agree to 0.1 voxel. With
    the two moving spheres (masks at frames 0 and 3): the same live
    objects after every frame, camera positions within 0.1 background
    voxel and object positions within 0.5 object voxel. The object bound
    is loose because a sphere's rotation about its centre is unobservable
    and the object's origin is not its centre: where the LM stops along
    that flat direction moves the origin, on one device as well, by
    rounding-sized changes of the input."""
    from emfusion_tpu_torch.config import Params
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    scene = make_scene(120, 160, 130.0)
    small = dict(frameSize=(160, 120), fx=130.0, fy=130.0, cx=79.5,
                 cy=59.5)
    params = Params(**small, globalVolumeDims=(64, 64, 64),
                    globalVoxelSize=5.12 / 64, volumePose=(0.0, 0.0, 2.56),
                    maxTrackingIter=50, raycast_max_steps=512)
    frames = [sensor_depth(scene.render(gt_pose(2 * i)), rng)
              for i in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = EMFusionPipeline(params, device=dev)
        for depth in frames:
            pipe.process_frame(None, depth)
        out[dev] = np.stack([pipe.poses[f] for f in range(4)])
    diff = float(np.abs(out["cuda"][:, :3, 3] - out["cpu"][:, :3, 3]).max())
    report["small_reference_max_translation_diff"] = diff
    print(f"small scene, card vs CPU: max camera translation difference "
          f"{diff:.3e} m (limit {0.1 * 5.12 / 64:.3e})", flush=True)
    if not diff < 0.1 * 5.12 / 64:
        raise RuntimeError("card and CPU pipelines disagree")

    params = Params(**small, **SMALL_OBJECTS)
    n = 6
    frames, masks = object_scene(scene, params, n, rng, step=2)
    runs = {}
    for dev in ("cuda", "cpu"):
        pipe = EMFusionPipeline(params, mask_provider(masks), device=dev)
        ids = []
        for depth in frames:
            pipe.process_frame(None, depth)
            ids.append(pipe.active_object_ids)
        runs[dev] = dict(ids=ids, cam=dict(pipe.poses),
                         obj={o: dict(t) for o, t in pipe.obj_poses.items()},
                         vs={o: float(pipe.state.objs.voxel_size[
                             pipe._slot_of(o)]) for o in ids[-1]})
    a, b = runs["cuda"], runs["cpu"]
    cam = max(np.linalg.norm(a["cam"][f][:3, 3] - b["cam"][f][:3, 3])
              for f in range(n))
    obj = {o: max(np.linalg.norm(a["obj"][o][f][:3, 3]
                                 - b["obj"][o][f][:3, 3])
                  for f in b["obj"][o]) / b["vs"][o] for o in b["vs"]}
    report["small_reference_objects"] = dict(
        ids=b["ids"], max_camera_translation_diff=float(cam),
        max_object_translation_diff_voxels=obj)
    print(f"small object scene, card vs CPU: live objects {a['ids'][-1]} / "
          f"{b['ids'][-1]}, max camera translation difference {cam:.3e} m, "
          f"object translation difference in object voxels {obj}",
          flush=True)
    if a["ids"] != b["ids"] or len(b["ids"][-1]) != len(MOVERS):
        raise RuntimeError(f"card and CPU object lifecycles differ: "
                           f"{a['ids']} / {b['ids']}")
    if not cam < 0.1 * params.globalVoxelSize or \
            not all(v < 0.5 for v in obj.values()):
        raise RuntimeError("card and CPU object pipelines disagree")


# ---------------------------------------------------------------------
# steps 12-14: object deletion and slot re-use at full width and at the
# small size (card against CPU), and configs/room4.cfg through the CLI
def respawn_scene(scene, params, n_frames, rng, step=1):
    """Depth frames of the scene with the ``RESPAWN_MOVERS`` present at
    frame ``step * i`` (``RESPAWN_FROM``) for frame ``i``, their
    ground-truth masks on the mask frames (every ``maskRCNNFrames``, in
    the movers' order), and per frame mover A's pixels inside the
    ``boundary`` (where the raycast counts an object visible)."""
    frames, masks, a_pixels = [], {}, []
    b, H, W = params.boundary, scene.H, scene.W
    for i in range(n_frames):
        f = step * i
        movers = [m for m, f0 in zip(movers_at(f, RESPAWN_MOVERS),
                                     RESPAWN_FROM) if f >= f0]
        depth, ms = scene.render(gt_pose(f), movers)
        frames.append(sensor_depth(depth, rng))
        a_pixels.append(int(ms[0][b:H - b, b:W - b].sum()))
        if i % params.maskRCNNFrames == 0:
            masks[i] = ms
    return frames, masks, a_pixels


def respawn_frames(torch, pipe, frames, spawn_frame, after=None):
    """Drive ``pipe`` over ``frames`` (calling ``after()`` after each);
    per frame its host ms around a synchronised frame (on the card) and
    its lifecycle: the live ids, their slots and voxel sizes, the slots
    live at the frame's start, each slot's visible pixels in the frame's
    raycast, the object raycasts (K4 launches at the object shape) and
    the object LMs of the frame, the largest weight of slot 0, and
    whether a live slot's volume holds a NaN. Also returns, for each
    slot spawned at frame ``spawn_frame``, the largest magnitude of its
    tsdf, weights and fg counts as the spawn left them, before the
    frame's fusion."""
    from emfusion_tpu_torch import kernels

    cuda = pipe.device.type == "cuda"
    obj_shape = tuple(pipe.state.objs.tsdf.shape[1:])
    zeroed = {}
    fuse = pipe.integrate

    def integrate(depth):
        if pipe.frame == spawn_frame:
            o = pipe.state.objs
            for k in pipe._frame_spawned:
                zeroed[k] = max(float(t[k].abs().max())
                                for t in (o.tsdf, o.weights, o.fg_counts))
        return fuse(depth)

    pipe.integrate = integrate
    life, e2e = [], []
    try:
        for depth in frames:
            before = dict(kernels.launches_by_shape)
            live = [int(k) for k in np.nonzero(pipe._h_active)[0]]
            first = pipe.frame == 0
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.process_frame(None, depth, timestamp=float(pipe.frame))
            if cuda:
                torch.cuda.synchronize()
            e2e.append(1e3 * (time.perf_counter() - t0))
            o, rc = pipe.state.objs, pipe._last_raycast
            ids = pipe.active_object_ids
            life.append(dict(
                ids=ids, slots={j: pipe._slot_of(j) for j in ids},
                vs={j: float(o.voxel_size[pipe._slot_of(j)]) for j in ids},
                live_before=live,
                vis=(None if first
                     else rc["vis_counts"].cpu().numpy().tolist()),
                obj_raycasts=kernels.launches_by_shape[
                    ("raycast", obj_shape)] - before.get(
                        ("raycast", obj_shape), 0),
                object_lms=0 if first else len(pipe.last_obj_track_stats),
                slot0_max_weight=float(o.weights[0].max()),
                nan=any(bool(torch.isnan(t[pipe._slot_of(j)]).any())
                        for j in ids for t in (o.tsdf, o.weights))))
            if after is not None:
                after()
    finally:
        pipe.integrate = fuse
    return life, e2e, zeroed


def respawn_lifecycle(life, a_pixels, thresh, spawn_frame):
    """A's deletion frame; the frame from which it is leaving the view
    (fewer than ``2 * thresh`` of its true pixels inside the boundary: the
    raycast of a fused sphere misses the rim of its silhouette, 10-40% of
    its true pixels as it leaves, so the not-visible rule may fire a frame
    before the truth falls under ``thresh``) and the frame from which it
    is out of it (at most ``thresh``); the rule that deleted it (its
    slot's raycast count at most ``thresh``: not visible); C's id and
    slot."""
    a = 1                          # the first spawn: mover A, slot 0
    deleted = next((i for i, r in enumerate(life) if a not in r["ids"]),
                   None)
    leaving = next((i for i, n in enumerate(a_pixels) if n < 2 * thresh),
                   None)
    left = next((i for i, n in enumerate(a_pixels) if n <= thresh), None)
    rule = None
    if deleted is not None:
        rule = ("not visible" if life[deleted]["vis"][0] <= thresh
                else "association or existence")
    new = [j for j in life[spawn_frame]["ids"]
           if j not in life[spawn_frame - 1]["ids"]]
    c = new[0] if len(new) == 1 else None
    return dict(a_deleted=deleted, a_leaving=leaving, a_left=left,
                rule=rule, c=c, c_slot=life[spawn_frame]["slots"].get(c))


def respawn_path(torch, params, scene, rng, report):
    """Step 12: ``RESPAWN_FRAMES`` frames of the respawn scene at full
    width (``configs/default.cfg``): movers A and B spawn at frame 0, A
    leaves the view for good and is deleted, C enters at ``RESPAWN_C`` (a
    mask frame) and spawns into the first free slot, A's. Fails if A is
    not deleted, or is deleted by another rule than the not-visible one
    or before it is leaving the view (:func:`respawn_lifecycle`), if B is
    lost, if B's or C's x-motion recovers outside 0.35-2.0 of the truth,
    if C does not take slot 0, if slot 0 is not zero at C's spawn or
    holds a weight above one frame's (1) after C's first fusion, if the
    camera ATE reaches a voxel, if the object raycasts and the object LMs
    of a frame do not follow the slots live at its start, if a kernel of
    the path never ran, or on a NaN in a live volume."""
    from emfusion_tpu_torch import kernels
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    n = RESPAWN_FRAMES
    frames, masks, a_px = respawn_scene(scene, params, n, rng)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()    # what earlier steps hold
    pipe = EMFusionPipeline(params, mask_provider(masks))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    life, e2e, zeroed = respawn_frames(torch, pipe, frames, RESPAWN_C)
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() - base
    thresh = params.visibilityThresh
    lc = respawn_lifecycle(life, a_px, thresh, RESPAWN_C)
    rec = motion_recovery(pipe, movers=RESPAWN_MOVERS)
    ate = camera_ate(pipe, n)
    for i, r in enumerate(life):
        print(f"respawn path frame {i}: live {r['slots']} (id: slot), A's "
              f"pixels {a_px[i]}, visible {r['vis']}, object raycasts "
              f"{r['obj_raycasts']}, object LMs {r['object_lms']}, slot 0's "
              f"largest weight {r['slot0_max_weight']:.3f}, "
              f"{e2e[i]:.3f} ms", flush=True)
    report["respawn_path"] = dict(
        frames=n, mask_frames=sorted(masks), lifecycle=lc, life=life,
        a_pixels=a_px, e2e_ms=e2e,
        e2e_ms_per_frame=float(np.mean(e2e[1:])),
        max_memory_allocated=peak, memory_held_before=base,
        launches=launches, ate=ate, recovery=rec,
        spawn_slot_max_abs=zeroed,
        phase_ms_per_call=pipe.timer.ms_per_call())
    print(f"respawn path: {n} frames 640x480 into 512^3; A deleted at frame "
          f"{lc['a_deleted']} (rule: {lc['rule']}), leaving the view from "
          f"frame {lc['a_leaving']}, out of it from frame {lc['a_left']}; "
          f"C (id {lc['c']}) spawned at frame {RESPAWN_C} "
          f"into slot {lc['c_slot']}, its volumes' largest magnitude at the "
          f"spawn {zeroed}, slot 0's largest weight before / after C's "
          f"first fusion {life[RESPAWN_C - 1]['slot0_max_weight']:.3f} / "
          f"{life[RESPAWN_C]['slot0_max_weight']:.3f}; e2e "
          f"{np.mean(e2e[1:]):.3f} ms/frame (frames 1..); peak memory "
          f"{peak / 2**30:.3f} GiB (above the {base / 2**30:.3f} GiB "
          f"earlier steps hold); camera ATE rmse {ate['rmse'] * 1e3:.3f} "
          f"mm; x-motion recovery " + ", ".join(
              f"object {oid} (mover {'ABC'[r['mover']]}) {r['recovery']:.3f}"
              for oid, r in rec.items()), flush=True)
    check_launches("respawn path", launches, PATH_KERNELS, pipe.timer,
                   forbidden=LM_SPLIT_KERNELS + [LM_CLUSTER])
    bad = []
    if lc["a_deleted"] is None:
        bad.append("A was not deleted")
    elif lc["a_leaving"] is None or lc["a_deleted"] < lc["a_leaving"] \
            or lc["rule"] != "not visible":
        bad.append(f"A was deleted at frame {lc['a_deleted']} by the "
                   f"{lc['rule']} rule, before it left the view (from "
                   f"frame {lc['a_leaving']})")
    if sorted(r["mover"] for r in rec.values()) != [1, 2]:
        bad.append(f"B or C lost: {rec}")
    bad += [f"object {o} x-motion not recovered: {r}"
            for o, r in rec.items() if not 0.35 < r["recovery"] < 2.0]
    if lc["c_slot"] != 0:
        bad.append(f"C took slot {lc['c_slot']}, not A's freed slot 0")
    if zeroed.get(0) != 0.0:
        bad.append(f"slot 0 not zero at C's spawn: {zeroed}")
    if not life[RESPAWN_C]["slot0_max_weight"] <= 1.0:
        bad.append("slot 0 holds a weight that C's first frame did not "
                   "fuse")
    if not ate["rmse"] < VOXEL_CUT:
        bad.append(f"ATE {ate['rmse']} m >= {VOXEL_CUT} m")
    follow = [i for i, r in enumerate(life[1:], 1)
              if r["obj_raycasts"] != len(r["live_before"])
              or r["object_lms"] != len(r["live_before"])]
    if follow:
        bad.append(f"object raycasts or LMs do not follow the live slots "
                   f"at frames {follow}")
    if lc["a_deleted"] is not None and lc["a_deleted"] + 1 < n and (
            len(life[lc["a_deleted"] + 1]["live_before"])
            != len(life[lc["a_deleted"]]["live_before"]) - 1
            or len(life[RESPAWN_C + 1]["live_before"])
            != len(life[RESPAWN_C]["live_before"]) + 1):
        bad.append("the live slots did not fall by one after A's deletion "
                   "and rise by one after C's spawn")
    nan = [i for i, r in enumerate(life) if r["nan"]]
    if nan:
        bad.append(f"NaN in a live volume at frames {nan}")
    if bad:
        raise RuntimeError("respawn path: " + "; ".join(bad))


def host_snapshot(pipe):
    """``pipe``'s state copied to the host, with the bookkeeping that
    ``load_state`` takes."""
    from emfusion_tpu_torch.pipeline import ObjectPool, PipelineState

    s = pipe.state
    objs = ObjectPool(**{f.name: getattr(s.objs, f.name).cpu().clone()
                         for f in dataclasses.fields(ObjectPool)})
    state = PipelineState(objs=objs, **{
        f.name: getattr(s, f.name).cpu().clone()
        for f in dataclasses.fields(PipelineState) if f.name != "objs"})
    return dict(state=state, frame=pipe.frame,
                meta=copy.deepcopy(pipe.meta), next_id=pipe._next_id,
                poses=dict(pipe.poses))


def respawn_small(torch, rng, report):
    """Step 13: the respawn scene at ``tests/test_torch_pipeline_objects.
    py``'s ``SMALL`` size (160x120, 96^3 at 3 cm, 32^3 objects, masks
    every third frame), every ``RESPAWN_SMALL_STEP``-th frame of step
    12's, on the card, and on the CPU (plain versions) frame by frame
    from the card's states: the CPU's frame ``f`` from the card's state
    after frame ``f - 1``. Fails unless A is deleted and C spawns into
    slot 0, every frame's live ids and slots are the card's, a spawn
    finds its slot zeroed on both, and every frame's camera position is
    within 0.1 background voxel of the card's and each object's within
    0.1 object voxel. (Run free, the two drift apart at mover B: its
    position moves by up to 0.44 object voxel when the CPU run's depth is
    scaled by 1 + 2e-7, ``scripts/respawn_spread.py``.)"""
    from emfusion_tpu_torch.config import Params
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    params = Params(**RESPAWN_SMALL)
    scene = make_scene(120, 160, 120.0)
    step = RESPAWN_SMALL_STEP
    spawn = RESPAWN_C // step
    frames, masks, a_px = respawn_scene(scene, params, RESPAWN_SMALL_FRAMES,
                                        rng, step=step)
    t0 = time.perf_counter()
    card = EMFusionPipeline(params, mask_provider(masks))
    snaps = []
    life, _, zeroed = respawn_frames(
        torch, card, frames, spawn,
        after=lambda: snaps.append(host_snapshot(card)))
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_life, cpu_zeroed, cam, obj = [], {}, [], {}
    for i, depth in enumerate(frames):
        pipe = EMFusionPipeline(params, mask_provider(masks), device="cpu")
        if i:
            snap = snaps[i - 1]
            pipe.load_state(snap["state"], frame=snap["frame"],
                            meta=snap["meta"], next_id=snap["next_id"],
                            poses=snap["poses"])
        r, _, z = respawn_frames(torch, pipe, [depth], spawn)
        cpu_life += r
        cpu_zeroed.update(z)
        cam.append(float(np.linalg.norm(pipe.poses[i][:3, 3]
                                        - card.poses[i][:3, 3])))
        for o, traj in pipe.obj_poses.items():
            if i in traj:
                vs = r[0]["vs"].get(o, life[i - 1]["vs"].get(o))
                theirs = card.obj_poses.get(o, {}).get(i)
                obj.setdefault(o, []).append(float("inf") if theirs is None
                                             else float(np.linalg.norm(
                                                 traj[i][:3, 3]
                                                 - theirs[:3, 3])) / vs)
    cpu_s = time.perf_counter() - t0
    lc = respawn_lifecycle(life, a_px, params.visibilityThresh, spawn)
    same = [i for i, (x, y) in enumerate(zip(life, cpu_life))
            if (x["ids"], x["slots"]) != (y["ids"], y["slots"])]
    worst = {o: max(g) for o, g in obj.items()}
    report["respawn_small"] = dict(
        frames=RESPAWN_SMALL_FRAMES, step=step, lifecycle=lc,
        slots=[r["slots"] for r in life], frames_differing=same,
        spawn_slot_max_abs=dict(card=zeroed, cpu=cpu_zeroed),
        camera_translation_diff=cam, object_translation_diff_voxels=obj,
        seconds=dict(card=card_s, cpu=cpu_s))
    print(f"respawn scene at 160x120, the CPU frame by frame from the "
          f"card's states: live (id: slot) per frame "
          f"{[r['slots'] for r in life]}; A deleted at frame "
          f"{lc['a_deleted']} ({lc['rule']}), C (id {lc['c']}) into slot "
          f"{lc['c_slot']} at frame {spawn}, zeroed at its spawn "
          f"{zeroed} / {cpu_zeroed}; frames whose lifecycle differs "
          f"{same}; max camera translation difference {max(cam):.3e} m "
          f"(limit {0.1 * params.globalVoxelSize:.3e}); max object "
          f"translation difference in object voxels {worst} (limit 0.1); "
          f"card {card_s:.1f} s, CPU {cpu_s:.1f} s", flush=True)
    if lc["a_deleted"] is None or lc["c_slot"] != 0 or same or \
            zeroed.get(0) != 0.0 or cpu_zeroed.get(0) != 0.0:
        raise RuntimeError(f"respawn scene at 160x120: lifecycle {lc}, "
                           f"card and CPU differ at frames {same}, zeroed "
                           f"at the spawn {zeroed} / {cpu_zeroed}")
    if not max(cam) < 0.1 * params.globalVoxelSize or not all(
            v < 0.1 for v in worst.values()):
        raise RuntimeError("respawn scene at 160x120: card and CPU poses "
                           "disagree")


def room4_cli(torch, rng, report):
    """Step 14: ``configs/room4.cfg`` (1.5 cm voxels, ``volumePose`` z
    3.84, its intrinsics) through the CLI: a ``ROOM4_FRAMES``-frame TUM
    sequence of the object path's scene seen through room4's camera
    (:func:`write_tum_sequence`), ``apps.run_emfusion`` with its masks
    and a checkpoint at the end, ``apps.evaluate``, then the 512^3
    background mesh of the checkpoint. Fails on a camera ATE of a voxel
    or more, or a mesh whose median distance to the scene's surfaces is
    half a voxel or more."""
    from emfusion_tpu_torch import kernels
    from emfusion_tpu_torch.apps import evaluate, run_emfusion
    from emfusion_tpu_torch.checkpoint import load_checkpoint
    from emfusion_tpu_torch.config import load_config
    from emfusion_tpu_torch.io.writers import background_mesh
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    config = os.path.join(HERE, "configs", "room4.cfg")
    params = load_config(config)
    vs = params.globalVoxelSize
    scene = make_scene(params.height, params.width, params.fx, params.cx,
                       params.cy)
    work = os.path.join(HERE, "chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        seq, out = os.path.join(work, "seq"), os.path.join(work, "out")
        ck = os.path.join(work, "ck.npz")
        write_tum_sequence(seq, params, scene, ROOM4_FRAMES, rng)
        torch.cuda.synchronize()
        kernels.reset_launches()
        text, run_s = run_cli(run_emfusion, [
            "-t", seq, "-m", os.path.join(seq, "masks"), "-c", config,
            "-e", out, "--checkpoint", ck, "--checkpoint-every",
            str(ROOM4_FRAMES)])
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        steady = [float(line.split()[1]) for line in text.splitlines()
                  if line.startswith("steady-state:")]
        ev, _ = run_cli(evaluate, [out, os.path.join(seq, "groundtruth.txt"),
                                   "--json"])
        ate = json.loads(ev)["camera"]
        live = sorted(int(f[5:-4]) for f in os.listdir(out)
                      if f.startswith("mesh_") and f[5:-4].isdigit())
        pipe = EMFusionPipeline(params)
        load_checkpoint(pipe, ck)
        verts, _, tris = background_mesh(pipe)
        world = verts @ pipe.state.bg_pose[:3, :3].numpy().T \
            + pipe.state.bg_pose[:3, 3].numpy()
        dist = scene_distance(scene, world, movers_at(ROOM4_FRAMES - 1))
        med = float(np.median(dist)) if len(dist) else float("inf")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report["room4_cli"] = dict(
        frames=ROOM4_FRAMES, voxel_size=vs, run_s=run_s,
        steady_ms_per_frame=steady, launches=launches, ate=ate,
        live_objects=live, mesh_vertices=len(verts),
        mesh_triangles=len(tris), mesh_median_scene_distance_m=med)
    print(f"room4 cli: {ROOM4_FRAMES} frames 640x480 (fx {params.fx}, cx "
          f"{params.cx}, cy {params.cy}) into 512^3 at {vs * 1e3:.1f} mm, "
          f"{run_s:.3f} s, steady-state {steady} ms/frame; camera ATE rmse "
          f"{ate['ate_rmse'] * 1e3:.3f} mm ({ate['pairs']} pairs, limit "
          f"{vs * 1e3:.1f}); live objects {live}; mesh {len(verts)} "
          f"vertices, median distance to the scene {med * 1e3:.3f} mm "
          f"(limit {0.5 * vs * 1e3:.2f})", flush=True)
    check_launches("room4 cli", launches, PATH_KERNELS,
                   forbidden=LM_SPLIT_KERNELS)
    if not ate["ate_rmse"] < vs:
        raise RuntimeError(f"room4 cli: ATE {ate['ate_rmse']} m >= {vs} m")
    if not len(verts) or not med < 0.5 * vs:
        raise RuntimeError(f"room4 cli: the background mesh lies {med} m "
                           "(median) from the scene")


# ---------------------------------------------------------------------
# step 11: the distributed path
def hold_fusion_slab(torch, pipe, depth_raw):
    """K1's slab form: the background of ``pipe``'s fusion table cut into
    its two z-slabs (what the two ``z`` ranks of a mesh fuse), each slab
    one launch on a copy, held against the plain version of the slab and
    against the same planes of one whole-volume K1 launch (exact: a
    slab's voxel centres are formed from the global plane). Timed as the
    other rows (the slab's launch; the whole volume's beside it), its
    bound counted from the slab's voxel classes."""
    from emfusion_tpu_torch.ops import fusion

    depth, _ = pipe.preprocess(depth_raw)
    intr = pipe.intr
    bg = pipe.fusion_items()[0]
    Z = bg.tsdf.shape[0]
    h = Z // 2
    slabs = [dataclasses.replace(bg, tsdf=bg.tsdf[z0:z0 + h],
                                 weights=bg.weights[z0:z0 + h], z0=z0, Z=Z)
             for z0 in (0, h)]
    kit = copy_items(slabs, lambda v: v.clone())
    for it in kit:
        fusion.integrate_tsdf_batched([it], depth, intr)
    qit = copy_items(slabs, lambda v: v.clone())

    def plain(items):
        for it in items:
            fusion.integrate_tsdf_plain(
                it.tsdf, it.weights, depth, it.assoc, it.rot, it.trans,
                intr, it.voxel_size, it.truncdist, it.max_weight,
                it.carve_dist, it.carve_weight_cap, it.carve_margin,
                it.z0, it.Z)

    plain(qit)
    whole = copy_items([bg], lambda v: v.clone())[0]
    fusion.integrate_tsdf_batched([whole], depth, intr)
    err_plain = max(max(max_err(k.tsdf, q.tsdf), max_err(k.weights,
                                                          q.weights))
                    for k, q in zip(kit, qit))
    err_whole = max(max(max_err(k.tsdf, whole.tsdf[k.z0:k.z0 + h]),
                        max_err(k.weights, whole.weights[k.z0:k.z0 + h]))
                    for k in kit)
    b, b_all, counts, shares = fusion_traffic(
        torch, [slabs[0]], [(qit[0].tsdf, qit[0].weights)], depth, intr)
    wb = fusion_traffic(torch, [bg], [(whole.tsdf, whole.weights)], depth,
                        intr)[0]
    row = dict(
        max_abs_err=max(err_plain, err_whole), tol=0.0,
        err_vs_plain=err_plain, err_vs_whole=err_whole, items=1,
        shapes=[list(kit[0].tsdf.shape)], voxels=counts, shares=shares,
        bound_all=b_all,
        ms=graph_ms(torch, lambda: fusion.integrate_tsdf_batched(
            [kit[0]], depth, intr), 10),
        whole_ms=graph_ms(torch, lambda: fusion.integrate_tsdf_batched(
            [whole], depth, intr), 10),
        whole_bound=wb,
        plain_ms=time_ms(torch, lambda: plain(qit[:1]), 2, warmup=1),
        bound=b, library_ms=None)
    print(f"fusion_slab: slab of planes 0..{h - 1} of {Z}: "
          f"{row['ms']:.4f} ms against the whole volume's "
          f"{row['whole_ms']:.4f} ms (bounds {b[0]:.5f} / {wb[0]:.5f} ms); "
          f"max abs err against the plain slab {err_plain:.1e}, against "
          f"the whole-volume launch's planes {err_whole:.1e}", flush=True)
    del kit, qit, whole
    torch.cuda.empty_cache()
    return row


def save_stress_state(torch, pipe, path):
    """``pipe``'s state (a filled pool, :func:`fill_pool`) as tensors for
    the ranks of step 11: the one-card ``PipelineState`` they shard."""
    from emfusion_tpu_torch.pipeline import ObjectPool

    s, o = pipe.state, pipe.state.objs
    torch.save(dict(
        bg={k: getattr(s, k).cpu() for k in (
            "bg_tsdf", "bg_weights", "bg_pose", "bg_assoc", "cam_pose")},
        objs={f.name: getattr(o, f.name).cpu()
              for f in dataclasses.fields(ObjectPool)},
        frame=pipe.frame, next_id=int(o.object_id.max()) + 1), path)


def load_stress_state(torch, path, device):
    from emfusion_tpu_torch.pipeline import ObjectMeta, state_from_numpy

    st = torch.load(path, weights_only=True)
    arrays = {k: v.numpy() for k, v in st["bg"].items()}
    arrays["objs"] = {k: v.numpy() for k, v in st["objs"].items()}
    ids = [int(i) for i in st["objs"]["object_id"][st["objs"]["active"]]]
    return (state_from_numpy(arrays, device), st["frame"],
            {i: ObjectMeta() for i in ids}, st["next_id"])


def bits_differ(torch, a, b):
    """Elements of ``a`` and ``b`` whose bits differ (NaN-safe)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b).to(a.device)
    if a.shape != b.shape:
        return -1
    if a.dtype == torch.bool:
        return int((a != b).sum())
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return int((a.contiguous().view(bits) != b.contiguous().view(bits)).sum())


def frame_diffs(torch, pipe, pool, ref):
    """Per part of the frame, the elements whose bits differ between the
    sharded rank 0 (``pool``: its gathered pool) and the one-card
    ``ref``, and the largest object-pose difference."""
    s, r = pipe.state, ref.state
    rc, rr = pipe.last_raycast, ref.last_raycast
    act = r.objs.active.numpy()
    out = {"estep_bg": bits_differ(torch, s.bg_assoc, r.bg_assoc),
           "estep_obj": bits_differ(torch, s.objs.assoc, r.objs.assoc),
           "camera_pose": bits_differ(torch, s.cam_pose, r.cam_pose),
           "bg_tsdf": bits_differ(torch, s.bg_tsdf, r.bg_tsdf),
           "bg_weights": bits_differ(torch, s.bg_weights, r.bg_weights),
           "obj_volumes": sum(bits_differ(torch, getattr(pool, k),
                                          getattr(r.objs, k))
                              for k in ("tsdf", "weights", "fg_counts")),
           "host_mirrors": sum(bits_differ(torch, getattr(s.objs, k),
                                           getattr(r.objs, k))
                               for k in ("active", "visible", "object_id",
                                         "voxel_size"))}
    out["composite"] = sum(bits_differ(torch, rc[k], rr[k]) for k in (
        "seg", "vertices", "normals", "mask", "obj_masks", "vis_counts"))
    d = (s.objs.pose - r.objs.pose)[torch.from_numpy(act)].abs()
    out["obj_pose_max_abs"] = float(d.max()) if d.numel() else 0.0
    out["obj_pose_bits"] = bits_differ(torch, s.objs.pose, r.objs.pose)
    return out


def dist_stress(torch, mesh, spec):
    """Step 11's stress scene on one rank: the 16-slot state sharded over
    the mesh, ``spec["stress_frames"]`` frames, each followed by the
    frame's meshes (the z-sharded background mesh and the objects'),
    exported by rank 0. Rank 0 also runs the one-card pipeline from the
    same state on the same frames, interleaved, and compares each frame
    (:func:`frame_diffs`, and the sharded mesh against ``extract_mesh``
    of its read copy). Per frame: its ms (rank 0, synchronised) and the
    one-card pipeline's, the collectives of the frame, the kernel
    launches."""
    from emfusion_tpu_torch import kernels
    from emfusion_tpu_torch.distributed.comm import all_gather_into
    from emfusion_tpu_torch.distributed.mesh import gather_pool
    from emfusion_tpu_torch.io.writers import write_frame_meshes
    from emfusion_tpu_torch.ops.marching_cubes import extract_mesh_sparse
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    params, dev = spec["params"], mesh.device
    state, frame, meta, next_id = load_stress_state(torch, spec["state"],
                                                    dev)
    pipe = EMFusionPipeline(params, mesh=mesh)
    pipe.load_state(state, frame, meta=meta, next_id=next_id)
    del state
    ref = None
    if mesh.rank == 0:
        state, frame, meta, next_id = load_stress_state(
            torch, spec["state"], dev)
        ref = EMFusionPipeline(params, device=dev)
        ref.load_state(state, frame, meta=meta, next_id=next_id)
        del state
    slab_shape = (pipe._z1 - pipe._z0,) + tuple(pipe.state.bg_tsdf.shape[1:])
    frames_out = []
    for depth in spec["stress_frames"]:
        live = len(pipe.active_object_ids)
        kernels.reset_launches()
        mesh.stats.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.process_frame(None, depth)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        comm_f = mesh.stats.summary()
        launches = dict(kernels.launches)
        slab_launches = kernels.launches_by_shape.get(("fusion",
                                                       slab_shape), 0)
        t0 = time.perf_counter()
        meshes = write_frame_meshes(pipe, spec["mesh_dir"], pipe.frame)
        export_ms = 1e3 * (time.perf_counter() - t0)
        pool = gather_pool(pipe)
        rec = dict(ms=ms, live=live, comm=comm_f, launches=launches,
                   slab_launches=slab_launches, export_ms=export_ms)
        if ref is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref.process_frame(None, depth)
            torch.cuda.synchronize()
            rec["one_card_ms"] = 1e3 * (time.perf_counter() - t0)
            rec["diffs"] = frame_diffs(torch, pipe, pool, ref)
            bg_mesh = meshes[0]
            full = extract_mesh_sparse(pipe.state.bg_tsdf,
                                       pipe.state.bg_weights > 0,
                                       pipe.voxel)
            rec["mesh"] = dict(
                verts=len(bg_mesh[0]), tris=len(bg_mesh[2]),
                verts_whole=len(full[0]), tris_whole=len(full[2]),
                same_vertex_set=bool(np.array_equal(
                    vertex_set(bg_mesh[0]), vertex_set(full[0]))),
                valid_indices=bool(len(bg_mesh[2]) == 0 or int(
                    bg_mesh[2].max()) < len(bg_mesh[0])),
                objects=len(meshes[1]))
            print(f"  stress frame {pipe.frame - 1}: {ms:.1f} ms, {live} "
                  f"live slots, export {export_ms:.0f} ms, diffs "
                  f"{rec['diffs']}, mesh {rec['mesh']}", flush=True)
        del pool
        frames_out.append(rec)
    out = dict(frames=frames_out, ids=pipe.active_object_ids,
               cam=pipe.cam_pose.copy())
    del ref
    # the read copy's refresh alone: the z all-gather of the pair
    s, (z0, z1) = pipe.state, (pipe._z0, pipe._z1)
    for rep in range(3):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for vol in (s.bg_tsdf, s.bg_weights):
            all_gather_into(mesh.z, vol, vol[z0:z1])
        b.record()
        torch.cuda.synchronize()
        recv = sum(v.numel() * v.element_size() for v in (
            s.bg_tsdf, s.bg_weights)) * (mesh.shape[1] - 1) // mesh.shape[1]
        out.setdefault("refresh_ms", []).append(a.elapsed_time(b))
    out["refresh_bytes"] = recv
    return out, pipe


def vertex_set(v):
    """A mesh's vertices rounded to 1e-5 m, sorted: its vertex set."""
    r = np.ascontiguousarray(np.round(np.asarray(v, np.float32), 5))
    return np.sort(r.view([("x", "f4"), ("y", "f4"), ("z", "f4")]), axis=0)


def dist_lm(torch, mesh, pipe, depth_raw):
    """The pixel-sharded ``track_volume`` on every rank: the camera's
    stride-1 points of a frame cut into contiguous blocks, one a rank, the
    LM's (A, b, err), weight maximum and trial errors all-reduced over
    the ranks, started from the camera pose moved by a small twist; rank
    0 also runs the one-rank LM on all points, and again on the points in
    reverse order and in two seeded shuffles: the same data summed in
    other orders, whose poses differ from the first by the float32 LM's
    own reproducibility (near
    its minimum the objective's changes fall below the rounding of a sum
    of 307,200 terms, so where it stops depends on the order of the sum;
    the ranks' partial sums are another order). Returns the pose, the
    iterations and the all-reduces (calls, bytes, ms) of the call, and on
    rank 0 the largest pose differences to the one-rank LM and between
    the one-rank LMs (its spread)."""
    from emfusion_tpu_torch import kernels
    from emfusion_tpu_torch.geometry.se3 import (
        pose_inverse, reorthonormalize, se3_exp,
    )
    from emfusion_tpu_torch.tracking import track_volume

    s = pipe.state
    _, points = pipe.preprocess(depth_raw)
    pts = points.reshape(3, -1)
    n, g = pts.shape[1], mesh.world
    lo, hi = g.rank * n // g.size, (g.rank + 1) * n // g.size
    asc = torch.ones(n, dtype=torch.float32, device=pts.device)
    start = reorthonormalize(pose_inverse(s.bg_pose) @ s.cam_pose @ se3_exp(
        torch.tensor([0.004, -0.003, 0.002, 0.003, -0.002, 0.004])))
    mesh.stats.reset()
    before = dict(kernels.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pose, st = track_volume(s.bg_tsdf, s.bg_weights, pipe.voxel,
                            pts[:, lo:hi].contiguous(), asc[lo:hi], start,
                            pipe.track_cfg, group=g)
    torch.cuda.synchronize()
    out = dict(ms=1e3 * (time.perf_counter() - t0),
               iterations=st["iterations"], pose=pose.numpy(),
               comm=mesh.stats.summary(), points=n,
               launches={k: kernels.launches[k] - before[k]
                         for k in LM_KERNELS})
    if mesh.rank == 0:
        one, st1 = track_volume(s.bg_tsdf, s.bg_weights, pipe.voxel, pts,
                                asc, start, pipe.track_cfg)
        gen = torch.Generator().manual_seed(0)
        orders = [torch.arange(n - 1, -1, -1)] + [
            torch.randperm(n, generator=gen) for _ in range(2)]
        spread, iters = 0.0, []
        for order in orders:
            other, st2 = track_volume(
                s.bg_tsdf, s.bg_weights, pipe.voxel,
                pts[:, order.to(pts.device)].contiguous(), asc, start,
                pipe.track_cfg)
            spread = max(spread, float((one - other).abs().max()))
            iters.append(st2["iterations"])
        out.update(one_rank_iterations=st1["iterations"],
                   reordered_iterations=iters,
                   max_abs_diff=float((one - pose).abs().max()),
                   one_rank_spread=spread)
    return out


def dist_lifecycle(torch, mesh, spec):
    """The object path's first frames and masks (spawn, then match) on
    the mesh, from an empty state: every rank's camera and object poses
    and live ids per frame, and on rank 0 the object path's checks
    (recovery, ATE) and the largest pose differences to the one-card
    run's (``spec["ref"]``)."""
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    frames, masks = spec["life_frames"], spec["life_masks"]
    pipe = EMFusionPipeline(spec["params"], mask_provider(masks), mesh=mesh)
    ids, ms = [], []
    for i, depth in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.process_frame(None, depth, timestamp=float(i))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        ids.append(pipe.active_object_ids)
    ref_cam, ref_obj = spec["ref"]
    cam = max(float(np.abs(pipe.poses[f] - ref_cam[f]).max())
              for f in ref_cam)
    obj = float("inf")              # another set of objects than one card's
    if sorted(pipe.obj_poses) == sorted(ref_obj):
        obj = max([float(np.abs(t[f] - ref_obj[oid][f]).max())
                   for oid, t in pipe.obj_poses.items() for f in t] + [0.0])
    out = dict(ids=ids, ms=ms, cam_max_abs=cam, obj_max_abs=obj,
               poses=dict(pipe.poses),
               obj_poses={o: dict(t) for o, t in pipe.obj_poses.items()},
               slots={o: pipe._slot_of(o) for o in pipe.active_object_ids})
    if mesh.rank == 0:
        out.update(recovery=motion_recovery(pipe),
                   ate=camera_ate(pipe, len(frames)))
    return out


def dist_rank(mesh, spec):
    """One rank of step 11: the stress scene, the read copy's refresh,
    the pixel-sharded LM and the lifecycle run, and the rank's peak
    device memory."""
    import torch

    torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    stress, pipe = dist_stress(torch, mesh, spec)
    lm = dist_lm(torch, mesh, pipe, spec["stress_frames"][-1])
    del pipe
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    life = dist_lifecycle(torch, mesh, spec)
    return dict(rank=mesh.rank, coords=mesh.coords, stress=stress, lm=lm,
                life=life, peak=torch.cuda.max_memory_allocated(mesh.device),
                stress_s=t1 - t0, life_s=time.perf_counter() - t1)


def dist_transport(torch):
    """(backend, printed line): NCCL, a rank a card, when the machine has
    at least ``DIST_RANKS`` cards; with one card, gloo by name, the ranks
    sharing it, every collective staged through host memory."""
    n = torch.cuda.device_count()
    if n >= 2:
        if n < DIST_RANKS:
            raise RuntimeError(f"{n} cards: the distributed step takes "
                               f"{DIST_RANKS} (NCCL) or 1 (gloo)")
        return "nccl", (f"transport: nccl, {DIST_RANKS} ranks on "
                        f"{DIST_RANKS} cards")
    return "gloo", (f"transport: gloo staged through host, {DIST_RANKS} "
                    "ranks on 1 card")


def distributed_step(torch, params, stress, life, report):
    """Step 11: the port's distributed path. ``stress``: (the file
    :func:`save_stress_state` wrote from a pipeline whose pool
    :func:`fill_pool` filled, that pipeline's frame, the pool's spheres:
    the stress frames render them, still, so that the slots track real
    surfaces); ``life``:
    (frames, masks, camera poses, object poses) of the object path's
    first ``LIFE_FRAMES`` frames on one card. Runs :func:`dist_rank` on
    ``DIST_RANKS`` ranks (:func:`dist_transport`), prints the frames'
    ms, collectives and checks, and fails if a rank fails, a part of a
    stress frame differs from the one-card run (bits; object poses 1e-4),
    a sharded mesh differs from the whole volume's, the pixel-sharded LM
    is more than 1e-4 from the one-rank LM or the ranks disagree, or the
    lifecycle run loses an object, recovers outside 0.35-2.0, reaches 1
    voxel of ATE or is off the one-card poses (camera 1e-5, objects
    1e-4), or if the pixel-sharded LM launched ``lm_run`` or never
    launched a split LM kernel. Returns the ``fusion_slab`` row's
    launches (rank 0's slab launches over the stress frames) and rank
    0's LM kernel launches in the pixel-sharded LM."""
    from emfusion_tpu_torch.distributed.mesh import launch, mesh_shape

    path, f0, spheres = stress
    rng = np.random.default_rng(f0)
    scene = make_scene(params.height, params.width, params.fx)
    stress_frames = [sensor_depth(scene.render(gt_pose(f0 + i), spheres)[0],
                                  rng) for i in range(DIST_FRAMES)]
    backend, line = dist_transport(torch)
    print(line, flush=True)
    frames, masks, ref_cam, ref_obj = life
    spec = dict(params=params, state=path, stress_frames=stress_frames,
                mesh_dir=os.path.join(DIST_WORK, "frame_meshes"),
                life_frames=frames, life_masks=masks,
                ref=(ref_cam, ref_obj))
    res = launch("chip_smoke:dist_rank", DIST_RANKS, args=(spec,),
                 device="cuda", backend=backend, timeout_s=DIST_TIMEOUT_S,
                 rank0_output=True)
    r0 = res[0]
    st = r0["stress"]
    per_frame = [f["ms"] for f in st["frames"]]
    kinds = sorted({k for f in st["frames"] for k in f["comm"]})
    comm_pf = {k: dict(
        calls=float(np.mean([f["comm"].get(k, {}).get("calls", 0)
                             for f in st["frames"]])),
        mb=float(np.mean([f["comm"].get(k, {}).get("bytes", 0)
                          for f in st["frames"]])) / 2**20,
        ms=float(np.mean([f["comm"].get(k, {}).get("ms", 0.0)
                          for f in st["frames"]]))) for k in kinds}
    refresh = float(np.median(st["refresh_ms"]))
    gbps = st["refresh_bytes"] / refresh / 1e6
    lm = r0["lm"]
    ar = lm["comm"].get("all_reduce", dict(calls=0, bytes=0, ms=0.0))
    life_r = r0["life"]
    report["distributed"] = dict(
        backend=backend, ranks=DIST_RANKS, mesh=list(mesh_shape(DIST_RANKS)),
        stress_frame_ms=per_frame,
        stress_one_card_ms=[f["one_card_ms"] for f in st["frames"]],
        stress_live_slots=[f["live"] for f in st["frames"]],
        stress_export_ms=[f["export_ms"] for f in st["frames"]],
        stress_diffs=[f["diffs"] for f in st["frames"]],
        stress_meshes=[f["mesh"] for f in st["frames"]],
        stress_launches=[f["launches"] for f in st["frames"]],
        comm_per_frame=comm_pf, refresh_ms=st["refresh_ms"],
        refresh_bytes=st["refresh_bytes"], refresh_gb_per_s=gbps,
        lm=dict(iterations=lm["iterations"], ms=lm["ms"], points=lm["points"],
                launches=lm["launches"],
                one_rank_iterations=lm["one_rank_iterations"],
                reordered_iterations=lm["reordered_iterations"],
                max_abs_diff=lm["max_abs_diff"],
                one_rank_spread=lm["one_rank_spread"], all_reduce=ar),
        peak_bytes=[r["peak"] for r in res],
        life=dict(frames=len(frames), ms=life_r["ms"],
                  ids=life_r["ids"][-1], slots=life_r["slots"],
                  recovery=life_r["recovery"], ate=life_r["ate"],
                  cam_max_abs=[r["life"]["cam_max_abs"] for r in res],
                  obj_max_abs=[r["life"]["obj_max_abs"] for r in res]),
        stress_s=r0["stress_s"], life_s=r0["life_s"])
    print(f"distributed stress scene: {DIST_FRAMES} frames "
          f"{params.width}x{params.height} into "
          f"{params.globalVolumeDims[0]}^3, {params.max_objects} slots of "
          f"{params.objVolumeDims[0]}^3 (live {report['distributed']['stress_live_slots']}) "
          f"over a {mesh_shape(DIST_RANKS)} mesh: ms a frame (rank 0) "
          + ", ".join(f"{m:.1f}" for m in per_frame)
          + "; the one-card pipeline on rank 0's card " + ", ".join(
              f"{f['one_card_ms']:.1f}" for f in st["frames"])
          + "; mesh export ms " + ", ".join(
              f"{f['export_ms']:.0f}" for f in st["frames"]), flush=True)
    print("distributed collectives a frame (rank 0): " + "; ".join(
        f"{k} {v['calls']:.1f} calls, {v['mb']:.2f} MB, {v['ms']:.2f} ms"
        for k, v in comm_pf.items()), flush=True)
    print(f"distributed read-copy refresh (z all-gather of the pair): "
          f"{refresh:.3f} ms, {st['refresh_bytes'] / 2**20:.0f} MiB "
          f"received a rank, {gbps:.2f} GB/s", flush=True)
    print(f"distributed pixel-sharded LM over {lm['points']} points: "
          f"{lm['iterations']} iterations (one rank: "
          f"{lm['one_rank_iterations']}), {lm['ms']:.1f} ms, "
          f"{ar['calls']} all-reduces "
          f"({ar['calls'] / max(lm['iterations'], 1):.2f} an iteration, "
          f"{1e3 * ar['ms'] / max(ar['calls'], 1):.1f} us each), pose max "
          f"abs diff to the one-rank LM {lm['max_abs_diff']:.2e}; the "
          f"one-rank LM on the points reordered (reversed, two shuffles): "
          f"{lm['reordered_iterations']} iterations, up to "
          f"{lm['one_rank_spread']:.2e} from the first; within 1e-5 of the "
          f"one-rank LM: {lm['max_abs_diff'] <= 1e-5}; rank 0's LM "
          f"launches {lm['launches']}", flush=True)
    print("distributed peak memory per rank GiB: " + ", ".join(
        f"{r['peak'] / 2**30:.3f}" for r in res), flush=True)
    print(f"distributed lifecycle: {len(frames)} frames, live objects "
          f"{life_r['ids'][-1]} in slots {life_r['slots']}, ms a frame "
          f"{np.mean(life_r['ms'][1:]):.1f}, camera ATE "
          f"{life_r['ate']['rmse'] * 1e3:.3f} mm, recovery " + ", ".join(
              f"{o} {r['recovery']:.3f}"
              for o, r in life_r["recovery"].items())
          + f"; pose max abs diff to one card: camera "
          f"{max(report['distributed']['life']['cam_max_abs']):.2e}, "
          f"objects {max(report['distributed']['life']['obj_max_abs']):.2e}",
          flush=True)
    bad = [(i, k, v) for i, f in enumerate(st["frames"])
           for k, v in f["diffs"].items()
           if (v > 1e-4 if k == "obj_pose_max_abs"
               else k != "obj_pose_bits" and v != 0)]
    if bad:
        raise RuntimeError(f"distributed stress scene differs from one "
                           f"card: {bad}")
    for i, f in enumerate(st["frames"]):
        m = f["mesh"]
        if not (m["same_vertex_set"] and m["tris"] == m["tris_whole"]
                and m["valid_indices"] and m["verts"] > 0):
            raise RuntimeError(f"distributed mesh of frame {i}: {m}")
    if any(not np.array_equal(r["lm"]["pose"], lm["pose"]) for r in res):
        raise RuntimeError("pixel-sharded LM: the ranks' poses differ")
    # the ranks' partial sums are another order of the one-rank sum: the
    # pose is held to 1e-4 (a wrong reduction moves it by the start's
    # twist, ~4e-3); whether it is also within 1e-5 is reported beside
    # the one-rank LM's own spread under reordered sums
    if lm["launches"][LM_RUN] or not all(
            lm["launches"][k] > 0 for k in LM_SPLIT_KERNELS):
        raise RuntimeError(f"pixel-sharded LM: launches {lm['launches']}, "
                           "expected the split kernels alone")
    if not lm["max_abs_diff"] <= LM_POSE_TOL:
        raise RuntimeError(f"pixel-sharded LM: {lm['max_abs_diff']} from "
                           f"the one-rank LM (limit {LM_POSE_TOL})")
    for r in res[1:]:
        if r["life"]["ids"] != life_r["ids"] or any(
                not np.array_equal(r["life"]["poses"][f],
                                   life_r["poses"][f])
                for f in life_r["poses"]):
            raise RuntimeError(f"rank {r['rank']}'s lifecycle differs from "
                               "rank 0's")
    rec = life_r["recovery"]
    if len(rec) != len(MOVERS) or sorted(
            r["mover"] for r in rec.values()) != list(range(len(MOVERS))):
        raise RuntimeError(f"distributed lifecycle: object lost: {rec}")
    if any(not 0.35 < r["recovery"] < 2.0 for r in rec.values()):
        raise RuntimeError(f"distributed lifecycle: motion not recovered "
                           f"{rec}")
    if not life_r["ate"]["rmse"] < VOXEL_CUT:
        raise RuntimeError(f"distributed lifecycle: ATE "
                           f"{life_r['ate']['rmse']}")
    if max(report["distributed"]["life"]["cam_max_abs"]) > 1e-5 or max(
            report["distributed"]["life"]["obj_max_abs"]) > 1e-4:
        raise RuntimeError("distributed lifecycle: poses off the one-card "
                           "run's")
    if not all(f["slab_launches"] >= 1 for f in st["frames"]):
        raise RuntimeError("distributed stress scene: K1 never ran on a "
                           "slab in a frame")
    return sum(f["slab_launches"] for f in st["frames"]), lm["launches"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the depth noise")
    ap.add_argument("--only", choices=["distributed"],
                    help="run step 11 alone (with the object path's first "
                         f"{LIFE_FRAMES} frames on one card as its "
                         "reference)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from emfusion_tpu_torch import kernels
    from emfusion_tpu_torch.config import load_config
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    card = card_line()
    report = {"card": card}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    t0 = time.perf_counter()
    laps = report["step_s"] = {}
    last = [t0]

    def lap(name):
        """Seconds since the previous step ended, printed and kept."""
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now
        print(f"step {name}: {laps[name]:.1f} s", flush=True)

    build_s = kernels.build()
    print(f"kernels built in {build_s:.1f} s", flush=True)
    report["ptxas"] = ptxas_lines(kernels.build_log)
    for line in report["ptxas"]:
        print(f"  {line}", flush=True)
    report["build_s"] = build_s

    params = load_config(os.path.join(HERE, "configs", "default.cfg"))
    scene = make_scene(params.height, params.width, params.fx)
    rng = np.random.default_rng(args.seed)
    report["seed"] = args.seed
    shutil.rmtree(DIST_WORK, ignore_errors=True)
    os.makedirs(DIST_WORK)
    stress_path = os.path.join(DIST_WORK, "stress_state.pt")
    try:
        if args.only == "distributed":
            return only_distributed(torch, args, params, scene, rng, report,
                                    stress_path, lap, card)
        return whole_run(torch, args, params, scene, rng, report,
                         stress_path, lap, card)
    finally:
        shutil.rmtree(DIST_WORK, ignore_errors=True)


def second_card_run(torch, params, frames, masks, dev):
    """The object path's first frames on ``dev`` (a spawn at frame 0,
    then the objects tracked), then the serial object LMs' table of the
    next frame run alone (``tracking.run_lm_items``, one ``lm_run``).
    Returns the poses, every state tensor on the host and the LMs'
    results."""
    from emfusion_tpu_torch import tracking
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    pipe = EMFusionPipeline(params, mask_provider(masks), device=dev)
    for depth in frames[:-1]:
        pipe.process_frame(None, depth)
    s, o = pipe.state, pipe.state.objs
    live = [int(k) for k in np.nonzero(pipe._h_active)[0]]
    _, points = pipe.preprocess(frames[-1])
    lms = tracking.run_lm_items(pipe.object_lm_items(points, live),
                                pipe.track_cfg)
    tensors = [s.bg_tsdf, s.bg_weights, s.bg_assoc, s.cam_pose, o.tsdf,
               o.weights, o.fg_counts, o.assoc, o.pose]
    return dict(live=live, poses=dict(pipe.poses),
                obj_poses={i: dict(t) for i, t in pipe.obj_poses.items()},
                tensors=[t.cpu() for t in tensors],
                lms=[{k: (v.cpu() if torch.is_tensor(v) else v)
                      for k, v in r.items()} for r in lms])


def second_card(torch, params, frames, masks, report):
    """Every launch on its tensors' card: the object path's first
    ``SECOND_CARD_FRAMES`` frames and a table of its object LMs on
    ``cuda:1`` while ``cuda:0`` stays the current card, against the
    same on ``cuda:0``, bit for bit (poses, volumes, association images,
    the LMs' poses, iterations and weights). Fails on any difference or
    if a kernel of the path did not launch on ``cuda:1``; with one card,
    says that it skipped."""
    from emfusion_tpu_torch import kernels

    if torch.cuda.device_count() < 2:
        report["second_card"] = "skipped: one card"
        print("second card: skipped (one card)", flush=True)
        return
    torch.cuda.set_device(0)
    frames = frames[:SECOND_CARD_FRAMES + 1]
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    one = second_card_run(torch, params, frames, masks,
                          torch.device("cuda", 1))
    secs = time.perf_counter() - t0
    ran = {k: kernels.launches[k] - before[k] for k in kernels.launches}
    if torch.cuda.current_device() != 0:
        raise RuntimeError("second card: the run changed the current card")
    zero = second_card_run(torch, params, frames, masks,
                           torch.device("cuda", 0))
    diffs = [bits_differ(torch, a, b)
             for a, b in zip(one["tensors"], zero["tensors"])]
    poses = sum(int(not np.array_equal(q, zero["poses"][f]))
                for f, q in one["poses"].items())
    obj = sum(int(not np.array_equal(q, zero["obj_poses"][i][f]))
              for i, t in one["obj_poses"].items() for f, q in t.items())
    lms = sum(int(not (torch.equal(v, b[k]) if torch.is_tensor(v)
                       else v == b[k]))
              for a, b in zip(one["lms"], zero["lms"]) for k, v in a.items())
    report["second_card"] = dict(
        frames=SECOND_CARD_FRAMES, live=one["live"], seconds=secs,
        launches_on_cuda1=ran, tensor_bits_differ=diffs,
        camera_poses_differ=poses, object_poses_differ=obj,
        lm_fields_differ=lms,
        lm_iterations=[r["iterations"] for r in one["lms"]])
    print(f"second card: {SECOND_CARD_FRAMES} object-path frames and "
          f"{len(one['lms'])} object LMs on cuda:1 (current card 0), "
          f"{secs:.3f} s; launches there " + ", ".join(
              f"{k} {v}" for k, v in ran.items() if v) +
          f"; against cuda:0: tensor elements differing {diffs}, camera "
          f"poses {poses}, object poses {obj}, LM fields {lms}",
          flush=True)
    missing = [k for k in ("fusion", "sample", "raycast", "bilateral",
                           "lm_run") if not ran[k]]
    if missing or not one["live"] or one["live"] != zero["live"] or any(
            diffs) or poses or obj or lms or len(one["poses"]) != len(
                zero["poses"]):
        raise RuntimeError(f"second card: cuda:1 differs from cuda:0 or a "
                           f"kernel did not run there (missing {missing})")


def life_reference(pipe, frames, masks):
    """Step 11's lifecycle reference from a one-card object path run:
    its first ``LIFE_FRAMES`` frames, their masks, camera poses and
    object poses."""
    n = LIFE_FRAMES
    return (frames[:n], {f: m for f, m in masks.items() if f < n},
            {f: q for f, q in pipe.poses.items() if f < n},
            {o: {f: q for f, q in t.items() if f < n}
             for o, t in pipe.obj_poses.items()})


def table_row(name, src, replaces, r, launches):
    row = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches,
           "max_abs_err": r["max_abs_err"], "tol": r["tol"],
           "ms": r["ms"], "plain_ms": r["plain_ms"],
           "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
           "library_ms": r["library_ms"]}
    if "bound_all" in r:
        row["bound_all_ms"] = r["bound_all"][0]
    if "floor_ms" in r:
        row["floor_ms"] = r["floor_ms"]
    return row


def finish(torch, report, rows, table, card, t0):
    """Writes the report; fails if a kernel disagrees with its plain
    version; prints the card, the kernels line and the last line."""
    bad = [n for n, r in rows.items() if not r["max_abs_err"] <= r["tol"]]
    report["kernel_rows"] = rows
    report["kernels"] = table
    report["seconds"] = time.perf_counter() - t0
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")
    print(card, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def only_distributed(torch, args, params, scene, rng, report, stress_path,
                     lap, card):
    """``--only distributed``: the object path's first ``LIFE_FRAMES``
    frames on one card (the lifecycle's reference), K1's slab form held
    on that state, its pool filled (the stress state), then step 11."""
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    t0 = time.perf_counter()
    frames, masks = object_scene(scene, params, LIFE_FRAMES, rng)
    pipe = EMFusionPipeline(params, mask_provider(masks))
    for i, depth in enumerate(frames):
        pipe.process_frame(None, depth, timestamp=float(i))
    life = life_reference(pipe, frames, masks)
    f0 = pipe.frame
    depth = sensor_depth(scene.render(gt_pose(f0), movers_at(f0))[0], rng)
    rows = {"fusion_slab": hold_fusion_slab(torch, pipe, depth)}
    print_row("fusion_slab", rows["fusion_slab"])
    spheres = fill_pool(torch, pipe)
    save_stress_state(torch, pipe, stress_path)
    del pipe
    torch.cuda.empty_cache()
    lap("reference (one card)")
    second_card(torch, params, frames, masks, report)
    lap("second card")
    slab_launches, _ = distributed_step(torch, params,
                                        (stress_path, f0, spheres), life,
                                        report)
    lap("distributed")
    backend, _ = dist_transport(torch)
    sharded_viewer(torch, params, scene, np.random.default_rng(args.seed + 2),
                   report, "sharded_viewer_full",
                   os.path.join(HERE, "configs", "default.cfg"), DIST_RANKS,
                   backend, "torchrun" if backend == "nccl" else "launch")
    lap("sharded viewer (full width)")
    table = [table_row(*SLAB_ROWS[0][:3], rows["fusion_slab"],
                       slab_launches)]
    return finish(torch, report, rows, table, card, t0)


def whole_run(torch, args, params, scene, rng, report, stress_path, lap,
              card):
    """Steps 1-14."""
    from emfusion_tpu_torch.config import Params
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    t0 = time.perf_counter()

    # a fused volume for the kernel phases: three frames of the scene
    warm = EMFusionPipeline(params)
    for i in range(3):
        warm.process_frame(None, sensor_depth(scene.render(gt_pose(i)),
                                              rng))
    rows = kernel_phases(torch, warm,
                         sensor_depth(scene.render(gt_pose(3)), rng), report)
    del warm
    torch.cuda.empty_cache()
    for name, r in rows.items():
        print_row(name, r)
    lap("kernels")

    frames = [sensor_depth(scene.render(gt_pose(i)), rng)
              for i in range(N_FRAMES)]
    launches, pipe = main_path(torch, params, frames, report)
    profile_frames(torch, pipe, [
        sensor_depth(scene.render(gt_pose(N_FRAMES + i)), rng)
        for i in range(PROFILE_FRAMES)], report, "profile")
    # its own noise, so the later steps draw what they drew before
    lm_chunk_sweep(torch, pipe, sensor_depth(scene.render(
        gt_pose(N_FRAMES + PROFILE_FRAMES)),
        np.random.default_rng(args.seed + 1)), report)
    del pipe
    torch.cuda.empty_cache()
    # the same frames with the capture sampler, the exact paths' LM before
    # the gather sampler came (and the JAX package's on its chips)
    cap_launches, pipe = main_path(torch, params, frames, report,
                                   sampler="capture",
                                   key="main_path_capture")
    del pipe
    torch.cuda.empty_cache()
    g, c = report["main_path"], report["main_path_capture"]
    print("camera LM, gather against capture on the same frames: "
          f"iterations a call {g['camera_lm_iterations_mean']:.2f} / "
          f"{c['camera_lm_iterations_mean']:.2f}, ms an iteration "
          f"{g['camera_lm_ms_per_iteration']:.4f} / "
          f"{c['camera_lm_ms_per_iteration']:.4f}, track_camera ms "
          f"{g['phase_ms_per_call']['track_camera']:.3f} / "
          f"{c['phase_ms_per_call']['track_camera']:.3f}, ATE mm "
          f"{g['ate']['rmse'] * 1e3:.4f} / {c['ate']['rmse'] * 1e3:.4f}",
          flush=True)
    # the same frames with the gather LM in the per-iteration host loop
    _, pipe = main_path(torch, params, frames, report, loop="host",
                        key="main_path_host")
    del pipe
    torch.cuda.empty_cache()
    h = report["main_path_host"]
    gap = max(float(np.abs(np.array(q) - np.array(h["poses"][f])).max())
              for f, q in g["poses"].items())
    report["device_lm_vs_host_loop_pose_gap"] = gap
    print("camera LM, device loop against host loop on the same frames: "
          f"iterations a call {g['camera_lm_iterations_mean']:.2f} / "
          f"{h['camera_lm_iterations_mean']:.2f}, ms an iteration "
          f"{g['camera_lm_ms_per_iteration']:.4f} / "
          f"{h['camera_lm_ms_per_iteration']:.4f}, track_camera ms "
          f"{g['phase_ms_per_call']['track_camera']:.3f} / "
          f"{h['phase_ms_per_call']['track_camera']:.3f}, device reads a "
          f"call {g['camera_lm_host_reads_mean']:.2f} / "
          f"{h['camera_lm_host_reads_mean']:.2f}, e2e ms "
          f"{g['e2e_ms_per_frame']:.3f} / {h['e2e_ms_per_frame']:.3f}, "
          f"largest camera pose gap {gap:.3e}, ATE mm "
          f"{g['ate']['rmse'] * 1e3:.4f} / {h['ate']['rmse'] * 1e3:.4f}",
          flush=True)
    # the same frames with the device LM as the split kernels
    _, pipe = main_path(torch, params, frames, report, loop="split",
                        key="main_path_split")
    del pipe
    torch.cuda.empty_cache()
    sp = report["main_path_split"]
    gap = max(float(np.abs(np.array(q) - np.array(sp["poses"][f])).max())
              for f, q in g["poses"].items())
    report["lm_run_vs_split_pose_gap"] = gap
    print("camera LM, lm_run against the split kernels on the same frames: "
          f"iterations a call {g['camera_lm_iterations_mean']:.2f} / "
          f"{sp['camera_lm_iterations_mean']:.2f}, ms an iteration "
          f"{g['camera_lm_ms_per_iteration']:.4f} / "
          f"{sp['camera_lm_ms_per_iteration']:.4f}, track_camera ms "
          f"{g['phase_ms_per_call']['track_camera']:.3f} / "
          f"{sp['phase_ms_per_call']['track_camera']:.3f}, device reads a "
          f"call {g['camera_lm_host_reads_mean']:.2f} / "
          f"{sp['camera_lm_host_reads_mean']:.2f}, e2e ms "
          f"{g['e2e_ms_per_frame']:.3f} / {sp['e2e_ms_per_frame']:.3f}, "
          f"largest camera pose gap {gap:.3e}", flush=True)
    if not gap <= 1e-5:
        raise RuntimeError(f"lm_run ends {gap} from the split kernels")
    lap("main_path")

    obj_launches, pipe, obj_frames, obj_masks = object_path(
        torch, params, scene, OBJ_FRAMES, rng, report)
    life = life_reference(pipe, obj_frames, obj_masks)
    del obj_frames
    lap("object_path (frames)")
    more = [sensor_depth(scene.render(gt_pose(i), movers_at(i))[0], rng)
            for i in range(OBJ_FRAMES, OBJ_FRAMES + PROFILE_FRAMES + 1)]
    obj_rows = object_kernel_phases(torch, pipe, more[0])
    obj_rows["fusion_slab"] = hold_fusion_slab(torch, pipe, more[0])
    lap("object_path (holds)")
    profile_frames(torch, pipe, more[1:], report, "object_profile")
    lap("object_path (profile)")
    pool_rows, spheres = pool_kernel_phases(torch, pipe, more[0])
    obj_rows.update(pool_rows)
    save_stress_state(torch, pipe, stress_path)
    stress = (stress_path, pipe.frame, spheres)
    del pipe
    torch.cuda.empty_cache()
    for name, r in obj_rows.items():
        print_row(name, r)
    rows.update(obj_rows)
    lap("object_path (pool holds)")

    acc_params = dataclasses.replace(params, **ACCEL)
    acc_frames, acc_masks = object_scene(scene, acc_params, ACCEL_FRAMES,
                                         rng)
    more = [sensor_depth(scene.render(gt_pose(i), movers_at(i))[0], rng)
            for i in range(ACCEL_FRAMES, ACCEL_FRAMES + PROFILE_FRAMES + 1)]
    acc_launches, pipe = accel_path(torch, params, acc_frames, acc_masks,
                                    report)
    acc_rows = accel_kernel_phases(torch, pipe, more[0])
    profile_frames(torch, pipe, more[1:], report, "accel_profile")
    acc_rows.update(accel_pool_phase(torch, pipe, more[0]))
    del pipe
    torch.cuda.empty_cache()
    for name, r in acc_rows.items():
        print_row(name, r)
    rows.update(acc_rows)
    hold_lm_escape(torch, report)
    capture_vs_host_loop(torch, params, acc_frames, acc_masks, report,
                         "accel_path_vs_host_loop")
    lap("accel_path")

    # step 8b: the same frames and masks with bf16 background volumes
    bf_launches, pipe = accel_path(torch, params, acc_frames, acc_masks,
                                   report, key="accel_path_bf16",
                                   volume_dtype="bfloat16")
    compare_accel(report)
    bf_rows = bf16_kernel_phases(torch, pipe, more[0])
    del pipe
    torch.cuda.empty_cache()
    for name, r in bf_rows.items():
        print_row(name, r)
    rows.update(bf_rows)
    capture_vs_host_loop(torch, params, acc_frames, acc_masks, report,
                         "accel_path_bf16_vs_host_loop",
                         volume_dtype="bfloat16")
    lap("accel_path_bf16")

    config = os.path.join(HERE, "configs", "default.cfg")

    def viewers(pipe, seq, masks_dir):
        lap("cli_path")
        return viewer_step(torch, pipe, seq, masks_dir, config, report)

    cli_launches, (orbit_row, orbit_launches) = cli_path(
        torch, params, scene, rng, report, config, then=viewers)
    print_row("raycast_orbit", orbit_row)
    rows["raycast_orbit"] = orbit_row
    lap("viewer")
    small = Params(frameSize=(160, 120), fx=130.0, fy=130.0, cx=79.5,
                   cy=59.5, **SMALL_OBJECTS)
    sharded_viewer(torch, small, make_scene(120, 160, 130.0),
                   np.random.default_rng(args.seed + 2), report,
                   "sharded_viewer", SERVE_SMALL_CONFIG, SERVE_RANKS,
                   "gloo", "launch")
    lap("sharded viewer")
    small_reference(torch, np.random.default_rng(args.seed), report)
    lap("small_reference")
    slab_launches, group_lm = distributed_step(torch, params, stress, life,
                                               report)
    lap("distributed")
    # steps 12-14, each with noise of its own
    respawn_path(torch, params, scene, np.random.default_rng(args.seed + 3),
                 report)
    lap("respawn (full width)")
    respawn_small(torch, np.random.default_rng(args.seed + 4), report)
    lap("respawn (160x120, card vs CPU)")
    room4_cli(torch, np.random.default_rng(args.seed + 5), report)
    lap("room4 cli")

    row_launches = {name: (obj_launches if name in obj_rows
                           else launches)[kernel]
                    for name, _, _, kernel in (KERNEL_ROWS + OBJECT_ROWS
                                               + POOL_ROWS + LM_ROWS)}
    # K3 runs on the paths whose LMs capture: at the background's shape
    # the main path's capture run, at the objects' the accelerator path
    row_launches.update(capture=cap_launches["capture"],
                        capture_object=acc_launches["objects"],
                        capture_camera_accel=acc_launches["camera"],
                        capture_objects_accel=acc_launches["objects"],
                        capture_pool_accel=acc_launches["objects"],
                        lm_run_cache=acc_launches["lm_objects"],
                        lm_run_cache_pool=acc_launches["lm_objects"],
                        # no path's objects keep bf16 volumes
                        lm_run_cache_bf16=0,
                        lm_run_capture=acc_launches["lm_camera"],
                        lm_run_capture_bf16=bf_launches["lm_camera"],
                        fusion_bf16=bf_launches["all"]["fusion"],
                        sample_bf16=bf_launches["all"]["sample"],
                        capture_camera_bf16=bf_launches["camera"],
                        raycast_bf16=bf_launches["background"]["raycast"],
                        raycast_orbit=orbit_launches,
                        fusion_slab=slab_launches)
    # the split LM kernels run the pixel-sharded LM alone (step 11)
    row_launches.update({k: group_lm[k] for k in LM_SPLIT_KERNELS})
    report["cli_path_launches"] = cli_launches
    table = [table_row(name, src, replaces, rows[name], row_launches[name])
             for name, src, replaces, kernel in (
                 KERNEL_ROWS + OBJECT_ROWS + POOL_ROWS + ACCEL_ROWS
                 + BF16_ROWS + VIEW_ROWS + SLAB_ROWS + LM_ROWS
                 + LM_CACHE_ROWS + LM_CAPTURE_ROWS)]
    return finish(torch, report, rows, table, card, t0)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-rank"]:
        sys.path.insert(0, HERE)
        sys.exit(serve_rank_main(sys.argv[2:]))
    sys.exit(main())
