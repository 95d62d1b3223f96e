"""The device LM's loop (``tracking.run_lm_items``: one ``lm_run`` of
``max_iter`` iterations a table, which stops once every LM has stopped;
on the CPU the plain versions) against the JAX package's
``track_volume`` with its default sampler (the gather sampler, no
override on either side), and a plain model of ``csrc/lm.cu``'s span
schedule and fixed-order tree of sums, which ``lm_run`` cannot show on
the CPU; the model reads its constants and its shuffle offsets from
``lm.cu``. The loop against the split loop at several chunks is
``test_torch_device_lm.py::test_chunks_and_a_stop_at_a_chunk_end``.

Tolerances: against JAX those of ``test_torch_device_lm.py``: poses
within 0.01 voxel, iterations within 3 (the JAX package sums in float32,
the port in float64). The model's float64 sums, rounded to float32,
equal the float64 ``torch.sum`` of the same float32 terms rounded to
float32 (what the plain versions compute): both are the float32
rounding of the exact sum unless it lies within a few float64 ulps of a
float32 tie, which random terms do not reach."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from emfusion_tpu.tracking import TrackConfig as JaxTrackConfig
from emfusion_tpu.tracking import track_volume as jax_track
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.tracking import LMItem, TrackConfig, run_lm_items
from test_torch_device_lm import assert_pose_close, sphere_case, torch_args
from test_torch_fusion import VOXEL as JUMP_VOXEL
from test_torch_gather_lm import camera_jump

torch.set_num_threads(2)

MAX_ITER = 50


def lm_source():
    with open(os.path.join(kernels.CSRC, "lm.cu")) as f:
        return f.read()


def lm_define(src, name):
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


# the model's schedule, from lm.cu: a span is EMF_LM_BLOCK threads of
# EMF_LM_PPT points each, a warp 32 lanes
SRC = lm_source()
BLOCK, PPT = lm_define(SRC, "EMF_LM_BLOCK"), lm_define(SRC, "EMF_LM_PPT")
SPAN, WARPS = BLOCK * PPT, BLOCK // 32
# every shuffle tree of lm.cu halves its offset from the same start
(SHUFFLE_START,) = {int(o) for o in re.findall(
    r"for \(int o = (\d+); o > 0; o >>= 1\)", SRC)}


@pytest.fixture(scope="module")
def cases():
    """The sphere of ``test_tracking.py`` and a 5-voxel camera jump of
    ``test_torch_gather_lm``."""
    t, w, p, a, i = camera_jump(5)
    return {"sphere": sphere_case(), "jump5": (t, w, JUMP_VOXEL, p, a, i)}


@pytest.mark.parametrize("name", ["sphere", "jump5"])
def test_chunked_loop_matches_jax_default(cases, name):
    """The loop (through ``run_lm_items``'s default: one ``lm_run``,
    one read) against the JAX package's ``track_volume`` with its default
    sampler: poses within 0.01 voxel, iterations within 3, the same
    converged flag, and the last evaluation's track weights within
    1e-3."""
    case = cases[name]
    t, w, vs, p, a, i = case
    ref, ref_st = jax_track(jnp.asarray(t), jnp.asarray(w), vs,
                            jnp.asarray(p), jnp.asarray(a), jnp.asarray(i),
                            JaxTrackConfig(max_iter=MAX_ITER))
    (res,) = run_lm_items([LMItem(*torch_args(case))],
                          TrackConfig(max_iter=MAX_ITER))
    assert res["host_reads"] == 1
    assert_pose_close(res["pose"].numpy(), ref, vs)
    assert abs(res["iterations"] - int(ref_st["iterations"])) <= 3
    assert res["converged"] == bool(ref_st["converged"])
    np.testing.assert_allclose(res["track_weights"].numpy(),
                               np.asarray(ref_st["track_weights"]),
                               rtol=0, atol=1e-3)


# ---------------------------------------------------------------------
# lm.cu's sums, modelled: a span's terms summed by its block in a fixed
# order, one row of partials a span, and an item's rows summed by the
# lead block's fixed-order tree; block b takes spans b, b + G, ...
def shuffle_tree(v):
    """``__shfl_down_sync`` by ``SHUFFLE_START`` (16), then half of it
    down to 1, over the last axis (32 lanes): lane 0's sum."""
    v = v.copy()
    o = SHUFFLE_START
    while o:
        v[..., :o] = v[..., :o] + v[..., o:2 * o]
        o >>= 1
    return v[..., 0]


def span_row(terms):
    """One span's float64 partial of its up to ``SPAN`` (1024) float32
    terms: thread t of ``BLOCK`` (256) adds points t, t + BLOCK, ... in
    order, then each warp's shuffle tree, then the warps in order."""
    x = np.zeros(SPAN, np.float64)
    x[:len(terms)] = terms
    x = x.reshape(PPT, BLOCK)
    acc = np.zeros(BLOCK, np.float64)
    for j in range(PPT):
        acc = acc + x[j]
    warps = shuffle_tree(acc.reshape(WARPS, 32))
    v = 0.0
    for q in range(WARPS):
        v = v + warps[q]
    return v


def tree_rows(rows):
    """The lead block's tree (``emf_lm_rows``): lane l adds rows l, l + 32,
    ... in order, then the shuffle tree."""
    m = -(-len(rows) // 32)
    x = np.zeros(32 * m, np.float64)
    x[:len(rows)] = rows
    x = x.reshape(m, 32)
    lanes = np.zeros(32, np.float64)
    for r in range(m):
        lanes = lanes + x[r]
    return shuffle_tree(lanes)


def kernel_sum(terms, grid):
    """An item's sum as ``emf_lm_run`` forms it on ``grid`` blocks."""
    spans = max(1, -(-len(terms) // SPAN))
    rows = np.full(spans, np.nan)
    for b in range(grid):
        for s in range(b, spans, grid):
            rows[s] = span_row(terms[s * SPAN:(s + 1) * SPAN])
    assert not np.isnan(rows).any()
    return tree_rows(rows)


@settings(max_examples=60, deadline=None)
@given(n=st.integers(0, 20000), grids=st.lists(st.integers(1, 400),
                                               min_size=2, max_size=3),
       seed=st.integers(0, 2 ** 31 - 1), spread=st.integers(0, 30))
def test_span_sums_round_to_plain_sum(n, grids, seed, spread):
    """Over point counts and grid sizes: float32 terms of mixed sign and
    magnitudes spread over 2^spread (products of weights, gradients and
    residuals), summed as the kernel sums them, round to the float32 of
    the float64 ``torch.sum`` of the same terms (the plain versions'),
    and the float64 sum itself does not depend on the grid."""
    rng = np.random.default_rng(seed)
    terms = (rng.standard_normal(n) * np.exp2(
        rng.uniform(-spread, 0, n))).astype(np.float32)
    sums = [kernel_sum(terms.astype(np.float64), g) for g in grids]
    assert all(s == sums[0] for s in sums)
    plain = torch.tensor(terms).double().sum().float()
    assert np.float32(sums[0]) == plain.item()
