"""The traffic generator: closed loops, clear movers, every mover in view."""

import math

import numpy as np
import pytest

from benchmark import harness, traffic

MIXES = ["static", "movers3"]
SEEDS = [0, 2147483659, 9000000000000000011]


def _mix(name):
    return traffic.Mix.load(f"{harness.HERE}/traffic/{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_camera_loop_closes(name):
    mix = _mix(name)
    P = mix.period
    np.testing.assert_allclose(traffic.camera_pose(mix, P),
                               traffic.camera_pose(mix, 0), atol=1e-12)
    np.testing.assert_allclose(traffic.camera_pose(mix, 0), np.eye(4),
                               atol=1e-12)
    steps = [np.linalg.norm(traffic.camera_pose(mix, i + 1)[:3, 3]
                            - traffic.camera_pose(mix, i)[:3, 3])
             for i in range(P)]
    assert max(steps) <= 0.006          # 6 mm a frame at most


@pytest.mark.parametrize("seed", SEEDS)
def test_movers_close_and_clear(seed):
    mix = _mix("movers3")
    ph = traffic.mover_phases(mix, seed)
    for (a, r), (b, s) in zip(traffic.mover_centres(mix, ph, 0),
                              traffic.mover_centres(mix, ph, mix.period)):
        np.testing.assert_allclose(a, b, atol=1e-12)
        assert r == s
    assert traffic.clearance(mix, ph) > 0.03
    speed = max(np.linalg.norm(a[0] - b[0]) for i in range(mix.period)
                for a, b in zip(traffic.mover_centres(mix, ph, i + 1),
                                traffic.mover_centres(mix, ph, i)))
    assert speed <= 0.005


def test_phases_from_seed():
    mix = _mix("movers3")
    assert np.array_equal(traffic.mover_phases(mix, 5),
                          traffic.mover_phases(mix, 5))
    assert not np.array_equal(traffic.mover_phases(mix, 5),
                              traffic.mover_phases(mix, 6))


@pytest.mark.parametrize("config", ["default", "room4_accel"])
def test_movers_in_view(config):
    """Each mover's mask holds more than the lifecycle's thresholds inside
    the boundary, at every 8th frame of the loop, through the config's own
    camera (two seeds)."""
    import json
    import torch
    mix = _mix("movers3")
    with open(f"{harness.HERE}/configs/{config}.json") as f:
        p = json.load(f)["params"]
    W, H = p["frameSize"]
    ren = traffic.Renderer(mix, W, H, p["fx"], p["fy"], p["cx"], p["cy"],
                           "cpu")
    b = p["boundary"]
    least = math.inf
    for seed in SEEDS[:2]:
        ph = traffic.mover_phases(mix, seed)
        for i in range(0, mix.period, 8):
            _, masks = ren.render(traffic.camera_pose(mix, i),
                                  traffic.mover_centres(mix, ph, i))
            for m in masks:
                least = min(least, int(m[b:H - b, b:W - b].sum()))
    assert least > 2 * max(p["visibilityThresh"], 50 * 50 / 2)
    del torch


def test_noise_from_seed():
    import torch
    mix = _mix("static")
    ren = traffic.Renderer(mix, 64, 48, 50.0, 50.0, 31.5, 23.5, "cpu")
    d, _ = ren.render(traffic.camera_pose(mix, 3))

    def noisy(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return traffic.sensor_noise(mix, d, g)
    assert torch.equal(noisy(1), noisy(1))
    assert not torch.equal(noisy(1), noisy(2))
    assert noisy(1).dtype == torch.float32
