"""The manifest keeps to its contract, and every cell finds its files."""

import json
import os
import re

import pytest

from benchmark import harness

with open(harness.MANIFEST) as f:
    MAN = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in MAN["paths"])
    assert 1 <= MAN["run_seconds"] <= 51
    assert os.path.getsize(harness.MANIFEST) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])


def test_unique_names():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert harness.reader(m["name"]) is not None
    if m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in m.get("workloads", []):
        assert w in {c["name"] for c in MAN["workloads"]}


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    c = harness.load_cell(cell["name"])
    assert cell["chips"] == 1
    assert _line(cell["why"])
    assert c.mix.period % c.config["params"]["maskRCNNFrames"] == 0
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.limits) <= set(("points", "assoc", "cam_pose", "obj_pose",
                                 "obj_unsettled", "raycast", "fused",
                                 "lifecycle"))
    assert ("obj_pose" in c.limits) == bool(c.mix.movers)
    assert ("obj_unsettled" in c.limits) == bool(c.mix.movers)


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = os.path.join(harness.ROOT, conf["file"])
    assert conf["file"].startswith(MAN["paths"][0] + "/")
    with open(path) as f:
        cfg = json.load(f)
    assert cfg["name"] == conf["name"]
    assert conf["reduced"] == []
    assert conf["source"].startswith("https://")
    harness.program_params(cfg)        # every key is one the port takes
    assert [c["file"] for c in MAN["configs"]].count(conf["file"]) == 1
