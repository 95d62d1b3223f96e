"""The camera LM (``track_camera``), ms a call."""

from benchmark.metrics import _phases as _pc


def read(w):
    return _pc.per_call(w, ("track_camera",))
