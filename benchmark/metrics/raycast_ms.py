"""The raycast composite and the frame summary (``raycast``, ``summary``;
K4), ms a frame."""

from benchmark.metrics import _phases as _pc


def read(w):
    return _pc.per_frame(w, ("raycast", "summary"))
