"""The three E-steps (``estep_pre``, ``estep_mid``, ``estep_post``; K2), ms a
frame."""

from benchmark.metrics import _phases as _pc


def read(w):
    return _pc.per_frame(w, ("estep_pre", "estep_mid", "estep_post"))
