"""The ``preprocess`` phase (K5 and the point map), ms a frame."""

from benchmark.metrics import _phases as _pc


def read(w):
    return _pc.per_call(w, ("preprocess",))
