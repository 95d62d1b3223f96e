"""The object LMs (``track_objects``), ms a call; nothing where no object
was tracked."""

from benchmark.metrics import _phases as _pc


def read(w):
    return _pc.per_call(w, ("track_objects",))
