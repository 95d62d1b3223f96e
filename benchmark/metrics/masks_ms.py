"""The lifecycle on a mask frame (``masks``: match, spawn, resize; host),
ms a mask frame."""

from benchmark.metrics import _phases as _pc


def read(w):
    return _pc.per_call(w, ("masks",))
