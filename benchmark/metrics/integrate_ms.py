"""The fusion and the mask evidence (``integrate``, ``integrate_masks``; K1),
ms a frame."""

from benchmark.metrics import _phases as _pc


def read(w):
    return _pc.per_frame(w, ("integrate", "integrate_masks"))
