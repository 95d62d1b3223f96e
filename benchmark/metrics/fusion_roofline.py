"""K1's share (%) of its roofline: the least time its work needs for each
checked frame's launch (``roofline.fusion_work``: the bytes and float32
operations of that launch's data, over the published peaks) over the
launch's device time in the trace, summed over the launches."""


def read(w):
    least = sum(s for s, _ in w.k1)
    spent = sum(d for _, d in w.k1)
    return 100.0 * least / spent if spent > 0 else None
