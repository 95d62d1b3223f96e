"""Share (%) of the traced span's wall time in which no kernel, copy or set ran
on the card (the union of their intervals)."""


def read(w):
    if w.span is None or w.span.wall_s <= 0:
        return None
    from benchmark.trace import busy_seconds
    return 100.0 * (1.0 - busy_seconds(w.span.events) / w.span.wall_s)
