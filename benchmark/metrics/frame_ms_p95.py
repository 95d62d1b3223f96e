"""95th percentile of every window frame's latency (ms): host clock from the
frame's call to its completion, mask frames included."""


def read(w):
    from benchmark.harness import percentile
    return 1e3 * percentile(w.latencies_s, 95) if w.latencies_s else None


def read_untraced(w):
    """The same over the window's frames that ran outside the traced span
    (the per-layer form, read in the ``--trace 1`` run)."""
    a, b = w.traced
    return read(type(w)(latencies_s=w.latencies_s[:a] + w.latencies_s[b:]))
