"""Frames completed in the window over the window's wall time (host clock)."""


def read(w):
    return w.frames / w.wall_s if w.wall_s > 0 else None
