"""Helpers of the phase readers: a phase's ms over its calls or the
window's frames, from ``PhaseTimer`` totals."""


def per_call(w, names):
    calls = sum(w.phases.get(n, (0.0, 0))[1] for n in names[:1])
    if not calls:
        return None
    return sum(w.phases.get(n, (0.0, 0))[0] for n in names) / calls


def per_frame(w, names):
    if not w.phase_frames or not any(n in w.phases for n in names):
        return None
    return sum(w.phases.get(n, (0.0, 0))[0] for n in names) / w.phase_frames
