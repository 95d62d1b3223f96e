"""Device time of the LM kernels and K3 (``emf_lm_run_kernel``,
``emf_lm_cluster_kernel``, ``emf_capture_kernel``) in the traced span, ms
a frame."""


def read(w):
    if w.span is None or not w.span_frames:
        return None
    from benchmark.harness import LM_KERNELS
    from benchmark.trace import kernel_seconds
    return 1e3 * kernel_seconds(w.span.events, LM_KERNELS) / w.span_frames
