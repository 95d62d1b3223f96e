"""The card's peak allocated memory over warm-up and window (GiB),
``torch.cuda.max_memory_allocated``; nothing without a card."""


def read(w):
    return w.peak_bytes / 2 ** 30 if w.peak_bytes else None
