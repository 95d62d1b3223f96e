"""Native tier: codecs, the multi-worker frame decoder and the async
export writer (the counterpart of ``emfusion_tpu/native/``)."""

from emfusion_tpu_torch.native.runtime import (  # noqa: F401
    AsyncWriter, NativePrefetcher, available, decode_frame, read_exr,
    read_png_gray16, read_png_rgb, write_exr, write_png_gray16,
    write_png_rgb,
)
