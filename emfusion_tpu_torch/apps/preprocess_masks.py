"""Offline mask preprocessing CLI — equivalent of the reference's
``preprocess_masks`` app (``apps/preprocess_masks.cpp:40-159``): runs the
detector every ``maskRCNNFrames`` frames and pickles reference-compatible
``Mask%04d.plk`` files for deterministic replay with ``-m``.

Usage:
  python -m emfusion_tpu_torch.apps.preprocess_masks -t TUMDIR -o MASKDIR \
      --model model.torchscript [--every 30] [--device cuda|cpu]

The detector runs on ``--device`` (``cuda``, the default, or ``cpu``);
without a card, ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser("emfusion-preprocess-masks")
    ap.add_argument("--tumdir", "-t", help="TUM RGB-D directory")
    ap.add_argument("--dir", "-d", dest="dir_", help="Co-Fusion directory")
    ap.add_argument("--colordir", default="colour")
    ap.add_argument("--depthdir", default="depth_noise")
    ap.add_argument("--out", "-o", required=True, help="mask output dir")
    ap.add_argument("--model", required=True,
                    help="TorchScript instance-segmentation model")
    ap.add_argument("--every", type=int, default=30,
                    help="detector cadence in frames (maskRCNNFrames)")
    ap.add_argument("--score-thresh", type=float, default=0.7)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="detector device (default cuda; raises without "
                         "a card)")
    args = ap.parse_args(argv)

    if not args.tumdir and not args.dir_:
        print("error: need --tumdir or --dir", file=sys.stderr)
        return 2

    from emfusion_tpu_torch.io.readers import TUMReader, CoFusionReader
    from emfusion_tpu_torch.segmentation import (TorchScriptMaskProvider,
                                                 save_detections)

    provider = TorchScriptMaskProvider(args.model,
                                       score_thresh=args.score_thresh,
                                       device=args.device)
    if args.tumdir:
        reader = TUMReader(args.tumdir)
    else:
        reader = CoFusionReader(args.dir_, args.colordir, args.depthdir)
    reader.init()
    os.makedirs(args.out, exist_ok=True)

    n = 0
    try:
        for frame in reader.frames():
            if frame.index % args.every == 0:
                dets = provider.detect(frame.rgb, frame.index) or []
                save_detections(
                    os.path.join(args.out, f"Mask{frame.index:04d}.plk"),
                    dets)
                n += 1
                print(f"frame {frame.index}: {len(dets)} detections",
                      flush=True)
    finally:
        reader.close()
    print(f"wrote {n} mask files to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
