"""EM-Fusion CLI of the PyTorch port.

    python -m emfusion_tpu_torch.apps.run_emfusion -t TUMDIR -e OUT \\
        [-m MASKDIR] [-c CONFIG] [--device cuda|cpu]

The flags of ``emfusion_tpu/apps/run_emfusion.py`` (the reference app's,
``apps/EM-Fusion.cpp:217-256``):

  --tumdir/-t      TUM RGB-D sequence directory (with associations.txt)
  --dir/-d         Co-Fusion style directory (Color%04d.png/Depth%04d.exr)
  --colordir / --depthdir   subdirectory names for -d
  --exportdir/-e   write results (poses, meshes, renderings)
  --export-volume  also dump raw TSDF volumes
  --config/-c      INI config file (reference config format)
  --maskdir/-m     replay preprocessed masks (Mask%04d.plk)
  --background     headless (no GUI display; always the case here)
  --show-slam      reserved (3D visualization not implemented)
  --frames, --frame-meshes, --checkpoint, --checkpoint-every, --resume
  --serve PORT     live HTTP viewer (``viz_server.LiveViewer``) on PORT
                   (0, the default: none), at --serve-host (loopback);
                   each frame's rendering is published to it
  --turntable N    after the run, N orbit views of the final model as
                   turntable/view%03d.png under --exportdir

with ``--device`` (``cuda``, the default, or ``cpu``) for the JAX
package's ``--platform``, and ``--profile DIR`` writing a
``torch.profiler`` trace. Without a card, ``--device cuda`` raises.
Without ``--serve`` no frame renders for the viewer.

``--nprocs N`` (default 1) runs the (obj, z) sharded pipeline
(``distributed/``) on N ranks of this host: one card each under NCCL
(cards 0..N-1), or N processes under gloo with ``--device cpu``. Under
``torchrun`` (its ``WORLD_SIZE``/``RANK``/``MASTER_*`` variables) each
process joins that group instead. Every rank reads the same sequence;
rank 0 prints, writes the export tree and the checkpoints, and the tree
is the one-card run's. (The JAX app builds its mesh whenever more than
one device is visible; the port asks for the number of ranks.) Rank 0
serves ``--serve``; after each frame every rank runs the viewer's
service step (``viz_server.serve_step``), in which the orbit views and
meshes that rank 0's handlers asked for are computed by all ranks
together, and after the last frame one more before the viewer closes.
``--turntable`` renders each view on every rank, and rank 0 writes it.

The reader decodes ahead on 4 worker threads (``native.
NativePrefetcher``). ``--frame-meshes`` meshes on the frame loop and
writes the files on one writer thread (``native.AsyncWriter``), held
for the run: the CLI waits for it before ``write_results`` and at exit,
and raises if a write failed.

The frame size comes from the data; where it differs from the config's,
the intrinsics are scaled with it (``config.fit_frame_size``) before a
``calibration.txt`` beside the data overrides them. The per-phase report
on stderr is timed with CUDA events (``PhaseTimer(mode="events")``), so
timing does not serialise the run.
"""

from __future__ import annotations

import argparse
import logging
import os
import statistics
import sys
import time


def build_parser():
    ap = argparse.ArgumentParser("emfusion-tpu-torch")
    ap.add_argument("--tumdir", "-t", help="TUM RGB-D directory")
    ap.add_argument("--dir", "-d", dest="dir_", help="Co-Fusion directory")
    ap.add_argument("--colordir", default="colour")
    ap.add_argument("--depthdir", default="depth_noise")
    ap.add_argument("--exportdir", "-e", help="export results here")
    ap.add_argument("--export-volume", action="store_true")
    ap.add_argument("--config", "-c", help="INI config file")
    ap.add_argument("--maskdir", "-m", help="preprocessed mask dir")
    ap.add_argument("--background", action="store_true",
                    help="run headless (no display)")
    ap.add_argument("--show-slam", action="store_true")
    ap.add_argument("--turntable", type=int, default=0, metavar="N",
                    help="render N orbit views of the final model into "
                         "EXPORTDIR/turntable/")
    ap.add_argument("--frame-meshes", type=int, default=0, metavar="N",
                    help="export per-frame meshes every N frames "
                         "(frame_meshes/ tree)")
    ap.add_argument("--frames", type=int, default=None,
                    help="process at most N frames")
    ap.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="live HTTP viewer on this port (0: none)")
    ap.add_argument("--serve-host", default="127.0.0.1",
                    help="viewer address (default loopback only)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="compute device (default cuda; raises without "
                         "a card)")
    ap.add_argument("--profile", help="torch.profiler trace directory")
    ap.add_argument("--checkpoint", help="checkpoint file (.npz)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="write --checkpoint every N frames")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists")
    ap.add_argument("--nprocs", type=int, default=1,
                    help="ranks of the sharded pipeline (NCCL, a card "
                         "each; gloo with --device cpu)")
    return ap


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    if not args.tumdir and not args.dir_:
        print("error: need --tumdir or --dir", file=sys.stderr)
        return 2
    world = int(os.environ.get("WORLD_SIZE", 1))
    backend = "gloo" if args.device == "cpu" else "nccl"
    if world > 1:                     # under torchrun: join its group
        from emfusion_tpu_torch.distributed.mesh import (
            initialize_multihost, make_mesh,
        )
        initialize_multihost(backend=backend)
        return _run(args, make_mesh(device=args.device, backend=backend))
    if args.nprocs > 1:
        from emfusion_tpu_torch.distributed.mesh import launch
        launch("emfusion_tpu_torch.apps.run_emfusion:_rank_main", args.nprocs,
               args=(list(sys.argv[1:] if argv is None else argv),),
               device=args.device, backend=backend, timeout_s=None,
               rank0_output=True)
        return 0
    return _run(args)


def _rank_main(mesh, argv) -> int:
    """One rank of ``--nprocs``."""
    logging.basicConfig(level=logging.INFO if mesh.rank == 0
                        else logging.WARNING,
                        format="%(name)s: %(message)s")
    return _run(build_parser().parse_args(argv), mesh)


def _run(args, mesh=None) -> int:
    """The run, on one card or as one rank of ``mesh``."""
    say = print if mesh is None or mesh.rank == 0 else (
        lambda *a, **k: None)

    from emfusion_tpu_torch.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from emfusion_tpu_torch.config import (
        Params, fit_frame_size, load_calibration, load_config,
    )
    from emfusion_tpu_torch.device import resolve_device
    from emfusion_tpu_torch.io.readers import CoFusionReader, TUMReader
    from emfusion_tpu_torch.io.writers import write_frame_meshes, \
        write_results
    from emfusion_tpu_torch.native import AsyncWriter
    from emfusion_tpu_torch.pipeline import EMFusionPipeline
    from emfusion_tpu_torch.profiling import PhaseTimer
    from emfusion_tpu_torch.segmentation import ReplayMaskProvider

    device = mesh.device if mesh is not None else resolve_device(args.device)
    params = Params()
    if args.config:
        params = load_config(args.config, params)
    if args.tumdir:
        reader = TUMReader(args.tumdir)
        calib = os.path.join(args.tumdir, "calibration.txt")
    else:
        reader = CoFusionReader(args.dir_, args.colordir, args.depthdir)
        calib = os.path.join(args.dir_, "calibration.txt")
    reader.init()
    probe = reader.peek()
    if probe is not None:
        dh, dw = probe.depth.shape[:2]
        if (dw, dh) != tuple(params.frameSize):
            say(f"frameSize {tuple(params.frameSize)} -> dataset "
                  f"({dw}, {dh}), intrinsics scaled with it")
            params = fit_frame_size(params, dw, dh)
    if os.path.exists(calib):
        params = load_calibration(calib, params)

    provider = ReplayMaskProvider(args.maskdir) if args.maskdir else None
    pipe = EMFusionPipeline(params, provider, device=device,
                            save_output=bool(args.exportdir), mesh=mesh)
    pipe.timer = PhaseTimer(device, mode="events")

    skip_until = 0
    if args.checkpoint and args.resume and os.path.exists(args.checkpoint):
        load_checkpoint(pipe, args.checkpoint)
        skip_until = pipe.frame
        say(f"resumed from {args.checkpoint} at frame {skip_until}")

    viewer = None
    if args.serve:
        from emfusion_tpu_torch import viz_server
        if pipe.is_writer:
            viewer = viz_server.LiveViewer(pipe, port=args.serve,
                                           host=args.serve_host)
            print(f"live viewer: http://{args.serve_host}:{viewer.port}/",
                  flush=True)

    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()

    writer = AsyncWriter() if args.exportdir and args.frame_meshes else None
    t_start = time.time()
    n = 0
    frame_times = []
    stop = False

    def do_frame(frame, nxt):
        """Process ``frame``; then start the upload of the next frame's
        depth (the one-frame lookahead), then the exports."""
        nonlocal n, stop
        t_f = time.time()
        pipe.process_frame(frame.rgb, frame.depth, timestamp=frame.timestamp)
        if nxt is not None:
            pipe.prefetch_depth(nxt.depth)
        frame_times.append(time.time() - t_f)
        if viewer is not None:
            viewer.publish()
        if args.serve:
            viz_server.serve_step(pipe, viewer)
        if args.exportdir:
            if pipe.is_writer:
                pipe.outputs["renderings"][n] = pipe.render()
            if args.frame_meshes and pipe.frame % args.frame_meshes == 0:
                write_frame_meshes(
                    pipe, os.path.join(args.exportdir, "frame_meshes"),
                    pipe.frame, writer=writer)
        n += 1
        if (args.checkpoint and args.checkpoint_every
                and pipe.frame % args.checkpoint_every == 0):
            save_checkpoint(pipe, args.checkpoint)
        if n % 10 == 0:
            fps = n / (time.time() - t_start)
            say(f"frame {n}/{reader.num_frames}  {fps:.2f} fps  "
                  f"objects={pipe.active_object_ids}", flush=True)
        if args.frames and n >= args.frames:
            stop = True

    ended = False
    try:
        pending = None
        for nxt in reader.frames():
            if nxt.index < skip_until:
                continue
            if pending is not None:
                do_frame(pending, nxt)
                if stop:
                    pending = None
                    break
            pending = nxt
        if pending is not None and not stop:
            do_frame(pending, None)
        ended = True
    finally:
        reader.close()
        failed = writer.close() if writer is not None else 0
        if args.serve:
            viz_server.serve_close(pipe, viewer, final_step=ended)
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                args.profile, "trace.json" if mesh is None
                else f"trace.rank{mesh.rank}.json"))

    if failed:
        raise RuntimeError(f"--frame-meshes: {failed} file writes failed "
                           f"({writer.last_error})")
    elapsed = time.time() - t_start
    say(f"processed {n} frames in {elapsed:.1f}s "
          f"({n / max(elapsed, 1e-9):.2f} fps)")
    if len(frame_times) >= 6:
        tail = frame_times[len(frame_times) // 2:]
        steady = statistics.median(tail)
        say(f"steady-state: {steady * 1e3:.3f} ms/frame "
              f"({1.0 / max(steady, 1e-9):.2f} fps, median of last "
              f"{len(tail)} frames)")
    say(pipe.timer.summary(), file=sys.stderr)

    if args.exportdir:
        write_results(pipe, args.exportdir,
                      export_volumes=args.export_volume)
        if args.turntable > 0:
            from emfusion_tpu_torch.viz import render_turntable, save_frames
            views = render_turntable(pipe, n_views=args.turntable)
            if pipe.is_writer:
                tt_dir = os.path.join(args.exportdir, "turntable")
                os.makedirs(tt_dir, exist_ok=True)
                save_frames(views, os.path.join(tt_dir, "view%03d.png"))
        say(f"results written to {args.exportdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
