"""Command-line driver — the ``main.py`` the reference gitignored.

The reference's driver script (which constructed ``lk_params``,
``feature_params``, ``flann_params`` and called ``process``) was deliberately
excluded from the repo (``.gitignore:131-132``, SURVEY.md §0.5). This CLI
replaces it: ``meatmodeler VIDEO -o OUT_PREFIX`` runs the full pipeline and
prints the volume estimate and per-stage metrics.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="meatmodeler",
        description="GPU SfM: turntable video -> point cloud + volume",
    )
    parser.add_argument("video", nargs="*", help="video file(s): container, .npy frame stack, or .y4m; several videos reconstruct as a batch")
    parser.add_argument("-o", "--output", default="out", help="output prefix (writes <prefix>Cloud.ply; batches append _0, _1, ...)")
    parser.add_argument("--schedule", choices=("mesh", "pipelined", "sequential"), default="mesh", help="multi-video schedule: per-core BA solves over the device mesh, two-stage cross-device pipeline, or one at a time")
    parser.add_argument("--pattern", type=int, nargs=2, default=None, metavar=("W", "H"), help="chessboard inner corners")
    parser.add_argument("--side-length", type=float, default=None, help="board square size (world units)")
    parser.add_argument("--max-features", type=int, default=None, help="ORB feature budget per keyframe")
    parser.add_argument("--max-tracks", type=int, default=None, help="track-store capacity")
    parser.add_argument("--max-keyframes", type=int, default=None, help="keyframe capacity")
    parser.add_argument("--keyframe-threshold", type=float, default=None, help="keyframe accumulation threshold (reference default 0.1; smaller = denser)")
    parser.add_argument("--incremental", action="store_true", help="online BA after every keyframe (the reference's intended design)")
    parser.add_argument("--detector", choices=("auto", "device", "host"), default=None, help="chessboard detector: on-device saddle+grid-fit, host cv2, or auto (device with host fallback)")
    parser.add_argument("--pass1-backend", choices=("device", "host"), default=None, help="keyframe-selection backend: the device lax.scan program, or the native C++ host scan (only keyframes are copied to the device)")
    parser.add_argument("--pass1-downscale", type=int, default=None, help="pass-1 working-resolution divisor (0 = auto)")
    parser.add_argument("--pass2-downscale", type=int, default=None, help="keyframe (pass-2) resolution divisor; image-plane outputs land in the downscaled pixel units (0 = auto)")
    parser.add_argument("--checkpoint-dir", default=None, help="persist per-stage artifacts; re-runs resume")
    parser.add_argument("--json", action="store_true", help="print metrics as JSON")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument(
        "--warmup",
        type=int,
        nargs=2,
        default=None,
        metavar=("W", "H"),
        help="compile-prime the pipeline's device programs for WxH video and "
        "exit (populates the persistent XLA compilation cache so the next "
        "run of that resolution starts warm); pass the usual config flags "
        "to prime a non-default configuration. VIDEO args are ignored.",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING, format="%(message)s")

    import dataclasses

    from meatmodeler_tpu.config import DEFAULT_CONFIG
    from meatmodeler_tpu.pipeline import process

    config = DEFAULT_CONFIG
    if args.pattern is not None:
        config = dataclasses.replace(
            config, chessboard=dataclasses.replace(config.chessboard, pattern=tuple(args.pattern))
        )
    if args.side_length is not None:
        config = dataclasses.replace(
            config, chessboard=dataclasses.replace(config.chessboard, side_length=args.side_length)
        )
    if args.max_features is not None:
        config = dataclasses.replace(
            config, orb=dataclasses.replace(config.orb, num_features=args.max_features)
        )
    if args.keyframe_threshold is not None:
        config = dataclasses.replace(
            config, keyframe=dataclasses.replace(config.keyframe, threshold=args.keyframe_threshold)
        )
    if args.max_tracks is not None or args.max_keyframes is not None:
        tr = config.tracks
        if args.max_tracks is not None:
            tr = dataclasses.replace(tr, max_tracks=args.max_tracks)
        if args.max_keyframes is not None:
            tr = dataclasses.replace(tr, max_keyframes=args.max_keyframes)
        config = dataclasses.replace(config, tracks=tr)
    if args.incremental:
        config = dataclasses.replace(config, incremental_ba=True)
        if len(args.video) > 1 and args.schedule != "sequential":
            print(
                "note: --incremental requires the sequential schedule for "
                "multi-video input; switching to --schedule sequential",
                file=sys.stderr,
            )
            args.schedule = "sequential"
    if args.detector:
        config = dataclasses.replace(
            config, chessboard=dataclasses.replace(config.chessboard, detector=args.detector)
        )
    if args.pass1_backend is not None:
        config = dataclasses.replace(config, pass1_backend=args.pass1_backend)
    if args.pass1_downscale is not None:
        config = dataclasses.replace(config, pass1_downscale=args.pass1_downscale)
    if args.pass2_downscale is not None:
        config = dataclasses.replace(config, pass2_downscale=args.pass2_downscale)

    if args.warmup is not None:
        return _warmup(tuple(args.warmup), config)
    if not args.video:
        parser.error("video is required (or pass --warmup W H)")

    if len(args.video) == 1:
        results = [
            process(
                args.video[0], path=args.output, config=config,
                checkpoint_dir=args.checkpoint_dir,
            )
        ]
    else:
        paths = [f"{args.output}_{i}" for i in range(len(args.video))]
        if args.checkpoint_dir and args.schedule != "sequential":
            print(
                "note: --checkpoint-dir requires the sequential schedule for "
                "multi-video input; switching to --schedule sequential",
                file=sys.stderr,
            )
            args.schedule = "sequential"
        if args.schedule == "pipelined":
            from meatmodeler_tpu.parallel.pipelined import process_batch_pipelined

            results = process_batch_pipelined(args.video, config=config, paths=paths)
        elif args.schedule == "mesh":
            import jax

            from meatmodeler_tpu.parallel import sharded
            from meatmodeler_tpu.parallel.batch import process_batch

            # Size the data axis to the batch: a full-device mesh would pad
            # the batch up to the device count with redundant solves.
            data = min(len(jax.devices()), len(args.video))
            mesh = sharded.make_mesh(data=data, model=1) if data > 1 else None
            results = process_batch(args.video, config=config, mesh=mesh, paths=paths)
        else:
            results = [
                process(
                    v, path=p, config=config,
                    checkpoint_dir=f"{args.checkpoint_dir}_{i}" if args.checkpoint_dir else None,
                )
                for i, (v, p) in enumerate(zip(args.video, paths))
            ]
    if args.json:
        payloads = [
            {
                "video": v,
                "points": int(len(r.points)),
                "keyframes": int(len(r.extrinsics)),
                "volume": r.volume,
                "volume_carved": r.volume_carved,
                "reprojection_rmse": r.reprojection_rmse,
                "ply": r.ply_path,
                **r.metrics,
            }
            for v, r in zip(args.video, results)
        ]
        print(json.dumps(payloads[0] if len(payloads) == 1 else payloads))
    else:
        for v, result in zip(args.video, results):
            if len(results) > 1:
                print(f"--- {v}")
            print(f"keyframes:          {len(result.extrinsics)}")
            print(f"points:             {len(result.points)}")
            print(f"reprojection RMSE:  {result.reprojection_rmse:.3f} px")
            print(f"volume (hull):      {result.volume:.3f}")
            print(f"volume (carved):    {result.volume_carved:.3f}")
            if result.ply_path:
                print(f"cloud written to:   {result.ply_path}")
    return 0


def _warmup(size, config) -> int:
    """Compile-prime the pipeline for WxH input (``meatmodeler --warmup``).

    Renders a short synthetic turntable clip at the requested resolution and
    runs the full pipeline on it with the EXACT config the user will run
    (jit programs key on the config), populating the persistent XLA
    compilation cache. Subsequent runs
    of same-resolution video start warm.
    """
    import time

    import numpy as np

    from meatmodeler_tpu.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu.pipeline import process

    w, h = size
    t0 = time.time()
    scene = TurntableScene(
        image_size=(w, h), focal=0.78 * max(w, h), noise_sigma=1.0,
        pattern=config.chessboard.pattern,
        side_length=config.chessboard.side_length,
    )
    n_frames = 3 * config.frame_chunk
    frames, _, corners = render_sequence(scene, n_frames, seed=0, backend="jax")
    print(f"warmup: rendered {n_frames} frames at {w}x{h} "
          f"({time.time() - t0:.1f}s); compiling pipeline...", file=sys.stderr)
    try:
        process(np.asarray(frames), config=config, known_corners=corners)
    except ValueError as e:
        # Too few keyframes on the tiny clip still compiled pass 1 + pass 2's
        # big programs — which is the point of the warmup.
        print(f"warmup: partial ({e})", file=sys.stderr)
    print(f"warmup: done in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
