"""Configuration tree for the pipeline.

The reference threads three loose param dicts (``lk_params``,
``feature_params``, ``flann_params``) through ``process``
(``processor.py:294-301``) and hard-codes everything else (chessboard shape
``(4, 3)`` at ``processor.py:315,369,422,433``; square side 2 at
``processor.py:434``; keyframe threshold 0.1 at ``:365``; ORB
``nfeatures=20000`` at ``:308``; Lowe ratio 0.75 at ``:113``; CLAHE clip 3.5 /
tiles (8, 8) at ``:22``; BA ``ftol=1e-4`` at ``bundleAdjuster.py:185,235``).
The driver that sets the dicts was gitignored, so the classic cv2 LK/GFTT
defaults are used here.

Here every knob lives in one frozen dataclass tree with the reference's
constants as defaults. Frozen so configs can be static args to ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _check_choice(name: str, value: str, choices: Tuple[str, ...]) -> None:
    """A typo'd string knob must fail loudly at config construction, not
    silently fall through an if/elif chain stages later."""
    if value not in choices:
        raise ValueError(f"{name} must be one of {choices}, got {value!r}")


@dataclasses.dataclass(frozen=True)
class ClaheConfig:
    """CLAHE contrast enhancement (``processor.py:22``)."""

    clip_limit: float = 3.5
    tile_grid: Tuple[int, int] = (8, 8)


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """KLT-based keyframe selection (``processor.py:61-110``)."""

    # Fraction of frame width of accumulated flow error that triggers a new
    # keyframe. `process` passes 0.1 (processor.py:365); the function default
    # was 0.2 (processor.py:62).
    threshold: float = 0.1
    # Resolution-invariant alternative: when > 0, the rule
    # is `accumulated_error > threshold_abs` — a constant intensity budget,
    # independent of both the full resolution and the pass-1 downscale.
    # The reference's `err > threshold * full_width` rule (processor.py:100)
    # couples selection density to the frame width even though the
    # accumulated LK intensity residual is (approximately) resolution-
    # independent, so every (resolution, downscale) pair needed its own
    # re-tuned `threshold`; one `threshold_abs` serves them all. The
    # reference-compat semantics stay the default (0 = off). Equivalence
    # anchor: threshold_abs = threshold * width_of_the_calibration_clip
    # (e.g. the 1080p rule threshold=0.05 becomes threshold_abs=96).
    threshold_abs: float = 0.0
    # Secondary FRAME-COUNT-INVARIANT trigger (the reference has nothing
    # like it): also fire a keyframe when the accumulated mean
    # optical-flow DISPLACEMENT of the tracked points exceeds
    # flow_threshold * working_width. The reference's intensity rule
    # (processor.py:95-100) accumulates a per-frame appearance residual that
    # is nearly independent of motion magnitude, so a fast clip (the same
    # orbit in 5x fewer frames) crosses it 5x less often and starves the
    # reconstruction — measured: 60-frame 1080p batch clips selected 5
    # keyframes / ~300 points where the 300-frame clip of the same scene
    # selected 18 / ~2100, underreading the volume 55-71%. Displacement
    # accumulates with the MOTION itself (px of baseline), so the trigger
    # spacing is a view-geometry quantity, invariant to frame rate.
    # Displacement and width are both in working-res units, so the ratio is
    # also resolution- and downscale-invariant. 0 = off (reference compat).
    flow_threshold: float = 0.0
    # Pyramidal LK parameters (cv2 calcOpticalFlowPyrLK defaults, since the
    # reference's driver that chose lk_params was never committed; iteration
    # count trimmed — the eps freeze converges in < 10 steps in practice).
    window: int = 21
    pyramid_levels: int = 4
    max_iters: int = 10
    eps: float = 0.01
    # Shi-Tomasi re-seeding (cv2 goodFeaturesToTrack; classic LK-demo values).
    max_corners: int = 128
    quality_level: float = 0.01
    min_distance: int = 7
    block_size: int = 7
    # Force the exact lax.top_k Shi-Tomasi ranking for the keyframe-scan
    # reseed instead of the oversampled approx_max_k path — the same
    # debugging escape hatch as OrbConfig.topk_recall=1.0 and
    # ChessboardConfig.detect_exact_topk (see ops/features.good_features).
    exact_topk: bool = False


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB detection/description (``processor.py:308``: nfeatures=20000)."""

    num_features: int = 20000
    # Detection capacity per pyramid level (static shape cap).
    fast_threshold: int = 20
    num_levels: int = 8
    scale_factor: float = 1.2
    patch_size: int = 31
    harris_block: int = 7
    # Recall target for the approx_max_k corner ranking (1.0 = exact
    # lax.top_k, the original ordering).
    topk_recall: float = 0.95
    # Spatially-bucketed detection: cap each cell of a G x G grid at
    # ceil(num_features / G^2) keypoints before the global ranking (cv2's
    # ORB quadtree distribution serves the same purpose). Global ranking
    # hands every slot to the strongest-textured region, so weak-texture
    # keypoints flicker out of the top-k between keyframes and their
    # multi-view tracks die — fatal for the marker-free chain, which needs
    # stable background parallax. 0 = pure global ranking.
    grid_cells: int = 0


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching (FLANN knnMatch k=2 + Lowe 0.75, processor.py:132-137)."""

    ratio: float = 0.75
    # Maximum matches kept per keyframe pair (static cap).
    max_matches: int = 4096
    # Reject matches whose best Hamming distance exceeds this (256-bit descs).
    max_distance: int = 96
    cross_check: bool = True


@dataclasses.dataclass(frozen=True)
class ChessboardConfig:
    """Calibration target (``processor.py:315,434``)."""

    pattern: Tuple[int, int] = (4, 3)  # inner corners (width, height)
    side_length: float = 2.0
    subpix_window: int = 11
    subpix_iters: int = 30
    subpix_eps: float = 1e-3
    # Board detector: "device" (saddle top-k + batched homography-hypothesis
    # grid fit, ops/board_detect.py), "host" (cv2.findChessboardCorners as in
    # processor.py:315), or "auto" (device first, host fallback per frame).
    detector: str = "auto"
    detect_candidates: int = 24  # saddle candidates kept for grid assignment
    detect_tol: float = 3.0  # px gate between projected grid and candidates
    # Force exact lax.top_k saddle ranking (the original behavior) instead of the
    # oversampled approx_max_k path — a debugging escape hatch for missed
    # detections; see ops/board_detect.saddle_candidates.
    detect_exact_topk: bool = False

    def __post_init__(self):
        _check_choice("chessboard.detector", self.detector, ("auto", "device", "host"))
    # Calibration constraints. The reference runs full cv2.calibrateCamera
    # (processor.py:49-53), which is degenerate for its own tiny (4, 3)
    # board on turntable orbits (cv2 returns garbage focals there too); the
    # constrained defaults recover accurate intrinsics in that regime. For
    # large boards with strong tilt coverage, set both False and
    # calib_num_dist=5 for OpenCV-equivalent behavior.
    calib_single_focal: bool = True
    calib_fix_principal_point: bool = True
    calib_num_dist: int = 0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Bundle-adjustment stopping criteria (``bundleAdjuster.py:180-192``)."""

    ftol: float = 1e-4
    max_iters: int = 50
    init_lambda: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 0.25
    # Shard ONE global-BA problem's points over this many devices
    # (SURVEY §5.7: point blocks local, camera system psum-reduced; see
    # parallel.sharded.solve_ba_point_sharded). 0/1 = single-device solve.
    # Requires that many addressable devices at solve time.
    point_shard_devices: int = 0
    # Memory band for the solver's peak term, the dense Schur strip
    # a (P, F, 6, 3) plus its V^-1 product (~144*P*F bytes at f32). When a
    # padded problem's strip would exceed this per-device budget,
    # adjust_points AUTO-shards its points over enough devices to fit
    # (overriding point_shard_devices upward) and refuses with a described
    # error if the machine has too few — there is no silent-OOM path into
    # the dense strip. Default: about half of what JAX lets one process
    # allocate on an NVIDIA H100 80GB at its default 75% memory fraction
    # (memory_stats()["bytes_limit"] = 63,763,120,128 bytes, printed by
    # chip_smoke.py's device phase); the strip coexists with the problem
    # arrays and XLA temporaries. 0 disables.
    hbm_strip_budget_bytes: int = 29 * 2**30
    # Pad adjust_points/adjust_pose problem shapes up to these multiples
    # (frames, points, observations) before solving. BA problem sizes are
    # data-dependent (every video yields a different track count), so
    # unbucketed shapes recompile the ~20 s solver program per video;
    # bucketing lets videos share compiled programs (padded cameras/points/
    # observations are masked out and provably do not perturb the solve).
    # Set to (1, 1, 1) for exact shapes.
    bucket: Tuple[int, int, int] = (4, 256, 1024)


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """SoA track-store capacities (replaces dict-of-Track, track.py)."""

    max_tracks: int = 16384
    max_keyframes: int = 128
    # Minimum triangulation (parallax) angle in degrees between the two
    # endpoint rays. The reference triangulates every popped track
    # (processor.py:254-261); near-zero-baseline pairs have unbounded depth
    # noise that reprojection gating cannot see (depth errors barely move
    # the reprojection at small parallax) and inflate the hull volume
    # cubically. 0 disables.
    min_parallax_deg: float = 1.0
    # Track-consistency (inlier) gate: a triangulated track is kept only if
    # its worst octave-normalized reprojection residual is below this many
    # FULL-resolution pixels (the role RANSAC plays in the north-star
    # design; the reference has no outlier handling at all). Denominated in
    # full-res px so downscaled pass-2 keyframes (pass2_downscale) keep
    # full-res-equivalent track quality.
    max_reproj_px: float = 4.0
    # Initial triangulation: "nview" (default) solves the masked DLT over
    # ALL of a track's observations; "endpoints" reproduces the reference's
    # first+last widest-baseline policy (track.py:30-32), which feeds middle
    # observations only to BA. nview measures equal reprojection RMSE with
    # several-fold smaller volume error on noisy/dense-keyframe regimes
    # (middle observations constrain the initialization's depth).
    triangulation: str = "nview"

    def __post_init__(self):
        _check_choice("tracks.triangulation", self.triangulation, ("endpoints", "nview"))


@dataclasses.dataclass(frozen=True)
class VolumeConfig:
    """Volume estimation (new capability; promised by README.md:2, unbuilt)."""

    voxel_resolution: int = 128
    carve_dilation: int = 5  # pixels of dilation around projected points
    # Morphological closing radius for the carve silhouettes, as a fraction
    # of the working image's long side (bridges gaps between sparse feature
    # splats; see volume.carved_volume). Smaller = tighter silhouettes;
    # sparse/noisy clouds need more closing.
    carve_close_frac: float = 0.029
    # A voxel survives carving when this fraction of views agree it is
    # inside their silhouette (1.0 = strict intersection; lower tolerates
    # per-view coverage holes from textureless boundaries).
    carve_vote_frac: float = 0.8
    # Exclude points whose octave sigma (scale_factor**octave px) exceeds
    # this from the volume estimators — hull/carve are set by extreme
    # points, and coarse-pyramid detections carry multi-px position noise
    # that inflates volumes cubically. 0 disables the gate.
    max_point_sigma: float = 2.0
    # Exclude points whose endpoint-ray parallax (deg) is below this from
    # the volume estimators: depth noise scales as 1/parallax, so marginal
    # low-parallax tracks (which legitimately serve BA) smear along their
    # viewing rays and inflate the hull. Stricter than
    # tracks.min_parallax_deg (the BA-inclusion gate). 0 disables.
    min_parallax_deg: float = 2.5
    # Hull estimator knobs (volume.hull_and_carved_volume): support-function
    # direction count, and the order-statistic trim (skip the `trim` deepest
    # points per direction before taking the support, AFTER the visual-hull
    # membership pruning of the support cloud). Re-tuned in round 4 after
    # the split_item_points precision fix (the earlier trim=9 was
    # compensating for an on-device item split corrupted by reduced-
    # precision matmuls): with the gated support cloud, trim=5 is the
    # scene-spread optimum — worst-case |err| 15.5% across the validation
    # scenes outside the flagged weak regime (e2e -6.9%, flat -ish +11%,
    # wide-arc -15.4%, 1080p bench -14.3%; tools/volume_validation.py).
    # Elongated items seen from a narrow arc remain the weak case (+~35%),
    # the symmetric completion's known failure direction — now surfaced by
    # ProcessResult.volume_confidence.
    hull_directions: int = 512
    hull_trim: int = 5
    # Sparse-aware trim scaling: the trim depth reaches
    # `hull_trim` at `hull_trim_ref` support points and scales down
    # linearly below it (0 points -> raw max), so the order statistic bites
    # a roughly constant FRACTION of the support cloud instead of a fixed
    # count — a fixed trim=5 tuned on the ~1800-point bench cloud dug 55-71%
    # of the volume out of ~300-point short-clip clouds. 0 = fixed depth.
    hull_trim_ref: int = 1500
    # Volume-confidence regime thresholds (ProcessResult.volume_confidence):
    # the estimate is flagged LOW-confidence when the keyframe view arc is
    # below confidence_min_arc_deg AND the item cloud's elongation (sqrt of
    # the largest/middle covariance-eigenvalue ratio) exceeds
    # confidence_max_elongation — the validated ~+40% weak regime (an
    # elongated item whose unseen long-axis extent a narrow arc cannot
    # constrain; tools/volume_validation.py). Thresholds sit between the
    # validation tool's weak scene (50-deg arc, elongation ~2) and the
    # gated accuracy scenes (wide arcs / rounder items).
    confidence_min_arc_deg: float = 100.0
    confidence_max_elongation: float = 1.6
    # ... and flagged LOW when the item cloud is too sparse for the trimmed
    # support to read the surface (measured: ~300-point clouds from
    # 60-frame clips underread 55-71% where the 300-frame clip of the same
    # scene reads -14%).
    confidence_min_item_points: int = 500


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    clahe: ClaheConfig = ClaheConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    orb: OrbConfig = OrbConfig()
    matcher: MatcherConfig = MatcherConfig()
    chessboard: ChessboardConfig = ChessboardConfig()
    solver: SolverConfig = SolverConfig()
    tracks: TrackConfig = TrackConfig()
    volume: VolumeConfig = VolumeConfig()
    # Frames are streamed to device in chunks of this many for the scan-based
    # keyframe pass.
    frame_chunk: int = 32
    # Pass-1 (keyframe selection) runs on frames downscaled by this integer
    # factor; 0 = auto (4 when min(H, W) >= 1060, 2 when >= 720, else 1).
    # Upload bytes and scan FLOPs drop by scale^2; pass 2 always works on
    # full-res keyframes. The keyframe decision compares the accumulated LK
    # intensity residual against threshold * full-res width; measured: at
    # high resolutions (the auto operating points) the selected density is
    # nearly independent of the factor (1080p: 24 kf at /2 vs 21 at /4 on
    # the bench clip), while forcing a downscale on already-small inputs
    # picks up to ~2x denser keyframes (steeper per-pixel gradients raise
    # the residual) — denser keyframes degrade nothing but wall clock.
    pass1_downscale: int = 0
    # Pass-2 (keyframe) processing resolution: keyframes ship to the device
    # and run ORB/subpix/calibration downscaled by this integer factor
    # (point-sampled, matching pass 1's decimation); 0 = auto (2 when
    # min(H, W) >= 1060, else 1). All image-plane quantities (K,
    # observations, reprojection RMSE) are then expressed in the downscaled
    # pixel units; the 3D cloud and volume are unchanged (world units come
    # from the board's side_length). Cuts keyframe bytes moved to the
    # device and pass-2 work by factor^2 at the cost of proportionally
    # coarser feature/corner localization in full-resolution pixels.
    pass2_downscale: int = 1
    # Keyframe enhancement path for pass 2:
    #   "bgr_lab" — the exact reference path (CLAHE on the LAB L channel of
    #     the BGR keyframe, then grey; processor.py:12-26,314,357); keyframes
    #     ship to the device as full-resolution BGR.
    #   "grey" — CLAHE directly on the BT.601 grey (native host conversion);
    #     keyframes ship at one byte per pixel — 3x fewer bytes moved to the
    #     device, at the cost of an approximation: CLAHE on
    #     luma instead of LAB lightness (equivalent for low-chroma content).
    pass2_enhance: str = "bgr_lab"
    # Pass-1 execution backend: "device" streams every downscaled frame to
    # the device and runs the lax.scan keyframe program; "host" runs the
    # IDENTICAL selection state machine in native C++ (io/native_pass1.py)
    # so only selected keyframes are copied to the device — pass 1's stream
    # is ~60 MB per 300 frames of 1080p vs ~10 MB of selected keyframes.
    # The device scan is the default; which is faster on the GPU is
    # unmeasured (ROADMAP 1.5).
    pass1_backend: str = "device"
    # Marker-free fallback (north-star RANSAC requirement): when fewer than 3
    # keyframes show the calibration board, re-run keyframe selection without
    # the board gate and bootstrap poses from chained essential-matrix RANSAC
    # (geometry/ransac.py) with track-based scale chaining instead of
    # raising. Output is up-to-scale (monocular gauge); metrics flag it.
    # The reference crashes/loops forever on board-free videos
    # (processor.py:316-319).
    markerless_fallback: bool = True
    # Assumed focal length (px) for the marker-free path; 0 = auto
    # (1.2 * max(width, height), the classic uncalibrated-bootstrap prior).
    # Real deployments should pass the EXIF/calibrated focal when available:
    # turntable-style orbits are a CRITICAL MOTION SEQUENCE for monocular
    # self-calibration (Sturm 1997) — no estimator can recover focal from
    # such footage, and an assumed focal distorts the up-to-scale
    # reconstruction in ways a similarity alignment cannot absorb.
    markerless_focal: float = 0.0
    # Bootstrap board-hunt budget when the marker-free fallback is armed:
    # after this many board-free leading frames, pass 1 stops hunting and
    # the marker-free path engages immediately. The hunt costs a board
    # detect per frame (the reference busy-loops on it FOREVER,
    # processor.py:315-319, and a full no-board cv2 detect costs seconds
    # per 1080p frame). Frames past the first few probe in cv2's FAST_CHECK
    # mode (cheap no-board rejection). 0 = hunt every frame. Ignored when markerless_fallback is
    # off — a board-required run still scans everything before raising.
    board_probe_frames: int = 45
    # Declare the video board-free up front: pass 1 starts directly in the
    # marker-free mode instead of hunting for a board, selecting keyframes
    # with the board gate, coming up empty, and re-scanning marker-free.
    # For footage the caller KNOWS has no calibration board (the deployment
    # case where EXIF focal is passed via markerless_focal) this removes
    # the probe + the duplicate pass-1 scan from the critical path.
    # Ignored when explicit board corners are supplied to ``process``.
    assume_markerless: bool = False
    # Incremental (online) bundle adjustment: re-solve the BA after every
    # keyframe prefix instead of once globally — the reference's *intended*
    # design, left commented out at processor.py:395-408 (SURVEY.md §2.2).
    # One compiled masked solve is reused for every prefix (shapes never
    # change), warm-started from the previous prefix's solution and damping;
    # the final prefix IS the global problem, so results match the batch
    # mode at convergence.
    incremental_ba: bool = False

    def __post_init__(self):
        _check_choice("pass2_enhance", self.pass2_enhance, ("bgr_lab", "grey"))
        _check_choice("pass1_backend", self.pass1_backend, ("device", "host"))


DEFAULT_CONFIG = PipelineConfig()
