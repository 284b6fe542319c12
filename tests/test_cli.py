"""CLI driver (cli.py) — the main.py the reference gitignored."""

import contextlib
import io
import json

import numpy as np
import pytest

from meatmodeler_tpu import cli
from meatmodeler_tpu.io.synthetic import TurntableScene, render_sequence

SCENE = TurntableScene(image_size=(320, 240), focal=340.0, noise_sigma=1.0)
ARGS = [
    "--keyframe-threshold", "0.03", "--max-features", "512",
    "--max-tracks", "1024", "--max-keyframes", "24",
]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    paths = []
    for s in (0, 1):
        frames, _, _ = render_sequence(SCENE, 20, seed=s)
        p = d / f"clip{s}.npy"
        np.save(p, frames)
        paths.append(str(p))
    return paths, d


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    assert rc in (0, None)
    return buf.getvalue()


@pytest.mark.slow
def test_single_video_json(clips):
    paths, d = clips
    out = json.loads(_run([paths[0], "-o", str(d / "one"), "--json", *ARGS]))
    assert out["points"] > 50 and out["reprojection_rmse"] < 2.0
    assert out["ply"].endswith("oneCloud.ply")


@pytest.mark.slow
def test_batch_sequential(clips):
    paths, d = clips
    out = json.loads(
        _run([*paths, "-o", str(d / "seq"), "--schedule", "sequential", "--json", *ARGS])
    )
    assert isinstance(out, list) and len(out) == 2
    assert all(o["points"] > 50 for o in out)
    assert out[1]["ply"].endswith("seq_1Cloud.ply")


@pytest.mark.slow
def test_batch_mesh(clips):
    paths, d = clips
    out = json.loads(_run([*paths, "-o", str(d / "mesh"), "--json", *ARGS]))
    assert isinstance(out, list) and len(out) == 2
    assert all(np.isfinite(o["reprojection_rmse"]) for o in out)


def test_warmup_compile_primes(tmp_path):
    """meatmodeler --warmup W H compiles the pipeline for that resolution
    without any input video (cold-start mitigation). A partial
    run (too few keyframes on the tiny synthetic clip) still exits 0 — the
    big pass-1/pass-2 programs compiled, which is the command's contract."""
    rc = cli.main(
        ["--warmup", "160", "120", *ARGS, "--pass1-downscale", "2"]
    )
    assert rc == 0


def test_bad_flag_value(clips):
    paths, _ = clips
    with pytest.raises(SystemExit):
        cli.main([paths[0], "--detector", "nope"])
