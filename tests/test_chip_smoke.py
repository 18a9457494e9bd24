"""chip_smoke.py: refuses to run without a GPU, and its output contract."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def test_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs 1 GPU" in proc.stderr


def test_result_line():
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_reporter_fails_outside_tolerance(capsys):
    rep = chip_smoke.Reporter("card, 700 W")
    rep.check("p", "diff", 5e-4, 1e-3)
    with pytest.raises(AssertionError):
        rep.check("p", "diff", 2e-3, 1e-3)
    with pytest.raises(AssertionError):
        rep.check("p", "diff", float("nan"), 1e-3)
    out = capsys.readouterr().out
    assert out.count("| card, 700 W") == 3 and "FAILED" in out


def test_windows_and_stream_audio():
    feats = np.arange(20 * 3, dtype=np.float32).reshape(20, 3)
    w = chip_smoke._windows(feats, 16)
    assert w.shape == (5, 16, 3)
    np.testing.assert_array_equal(w[4], feats[4:20])
    a = chip_smoke._stream_audio(2.0, seed=1)
    assert a.dtype == np.int16 and len(a) % 1280 == 0
    np.testing.assert_array_equal(a, chip_smoke._stream_audio(2.0, seed=1))


@pytest.mark.gpu
def test_serve_phase_on_card(gpu_device):
    """The serving phase of the smoke run, on the card."""
    chip_smoke.phase_serve(chip_smoke.Reporter(str(gpu_device)))
