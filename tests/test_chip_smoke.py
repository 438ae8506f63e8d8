"""chip_smoke.py: its phases at tiny sizes on the CPU, and its refusal to
run (or print a result) anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit, match="needs 1 GPU"):
        chip_smoke.device_phase()


def test_four_card_device_phase_refuses_cpu():
    with pytest.raises(SystemExit, match="needs 4 GPU"):
        chip_smoke.device_phase(4)


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_script_fails_without_gpu_and_prints_no_result():
    r = _run([os.path.join(ROOT, "chip_smoke.py")], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_script_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run([str(tmp_path / "chip_smoke.py")], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_exact_topk_matches_brute_force():
    import numpy as np

    rng = np.random.default_rng(0)
    train = rng.standard_normal((300, 8)).astype(np.float32)
    test = rng.standard_normal((7, 8)).astype(np.float32)
    ids, d = chip_smoke.exact_topk(train, test, k=5)
    full = ((test[:, None, :].astype(np.float64) - train[None].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_array_equal(ids, np.argsort(full, axis=1)[:, :5])
    np.testing.assert_allclose(d, np.sort(full, axis=1)[:, :5], rtol=1e-12)
    assert chip_smoke.recall(ids, ids) == 1.0


def test_check_raises():
    chip_smoke.check(True, "fine")
    with pytest.raises(RuntimeError, match="check failed: broken"):
        chip_smoke.check(False, "broken")


def test_engine_phase_tiny():
    out = chip_smoke.engine_phase(
        n=3000, n_queries=512, n_check=200, batch=256,
        vamana_n=800, vamana_queries=100,
    )
    assert out["ivf_recall"] >= 0.99
    assert out["ivf_rerank_rel_err"] <= 1e-4
    assert out["vamana_recall"] >= 0.95


def test_serve_phase_tiny():
    out = chip_smoke.serve_phase(n=2000, insert_batch=500, n_single=10, n_batch=64)
    assert out["served_recall"] >= 0.99
    assert out["ingest_pts_per_s"] > 0
    assert 0 < out["single_p50_ms"] <= out["single_p99_ms"]


def test_bq_phase_tiny():
    out = chip_smoke.bq_phase(shapes=((2000, 128), (300, 1536)), n_queries=16)
    for words in (4, 48):
        assert out[f"hamming_w{words}"]["err"] == 0.0
        assert out[f"jaccard_w{words}"]["err"] <= 1e-6


def test_four_phase_tiny_on_virtual_devices():
    """Device placement makes one shard per device, searched through the
    mesh, and agrees with host placement; an explicit probe count above the
    shards' cluster count is clamped as on the host path."""
    out = chip_smoke.four_phase(per_device=150, n_queries=32, probes=64)
    assert out["agree"] == 1.0
    assert out["device_recall"] >= 0.99 and out["host_recall"] >= 0.99
