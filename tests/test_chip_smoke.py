"""chip_smoke.py off the card: its device guard, its kernel and solver phases
at tiny sizes (the CPU device stands in for the card), and the compile-cache
helper every entry point uses."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke as cs
from orbslam3_tpu.frontend.camera import Camera
from orbslam3_tpu.frontend.orb import OrbConfig
from orbslam3_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]
CPU = jax.devices("cpu")[0]


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_points_refuse_the_cpu(script):
    r = _run([script], REPO)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert '"ok": true' not in r.stdout


def test_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_import_allocates_on_no_device():
    """Render workers are spawned and import the package: an import that
    initialises a backend makes each of them take device memory."""
    code = ("import jax._src.xla_bridge as xb, bench, chip_smoke, "
            "orbslam3_tpu.models.fused, orbslam3_tpu.loop.closer, "
            "orbslam3_tpu.parallel.multi_session, orbslam3_tpu.io.synthetic; "
            "print(sorted(xb._backends))")
    r = _run(["-c", code], REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_render_workers_start_no_device_client(tmp_path):
    """A pickled world (what each render worker receives) unpickles into
    host arrays only."""
    import pickle

    from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld

    blob = tmp_path / "world.pkl"
    blob.write_bytes(pickle.dumps(SyntheticWorld(SyntheticConfig(duration=0.2))))
    code = ("import pickle, sys, jax._src.xla_bridge as xb; "
            f"w = pickle.loads(open({str(blob)!r}, 'rb').read()); "
            "w.render_frame(0.0); print(sorted(xb._backends))")
    r = _run(["-c", code], REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_require_gpu_raises_on_cpu():
    from bench import require_gpu

    with pytest.raises(SystemExit, match="needs a GPU"):
        require_gpu()


def test_phase_kernels_tiny():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 96, 128), dtype=np.uint8)
    out = cs.phase_kernels(CPU, CPU, imgs, OrbConfig(n_features=128, n_levels=3),
                           n_kp=64)
    assert out["ok"], out
    assert out["fast_nms"]["levels"] == 3
    assert out["fast_nms"]["mismatched_pixels"] == 0
    assert out["brief"]["bit_agreement"] == 1.0


def test_phase_solvers_tiny():
    cam = Camera.create(458.0, 458.0, 376.0, 240.0, 0.11)
    out = cs.phase_solvers(CPU, CPU, cam, n_feat=64, ba_window=4, ba_points=128)
    assert out["ok"], out
    assert set(out["rel_err"]) == {"pose_optimize", "solve_local_ba",
                                   "solve_vi_ba", "sim3_ransac",
                                   "triangulate_dlt"}


def test_rel_err_scales_by_reference_magnitude():
    assert cs._rel_err([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert cs._rel_err([0.1001], [0.1]) == pytest.approx(1e-4)  # |ref| < 1
    assert cs._rel_err([10.001], [10.0]) == pytest.approx(1e-4)


def test_gba_tile_follows_the_loop_closer_rule():
    assert cs.gba_tile(32768, 1, 4096) == 4096
    assert cs.gba_tile(32768, 4, 4096) == 4096
    assert cs.gba_tile(1000, 4, 4096) == 250


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_default_is_fixed(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.chdir(tmp_path)
    d = compile_cache.enable()
    assert d == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", d)]
    # the same path from anywhere
    r = subprocess.run(
        [sys.executable, "-c", "from orbslam3_tpu.utils import compile_cache;"
         "print(compile_cache.DEFAULT_DIR)"],
        cwd=REPO, env={k: v for k, v in os.environ.items()
                       if k != compile_cache.ENV_VAR},
        capture_output=True, text=True, timeout=120,
    )
    assert r.stdout.strip() == d


def test_card_info_reads_nvidia_smi(monkeypatch):
    import bench

    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench.card_info() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen["cmd"][0] == "nvidia-smi"
    assert "--query-gpu=name,power.limit" in seen["cmd"]


@pytest.fixture
def gpu_present():
    """A card is usable only where nvidia-smi lists one."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")
    r = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True)
    if r.returncode != 0 or "GPU" not in r.stdout:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu_present):
    """The full smoke on the card, in its own process: the CPU-forced test
    process cannot reach the GPU."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith('{"ok": true, "device": {"platform": "gpu"')
