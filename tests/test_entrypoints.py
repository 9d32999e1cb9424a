"""Start-up behaviour: where the compile cache lives, and the GPU-only
entry points refusing a CPU-only backend."""

import os
import subprocess
import sys

import pytest

import ra_slam_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, **env):
    full = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    full.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env)
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=full, capture_output=True,
        text=True, timeout=120,
    )


def test_cache_dir_is_the_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert ra_slam_tpu.compilation_cache_dir() == os.path.join(REPO, ".jax_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert ra_slam_tpu.compilation_cache_dir() == "/elsewhere/cache"


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_import_turns_the_cache_on(tmp_path, env_dir):
    env = {} if env_dir is None else {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / env_dir)}
    r = _run(["-c", "import ra_slam_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
             **env)
    assert r.returncode == 0, r.stderr
    want = os.path.join(REPO, ".jax_cache") if env_dir is None else str(tmp_path / env_dir)
    assert r.stdout.strip().splitlines()[-1] == want


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_fail_without_a_gpu(script):
    r = _run([script])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "metric" not in r.stdout
    assert "GPU" in r.stderr


def test_main_path_needs_no_flax_yaml_or_cv2():
    """The card's machine is only sure to have JAX, numpy, scipy, optax,
    chex and einops: the CLI's import graph and the demo UNet must not
    reach for flax, yaml or cv2."""
    code = (
        "import sys\n"
        "for mod in ('flax', 'yaml', 'cv2'):\n"
        "    sys.modules[mod] = None\n"
        "import numpy as np\n"
        "import ra_slam_tpu.pipeline.offline_eval\n"
        "from ra_slam_tpu.io import SyntheticBoxDataset\n"
        "from ra_slam_tpu.models import InferenceEngine\n"
        "eng = InferenceEngine('ra_slam_tpu/models/demo_seg.npz', width=32, height=32)\n"
        "ht, lt = eng.infer_one(np.zeros((32, 32, 3), np.uint8))\n"
        "print(ht.shape)\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "(32, 32)"
