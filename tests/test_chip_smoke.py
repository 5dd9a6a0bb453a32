"""The card-run contract of chip_smoke.py, and where the compile cache goes.

chip_smoke.py must refuse a CPU platform (a CPU run never passes for a card
run) and end with one exact JSON line; the persistent compile cache follows
JAX_COMPILATION_CACHE_DIR when it is set and a fixed path in the checkout
otherwise, and CPU test runs write none.
"""

import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def test_device_check_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.check_device_platform("cpu")
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_result_line_exact_form(monkeypatch):
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    line = chip_smoke.result_line(dev)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(line)["device"]["count"] == 1


def test_cpu_run_exits_nonzero_without_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_trajectory_rmse_is_rigid_invariant():
    rng = np.random.default_rng(3)
    gt = rng.uniform(-1, 1, (6, 3))
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    est = gt @ rot.T + np.array([0.3, -2.0, 1.0])
    assert chip_smoke.trajectory_rmse(est, gt) < 1e-12
    noisy = est.copy()
    noisy[0] += np.array([0.0, 0.0, 0.06])
    assert 0.005 < chip_smoke.trajectory_rmse(noisy, gt) < 0.06


def _cache_dir_in_fresh_process(env_value):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c",
         "import rgbd360_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_env_var(tmp_path):
    assert _cache_dir_in_fresh_process(str(tmp_path)) == str(tmp_path)


def test_compile_cache_defaults_to_checkout():
    assert _cache_dir_in_fresh_process(None) == os.path.join(REPO, ".jax_cache")


def test_cpu_tests_write_no_compile_cache():
    from jax._src import compilation_cache

    import rgbd360_tpu

    assert rgbd360_tpu.CHECKOUT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_enable_compilation_cache is False
    jax.jit(lambda x: x * 3.0 + 1.0)(np.ones(7, np.float32)).block_until_ready()
    assert not compilation_cache.is_cache_used(jax.devices()[0].client)
