"""Entry-point plumbing: compile-cache placement and the GPU smoke
script's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from mono_lidar_depth_tpu import compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/jax-cache"])
def test_compile_cache_placement(monkeypatch, env_dir):
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    try:
        got = compile_cache.use_compile_cache()
        now = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_dir is None:
        assert got == str(REPO / ".jax_cache") == now
    else:
        # JAX reads the variable itself; the helper must not override it
        assert got == env_dir and now == before


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
