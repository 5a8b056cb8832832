"""Process set-up: the compile-cache placement, and ``chip_smoke.py``
refusing to run (and to print a result) where JAX finds no GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from dabjax.runtime import environment

ROOT = Path(__file__).resolve().parents[1]


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = environment.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_compile_cache_env_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    assert environment.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == old


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    if alone:                   # a directory holding the script and nothing else
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode != 0
    assert "no GPU" in res.stderr
    for line in res.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
