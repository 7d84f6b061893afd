"""Compile-cache directory resolution and the chip smoke's refusal to run
without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from opencv_opencl_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_repo_dir_is_fixed():
    assert compile_cache.REPO_CACHE_DIR == str(REPO / ".jax_cache")


def test_unset_uses_repo_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.compile_cache_dir() == compile_cache.REPO_CACHE_DIR
    assert compile_cache.enable_compile_cache() == compile_cache.REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == compile_cache.REPO_CACHE_DIR


def test_set_variable_wins_and_code_sets_nothing(monkeypatch, cache_config,
                                                 tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_empty_variable_counts_as_unset(monkeypatch, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert compile_cache.compile_cache_dir() == compile_cache.REPO_CACHE_DIR


def test_gitignored():
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO / "chip_smoke.py", REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
