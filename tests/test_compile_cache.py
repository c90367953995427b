"""The entry points' persistent compilation cache: JAX_COMPILATION_CACHE_DIR
when set, otherwise a fixed directory inside the repository."""

import pathlib

import jax
import pytest

from simpledsp_jax.utils.compile_cache import (REPO_CACHE_DIR,
                                               enable_compile_cache)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_wins_and_nothing_is_set(monkeypatch, restore_cache_dir,
                                         tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_uses_the_repo_cache(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = enable_compile_cache()
    assert got == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert enable_compile_cache() == got   # fixed: same path every call


def test_repo_cache_is_ignored_by_git():
    assert REPO_CACHE_DIR == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
