"""utils/compilecache: $JAX_COMPILATION_CACHE_DIR when set, else a fixed
directory in the checkout."""

import os

import jax

from semadb_tpu.utils import compilecache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins_and_sets_nothing(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compilecache.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compilecache.configure()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert compilecache.configure() == path  # stable across calls


def test_default_dir_is_git_ignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
