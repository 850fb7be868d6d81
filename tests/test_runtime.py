"""Compilation-cache placement (scythe_tpu.utils.runtime)."""

import os

import jax
import pytest
from jax._src import compilation_cache

from scythe_tpu.utils import runtime

_KEYS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_entry_size_bytes",
    "jax_persistent_cache_min_compile_time_secs",
)


@pytest.fixture
def restore_cache_config():
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)
    compilation_cache.reset_cache()


def test_compile_cache_honours_env(tmp_path, monkeypatch, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_persistent_cache_min_compile_time_secs
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    # nothing else is configured when the environment names the cache
    assert jax.config.jax_persistent_cache_min_compile_time_secs == before


def test_compile_cache_defaults_to_repo(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = runtime.enable_compile_cache()
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
