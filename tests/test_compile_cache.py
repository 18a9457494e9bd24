"""The persistent compilation cache lives at one fixed place."""

import os

import jax
import pytest

from nanowakeword_tpu.utils import compile_cache as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins_and_nothing_else_is_set(monkeypatch, tmp_path,
                                              restore_cache_dir):
    monkeypatch.setenv(C.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert C.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_without_env_var_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(C.ENV_VAR, raising=False)
    path = C.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_path_is_stable_across_calls(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(C.ENV_VAR, raising=False)
    assert C.enable_compile_cache() == C.enable_compile_cache() \
        == C.checkout_cache_dir()


def test_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_counter_counts_cache_events():
    counter = C.CacheCounter()
    try:
        jax.monitoring.record_event(C.CACHE_EVENTS[0])
        jax.monitoring.record_event(C.CACHE_EVENTS[1])
        jax.monitoring.record_event(C.CACHE_EVENTS[1])
        jax.monitoring.record_event("/jax/other")
        assert (counter.hits, counter.misses) == (1, 2)
    finally:
        counter.close()
    jax.monitoring.record_event(C.CACHE_EVENTS[0])
    assert counter.hits == 1
