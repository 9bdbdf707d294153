"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR when it
is set, else a fixed .jax_cache/ in the checkout."""
from pathlib import Path

import jax
import pytest

from trilinos_tpu.utils import compile_cache as cc


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_unset_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(cc.ENV, raising=False)
    path = cc.enable_compile_cache()
    assert Path(path) == Path(__file__).resolve().parents[1] / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == path


@pytest.mark.parametrize("value", ["", None])
def test_empty_or_missing_env_is_unset(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(cc.ENV, raising=False)
    else:
        monkeypatch.setenv(cc.ENV, value)
    assert cc.cache_dir() == str(cc.CHECKOUT_CACHE)


def test_set_env_is_used_and_nothing_else_set(monkeypatch, tmp_path,
                                              restore_cache_dir):
    monkeypatch.setenv(cc.ENV, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/sentinel")
    assert cc.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper leaves the config alone
    assert jax.config.jax_compilation_cache_dir == "/sentinel"
