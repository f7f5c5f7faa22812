"""Platform selection: the fused-kernel rule, the compile cache location,
and the entry points' refusal to run without a GPU unless told to."""
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import pytest

from hnumo_tpu import compile_cache
from hnumo_tpu.core.init import resolve_pallas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("setting,platform,dtype,nel,nop,expect", [
    ("on", "cpu", jnp.float64, 30, 4, (True, True)),   # interpret (tests)
    ("on", "gpu", jnp.float32, 30, 8, (True, False)),  # compiled, Triton
    ("on", "rocm", jnp.float32, 625, 4, ValueError),   # no kernel there
    ("on", "gpu", jnp.float64, 625, 4, ValueError),    # Triton dot: no f64
    ("auto", "cpu", jnp.float32, 625, 4, (False, False)),
    ("auto", "gpu", jnp.float32, 625, 4, (True, False)),   # measured win
    ("auto", "gpu", jnp.float32, 624, 4, (False, False)),  # unmeasured
    ("auto", "gpu", jnp.float32, 1024, 8, (False, False)),  # measured loss
    ("auto", "gpu", jnp.float64, 16384, 4, (False, False)),
    ("off", "gpu", jnp.float32, 625, 4, (False, False)),
    ("maybe", "gpu", jnp.float32, 625, 4, ValueError),
])
def test_resolve_pallas(setting, platform, dtype, nel, nop, expect):
    if expect is ValueError:
        with pytest.raises(ValueError):
            resolve_pallas(setting, platform, dtype, nel, nop)
    else:
        assert resolve_pallas(setting, platform, dtype, nel, nop) == expect


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    path = str(tmp_path / "cache")
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, path)
    assert compile_cache.cache_dir() == path
    assert compile_cache.enable() == path and os.path.isdir(path)
    # JAX reads the variable itself; enable() sets no directory of its own
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.cache_dir() == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_driver_refuses_cpu_without_flag():
    from hnumo_tpu.driver import main

    with pytest.raises(RuntimeError, match="no GPU"):
        main(["missing.in"])


def test_chip_smoke_refuses_without_gpu(tmp_path, capsys):
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert chip_smoke.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out
    # alone in a directory, without the package, it fails as well
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
