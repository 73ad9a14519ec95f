"""The platform seam (utils/platform.py) and the chip smoke script's refusals.

One module answers "which machine is this?": kernel availability, the
inverter 'auto' resolves to, the card-qualified tuning key and the
persistent compilation cache.  ``chip_smoke.py`` must exit non-zero without
printing a result when JAX finds no GPU or the repository is missing.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from spike_petsc_tpu.utils import platform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch,
                                                      restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # the same path every time: the path is part of what makes entries hit
    assert platform.enable_compile_cache() == path


def test_compile_cache_honours_env_and_sets_no_dir(monkeypatch,
                                                   restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", "/sentinel/unchanged")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert platform.enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == "/sentinel/unchanged"


def test_seam_off_gpu():
    """On the CPU: no kernels, explicit kernel requests raise (unless the
    interpreter is asked for), 'auto' inverts with pivoted LU."""
    assert not platform.gpu_kernels_available()
    with pytest.raises(ValueError, match="CUDA GPU kernel"):
        platform.require_gpu_kernels("impl='pallas_fused'")
    platform.require_gpu_kernels("impl='pallas_fused'", interpret=True)
    assert platform.default_inverter() == "lapack"
    from spike_petsc_tpu.ops.blocktri import resolve_inverter
    assert resolve_inverter("auto") == "lapack"
    assert resolve_inverter("blocked") == "blocked"


def test_seam_on_faked_gpu(monkeypatch):
    monkeypatch.setattr(platform, "backend", lambda: "gpu")
    assert platform.gpu_kernels_available()
    platform.require_gpu_kernels("impl='pallas_fused'")
    assert platform.default_inverter() == "newton"
    from spike_petsc_tpu.solvers.pc import _newton_probe_active
    assert _newton_probe_active("auto")


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is not None:
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_fails_without_gpu():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert "JAX finds a GPU" in out.stderr
    assert not _printed_result(out.stdout)


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert not _printed_result(out.stdout)
