"""Test configuration: run the whole suite on a virtual 8-device CPU mesh.

Multi-device hardware is not available in CI; the reference's analogue is
running MPI with ``mpiexec -n N`` on one host (/root/reference/src/makefile:18).
Our analogue is XLA's forced host-platform device count — the same sharded
code paths compile and execute over 8 virtual CPU devices.

x64 is enabled so CPU parity tests can match PETSc f64 residual histories.

Tests marked ``gpu`` need the CUDA card (compiled Pallas kernels have no
CPU form); they skip on the CPU.  ``SPIKE_TEST_PLATFORM=cuda python -m
pytest tests/ -m gpu`` runs them on the card (``chip_smoke.py`` does).
"""

import os
import sys
import tempfile

# deterministic 'auto' dispatch in tests: a measured tuning record
# (<checkout>/.tuning.json, written by tools/tune.py) must not leak into
# route-selection assertions — point the record at a PER-SESSION absent
# file unless a test overrides it (a fixed shared /tmp name could be left
# behind by a stray tuning.update and silently re-route every later
# session)
os.environ.setdefault("SPIKE_TUNING_FILE", os.path.join(
    tempfile.mkdtemp(prefix="spike-tuning-test-"), "absent.json"))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# the virtual CPU mesh unless the gpu tier asks for the card
jax.config.update("jax_platforms",
                  os.environ.get("SPIKE_TEST_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite is compile-bound (~180 jitted
# programs); caching XLA executables across runs makes re-runs fast.
#
# CAVEAT (r3): full-suite runs segfaulted at ~70% FOUR times inside XLA
# compile/cache paths.  Root cause: vm.max_map_count exhaustion — the
# process accumulates JIT code mappings at ~3.3k/min (measured 36k maps at
# 20% progress against the 65,530 default), and when mmap fails LLVM/XLA
# segfaults.  Fix: `sysctl -w vm.max_map_count=1048576` (the make `test`
# target attempts it when root); the check below warns when the limit
# looks too small.  The cache policy (quick tier only by default,
# SPIKE_TESTS_CACHE=1/0 override) predates that diagnosis and is kept:
# cache loads also print AOT feature-mismatch SIGILL warnings on this
# image, and the full suite gains little from it.
_cache_env = os.environ.get("SPIKE_TESTS_CACHE", "")


def _enable_cache():
    from spike_petsc_tpu.utils.platform import enable_compile_cache
    enable_compile_cache(min_compile_time_secs=0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


if _cache_env == "1":
    _enable_cache()


def _check_map_count():
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            limit = int(f.read())
        if limit < 262144:
            import warnings
            warnings.warn(
                f"vm.max_map_count={limit}: full-suite runs exhaust memory "
                "maps (~65k by ~70% progress) and segfault inside XLA; run "
                "`sysctl -w vm.max_map_count=1048576` first",
                stacklevel=1)
    except OSError:
        pass


_check_map_count()

# ---------------------------------------------------------------------------
# Test tiers: the full suite is compile-heavy (~10 min).  Modules dominated
# by multi-device shard_map compiles are marked "slow" so the iteration tier
# (`pytest -m "not slow"` / `make test-quick`) stays fast.
# ---------------------------------------------------------------------------

import pytest  # noqa: E402

_SLOW_MODULES = {
    "test_parallel", "test_fieldsplit", "test_dist_auction",
    "test_matching_dev", "test_baseline_configs",
    "test_autodiff", "test_elastic", "test_dist_parity",
    "test_options_matrix",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: compile-heavy tests (multi-device shard_map, "
        "large configs); excluded by `make test-quick`")
    config.addinivalue_line(
        "markers", "gpu: needs the CUDA card (compiled Pallas kernels); "
        "skipped on the CPU")
    # quick tier (-m "not slow"): enable the persistent cache unless the
    # env var pinned a choice (see the cache caveat above).  Match the
    # DESELECTING expression specifically — a bare '-m slow' runs exactly
    # the compile-heavy tier the policy excludes.
    if _cache_env == "" and "not slow" in (config.option.markexpr or ""):
        _enable_cache()


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True)
def _skip_gpu_tests_off_gpu(request):
    """Decided per test at run time (never at import or collection): every
    worker collects the same tests, and only ``gpu``-marked ones skip."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs the CUDA card (compiled Pallas kernels have no "
                    "CPU form); run with SPIKE_TEST_PLATFORM=cuda -m gpu")
