"""Keeps a test process of the port's tests below the kernel's limit on
memory maps by dropping the JAX package's compiled executables.

XLA on the CPU maps every executable it compiles into memory, and jax
keeps the executables in its caches for the life of the process. A
pytest-xdist worker lives for the whole session, so a worker that compiles
enough of the reference reaches the limit on the memory maps of one
process (vm.max_map_count, 65,530 by default) and dies inside XLA's
compiler, whichever test happens to be compiling. `jax.clear_caches()`
releases nearly all of them (12,167 maps down to 718 after
tests/test_models_smoke.py and tests/test_overload.py in one process). A
module of the port's tests that runs the reference in the test process
imports the autouse fixture:

    from torch_reference_cache import jax_maps_below_limit  # noqa: F401
"""
import gc
import sys

import pytest


def _max_maps() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 65530


MAX_MAPS = _max_maps()


def process_maps() -> int:
    """The memory maps this process holds (0 where /proc is absent)."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return f.read().count(b"\n")
    except OSError:
        return 0


@pytest.fixture(autouse=True)
def jax_maps_below_limit():
    """Before each test, drop jax's compiled executables once the process
    holds more than half the map limit."""
    jax = sys.modules.get("jax")
    if jax is not None and process_maps() > MAX_MAPS // 2:
        jax.clear_caches()
        gc.collect()
    yield
