import os
import shutil
import sys
import types

import numpy as np
import pytest

# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke tests
# and benches must see 1 device; only launch/dryrun.py uses 512 placeholders.
# Tests that need a few devices spawn subprocesses (see test_distributed.py).

# The whole suite is host-CPU-only (accelerator paths run in interpret mode
# or on forced host devices).  On images that bundle libtpu, leaving the
# platform unpinned makes every fresh jax process — this one, the
# test_distributed subprocesses, the remote shard workers — probe the cloud
# metadata service for a TPU, which stalls for minutes when that endpoint
# blackholes instead of refusing.  Pin before anything imports jax; spawned
# children inherit it.  setdefault so a caller pinning a real platform wins.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# ---------------------------------------------------------------------------
# hypothesis fallback shim: the property tests import `given`/`settings`/
# `strategies` at module scope, so a missing hypothesis breaks *collection*
# of four whole modules.  When it is absent, install a stub whose `given`
# marks the test skipped; all non-property tests in those modules still run.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:

    class _Strategy:
        """Inert stand-in: any strategy combinator returns another stub."""

        def __call__(self, *a, **k):
            return self

        def __getattr__(self, name):
            return self

    def _given(*a, **k):
        return pytest.mark.skip(reason="hypothesis not installed")

    def _settings(*a, **k):
        if a and callable(a[0]):  # bare @settings usage
            return a[0]
        return lambda fn: fn

    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda name: _Strategy()

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.assume = lambda *a, **k: True
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


# ---------------------------------------------------------------------------
# shared `requires_gcc` marker: codegen / native-backend tests need a C
# toolchain; on toolchain-less hosts they must *skip*, not error.  Usage:
#     @pytest.mark.requires_gcc
# ---------------------------------------------------------------------------

def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "requires_gcc: test compiles emitted C; skipped when gcc is absent",
    )
    config.addinivalue_line(
        "markers",
        "slow: long end-to-end runs (training drivers, Poisson gateway "
        'workloads); CI deselects them with -m "not slow", `make check` '
        "still runs everything",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; the test's fixture skips it when there is none",
    )


def pytest_collection_modifyitems(config, items):
    if shutil.which("gcc") is not None:
        return
    skip_gcc = pytest.mark.skip(reason="gcc not available")
    for item in items:
        if "requires_gcc" in item.keywords:
            item.add_marker(skip_gcc)


@pytest.fixture(scope="session")
def shuttle_small():
    from repro.data.tabular import make_shuttle_like, train_test_split

    X, y = make_shuttle_like(n=4000, seed=7)
    return train_test_split(X, y, seed=7)


@pytest.fixture(scope="session")
def small_forest(shuttle_small):
    from repro.trees.forest import RandomForestClassifier

    Xtr, ytr, _, _ = shuttle_small
    return RandomForestClassifier(n_estimators=9, max_depth=6, seed=1).fit(Xtr, ytr)


@pytest.fixture(scope="session")
def small_packed(small_forest):
    from repro.core.packing import pack_forest

    return pack_forest(small_forest)
