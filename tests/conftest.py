"""Test harness: run everything on CPU with 8 virtual devices so sharding
logic is testable without several accelerators (SURVEY.md §4).

FMTPU_GPU_TESTS=1 leaves the backend alone so the card-only tests
(``@pytest.mark.gpu``, tests/test_gpu_accuracy.py) run on the GPU:

    FMTPU_GPU_TESTS=1 python -m pytest tests -m gpu -q
"""

import os

if os.environ.get("FMTPU_GPU_TESTS") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ.setdefault("JAX_ENABLE_X64", "0")

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")

# Two-lane suite: the default lane (`python -m pytest tests -q`) skips
# @pytest.mark.slow tests so it stays a fast (<~6 min) pre-commit gate; the
# FULL lane — every test, nothing deleted — is
#     FMTPU_FULL_SUITE=1 python -m pytest tests -q
# Explicit -m selections (e.g. `-m slow`) bypass the default skip too.
import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    if os.environ.get("FMTPU_FULL_SUITE") == "1" or config.option.markexpr:
        return
    skip = pytest.mark.skip(
        reason="slow lane — run with FMTPU_FULL_SUITE=1 (full suite)"
    )
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


# Fast-lane duration check (README's "<6 min" bound): the default lane is
# the pre-commit gate, so a creeping runtime is a regression worth flagging.
# Non-fatal (machines differ) but loud — a test that pushes the lane over
# the bound should be moved to the slow lane.
_FAST_LANE_BOUND_S = 360.0
_t_session_start = None


def pytest_sessionstart(session):
    global _t_session_start
    import time

    _t_session_start = time.monotonic()


def pytest_sessionfinish(session, exitstatus):
    import time

    if (
        _t_session_start is None
        or os.environ.get("FMTPU_FULL_SUITE") == "1"
        or session.config.option.markexpr
    ):
        return
    # partial selections (single file / -k) finish well under the bound and
    # never trigger; no need to detect them explicitly
    dur = time.monotonic() - _t_session_start
    if dur > _FAST_LANE_BOUND_S:
        import warnings

        warnings.warn(
            f"fast lane took {dur:.0f}s > {_FAST_LANE_BOUND_S:.0f}s bound "
            "(README): move the offending tests to @pytest.mark.slow",
            stacklevel=1,
        )


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` need a GPU backend: decided here, at run time,
    never while a module is imported (collection must be identical in
    every xdist worker)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (run on the card with "
                    "FMTPU_GPU_TESTS=1 python -m pytest tests -m gpu)")


# NaN-debug lane (SURVEY.md §5.2 — the JAX-side replacement for sanitizers):
# FMTPU_DEBUG_NANS=1 re-runs the ENTIRE suite with jax_debug_nans on, so any
# computation returning NaN raises at the producing op instead of corrupting
# downstream audio/RDS.  tests/test_nan_lane.py additionally runs the e2e
# chain under the flag in the default lane on every `pytest tests/` run.
if os.environ.get("FMTPU_DEBUG_NANS") == "1":
    import jax  # noqa: E402

    jax.config.update("jax_debug_nans", True)
