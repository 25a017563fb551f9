"""Test config: an 8-device virtual CPU mesh so sharding tests run anywhere.

JAX_PLATFORMS defaults to cpu; run the `gpu`-marked tests on a card with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)

# Quick/slow tier split (pyproject registers the marker): whole-render and
# multi-device modules are the long tail of the ~10-minute suite; select the
# quick tier with `pytest -m "not slow"`.
_SLOW_MODULES = {"test_parallel", "test_diff", "test_bdpt", "test_whitted",
                 "test_mis", "test_pathtracer", "test_scaling",
                 "test_dryrun_budget"}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked `gpu` need an NVIDIA GPU; decided per test at run time
    (never at import, so every xdist worker collects the same tests)."""
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
