"""Runtime plumbing: the compile-cache rule, the benchmark's peak table, the
pytree-dataclass helper, and chip_smoke.py's refusal to run without a GPU.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

import ba_pathtracing_fur
from ba_pathtracing_fur.core import pytree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_root_module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_compile_cache_honours_env():
    assert ba_pathtracing_fur.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}) is None


def test_compile_cache_default_in_checkout():
    path = ba_pathtracing_fur.compile_cache_dir({})
    assert path == ba_pathtracing_fur.CACHE_DIR
    assert path == os.path.join(ROOT, ".jax_cache")
    assert ba_pathtracing_fur.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": ""}) == path


def test_peak_table_h100():
    bench = _load_root_module("bench")

    class Dev:
        device_kind = "NVIDIA H100 80GB HBM3"

    peak = bench.device_peaks(Dev())
    assert peak["fp32_flops"] == 67e12
    assert peak["hbm_bytes_per_s"] == 3.35e12
    assert peak["source"]


def test_peak_table_unknown_device_raises():
    bench = _load_root_module("bench")

    class Dev:
        device_kind = "Imaginary Accelerator 9000"

    with pytest.raises(KeyError, match="Imaginary"):
        bench.device_peaks(Dev())


@pytree.dataclass
class _Box:
    data: jnp.ndarray
    scale: float = pytree.field(pytree_node=False, default=1.0)


def test_pytree_dataclass_static_fields():
    b = _Box(jnp.ones(3), scale=2.0)
    leaves, treedef = jax.tree.flatten(b)
    assert len(leaves) == 1 and leaves[0].shape == (3,)
    again = jax.tree.unflatten(treedef, leaves)
    assert again.scale == 2.0
    doubled = jax.tree.map(lambda x: x * 2, b)
    assert doubled.scale == 2.0 and float(doubled.data[0]) == 2.0


def test_pytree_dataclass_replace():
    b = _Box(jnp.zeros(2))
    c = b.replace(scale=3.0)
    assert c.scale == 3.0 and b.scale == 1.0
    assert c.data is b.data
    with pytest.raises(Exception):
        b.scale = 5.0  # frozen


def test_pytree_dataclass_static_change_retraces():
    traces = []

    @jax.jit
    def f(box):
        traces.append(box.scale)
        return box.data * box.scale

    f(_Box(jnp.ones(2), scale=2.0))
    f(_Box(jnp.full(2, 5.0, jnp.float32), scale=2.0))  # same static: hit
    out = f(_Box(jnp.ones(2), scale=3.0))  # new static value: retrace
    assert traces == [2.0, 3.0]
    assert float(out[0]) == 3.0


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
