"""Scaling harness (parallel/scaling.py): the BASELINE 1->N efficiency
metric has a measurement path, exercised on the virtual 8-device CPU mesh.
Virtual devices share one host's cores, so we assert structure and sanity,
not the >=90% hardware target."""

import json
import os
import subprocess
import sys

import pytest

from ba_pathtracing_fur.models.pathtracer import RenderConfig
from ba_pathtracing_fur.parallel import measure_scaling, scaling_panel
from ba_pathtracing_fur.scene.builtins import cornell_box


def test_measure_scaling_rows():
    scene, camera = cornell_box(resolution=(16, 16))
    cfg = RenderConfig(depth=2, spp=2, ray_chunk=4096)
    rows = measure_scaling(scene, camera, cfg, device_counts=(1, 2, 4),
                           repeats=1)
    assert [r["devices"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["wall_s"] > 0 and r["rays_per_s"] > 0
        assert 0 < r["efficiency"] <= r["speedup"] + 1e-9
    assert rows[0]["speedup"] == 1.0 and rows[0]["efficiency"] == 1.0

    panel = scaling_panel(rows)
    assert panel["1dev_efficiency"] == 1.0
    assert "4dev_rays_per_s" in panel


def test_scaling_cli_json():
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4")
    out = subprocess.run(
        [sys.executable, "-m", "ba_pathtracing_fur.parallel.scaling",
         "--devices", "2", "--res", "8", "--spp", "1", "--depth", "1"],
        env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr
    line = [l for l in out.stdout.splitlines() if l.startswith("{")][-1]
    data = json.loads(line)
    assert data["metric"] == "scaling_efficiency"
    assert [r["devices"] for r in data["rows"]] == [1, 2]


def test_multihost_initialize_single_process():
    """multihost_initialize brings up the distributed runtime (1-process
    cluster) — run in a subprocess so the coordinator doesn't leak into the
    test process."""
    code = (
        "import os; os.environ['JAX_PLATFORMS']='cpu'\n"
        "from ba_pathtracing_fur.parallel import multihost_initialize\n"
        "import jax\n"
        "multihost_initialize(coordinator_address='localhost:12757',"
        " num_processes=1, process_id=0)\n"
        "multihost_initialize(coordinator_address='localhost:12757',"
        " num_processes=1, process_id=0)  # idempotent\n"
        "assert jax.process_count() == 1\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
