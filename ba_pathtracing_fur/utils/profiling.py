"""Profiling hooks: jax.profiler traces + phase wall timers.

The reference's instrumentation is Clock stopwatches around BVH builds and
per-segment renders plus GL timer queries (SURVEY §5: Clock.h:10-60,
CPU_BVH.cpp:18,37, CPU_PathTracer.cpp:28-41). The equivalents here:

  * `trace(logdir)` — context manager capturing a jax.profiler trace
    (XLA device timeline, op breakdown) viewable in TensorBoard/XProf/
    Perfetto. Used by `bench.py` under BENCH_PROFILE=1 and available to
    any caller.
  * `annotate(name)` — jax.profiler.TraceAnnotation passthrough so render
    phases (build/trace/shade) show as named spans inside the trace.
  * `profile_call(fn, *args, logdir=...)` — capture one traced call and
    return {wall_s, logdir, files} for reports; the trace artifact itself
    is the op-level evidence (rays/s stays the first-class scalar metric).
"""

from __future__ import annotations

import contextlib
import os
import time


def trace(logdir: str):
    """jax.profiler.trace context manager (created lazily so importing this
    module never initializes the backend)."""
    import jax

    os.makedirs(logdir, exist_ok=True)
    return jax.profiler.trace(logdir)


def annotate(name: str):
    """Named span inside a profiler trace (no-op cost outside one)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def profile_call(fn, *args, logdir: str = "out/profile", warm: bool = True):
    """Run `fn(*args)` once under a profiler trace (optionally warming first
    so compile time stays out of the trace). Returns a summary dict."""
    import jax

    if warm:
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    with trace(logdir):
        jax.block_until_ready(fn(*args))
    wall = time.perf_counter() - t0
    files = []
    for root, _, names in os.walk(logdir):
        for n in names:
            p = os.path.join(root, n)
            files.append({"file": os.path.relpath(p, logdir),
                          "bytes": os.path.getsize(p)})
    return {"wall_s": round(wall, 4), "logdir": logdir, "files": files}


@contextlib.contextmanager
def phase_timer(stats: dict, name: str):
    """Wall-clock a phase into `stats[name]` (the Clock.h analog)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats[name] = round(time.perf_counter() - t0, 4)
