"""ba_pathtracing_fur — a differentiable fur path tracer in JAX.

A JAX/XLA/Pallas implementation of the capabilities of the KIRK
fur-path-tracing reference (lucashilbig/BA_Pathtracing_Fur): a wavefront path
tracer over triangle + fur-fiber-cone scenes with Marschner / d'Eon hair
scattering, next-event estimation, LBVH acceleration, progressive
accumulation, Yxy tonemapping, and multi-device sharding — with the full
light path differentiable so pixel gradients flow to material, fur, and
emitter parameters.

Layout (a redesign of the reference's layer map, SURVEY.md §1):
  core/      vector math, sampling, counter-based RNG, thin-lens camera
  scene/     host scene graph, meshes + fur growth, flattened device scene
  models/    BSDFs (incl. hair lobes), wavefront path tracer, Whitted tracer
  ops/       intersection kernels, LBVH, tonemapper, Pallas kernels
  parallel/  device-mesh sharding, psum reductions, multi-host helpers
  diff/      differentiable rendering + parameter pytrees
  utils/     config, logging, film/accumulation, checkpointing
"""

__version__ = "0.1.0"

import os


#: The persistent compile cache's directory when JAX_COMPILATION_CACHE_DIR
#: is unset: one fixed path inside the checkout (gitignored), so every
#: process of this checkout finds what another compiled.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir(environ=os.environ) -> str | None:
    """Directory this package sets for the compile cache: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself), else
    CACHE_DIR."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def _enable_persistent_compile_cache() -> None:
    path = compile_cache_dir()
    if path is None:
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", path)


_enable_persistent_compile_cache()
