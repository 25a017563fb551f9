"""Multi-device differentiable-rendering training step.

The differentiable path (SURVEY §7 step 6) scaled out (step 7): pixels are
sharded over "dp", geometry over "geo", and the scalar loss / parameter
gradients are reduced across the mesh by XLA collectives inserted for the
`jnp.mean` and the shard_map transpose (a psum all-reduce,
overlapped with the backward sweep by the XLA scheduler).

Trainable parameters = the material table (diffuse/specular/emission colors,
ior/roughness, and the hair lobe shift/width `hair_alpha`/`hair_beta` that
the reference randomizes per-eval, Bsdf.cpp:485-489, promoted here to real
differentiable parameters per SURVEY §7).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.pathtracer import RenderConfig
from ..scene.types import DeviceScene, MaterialTable
from . import render as prender


class TrainState(NamedTuple):
    materials: MaterialTable
    step: jnp.ndarray  # [] int32


# The differentiable columns of the material table (the int id columns —
# bsdf_id/shader_id/diffuse_tex — are structure, not parameters).
PARAM_FIELDS = ("diffuse", "specular", "volume", "emission", "ior",
                "transparency", "reflectivity", "roughness",
                "hair_alpha", "hair_beta")


def material_params(materials: MaterialTable) -> dict:
    return {k: getattr(materials, k) for k in PARAM_FIELDS}


def with_material_params(materials: MaterialTable, params: dict) -> MaterialTable:
    return materials.replace(**params)


def loss_fn(params: dict, scene: DeviceScene, camera, key, target,
            cfg: RenderConfig, mesh) -> jnp.ndarray:
    """Mean squared error between the (sharded) render and a target image."""
    mats = with_material_params(scene.materials, params)
    img = prender.render_image_sharded(
        scene.replace(materials=mats), camera, key, cfg, mesh)
    return jnp.mean((img - target) ** 2)


def train_step(state: TrainState, scene: DeviceScene, camera, key, target,
               cfg: RenderConfig, mesh, lr: float = 1e-2):
    """One SGD step on the material table. jit this with static cfg/mesh."""
    params = material_params(state.materials)
    loss, grads = jax.value_and_grad(loss_fn)(
        params, scene, camera, key, target, cfg, mesh)
    new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    new_mats = with_material_params(state.materials, new_params)
    return TrainState(materials=new_mats, step=state.step + 1), loss
