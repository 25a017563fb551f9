"""Physically-parameterized thin-lens camera.

Parity target: KIRK::Camera (/root/reference/src/libraries/KIRK/Common/
Camera.cpp:6-66, Camera.h:116-130 defaults). The sensor-size + focal-length
FoV derivation, bottom-left/pixel-size basis, and DoF disk jitter semantics
(including the reference's quirk of NOT normalizing the DoF direction,
Camera.cpp:48) are reproduced exactly so images validate allclose.

Ray generation is a pure batched function: the whole pixel grid is produced
in one fused elementwise pass, not per-pixel calls.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

from . import pytree, sampling, vecmath as vm


@pytree.dataclass
class Camera:
    """Derived camera state living on device. Build with `make_camera`."""

    position: jnp.ndarray  # [3]
    axis_x: jnp.ndarray  # [3]
    axis_y: jnp.ndarray  # [3]
    axis_z: jnp.ndarray  # [3]
    bottom_left: jnp.ndarray  # [3]
    pixel_size: jnp.ndarray  # []
    aperture: jnp.ndarray  # []
    focus_distance: jnp.ndarray  # []
    resolution: Tuple[int, int] = pytree.field(pytree_node=False, default=(512, 512))
    use_dof: bool = pytree.field(pytree_node=False, default=False)


def make_camera(
    position=(0.0, 0.0, 0.0),
    look_at=(0.0, 0.0, -1.0),
    up=(0.0, 1.0, 0.0),
    resolution=(512, 512),
    sensor_size=(0.036, 0.024),  # Camera.h:128
    focal_length=0.0415,  # Camera.h:129
    f_stop=1.8,  # Camera.h:130
    focus_distance=11.0,  # Camera.h:116
    transform=None,
    use_dof=False,
) -> Camera:
    """Equivalent of Camera::applyParameters (Camera.cpp:6-37).

    `look_at` is a *direction* (the reference transforms it with w=0 and
    negates it for axis_z).
    """
    # Host-side numpy on purpose: camera setup is scalar work, and eager
    # jnp here would dispatch ~24 tiny one-op programs per fresh process.
    # The derived arrays enter jit as ordinary f32 inputs; math is
    # bit-identical.
    import numpy as np

    def _nrm(v):
        return v / max(float(np.linalg.norm(v)), 1e-20)

    position = np.asarray(position, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)
    if transform is not None:
        t = np.asarray(transform, np.float32)
        position = (t @ np.append(position, 1.0))[:3].astype(np.float32)
        look_at = (t @ np.append(look_at, 0.0))[:3].astype(np.float32)
        up = (t @ np.append(up, 0.0))[:3].astype(np.float32)

    aperture = focal_length / f_stop
    axis_z = _nrm(-look_at).astype(np.float32)
    axis_x = _nrm(np.cross(up, axis_z)).astype(np.float32)
    axis_y = _nrm(np.cross(axis_z, axis_x)).astype(np.float32)

    sensor = np.asarray(sensor_size, np.float32)
    sensor_diameter = np.sqrt(sensor[0] ** 2 + sensor[1] ** 2)
    fov = 2.0 * np.arctan(sensor_diameter / (2.0 * focal_length))
    aspect = resolution[0] / resolution[1]
    sy = np.tan(0.5 * fov)
    sx = sy * aspect
    pixel_size = np.float32(2.0 * sx / resolution[0])
    bottom_left = (position - axis_z - sy * axis_y
                   - sx * axis_x).astype(np.float32)

    return Camera(
        position=position,
        axis_x=axis_x,
        axis_y=axis_y,
        axis_z=axis_z,
        bottom_left=bottom_left,
        pixel_size=jnp.float32(pixel_size),
        aperture=jnp.float32(aperture),
        focus_distance=jnp.float32(focus_distance),
        resolution=tuple(resolution),
        use_dof=use_dof,
    )


def rays_from_pixels(
    cam: Camera,
    px: jnp.ndarray,
    py: jnp.ndarray,
    jitter: jnp.ndarray,
    dof_uniforms: jnp.ndarray | None = None,
):
    """Primary rays for pixel coords (px, py) with subpixel jitter in [0,1)^2.

    Matches Camera::getRayFromPixel (Camera.cpp:59-66); if `cam.use_dof`,
    applies transformToDof (Camera.cpp:39-51): disk-jittered origin on a
    radius of 3*aperture, direction toward the focus plane, left
    unnormalized exactly as the reference does.

    Returns (origins [N,3], directions [N,3]); directions are NOT normalized
    (the reference's primary rays aren't either).
    """
    x = (px + jitter[..., 0])[..., None]
    y = (py + jitter[..., 1])[..., None]
    direction = (
        cam.bottom_left + x * cam.pixel_size * cam.axis_x + y * cam.pixel_size * cam.axis_y - cam.position
    )
    origin = jnp.broadcast_to(cam.position, direction.shape)

    if cam.use_dof:
        if dof_uniforms is None:
            raise ValueError("use_dof camera requires dof_uniforms")
        focus_point = cam.position + cam.focus_distance * direction
        # glm::diskRand(aperture*3): uniform in a disk of that radius
        r = cam.aperture * 3.0 * jnp.sqrt(dof_uniforms[..., 0])
        phi = 2.0 * jnp.pi * dof_uniforms[..., 1]
        start = (
            cam.position
            + (r * jnp.cos(phi))[..., None] * cam.axis_x
            + (r * jnp.sin(phi))[..., None] * cam.axis_y
        )
        direction = focus_point - start
        origin = start

    return origin, direction


def pixel_grid(resolution) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Flattened (px, py) int coords for the full image, row-major by y."""
    w, h = resolution
    ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    return xs.reshape(-1).astype(jnp.float32), ys.reshape(-1).astype(jnp.float32)
