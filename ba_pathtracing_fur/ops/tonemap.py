"""Yxy-space photographic (logarithmic) tone mapping.

Array re-design of KIRK::Tonemapper (/root/reference/src/libraries/KIRK/Utils/
Tonemapping.{h,cpp}; Drago et al. logmap, the paper the reference cites):
RGB→Yxy, adaptive-log luminance compression with bias, Yxy→RGB, optional
plain or Rec.709 gamma, white/black clamp. The reference walks the pixel
vector several times on the host; here it is one fused elementwise XLA pass
plus two reductions (max + mean-log luminance) — and it is differentiable,
so tonemapped-image losses backprop to scene parameters.

Defaults mirror Tonemapping.h:25-33 exactly (exposure 0 ⇒ 2^0, bias 0.85,
gamma 1, contrast 0, white 1, black 0).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

EPS = 1e-6
LOG05 = -0.693147  # Tonemapping.h:13

# RGB↔Yxy matrices, Tonemapping.h:36-43
RGB2YXY = jnp.array([
    [0.5141364, 0.3238786, 0.16036376],
    [0.265068, 0.67023428, 0.06409157],
    [0.0241188, 0.1228178, 0.84442666],
], jnp.float32)
YXY2RGB = jnp.array([
    [2.5651, -1.1665, -0.3986],
    [-1.0217, 1.9777, 0.0439],
    [0.0753, -0.2543, 1.1892],
], jnp.float32)


class TonemapParams(NamedTuple):
    exposure: float = 0.0  # scene exposure, applied as 2^exposure
    bias: float = 0.85
    gamma: float = 1.0  # "should use 2.2" (Tonemapping.h:25)
    contrast: float = 0.0
    white: float = 1.0
    black: float = 0.0
    use_rec_gamma: bool = False


def _rgb_to_yxy(img):
    """RGB_to_Yxy (Tonemapping.cpp:71-95): returns (Y, x, y) channels."""
    xyz = jnp.einsum("ij,...j->...i", RGB2YXY, img,
                     precision=jax.lax.Precision.HIGHEST)
    w = jnp.sum(xyz, axis=-1)
    ok = w > 0.0
    yy = jnp.where(ok, xyz[..., 1], 0.0)
    cx = jnp.where(ok, xyz[..., 0] / jnp.where(ok, w, 1.0), 0.0)
    cy = jnp.where(ok, xyz[..., 1] / jnp.where(ok, w, 1.0), 0.0)
    return yy, cx, cy


def _yxy_to_rgb(yy, cx, cy):
    """Yxy_to_RGB (Tonemapping.cpp:97-120)."""
    ok = (yy > EPS) & (cx > EPS) & (cy > EPS)
    safe_cy = jnp.where(ok, cy, 1.0)
    safe_cx = jnp.where(ok, cx, 1.0)
    x = jnp.where(ok, cx * yy / safe_cy, EPS)
    z = jnp.where(ok, x / safe_cx - x - yy, EPS)
    xyz = jnp.stack([x, yy, z], axis=-1)
    return jnp.einsum("ij,...j->...i", YXY2RGB, xyz,
                      precision=jax.lax.Precision.HIGHEST)


def tonemap(img: jnp.ndarray, params: TonemapParams = TonemapParams()) -> jnp.ndarray:
    """Map a linear [H,W,3] (or [...,3]) image. Matches Tonemapper::map
    (Tonemapping.cpp:9-46) with center-weighting off."""
    p = params
    yy, cx, cy = _rgb_to_yxy(img)

    max_lum = jnp.maximum(jnp.max(yy), EPS)
    world_lum = jnp.mean(jnp.log(2.3e-5 + yy))  # Tumblin contrast constant
    av_lum = jnp.exp(world_lum)

    exposure = 2.0 ** p.exposure
    bias_p = jnp.log(jnp.maximum(p.bias, 1e-12)) / LOG05
    lmax = max_lum / av_lum
    divider = jnp.log10(lmax + 1.0)

    y = yy
    if p.contrast:
        y = jnp.power(jnp.maximum(y, 0.0), 1.0 / p.contrast)
    y = y / av_lum * exposure
    interpol = jnp.log(2.0 + jnp.power(jnp.maximum(y / lmax, 0.0), bias_p) * 8.0)
    y = jnp.log(y + 1.0) / interpol / divider

    out = _yxy_to_rgb(y, cx, cy)

    if p.gamma != 1.0:
        if p.use_rec_gamma:
            out = _rec_gamma(out, p.gamma)
        else:
            out = jnp.power(jnp.maximum(out, 0.0), 1.0 / p.gamma)
    if p.white != 1.0 or p.black != 0.0:
        out = jnp.clip(out, p.black, p.white)
    return out


def _rec_gamma(img, gamma):
    """Rec.709 transfer with the reference's gamma-dependent knee
    (Tonemapping.cpp:155-182)."""
    inv_gamma = 0.45 / gamma * 2.0
    slope, start = 4.5, 0.018
    if gamma >= 2.1:
        start = 0.018 / ((gamma - 2.0) * 7.5)
        slope = 4.5 * ((gamma - 2.0) * 7.5)
    elif gamma <= 1.9:
        start = 0.018 * ((2.0 - gamma) * 7.5)
        slope = 4.5 / ((2.0 - gamma) * 7.5)
    return jnp.where(img <= start, img * slope,
                     1.099 * jnp.power(jnp.maximum(img, start), inv_gamma) - 0.099)
