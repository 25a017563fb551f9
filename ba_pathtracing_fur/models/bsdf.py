"""Surface BSDFs as pure batched functions with branchless dispatch.

Wavefront re-design of the reference's closure-registry BSDF system
(/root/reference/src/libraries/KIRK/Common/Shading/Bsdf.cpp:179-456,
BsdfFactory.h:40): instead of string factories + virtual dispatch, every
BSDF is a pure `(params, wi, n, u) -> (reflectance, wo, pdf, flags)`
function evaluated for ALL rays, and the per-ray `bsdf_id` selects the
result with jnp.where — zero divergence, and every branch stays
differentiable.

Conventions (identical to the reference):
  * `wi` is the COUNTER ray: -normalize(incoming ray direction), pointing
    away from the surface (SimpleShader.h:38).
  * returned reflectance is f / |cos| style exactly as each reference BSDF
    returns it; the shader multiplies by |dot(wo, n)| / pdf afterwards
    (SimpleShader.h:83).
  * radiance transport uses useRadianceOverImportance=True (the default at
    Bsdf.h:105): transmissive BSDFs scale by eta_i^2/eta_t^2.

Hair BSDFs (ids 9, 10) are in models/fur.py and merged by `sample()`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core import pytree, sampling as sp, vecmath as vm
from ..scene.types import (
    MaterialTable,
    MATFLAG_EMISSIVE_BOUNCE,
    MATFLAG_SPECULAR_BOUNCE,
    MATFLAG_TRANSPARENT_BOUNCE,
    BSDF_LAMBERT, BSDF_SPECULAR_REFLECTION, BSDF_SPECULAR_TRANSMISSION,
    BSDF_GLOSSY, BSDF_GLASS, BSDF_MILK_GLASS, BSDF_LAMBERT_TRANSMISSION,
    BSDF_EMISSION, BSDF_TRANSPARENT, BSDF_MARSCHNER_HAIR, BSDF_DEON_HAIR,
)


@pytree.dataclass
class MatParams:
    """Per-ray gathered material parameters (texture-resolved)."""

    diffuse: jnp.ndarray  # [R,3]
    specular: jnp.ndarray
    volume: jnp.ndarray
    emission: jnp.ndarray
    ior: jnp.ndarray  # [R]
    transparency: jnp.ndarray
    reflectivity: jnp.ndarray
    roughness: jnp.ndarray
    bsdf_id: jnp.ndarray  # [R] int32
    shader_id: jnp.ndarray
    hair_alpha: jnp.ndarray  # [R] degrees
    hair_beta: jnp.ndarray


#: slots gather_materials can resolve (the ones reference shading consumes)
CONSUMED_TEX_SLOTS = ("diffuse", "specular", "volume", "emission",
                      "transparency", "roughness")


def gather_materials(materials: MaterialTable, mat_id, uv=None, textures=None,
                     tex_slots=CONSUMED_TEX_SLOTS) -> MatParams:
    """Fetch the material row per ray; resolve textured parameter slots
    (Material::fetchParameterColor / fetchParameterFloat equivalents,
    Material.h:153-216). A color-slot texture REPLACES the value; a
    float-slot texture resolves to the glm::length of the fetched RGBA
    (Material.cpp:15-23 — the atlas carries alpha, defaulting to 1 for
    alpha-less sources, exactly the reference's 4-component length).
    normal/bump textures are carried by the scene but not fetched here —
    no reference render path consumes them.

    `tex_slots` statically gates which slots pay the bilinear fetch (pass
    scene.tex_slots — the slots actually textured in the scene)."""
    diffuse = materials.diffuse[mat_id]
    specular = materials.specular[mat_id]
    volume = materials.volume[mat_id]
    emission = materials.emission[mat_id]
    transparency = materials.transparency[mat_id]
    roughness = materials.roughness[mat_id]
    if textures is not None and tex_slots:
        from ..scene.texture import fetch_bilinear

        def resolve_color(tex_col, value):
            tex_id = tex_col[mat_id]
            c = fetch_bilinear(textures, jnp.maximum(tex_id, 0), uv)
            return jnp.where((tex_id >= 0)[:, None], c, value)

        def resolve_float(tex_col, value):
            tex_id = tex_col[mat_id]
            c = fetch_bilinear(textures, jnp.maximum(tex_id, 0), uv,
                               channels=4)
            return jnp.where(tex_id >= 0,
                             jnp.sqrt(jnp.sum(c * c, axis=-1)), value)

        if "diffuse" in tex_slots:
            diffuse = resolve_color(materials.diffuse_tex, diffuse)
        if "specular" in tex_slots:
            specular = resolve_color(materials.specular_tex, specular)
        if "volume" in tex_slots:
            volume = resolve_color(materials.volume_tex, volume)
        if "emission" in tex_slots:
            emission = resolve_color(materials.emission_tex, emission)
        if "transparency" in tex_slots:
            transparency = resolve_float(materials.transparency_tex, transparency)
        if "roughness" in tex_slots:
            roughness = resolve_float(materials.roughness_tex, roughness)
    return MatParams(
        diffuse=diffuse,
        specular=specular,
        volume=volume,
        emission=emission,
        ior=materials.ior[mat_id],
        transparency=transparency,
        reflectivity=materials.reflectivity[mat_id],
        roughness=roughness,
        bsdf_id=materials.bsdf_id[mat_id],
        shader_id=materials.shader_id[mat_id],
        hair_alpha=materials.hair_alpha[mat_id],
        hair_beta=materials.hair_beta[mat_id],
    )


class BsdfSample(NamedTuple):
    reflectance: jnp.ndarray  # [R,3]
    wo: jnp.ndarray  # [R,3]
    pdf: jnp.ndarray  # [R]
    flags: jnp.ndarray  # [R] int32


def _abs_dot_safe(a, b):
    return jnp.maximum(jnp.abs(vm.dot(a, b)), vm.EPS)


# --- individual BSDFs (each mirrors one reference localSample) --------------

def _lambert(mp: MatParams, wi, n, u, flags) -> BsdfSample:
    """LambertianReflectionBSDF::localSample (Bsdf.cpp:186-195)."""
    entering = vm.dot(wi, n) > 0.0
    local = sp.cosine_sample_hemisphere(u)
    local = jnp.where(entering[:, None], local, -local)
    wo = vm.local_to_world_normal(local, n)
    pdf = jnp.abs(vm.dot(wo, n)) / jnp.pi
    refl = mp.diffuse / jnp.pi
    refl = jnp.where((pdf == 0.0)[:, None], 0.0, refl)
    return BsdfSample(refl, wo, pdf, jnp.zeros_like(flags))


def _specular_reflection(mp, wi, n, u, flags) -> BsdfSample:
    """SpecularReflectionBSDF (Bsdf.cpp:210-217)."""
    nf = vm.faceforward(n, -wi, n)
    wo = vm.reflect(-wi, nf)
    refl = mp.specular / _abs_dot_safe(wo, n)[:, None]
    return BsdfSample(refl, wo, jnp.ones(wi.shape[0]), flags | MATFLAG_SPECULAR_BOUNCE)


def _specular_transmission(mp, wi, n, u, flags) -> BsdfSample:
    """SpecularTransmissionBSDF (Bsdf.cpp:258-288)."""
    entering = vm.dot(wi, n) > 0.0
    eta_i = jnp.where(entering, 1.0, mp.ior)
    eta_t = jnp.where(entering, mp.ior, 1.0)
    fresnel = sp.dielectric_fresnel(jnp.abs(vm.dot(wi, n)), eta_i, eta_t)
    nf = vm.faceforward(n, -wi, n)
    wo = vm.refract(vm.normalize(-wi), nf, (eta_i / eta_t)[:, None])
    refracted = vm.dot(wo, wo) > 0.0
    ft = mp.volume * (1.0 - fresnel)[:, None] * ((eta_i * eta_i) / (eta_t * eta_t))[:, None]
    refl = jnp.where(refracted[:, None], ft / _abs_dot_safe(wo, n)[:, None], 0.0)
    new_flags = flags | MATFLAG_SPECULAR_BOUNCE | jnp.where(refracted, MATFLAG_TRANSPARENT_BOUNCE, 0)
    return BsdfSample(refl, wo, jnp.ones(wi.shape[0]), new_flags)


def _glossy_dir(roughness, wi, n, u, sign_flip_if_negative):
    """Shared cone-perturbation used by Glossy and MilkGlass
    (Bsdf.cpp:229-238, 386-394)."""
    rad = jnp.radians(180.0 - (1.0 - roughness) * 180.0)
    sampled = sp.sample_angle(u, rad)
    return sampled


def _glossy(mp, wi, n, u, flags) -> BsdfSample:
    """GlossyBSDF (Bsdf.cpp:227-245)."""
    nf = vm.faceforward(n, -wi, n)
    reflected = vm.reflect(-wi, nf)
    sampled = _glossy_dir(mp.roughness, wi, n, u, True)
    wo = vm.local_to_world_normal(sampled, reflected)
    flip = vm.dot(wo, nf) < 0.0
    sampled_f = sampled * jnp.array([-1.0, -1.0, 1.0])
    wo = jnp.where(flip[:, None], vm.local_to_world_normal(sampled_f, reflected), wo)
    refl = mp.specular / _abs_dot_safe(wo, n)[:, None]
    return BsdfSample(refl, wo, jnp.ones(wi.shape[0]), flags | MATFLAG_SPECULAR_BOUNCE)


def _glass(mp, wi, n, u, flags) -> BsdfSample:
    """GlassBSDF (Bsdf.cpp:326-357): stochastic Fresnel-weighted choice."""
    win = vm.normalize(wi)
    entering = vm.dot(wi, n) > 0.0
    eta_i = jnp.where(entering, 1.0, mp.ior)
    eta_t = jnp.where(entering, mp.ior, 1.0)
    fresnel = sp.dielectric_fresnel(jnp.abs(vm.dot(win, n)), eta_i, eta_t)
    nf = vm.faceforward(n, -win, n)
    refr = vm.refract(-win, nf, (eta_i / eta_t)[:, None])
    can_refract = vm.dot(refr, refr) > 0.0
    choose_t = can_refract & (u[:, 1] > fresnel)

    ft = mp.volume * (1.0 - fresnel)[:, None] * ((eta_i * eta_i) / (eta_t * eta_t))[:, None]
    refl_t = ft / _abs_dot_safe(refr, n)[:, None]

    wo_r = vm.reflect(-win, nf)
    refl_r = fresnel[:, None] * mp.specular / _abs_dot_safe(wo_r, n)[:, None]

    wo = jnp.where(choose_t[:, None], refr, wo_r)
    refl = jnp.where(choose_t[:, None], refl_t, refl_r)
    pdf = jnp.where(choose_t, 1.0 - fresnel, fresnel)
    new_flags = flags | MATFLAG_SPECULAR_BOUNCE | jnp.where(choose_t, MATFLAG_TRANSPARENT_BOUNCE, 0)
    return BsdfSample(refl, wo, pdf, new_flags)


def _milk_glass(mp, wi, n, u, flags) -> BsdfSample:
    """MilkGlassBSDF (Bsdf.cpp:367-416): glass with cone-perturbed lobes."""
    win = vm.normalize(wi)
    entering = vm.dot(wi, n) > 0.0
    eta_i = jnp.where(entering, 1.0, mp.ior)
    eta_t = jnp.where(entering, mp.ior, 1.0)
    fresnel = sp.dielectric_fresnel(jnp.abs(vm.dot(win, n)), eta_i, eta_t)
    nf = vm.faceforward(n, -win, n)
    refr = vm.refract(-win, nf, (eta_i / eta_t)[:, None])
    can_refract = vm.dot(refr, refr) > 0.0
    choose_t = can_refract & (u[:, 1] > fresnel)

    sampled = _glossy_dir(mp.roughness, wi, n, u, True)
    sampled_f = sampled * jnp.array([-1.0, -1.0, 1.0])
    nf_unnorm = vm.faceforward(n, -wi, n)

    # transmission lobe about the refracted dir; flip if it lands on the
    # reflection side (note the reference's sign is inverted vs glossy)
    wo_t = vm.local_to_world_normal(sampled, refr)
    flip_t = vm.dot(wo_t, nf_unnorm) > 0.0
    wo_t = jnp.where(flip_t[:, None], vm.local_to_world_normal(sampled_f, refr), wo_t)
    ft = mp.volume * (1.0 - fresnel)[:, None] * ((eta_i * eta_i) / (eta_t * eta_t))[:, None]
    refl_t = ft / _abs_dot_safe(wo_t, n)[:, None]

    # reflection lobe about the mirror dir
    reflected = vm.reflect(-wi, nf_unnorm)
    wo_r = vm.local_to_world_normal(sampled, reflected)
    flip_r = vm.dot(wo_r, nf_unnorm) < 0.0
    wo_r = jnp.where(flip_r[:, None], vm.local_to_world_normal(sampled_f, reflected), wo_r)
    refl_r = fresnel[:, None] * mp.specular / _abs_dot_safe(wo_r, n)[:, None]

    wo = jnp.where(choose_t[:, None], wo_t, wo_r)
    refl = jnp.where(choose_t[:, None], refl_t, refl_r)
    pdf = jnp.where(choose_t, 1.0 - fresnel, fresnel)
    new_flags = flags | MATFLAG_SPECULAR_BOUNCE | jnp.where(choose_t, MATFLAG_TRANSPARENT_BOUNCE, 0)
    return BsdfSample(refl, wo, pdf, new_flags)


def _lambert_transmission(mp, wi, n, u, flags) -> BsdfSample:
    """LambertianTransmissionBSDF (Bsdf.cpp:298-308)."""
    entering = vm.dot(wi, n) > 0.0
    local = sp.cosine_sample_hemisphere(u)
    local = jnp.where(entering[:, None], -local, local)
    wo = vm.local_to_world_normal(local, n)
    pdf = jnp.abs(vm.dot(wo, n)) / jnp.pi
    refl = mp.volume / jnp.pi
    refl = jnp.where((pdf == 0.0)[:, None], 0.0, refl)
    return BsdfSample(refl, wo, pdf, jnp.full_like(flags, MATFLAG_TRANSPARENT_BOUNCE))


def _emission(mp, wi, n, u, flags) -> BsdfSample:
    """EmissionBSDF (Bsdf.cpp:427-435)."""
    wo = jnp.zeros_like(wi)
    return BsdfSample(jnp.ones_like(mp.diffuse), wo, jnp.ones(wi.shape[0]),
                      jnp.full_like(flags, MATFLAG_EMISSIVE_BOUNCE))


def _transparent(mp, wi, n, u, flags) -> BsdfSample:
    """TransparentBSDF (Bsdf.cpp:445-454): pass straight through."""
    wo = -wi
    refl = mp.volume / _abs_dot_safe(wo, n)[:, None]
    return BsdfSample(refl, wo, jnp.ones(wi.shape[0]),
                      jnp.full_like(flags, MATFLAG_TRANSPARENT_BOUNCE | MATFLAG_SPECULAR_BOUNCE))


_SURFACE_BSDFS = (
    (BSDF_LAMBERT, _lambert),
    (BSDF_SPECULAR_REFLECTION, _specular_reflection),
    (BSDF_SPECULAR_TRANSMISSION, _specular_transmission),
    (BSDF_GLOSSY, _glossy),
    (BSDF_GLASS, _glass),
    (BSDF_MILK_GLASS, _milk_glass),
    (BSDF_LAMBERT_TRANSMISSION, _lambert_transmission),
    (BSDF_EMISSION, _emission),
    (BSDF_TRANSPARENT, _transparent),
)


def sample_surface(mp: MatParams, wi, n, u, flags,
                   present: tuple = ()) -> BsdfSample:
    """Evaluate every surface BSDF and select per-ray by bsdf_id.

    BSDF::sample's zero-dot guard (Bsdf.cpp:181) is applied at the end.
    Hair ids fall through with zeros; models/fur.py overrides them.

    `present` (DeviceScene.bsdfs_present static): when non-empty, BSDFs
    whose id cannot occur in this scene are skipped entirely — same result,
    much smaller program (and grad graph). () evaluates all.

    Ids with no matching surface BSDF (hair ids, or ids filtered out by
    `present`) deterministically fall through to the _lambert sample —
    NEVER to "whichever BSDF happens to be first in the filtered list",
    which would make hair-vertex BDPT subpath weights vary with unrelated
    scene material composition (ADVICE r3).
    """
    bsdfs = [(b, f) for b, f in _SURFACE_BSDFS
             if not present or b in present]
    # deterministic fall-through base: always _lambert (evaluate it even
    # when `present` filtered it out — one cheap extra eval)
    out = _lambert(mp, wi, n, u, flags)
    for bid, fn in bsdfs:
        if bid == BSDF_LAMBERT:
            continue  # already the base
        res = fn(mp, wi, n, u, flags)
        is_b = mp.bsdf_id == bid
        out = BsdfSample(
            reflectance=jnp.where(is_b[:, None], res.reflectance, out.reflectance),
            wo=jnp.where(is_b[:, None], res.wo, out.wo),
            pdf=jnp.where(is_b, res.pdf, out.pdf),
            flags=jnp.where(is_b, res.flags, out.flags),
        )
    grazing = vm.dot(wi, n) == 0.0
    return BsdfSample(
        reflectance=jnp.where(grazing[:, None], 0.0, out.reflectance),
        wo=out.wo, pdf=out.pdf, flags=out.flags,
    )


# --- MIS support -------------------------------------------------------------
# The reference does plain NEE with no pdf formalism (SimpleShader.h:101-152);
# MIS is the north-star extension (SURVEY §7 step 4, BASELINE config 2). For
# the power heuristic both strategies must be compared in SOLID-ANGLE density,
# so the non-delta BSDFs get true (f, pdf) evaluators here. Approximate pdfs
# only affect variance, never bias — MIS stays unbiased for any weights that
# sum to 1 across strategies able to generate the sample.

_DELTA_EPS = 1e-3


def _glossy_cone(mp: MatParams):
    """Uniform-cone half-angle the glossy sampler uses (Bsdf.cpp:229-238:
    180 - (1-roughness)*180 = roughness*180 degrees) and its pdf."""
    rad = jnp.radians(mp.roughness * 180.0)
    cos_max = jnp.cos(rad)
    inv_solid = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max), 1e-6)
    return cos_max, inv_solid


def is_delta(mp: MatParams) -> jnp.ndarray:
    """[R] bool: BSDFs whose sampling density is a delta (mirror/glass/...),
    plus glossy at ~zero roughness. Hair ids count as delta — the automaton
    walk has no closed solid-angle pdf; light hits along it keep weight 1."""
    bid = mp.bsdf_id
    smooth = (bid == BSDF_LAMBERT) | (bid == BSDF_LAMBERT_TRANSMISSION)
    glossy_wide = (bid == BSDF_GLOSSY) & (mp.roughness > _DELTA_EPS)
    return ~(smooth | glossy_wide)


def eval_pdf(mp: MatParams, n, wi_view, wo):
    """(f [R,3], pdf [R]) of the material for an ARBITRARY direction `wo`,
    with `wi_view` the counter (toward-viewer) direction. Solid-angle
    measure. Delta BSDFs return (0, 0).

    Consistency contract with the samplers above: for a sampled wo,
    f * |cos| / pdf here equals the sampler's reflectance * |cos| / pdf —
    e.g. glossy's bundled form reflectance=specular/|cos|, pdf=1 maps to
    f = specular * cone_pdf / |cos|, pdf = cone_pdf.
    """
    bid = mp.bsdf_id
    won = vm.normalize(wo)
    cos_o = vm.dot(won, n)
    cos_i = vm.dot(vm.normalize(wi_view), n)
    same_side = (cos_o * cos_i) > 0.0
    abs_cos = jnp.maximum(jnp.abs(cos_o), vm.EPS)

    f = jnp.zeros_like(mp.diffuse)
    pdf = jnp.zeros((wo.shape[0],), jnp.float32)

    lamb = bid == BSDF_LAMBERT
    m = lamb & same_side
    f = jnp.where(m[:, None], mp.diffuse / jnp.pi, f)
    pdf = jnp.where(m, abs_cos / jnp.pi, pdf)

    lamt = bid == BSDF_LAMBERT_TRANSMISSION
    m = lamt & ~same_side
    f = jnp.where(m[:, None], mp.volume / jnp.pi, f)
    pdf = jnp.where(m, abs_cos / jnp.pi, pdf)

    glos = (bid == BSDF_GLOSSY) & (mp.roughness > _DELTA_EPS)
    nf = vm.faceforward(n, -wi_view, n)
    reflected = vm.normalize(vm.reflect(vm.normalize(-wi_view), nf))
    cos_max, inv_solid = _glossy_cone(mp)
    in_cone = vm.dot(won, reflected) >= cos_max
    m = glos & in_cone & same_side
    f = jnp.where(m[:, None], mp.specular * (inv_solid / abs_cos)[:, None], f)
    pdf = jnp.where(m, inv_solid, pdf)

    # hair: evaluateLight form diffuse/pi (Bsdf.cpp:771-776), no pdf (delta)
    hair = (bid == BSDF_MARSCHNER_HAIR) | (bid == BSDF_DEON_HAIR)
    f = jnp.where((hair & same_side)[:, None], mp.diffuse / jnp.pi, f)
    return f, pdf


def sample_pdf(mp: MatParams, n, wi_view, wo) -> jnp.ndarray:
    """Solid-angle pdf the sampler had for its OWN sampled `wo`; -1 marks a
    delta sample (MIS weight 1 on a subsequent light hit)."""
    _, pdf = eval_pdf(mp, n, wi_view, wo)
    return jnp.where(is_delta(mp), -1.0, jnp.maximum(pdf, 1e-8))


def evaluate_light(mp: MatParams, n, wi_light, wo_view) -> jnp.ndarray:
    """Branchless `evaluateLight` dispatch for NEE.

    Lambert (Bsdf.cpp:197-202) and MarschnerHair (Bsdf.cpp:771-776): diffuse/pi
    when both directions are on the same side; LambertianTransmission
    (Bsdf.cpp:310-318): diffuse/pi when on OPPOSITE sides (the reference
    evaluates DIFFUSE here even though it samples VOLUME — kept for parity);
    every other BSDF: zero.
    """
    same_side = (vm.dot(wi_light, n) * vm.dot(wo_view, n)) > 0.0
    lambert_like = (mp.bsdf_id == BSDF_LAMBERT) | (mp.bsdf_id == BSDF_MARSCHNER_HAIR)
    translucent = mp.bsdf_id == BSDF_LAMBERT_TRANSMISSION
    f = jnp.where(
        (lambert_like & same_side)[:, None] | (translucent & ~same_side)[:, None],
        mp.diffuse / jnp.pi,
        0.0,
    )
    return f
