"""Flattened device scene: SoA arrays, not object pointers.

Device-side replacement for the reference's `CPU::Scene` flattener
(/root/reference/src/libraries/KIRK/CPU/CPU_Raytracer/CPU_Scene.cpp:73-202),
which produced a `vector<Object*>` with virtual dispatch. Here the scene is
two typed primitive packs (triangles, fur-fiber cones) + dense material /
light tables, all static-shaped jnp arrays that live in HBM and broadcast
cleanly against ray wavefronts.

BSDF ids (registry-name parity with BsdfFactory registrations,
/root/reference/src/libraries/KIRK/Common/Shading/Bsdf.h:133-241):
  0 LambertianReflectionBSDF   1 SpecularReflectionBSDF
  2 SpecularTransmissionBSDF   3 GlossyBSDF
  4 GlassBSDF                  5 MilkGlassBSDF
  6 LambertianTransmissionBSDF 7 EmissionBSDF
  8 TransparentBSDF            9 MarschnerHairBSDF
 10 DEonHairBSDF
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..core import pytree

BSDF_LAMBERT = 0
BSDF_SPECULAR_REFLECTION = 1
BSDF_SPECULAR_TRANSMISSION = 2
BSDF_GLOSSY = 3
BSDF_GLASS = 4
BSDF_MILK_GLASS = 5
BSDF_LAMBERT_TRANSMISSION = 6
BSDF_EMISSION = 7
BSDF_TRANSPARENT = 8
BSDF_MARSCHNER_HAIR = 9
BSDF_DEON_HAIR = 10

BSDF_NAMES = {
    "LambertianReflectionBSDF": BSDF_LAMBERT,
    "SpecularReflectionBSDF": BSDF_SPECULAR_REFLECTION,
    "SpecularTransmissionBSDF": BSDF_SPECULAR_TRANSMISSION,
    "GlossyBSDF": BSDF_GLOSSY,
    "GlassBSDF": BSDF_GLASS,
    "MilkGlassBSDF": BSDF_MILK_GLASS,
    "LambertianTransmissionBSDF": BSDF_LAMBERT_TRANSMISSION,
    "EmissionBSDF": BSDF_EMISSION,
    "TransparentBSDF": BSDF_TRANSPARENT,
    "MarschnerHairBSDF": BSDF_MARSCHNER_HAIR,
    "DEonHairBSDF": BSDF_DEON_HAIR,
}
BSDF_ID_TO_NAME = {v: k for k, v in BSDF_NAMES.items()}

# Shader ids (ShaderFactory parity): hair materials use the MarschnerHairShader
# control flow, everything else the SimpleShader flow (SURVEY §2 comp. 7).
SHADER_SIMPLE = 0
SHADER_MARSCHNER_HAIR = 1
SHADER_NAMES = {"SimpleShader": SHADER_SIMPLE, "MarschnerHairShader": SHADER_MARSCHNER_HAIR}

# Material-flag bits — exact parity with BSDFHelper (Bsdf.h:18-22).
MATFLAG_TRANSPARENT_BOUNCE = 1 << 0
MATFLAG_SPECULAR_BOUNCE = 1 << 1
MATFLAG_EMISSIVE_BOUNCE = 1 << 2
MATFLAG_CYLINDER_T_BOUNCE = 1 << 3
MATFLAG_CYLINDER_TR_BOUNCE = 1 << 4

# Light kinds (Light.h:22-275).
LIGHT_POINT = 0
LIGHT_QUAD = 1
LIGHT_SPOT = 2
LIGHT_SUN = 3

# Environment kinds (Environment.h:18-100).
ENV_COLOR = 0
ENV_SPHERE_MAP = 1
ENV_CUBE_MAP = 2

# Material texture slots (Material.h:60-78; JSON keys are f"{slot}_map",
# jsonin.cpp:403-465; MaterialTable columns are f"{slot}_tex").
TEXTURE_SLOTS = ("diffuse", "specular", "volume", "emission",
                 "transparency", "roughness", "normal", "bump")


@pytree.dataclass
class TrianglePack:
    """[T] triangles with per-vertex normals/uvs and an optional fiber frame.

    The fiber (u, v, w) frame mirrors Object::getU/getV/getW (Object.h:33-38)
    which the reference keeps even on triangles so fur-as-triangle-tubes can
    still evaluate hair BSDFs (CPU_Scene.cpp:317-335).
    """

    v0: jnp.ndarray  # [T,3]
    v1: jnp.ndarray
    v2: jnp.ndarray
    n0: jnp.ndarray  # [T,3] vertex normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray  # [T,2]
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    mat_id: jnp.ndarray  # [T] int32
    fiber_u: jnp.ndarray  # [T,3]
    fiber_v: jnp.ndarray
    fiber_w: jnp.ndarray

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@pytree.dataclass
class ConePack:
    """[F] truncated fur-fiber cones in a local (u, v, w) frame.

    Geometry parity with KIRK::Cylinder (Cylinder.cpp:5-67): v is the
    base→apex axis, slope = (r_base - r_apex)/height, hits clamped to the
    [min_d, max_d] axis slab.
    """

    base: jnp.ndarray  # [F,3]
    apex: jnp.ndarray
    r_base: jnp.ndarray  # [F]
    r_apex: jnp.ndarray
    u: jnp.ndarray  # [F,3]
    v: jnp.ndarray  # axis
    w: jnp.ndarray
    slope: jnp.ndarray  # [F]
    height: jnp.ndarray
    base_d: jnp.ndarray
    min_d: jnp.ndarray
    max_d: jnp.ndarray
    mat_id: jnp.ndarray  # [F] int32

    @property
    def count(self) -> int:
        return self.base.shape[0]


@pytree.dataclass
class MaterialTable:
    """[M] dense material params (MatParam slots of Material.h:60-83).

    The hair lobe shift/width — randomized per evaluation in the reference
    (Bsdf.cpp:485-489) — are promoted to differentiable per-material
    parameters `hair_alpha`/`hair_beta` (degrees), per SURVEY §7.
    """

    diffuse: jnp.ndarray  # [M,3]
    specular: jnp.ndarray
    volume: jnp.ndarray
    emission: jnp.ndarray
    ior: jnp.ndarray  # [M]
    transparency: jnp.ndarray
    reflectivity: jnp.ndarray
    roughness: jnp.ndarray
    bsdf_id: jnp.ndarray  # [M] int32
    shader_id: jnp.ndarray  # [M] int32
    hair_alpha: jnp.ndarray  # [M] degrees, R-lobe longitudinal shift (negative)
    hair_beta: jnp.ndarray  # [M] degrees, R-lobe longitudinal width
    # Texture slots: atlas indices, -1 = none. One per MatParam texture slot
    # of the reference (Material.h:60-78, parsed from JSON *_map keys at
    # jsonin.cpp:403-465). Color slots REPLACE the value when present; float
    # slots resolve to the length of the fetched color (Material.cpp:15-23).
    # normal/bump are stored + round-tripped for schema parity but are never
    # consumed by shading — neither are they in the reference (no render
    # path calls fetchParameterColor<NORMAL> / <BUMP>).
    diffuse_tex: jnp.ndarray  # [M] int32
    specular_tex: jnp.ndarray  # [M] int32
    volume_tex: jnp.ndarray  # [M] int32
    emission_tex: jnp.ndarray  # [M] int32
    transparency_tex: jnp.ndarray  # [M] int32
    roughness_tex: jnp.ndarray  # [M] int32
    normal_tex: jnp.ndarray  # [M] int32
    bump_tex: jnp.ndarray  # [M] int32

    @property
    def count(self) -> int:
        return self.ior.shape[0]


@pytree.dataclass
class LightPack:
    """[L] lights of all 4 kinds in one padded table (Light.h/Light.cpp)."""

    kind: jnp.ndarray  # [L] int32
    color: jnp.ndarray  # [L,3]
    position: jnp.ndarray  # [L,3]
    direction: jnp.ndarray  # [L,3] normalized
    radius: jnp.ndarray  # [L]
    const_att: jnp.ndarray  # [L]
    lin_att: jnp.ndarray
    quad_att: jnp.ndarray
    verts: jnp.ndarray  # [L,4,3] quad corners (zeros otherwise)
    size: jnp.ndarray  # [L,2] quad size
    inner_angle: jnp.ndarray  # [L] degrees (spot)
    outer_angle: jnp.ndarray  # [L] degrees (spot)

    @property
    def count(self) -> int:
        return self.kind.shape[0]


@pytree.dataclass
class Environment:
    """Background + ambient (Environment.h:18-100).

    `texture` is a single equirect sphere map [H,W,3] or a cube map
    [6,H,W,3]; COLOR mode ignores it.
    """

    kind: int = pytree.field(pytree_node=False, default=ENV_COLOR)
    color: jnp.ndarray = pytree.field(default_factory=lambda: jnp.zeros(3, jnp.float32))
    ambient: jnp.ndarray = pytree.field(default_factory=lambda: jnp.zeros(3, jnp.float32))
    texture: Optional[jnp.ndarray] = None


@pytree.dataclass
class DeviceScene:
    tris: TrianglePack
    cones: ConePack
    materials: MaterialTable
    lights: LightPack
    env: Environment
    textures: Optional[jnp.ndarray] = None  # [NT,TH,TW,3] atlas, or None
    tri_bvh: Optional["object"] = None  # ops.bvh.BVH over triangles
    cone_bvh: Optional["object"] = None  # ops.bvh.BVH over cones
    # static: any material routes to the hair shader? False lets the bounce
    # loop skip the Marschner/d'Eon automaton entirely (it is compute-all-
    # select otherwise — pure waste in fur-less scenes). True is always safe.
    has_hair: bool = pytree.field(pytree_node=False, default=True)
    # static: which material slots are actually textured in this scene
    # (subset of TEXTURE_SLOTS) — gates the per-slot bilinear fetch in
    # gather_materials so un-textured slots cost nothing.
    tex_slots: tuple = pytree.field(pytree_node=False, default=())
    # static: sorted tuple of surface bsdf ids present in the material
    # table, or () = unknown (evaluate all — always safe). Gates the
    # compute-all-select in bsdf.sample_surface: a diffuse-only Cornell
    # traces 1 BSDF instead of 9, which shrinks every jit (and the grad
    # graph the multichip dryrun compiles) substantially.
    bsdfs_present: tuple = pytree.field(pytree_node=False, default=())


def scene_has_hair(materials: "MaterialTable") -> bool:
    """Host-side check for the DeviceScene.has_hair static (call at build
    time, outside jit)."""
    import numpy as _np
    return bool(_np.any(_np.asarray(materials.shader_id) == SHADER_MARSCHNER_HAIR))


def scene_bsdfs_present(materials: "MaterialTable") -> tuple:
    """Host-side: sorted tuple of distinct bsdf ids in the table (for the
    DeviceScene.bsdfs_present static; call at build time, outside jit)."""
    import numpy as _np
    return tuple(sorted(int(b) for b in
                        _np.unique(_np.asarray(materials.bsdf_id))))


# ---------------------------------------------------------------------------
# Builders (host-side, numpy-friendly)
# ---------------------------------------------------------------------------

def _as_f32(x, shape=None):
    """Host-side float32 (numpy). Packs are BUILT on host and moved to the
    device in ONE batched transfer by `to_device` (or implicitly at the jit
    boundary) instead of per-column eager transfers."""
    a = np.asarray(x, dtype=np.float32)
    if shape is not None:
        a = a.reshape(shape)
    return a


def _as_i32(x):
    return np.asarray(x, dtype=np.int32).reshape(-1)


def to_device(tree, device=None):
    """Move a host-built scene/pack pytree to the device in one transfer.
    Call once after scene build + attach_bvh; all render entry points also
    accept host (numpy) scenes, paying a transfer per jit call instead."""
    import jax
    return jax.device_put(tree, device)


def ensure_device(tree):
    """Convert any numpy leaves to jax arrays (no-op on tracers/device
    arrays). Public compute entry points call this so host-built scenes work
    both eagerly and as closure constants; pass scenes through `to_device`
    (or as jit arguments) to avoid the per-call conversion."""
    import jax
    import jax.numpy as _jnp
    return jax.tree.map(
        lambda x: _jnp.asarray(x) if isinstance(x, np.ndarray) else x, tree)


def make_triangle_pack(v0, v1, v2, n0=None, n1=None, n2=None, uv0=None, uv1=None,
                       uv2=None, mat_id=None, fiber_u=None, fiber_v=None,
                       fiber_w=None) -> TrianglePack:
    v0, v1, v2 = (_as_f32(v).reshape(-1, 3) for v in (v0, v1, v2))
    t = v0.shape[0]
    if n0 is None:
        # face normals from winding
        fn = np.cross(np.asarray(v1 - v0), np.asarray(v2 - v0))
        norm = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = fn / np.maximum(norm, 1e-12)
        n0 = n1 = n2 = fn
    zeros2 = np.zeros((t, 2), np.float32)
    default_frame = np.tile(np.eye(3, dtype=np.float32)[None], (t, 1, 1))
    return TrianglePack(
        v0=v0, v1=v1, v2=v2,
        n0=_as_f32(n0).reshape(-1, 3), n1=_as_f32(n1).reshape(-1, 3), n2=_as_f32(n2).reshape(-1, 3),
        uv0=_as_f32(uv0 if uv0 is not None else zeros2).reshape(-1, 2),
        uv1=_as_f32(uv1 if uv1 is not None else zeros2).reshape(-1, 2),
        uv2=_as_f32(uv2 if uv2 is not None else zeros2).reshape(-1, 2),
        mat_id=_as_i32(mat_id if mat_id is not None else np.zeros(t)),
        fiber_u=_as_f32(fiber_u if fiber_u is not None else default_frame[:, 0]).reshape(-1, 3),
        fiber_v=_as_f32(fiber_v if fiber_v is not None else default_frame[:, 1]).reshape(-1, 3),
        fiber_w=_as_f32(fiber_w if fiber_w is not None else default_frame[:, 2]).reshape(-1, 3),
    )


def empty_triangle_pack() -> TrianglePack:
    z3 = np.zeros((0, 3), np.float32)
    z2 = np.zeros((0, 2), np.float32)
    return TrianglePack(v0=z3, v1=z3, v2=z3, n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2,
                        uv2=z2, mat_id=np.zeros((0,), np.int32), fiber_u=z3,
                        fiber_v=z3, fiber_w=z3)


def make_cone_pack(base, apex, r_base, r_apex, mat_id, transform=None) -> ConePack:
    """Precompute the per-cone local frame exactly as Cylinder's ctor does
    (Cylinder.cpp:5-43): the frame axes are built in *pre-transform* space and
    then mapped by the transpose-inverse model matrix; base/apex points are
    mapped by the model matrix itself.
    """
    base = np.asarray(base, np.float32).reshape(-1, 3)
    apex = np.asarray(apex, np.float32).reshape(-1, 3)
    r_base = np.asarray(r_base, np.float32).reshape(-1)
    r_apex = np.asarray(r_apex, np.float32).reshape(-1)
    f = base.shape[0]

    local_v = apex - base
    height = np.linalg.norm(local_v, axis=-1)
    height = np.maximum(height, 1e-12)
    vhat = local_v / height[:, None]

    tmp = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (f, 1))
    degenerate = 1.0 - np.abs(np.sum(tmp * vhat, axis=-1)) < 1e-4
    tmp[degenerate] = np.array([0.0, 0.0, 1.0], np.float32)
    u = np.cross(vhat, tmp)
    u /= np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
    w = np.cross(u, vhat)
    w /= np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1e-12)
    v = vhat

    if transform is not None:
        m = np.asarray(transform, np.float32).reshape(4, 4)
        m_ti = np.linalg.inv(m[:3, :3]).T
        base = base @ m[:3, :3].T + m[:3, 3]
        apex = apex @ m[:3, :3].T + m[:3, 3]
        u = u @ m_ti.T
        v = v @ m_ti.T
        for ax in (u, v):
            ax /= np.maximum(np.linalg.norm(ax, axis=-1, keepdims=True), 1e-12)

    # INVARIANT relied on by the packed traversal (ops/bvh.py pack_cones):
    # w == normalize(cross(u, v)). Identical to the Cylinder-ctor w for
    # untransformed fibers (w = cross(u, vhat), Cylinder.cpp:5-43); under a
    # skewing transform this re-orthogonalizes w instead of transforming it
    # separately (negligible deviation, and oracle + BVH stay bit-identical
    # because both read THIS w).
    w = np.cross(u, v)
    w /= np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1e-12)

    slope = (r_base - r_apex) / height
    base_d = np.sum(base * v, axis=-1)
    apex_d = np.sum(apex * v, axis=-1)
    min_d = np.minimum(base_d, apex_d)
    max_d = np.maximum(base_d, apex_d)

    return ConePack(
        base=_as_f32(base), apex=_as_f32(apex), r_base=_as_f32(r_base),
        r_apex=_as_f32(r_apex), u=_as_f32(u), v=_as_f32(v), w=_as_f32(w),
        slope=_as_f32(slope), height=_as_f32(height), base_d=_as_f32(base_d),
        min_d=_as_f32(min_d), max_d=_as_f32(max_d),
        mat_id=_as_i32(mat_id),
    )


def make_cone_pack_jnp(base, apex, r_base, r_apex, mat_id) -> ConePack:
    """jnp twin of make_cone_pack (untransformed fibers) — the Cylinder-ctor
    frame (Cylinder.cpp:5-43) as a jit-traceable program, so the flagship's
    fiber pack is generated directly on device (no host pack, no 600 MB
    upload). Same f32 math and the same w = normalize(cross(u, v))
    invariant the packed traversal relies on."""
    import jax.numpy as jnp

    local_v = apex - base
    height = jnp.maximum(jnp.linalg.norm(local_v, axis=-1), 1e-12)
    vhat = local_v / height[:, None]

    up = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    zax = jnp.array([0.0, 0.0, 1.0], jnp.float32)
    degenerate = (1.0 - jnp.abs(vhat[:, 1])) < 1e-4  # dot(up, vhat) = v.y
    tmp = jnp.where(degenerate[:, None], zax, up)
    u = jnp.cross(vhat, tmp)
    u = u / jnp.maximum(jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
    v = vhat
    w = jnp.cross(u, v)
    w = w / jnp.maximum(jnp.linalg.norm(w, axis=-1, keepdims=True), 1e-12)

    slope = (r_base - r_apex) / height
    base_d = jnp.sum(base * v, axis=-1)
    apex_d = jnp.sum(apex * v, axis=-1)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return ConePack(
        base=f32(base), apex=f32(apex), r_base=f32(r_base),
        r_apex=f32(r_apex), u=f32(u), v=f32(v), w=f32(w), slope=f32(slope),
        height=f32(height), base_d=f32(base_d),
        min_d=f32(jnp.minimum(base_d, apex_d)),
        max_d=f32(jnp.maximum(base_d, apex_d)),
        mat_id=jnp.asarray(mat_id, jnp.int32),
    )


def empty_cone_pack() -> ConePack:
    z3 = np.zeros((0, 3), np.float32)
    z1 = np.zeros((0,), np.float32)
    return ConePack(base=z3, apex=z3, r_base=z1, r_apex=z1, u=z3, v=z3, w=z3,
                    slope=z1, height=z1, base_d=z1, min_d=z1, max_d=z1,
                    mat_id=np.zeros((0,), np.int32))


def make_material_table(materials: list[dict]) -> MaterialTable:
    """Build from a list of dicts with Material.h-default fallbacks."""

    def col(m, k, d):
        return np.asarray(m.get(k, d), np.float32)[:3]

    n = len(materials)
    diffuse = np.stack([col(m, "diffuse", (1, 1, 1)) for m in materials]) if n else np.zeros((0, 3), np.float32)
    specular = np.stack([col(m, "specular", (1, 1, 1)) for m in materials]) if n else np.zeros((0, 3), np.float32)
    volume = np.stack([col(m, "volume", (1, 1, 1)) for m in materials]) if n else np.zeros((0, 3), np.float32)
    emission = np.stack([col(m, "emission", (0, 0, 0)) for m in materials]) if n else np.zeros((0, 3), np.float32)

    def f(k, d):
        return np.asarray([m.get(k, d) for m in materials], np.float32)

    def resolve_bsdf(m):
        b = m.get("bsdf", BSDF_LAMBERT)
        return BSDF_NAMES[b] if isinstance(b, str) else int(b)

    def resolve_shader(m):
        s = m.get("shader")
        if s is None:
            b = resolve_bsdf(m)
            return SHADER_MARSCHNER_HAIR if b in (BSDF_MARSCHNER_HAIR, BSDF_DEON_HAIR) else SHADER_SIMPLE
        return SHADER_NAMES[s] if isinstance(s, str) else int(s)

    return MaterialTable(
        diffuse=_as_f32(diffuse), specular=_as_f32(specular), volume=_as_f32(volume),
        emission=_as_f32(emission),
        ior=_as_f32(f("ior", 1.52)),  # Material.h:83
        transparency=_as_f32(f("transparency", 0.0)),
        reflectivity=_as_f32(f("reflectivity", 0.0)),
        roughness=_as_f32(f("roughness", 1.0)),
        bsdf_id=_as_i32([resolve_bsdf(m) for m in materials]),
        shader_id=_as_i32([resolve_shader(m) for m in materials]),
        hair_alpha=_as_f32(f("hair_alpha", -7.5)),  # midpoint of [-10,-5]°
        hair_beta=_as_f32(f("hair_beta", 7.5)),  # midpoint of [5,10]°
        **{f"{slot}_tex": _as_i32([m.get(f"{slot}_tex", -1) for m in materials])
           for slot in TEXTURE_SLOTS},
    )


def make_light_pack(lights: list[dict]) -> LightPack:
    """Lights from dicts: kind point|quad|spot|sun + per-kind params.

    Quad corner layout matches QuadLight::calcParams (Light.cpp:263-276); the
    equivalent radius sqrt(area/pi) feeds distance attenuation parity.
    """
    n = len(lights)

    def one(li):
        kind = li["kind"] if isinstance(li["kind"], int) else \
            {"point": LIGHT_POINT, "quad": LIGHT_QUAD, "spot": LIGHT_SPOT, "sun": LIGHT_SUN}[li["kind"]]
        color = np.asarray(li.get("color", (1, 1, 1)), np.float32)[:3]
        pos = np.asarray(li.get("position", (0, 0, 0)), np.float32)
        direction = np.asarray(li.get("direction", (0, -1, 0)), np.float32)
        nd = np.linalg.norm(direction)
        direction = direction / nd if nd > 0 else np.array([1.0, 0, 0], np.float32)
        radius = float(li.get("radius", 0.0))
        size = np.asarray(li.get("size", (1.0, 1.0)), np.float32)
        verts = np.zeros((4, 3), np.float32)
        if kind == LIGHT_QUAD:
            nrm = direction
            s = (np.array([-nrm[2], 0, nrm[0]]) / np.sqrt(max(nrm[0] ** 2 + nrm[2] ** 2, 1e-12))
                 if abs(nrm[0]) > abs(nrm[1]) else
                 np.array([0, nrm[2], -nrm[1]]) / np.sqrt(max(nrm[1] ** 2 + nrm[2] ** 2, 1e-12)))
            t = np.cross(nrm, s)
            verts[0] = pos - s * size[0] / 2 - t * size[1] / 2
            verts[1] = pos + s * size[0] / 2 - t * size[1] / 2
            verts[2] = pos + s * size[0] / 2 + t * size[1] / 2
            verts[3] = pos - s * size[0] / 2 + t * size[1] / 2
            radius = float(np.sqrt(size[0] * size[1] / np.pi))
        return (kind, color, pos, direction, radius,
                float(li.get("const_att", 1.0)), float(li.get("lin_att", 0.0)),
                float(li.get("quad_att", 0.0)), verts, size,
                float(li.get("inner_angle", 30.0)), float(li.get("outer_angle", 45.0)))

    rows = [one(li) for li in lights]
    if not rows:
        return LightPack(
            kind=np.zeros((0,), np.int32), color=np.zeros((0, 3), np.float32),
            position=np.zeros((0, 3), np.float32), direction=np.zeros((0, 3), np.float32),
            radius=np.zeros((0,), np.float32), const_att=np.zeros((0,), np.float32),
            lin_att=np.zeros((0,), np.float32), quad_att=np.zeros((0,), np.float32),
            verts=np.zeros((0, 4, 3), np.float32), size=np.zeros((0, 2), np.float32),
            inner_angle=np.zeros((0,), np.float32), outer_angle=np.zeros((0,), np.float32))
    cols = list(zip(*rows))
    return LightPack(
        kind=_as_i32(np.asarray(cols[0])),
        color=_as_f32(np.stack(cols[1])), position=_as_f32(np.stack(cols[2])),
        direction=_as_f32(np.stack(cols[3])), radius=_as_f32(np.asarray(cols[4])),
        const_att=_as_f32(np.asarray(cols[5])), lin_att=_as_f32(np.asarray(cols[6])),
        quad_att=_as_f32(np.asarray(cols[7])), verts=_as_f32(np.stack(cols[8])),
        size=_as_f32(np.stack(cols[9])), inner_angle=_as_f32(np.asarray(cols[10])),
        outer_angle=_as_f32(np.asarray(cols[11])),
    )
