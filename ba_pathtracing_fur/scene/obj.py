"""Wavefront OBJ + MTL loader (pure python/numpy — no Assimp dependency).

Parity with the reference's Assimp import path (SceneGraph::importObj /
createMeshFromAi, /root/reference/src/libraries/KIRK/Common/
SceneGraph.cpp:85-256): triangle-fan triangulation of n-gon faces
(:196-216), smooth normal generation when the file has none
(aiProcess_GenSmoothNormals), texcoords when present, usemtl → per-face
material slots, and the material import of createMeshFromAi
(SceneGraph.cpp:145-180): diffuse color + diffuse/normal texture paths +
emission color, with the reference's fixed defaults reflectivity=0.2,
roughness=0.1, ior=1.56. As a superset, Ks/map_Ks (specular), Ns
(glossiness→roughness), d/Tr (transparency) and Ni (ior) are also read
when present — Assimp drops them; our parser need not.
"""

from __future__ import annotations

import os

import numpy as np

from .graph import HostMesh


#: MTL key → (material-dict key, arity). Color keys carry 3 floats, float
#: keys 1; map keys carry a path resolved relative to the .mtl file.
_MTL_COLOR_KEYS = {"Kd": "diffuse", "Ks": "specular", "Ke": "emission"}
_MTL_MAP_KEYS = {"map_Kd": "diffuse_map", "map_Ks": "specular_map",
                 "map_Ke": "emission_map", "map_Bump": "bump_map",
                 "map_bump": "bump_map", "bump": "bump_map",
                 "norm": "normal_map", "map_Kn": "normal_map",
                 "map_Ns": "roughness_map", "map_d": "transparency_map"}


def load_mtl(path: str) -> dict:
    """Parse a .mtl file → {material name: material dict} with the
    createMeshFromAi defaults (SceneGraph.cpp:175-179: reflectivity 0.2,
    roughness 0.1, ior 1.56) as the base for every entry."""
    directory = os.path.dirname(os.path.abspath(path))
    mats: dict = {}
    cur: dict | None = None
    try:
        fh = open(path, "r", errors="replace")
    except OSError:
        return mats
    with fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tag, *rest = line.split()
            if tag == "newmtl":
                name = rest[0] if rest else "default"
                cur = mats.setdefault(name, dict(
                    name=name, reflectivity=0.2, roughness=0.1, ior=1.56,
                    transparency=0.0))
            elif cur is None:
                continue
            elif tag in _MTL_COLOR_KEYS:
                cur[_MTL_COLOR_KEYS[tag]] = tuple(float(x) for x in rest[:3])
            elif tag in _MTL_MAP_KEYS:
                # options (-bm etc.) may precede the filename; take the last
                # token, resolved relative to the .mtl
                cur[_MTL_MAP_KEYS[tag]] = os.path.join(directory, rest[-1])
            elif tag == "Ns" and rest:
                # glossiness exponent 0..1000 → roughness in [0, 1]
                cur["roughness"] = max(0.0, 1.0 - float(rest[0]) / 1000.0)
            elif tag == "Ni" and rest:
                cur["ior"] = float(rest[0])
            elif tag == "d" and rest:
                cur["transparency"] = 1.0 - float(rest[0])
            elif tag == "Tr" and rest:
                cur["transparency"] = float(rest[0])
    return mats


def load_obj(path: str, name: str | None = None) -> HostMesh:
    positions: list = []
    normals: list = []
    uvs: list = []
    # corner = (pos_idx, uv_idx, n_idx); OBJ indexes each independently, so
    # unique corners become output vertices
    corner_index: dict = {}
    out_pos: list = []
    out_uv: list = []
    out_n: list = []
    faces: list = []
    face_mat: list = []
    materials: list = ["default"]
    mtl_defs: dict = {}
    cur_mat = 0
    has_normals = False
    has_uvs = False
    directory = os.path.dirname(os.path.abspath(path))

    def corner(tok: str) -> int:
        nonlocal has_normals, has_uvs
        if tok in corner_index:
            return corner_index[tok]
        parts = tok.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ni = None
        if len(parts) > 1 and parts[1]:
            t = int(parts[1])
            ti = t - 1 if t > 0 else len(uvs) + t
            has_uvs = True
        if len(parts) > 2 and parts[2]:
            nn = int(parts[2])
            ni = nn - 1 if nn > 0 else len(normals) + nn
            has_normals = True
        idx = len(out_pos)
        out_pos.append(positions[vi])
        out_uv.append(uvs[ti] if ti is not None else (0.0, 0.0))
        out_n.append(normals[ni] if ni is not None else (0.0, 0.0, 0.0))
        corner_index[tok] = idx
        return idx

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tag, *rest = line.split()
            if tag == "v":
                positions.append(tuple(float(x) for x in rest[:3]))
            elif tag == "vn":
                normals.append(tuple(float(x) for x in rest[:3]))
            elif tag == "vt":
                uvs.append(tuple(float(x) for x in rest[:2]))
            elif tag == "mtllib":
                for lib in rest:
                    mtl_defs.update(load_mtl(os.path.join(directory, lib)))
            elif tag == "usemtl":
                mat = rest[0] if rest else "default"
                if mat not in materials:
                    materials.append(mat)
                cur_mat = materials.index(mat)
            elif tag == "f":
                ids = [corner(t) for t in rest]
                # triangle fan (SceneGraph.cpp:196-216)
                for k in range(1, len(ids) - 1):
                    faces.append((ids[0], ids[k], ids[k + 1]))
                    face_mat.append(cur_mat)

    mesh = HostMesh(
        vertices=np.asarray(out_pos, np.float32).reshape(-1, 3),
        faces=np.asarray(faces, np.int64).reshape(-1, 3),
        normals=np.asarray(out_n, np.float32) if has_normals else None,
        uvs=np.asarray(out_uv, np.float32) if has_uvs else None,
        face_material=np.asarray(face_mat, np.int64),
        name=name or path.rsplit("/", 1)[-1],
    )
    mesh.material_slot_names = materials  # type: ignore[attr-defined]
    # per-slot material dicts: .mtl definition when present, else a
    # name-only default (the reference always creates a KIRK::Material per
    # Assimp slot, SceneGraph.cpp:157)
    mesh.material_defs = [  # type: ignore[attr-defined]
        dict(mtl_defs.get(n, {"name": n})) for n in materials]
    if mesh.normals is None:
        mesh.compute_smooth_normals()
    return mesh


def save_obj(path: str, mesh: HostMesh) -> None:
    """Minimal OBJ writer (round-trip support for the converter CLI)."""
    with open(path, "w") as fh:
        fh.write(f"# ba_pathtracing_fur export: {mesh.name}\n")
        for p in mesh.vertices:
            fh.write(f"v {p[0]} {p[1]} {p[2]}\n")
        if mesh.normals is not None:
            for n in mesh.normals:
                fh.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        if mesh.uvs is not None:
            for t in mesh.uvs:
                fh.write(f"vt {t[0]} {t[1]}\n")
        full = mesh.normals is not None and mesh.uvs is not None
        for f in mesh.faces:
            if full:
                fh.write("f " + " ".join(f"{i+1}/{i+1}/{i+1}" for i in f) + "\n")
            elif mesh.normals is not None:
                fh.write("f " + " ".join(f"{i+1}//{i+1}" for i in f) + "\n")
            else:
                fh.write("f " + " ".join(str(i + 1) for i in f) + "\n")
