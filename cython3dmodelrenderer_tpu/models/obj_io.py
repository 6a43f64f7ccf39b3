"""Wavefront OBJ / MTL / texture loading — the host-side asset layer.

Behavioral parity with the reference loader
(``crender/py/data_structures/model.py:6-116,263-328``):

* lenient line-by-line parsing — malformed lines are silently skipped unless
  ``silent=False`` (reference ``model.py:70-73``);
* ``v`` takes the first three floats (optional w ignored, ``model.py:263-267``);
  ``vt`` takes all floats; ``vn`` requires exactly three;
* faces are fan-triangulated (``[c0, c1+i, c2+i]``, reference ``model.py:288``)
  and support ``v``, ``v/vt``, ``v//vn`` and ``v/vt/vn`` forms;
* 1-based indices become 0-based; zero/negative indices pass through so that
  negative (relative) indices keep Python-style end-relative meaning
  (reference ``_fix_index``, ``model.py:279-283``);
* if *any* face vertex lacks a ``vt`` (resp. ``vn``) index, the whole
  per-triangle texture-coordinate (resp. normal) index table is dropped —
  matching the reference's all-or-nothing accumulation (``model.py:49-57``);
* ``mtllib`` resolves the material file relative to the OBJ's directory unless
  absolute, takes the *last* ``map_Kd`` entry, and loads the texture in
  OpenCV's **BGR channel order** (``model.py:59-66,102-103,114-116``) with
  the package's PNG reader (``utils/png.py``).
  MTL parse failures print a warning and are otherwise ignored
  (``model.py:107-112``).

This is deliberately plain NumPy/Python: asset IO is host work.  A native C++
fast path (``native/objparse.cpp``) handles the line-parsing hot loop for large
meshes when the shared library is built; this module is the always-available
fallback and the semantic definition.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ObjData:
    """Raw parse result: vertex pools + per-triangle index tables."""

    vertices: np.ndarray                     # (V, 3) float32
    texture_coords: Optional[np.ndarray]     # (VT, >=2) float32 or None
    normals: Optional[np.ndarray]            # (VN, 3) float32 or None
    faces_v: np.ndarray                      # (T, 3) int32 — vertex indices
    faces_vt: Optional[np.ndarray]           # (T, 3) int32 or None
    faces_vn: Optional[np.ndarray]           # (T, 3) int32 or None
    texture: Optional[np.ndarray]            # (H, W, 3) uint8 BGR or None


def _read_vertex(data: str) -> List[float]:
    # extra components (w, vertex colors) are legal OBJ — keep x, y, z
    x, y, z = [float(tok) for tok in data.split()][:3]
    return [x, y, z]


def _read_texture_coord(data: str) -> List[float]:
    # keep every component; the consumer slices u, v (some exporters write
    # a third w coordinate)
    return [float(tok) for tok in data.split()]


def _read_normal(data: str) -> List[float]:
    nx, ny, nz = (float(tok) for tok in data.split())
    return [nx, ny, nz]


def _corner(token: str) -> Tuple[int, Optional[int], Optional[int]]:
    """One face corner ``v[/vt[/vn]]`` → (v, vt, vn) 0-based indices.

    Absent/empty fields → None (v itself is mandatory — a malformed corner
    raises and the lenient caller skips the line). OBJ indices are 1-based;
    non-positive (end-relative) ones pass through untouched — they keep
    working via NumPy negative indexing downstream.
    """
    fields = token.split("/")[:3] + ["", ""]

    def to_index(field: str) -> Optional[int]:
        if not field:
            return None
        i = int(field)
        return i - 1 if i > 0 else i

    v = to_index(fields[0])
    if v is None:
        raise ValueError(f"face corner without a vertex index: {token!r}")
    return v, to_index(fields[1]), to_index(fields[2])


def _read_face(data: str):
    """Fan-triangulate one ``f`` record around its first corner.

    Returns three parallel lists (one entry per emitted triangle): vertex
    index triples, texture-coordinate triples (``None`` when any corner of
    that triangle lacks one) and normal triples likewise.
    """
    corners = [_corner(tok) for tok in data.split()]
    out_v, out_vt, out_vn = [], [], []
    for b, c in zip(corners[1:-1], corners[2:]):
        tri = (corners[0], b, c)
        out_v.append([cn[0] for cn in tri])
        vt = [cn[1] for cn in tri]
        out_vt.append(None if None in vt else vt)
        vn = [cn[2] for cn in tri]
        out_vn.append(None if None in vn else vn)
    return out_v, out_vt, out_vn


def _obj_dir(filename: str) -> str:
    parts = filename.rsplit("/", 1)
    return parts[-2] + "/" if len(parts) == 2 else ""


def read_material_file(filename: str, origin: str) -> Optional[str]:
    """Parse an MTL file, returning the last ``map_Kd`` image path (or None)."""
    image_filename = None
    try:
        with open(filename.strip(), "r") as f:
            for line in f:
                if line == "" or line[0] == "#":
                    continue
                parts = line.split(" ", 1)
                if len(parts) != 2:
                    continue
                command, data = parts
                if command == "map_Kd":
                    image_filename = data
    except Exception as e:  # lenient, like the reference (model.py:107-112)
        print(f"warning: could not parse material file for '{origin}': {e}")
        print("warning: rendering untextured (material ignored)")
    return image_filename


def read_texture_file(filename: str) -> Optional[np.ndarray]:
    """Load a PNG texture in BGR order (OpenCV convention, model.py:114-116).

    Like ``cv2.imread``, a missing or unreadable file yields None (the model
    renders untextured).
    """
    from ..utils.png import read_png

    try:
        return read_png(filename.strip())
    except (OSError, ValueError) as e:
        print(f"warning: could not read texture '{filename.strip()}': {e}")
        return None


def load_obj(filename: str, silent: bool = True,
             external_texture_filename: Optional[str] = None) -> ObjData:
    """Parse an OBJ file (plus its MTL/texture) into flat arrays."""
    native = _try_native(filename, silent, external_texture_filename)
    if native is not None:
        return native
    return _load_obj_python(filename, silent, external_texture_filename)


def _load_obj_python(filename: str, silent: bool = True,
                     external_texture_filename: Optional[str] = None) -> ObjData:
    vertices: List[List[float]] = []
    texture_coords: List[List[float]] = []
    normals: List[List[float]] = []
    faces_v: List[List[int]] = []
    faces_vt: Optional[List[List[int]]] = []
    faces_vn: Optional[List[List[int]]] = []

    texture = (read_texture_file(external_texture_filename)
               if external_texture_filename is not None else None)

    with open(filename.strip(), "r") as f:
        line_index = 0
        for line in f:
            try:
                if line == "" or line[0] == "#":
                    continue
                parts = line.split(" ", 1)
                if len(parts) != 2:
                    continue
                command, data = parts

                if command == "v":
                    vertices.append(_read_vertex(data))
                elif command == "vt":
                    texture_coords.append(_read_texture_coord(data))
                elif command == "vn":
                    normals.append(_read_normal(data))
                elif command == "f":
                    tv, tvt, tvn = _read_face(data)
                    faces_v.extend(tv)
                    if tvt.count(None) > 0:
                        faces_vt = None
                    if faces_vt is not None:
                        faces_vt.extend(tvt)
                    if tvn.count(None) > 0:
                        faces_vn = None
                    if faces_vn is not None:
                        faces_vn.extend(tvn)
                elif command == "mtllib" and texture is None:
                    mtl_path = (_obj_dir(filename) if data[0] != "/" else "") + data
                    image_filename = read_material_file(mtl_path, filename.strip())
                    if image_filename is not None:
                        image_filename = ((_obj_dir(filename)
                                           if image_filename[0] != "/" else "")
                                          + image_filename)
                        texture = read_texture_file(image_filename)
                line_index += 1
            except Exception as e:
                if not silent:
                    raise RuntimeError(
                        f'malformed OBJ line {line_index + 1} in '
                        f'"{filename}"') from e

    return _finalize(vertices, texture_coords, normals,
                     faces_v, faces_vt, faces_vn, texture)


def _finalize(vertices, texture_coords, normals,
              faces_v, faces_vt, faces_vn, texture) -> ObjData:
    arr_vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    arr_faces_v = np.asarray(faces_v, dtype=np.int32).reshape(-1, 3)

    arr_tc = (np.asarray(texture_coords, dtype=np.float32)
              if texture_coords else None)
    arr_n = (np.asarray(normals, dtype=np.float32).reshape(-1, 3)
             if normals else None)
    arr_fvt = (np.asarray(faces_vt, dtype=np.int32).reshape(-1, 3)
               if faces_vt else None)
    arr_fvn = (np.asarray(faces_vn, dtype=np.int32).reshape(-1, 3)
               if faces_vn else None)

    return ObjData(vertices=arr_vertices, texture_coords=arr_tc, normals=arr_n,
                   faces_v=arr_faces_v, faces_vt=arr_fvt, faces_vn=arr_fvn,
                   texture=texture)


# --------------------------------------------------------------------------
# Native (C++) fast path
# --------------------------------------------------------------------------

def _try_native(filename: str, silent: bool,
                external_texture_filename: Optional[str]) -> Optional[ObjData]:
    """Use the C++ parser for the line-scanning hot loop when available.

    The native parser handles the v/vt/vn/f records; mtllib resolution and
    texture loading stay in Python (they are one-shot file reads).
    Returns None when the shared library is absent or parsing fails.

    Strict mode (``silent=False``) always uses the Python parser: the C++
    scanner skips malformed lines without reporting them, so it cannot
    honor the reference's raise-on-first-error contract (model.py:70-73),
    and strict parses are an error-checking path where the speedup is
    irrelevant.
    """
    if not silent:
        return None
    try:
        from ..native import objparse_native
    except Exception:
        return None
    if not objparse_native.available():
        return None
    try:
        parsed = objparse_native.parse(filename.strip())
    except Exception:
        if not silent:
            raise
        return None
    if parsed is None:
        return None
    (vertices, texture_coords, normals, faces_v, faces_vt, faces_vn,
     mtllib_names) = parsed

    texture = (read_texture_file(external_texture_filename)
               if external_texture_filename is not None else None)
    for data in mtllib_names:
        if texture is not None:
            break
        mtl_path = (_obj_dir(filename) if not data.startswith("/") else "") + data
        image_filename = read_material_file(mtl_path, filename.strip())
        if image_filename is not None:
            image_filename = ((_obj_dir(filename)
                               if image_filename[0] != "/" else "")
                              + image_filename)
            texture = read_texture_file(image_filename)

    return ObjData(
        vertices=vertices,
        texture_coords=texture_coords if texture_coords is not None and len(texture_coords) else None,
        normals=normals if normals is not None and len(normals) else None,
        faces_v=faces_v,
        faces_vt=faces_vt,
        faces_vn=faces_vn,
        texture=texture,
    )
