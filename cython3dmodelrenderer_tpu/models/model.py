"""Scene model: device-resident geometry + transforms.

API-compatible with the reference ``Model``
(``crender/py/data_structures/model.py:118-328``): ``read_model``,
``shift/scale/rotate``, ``get_triangle/get_vertex``,
``get_mean_vertex/get_max_span``, ``n_triangles/n_vertices``.

Differences from the reference:

* all geometry lives as jnp device arrays (struct-of-arrays); transforms are
  jitted whole-pool ops instead of per-vertex Python;
* the O(T·V) pure-Python vertex-normal loop (reference ``model.py:173-187``)
  becomes a vectorized gather/scan over a precompiled incidence table
  (see ``ops/transforms.vertex_normals``);
* per-vertex colors are pre-sampled from the texture at load time exactly like
  the reference (nearest neighbor, V flip, clip — ``model.py:147-150``) but are
  stored as float32 on device (the compiled reference renderer does the same
  cast, ``crender/cy/data_structures/model.py:144-150``).
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..ops import transforms as T
from . import obj_io


class Model:
    @staticmethod
    def read_model(filename: str, silent: bool = True,
                   external_texture_filename: Optional[str] = None,
                   recalculate_normals: bool = True,
                   invert_calculated_normals: bool = False) -> "Model":
        data = obj_io.load_obj(filename, silent=silent,
                               external_texture_filename=external_texture_filename)
        return Model(data.vertices, data.faces_v,
                     texture_coords=data.texture_coords,
                     triangles_texture_coords=data.faces_vt,
                     texture=data.texture,
                     normals=data.normals,
                     triangles_normals=data.faces_vn,
                     recalculate_normals=recalculate_normals,
                     invert_calculated_normals=invert_calculated_normals)

    def __init__(self, vertices, triangles_vertices,
                 texture_coords=None, triangles_texture_coords=None,
                 texture=None, normals=None, triangles_normals=None,
                 recalculate_normals: bool = True,
                 invert_calculated_normals: bool = False):
        vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
        faces_v = np.asarray(triangles_vertices, dtype=np.int32).reshape(-1, 3)
        n_verts = len(vertices)
        # Resolve relative (negative) indices once so device gathers are plain.
        faces_v = np.where(faces_v < 0, faces_v + n_verts, faces_v).astype(np.int32)

        self._vertices = jnp.asarray(vertices)
        self._faces_v = jnp.asarray(faces_v)

        # Topology → incidence table, compiled once (static shapes for jit).
        inc, inc_valid = T.build_incidence(faces_v, n_verts)
        self._incidence = jnp.asarray(inc)
        self._incidence_valid = jnp.asarray(inc_valid)

        self._invert_calculated_normals = invert_calculated_normals

        if normals is not None and triangles_normals is not None:
            file_normals = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
            faces_vn = np.asarray(triangles_normals, dtype=np.int32).reshape(-1, 3)
            faces_vn = np.where(faces_vn < 0, faces_vn + len(file_normals),
                                faces_vn).astype(np.int32)
            self._file_normals = jnp.asarray(file_normals)
            self._file_faces_vn = jnp.asarray(faces_vn)
        else:
            self._file_normals = None
            self._file_faces_vn = None

        self._set_normals(recalculate_normals)
        self._refresh_stats()

        # --- texture → per-vertex colors (reference model.py:135-150)
        if texture_coords is None or triangles_texture_coords is None or texture is None:
            self._texture_coords = None
            self._faces_vt = None
            self._texture = None
            self._colors = None
        else:
            tc = np.asarray(texture_coords, dtype=np.float32)
            faces_vt = np.asarray(triangles_texture_coords, dtype=np.int32).reshape(-1, 3)
            faces_vt = np.where(faces_vt < 0, faces_vt + len(tc), faces_vt).astype(np.int32)
            tex = np.asarray(texture)
            h, w = tex.shape[0], tex.shape[1]
            # Nearest-neighbor sample at (u, 1-v), clipped — model.py:147-150.
            rows = np.clip(((1.0 - tc[:, 1]) * h).astype("int32"), 0, h - 1)
            cols = np.clip((tc[:, 0] * w).astype("int32"), 0, w - 1)
            colors = tex[rows, cols].astype(np.float32)
            self._texture_coords = jnp.asarray(tc)
            self._faces_vt = jnp.asarray(faces_vt)
            self._texture = jnp.asarray(tex)
            self._colors = jnp.asarray(colors)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _invalidate_caches(self) -> None:
        self._vbt_cache = None
        self._nbt_cache = None

    def _set_normals(self, recalculate: bool) -> None:
        if not recalculate and self._file_normals is not None:
            self._normals = self._file_normals
            self._faces_n = self._file_faces_vn
        else:
            n = T.vertex_normals(self._vertices, self._faces_v,
                                 self._incidence, self._incidence_valid)
            if self._invert_calculated_normals:
                n = -n
            self._normals = n
            self._faces_n = self._faces_v

    def _refresh_stats(self) -> None:
        self._mean_vertex, self._max_span = T.mean_and_span(self._vertices)

    def _update_vertices(self, new_vertices: jnp.ndarray,
                         recalculate_normals: bool) -> None:
        self._vertices = new_vertices
        self._invalidate_caches()
        if recalculate_normals:
            n = T.vertex_normals(self._vertices, self._faces_v,
                                 self._incidence, self._incidence_valid)
            if self._invert_calculated_normals:
                n = -n
            self._normals = n
            self._faces_n = self._faces_v
        self._refresh_stats()

    # ------------------------------------------------------------------
    # transforms (reference model.py:212-255)
    # ------------------------------------------------------------------

    def shift(self, shift) -> None:
        self._update_vertices(T.shift(self._vertices, shift),
                              recalculate_normals=False)

    def scale(self, scale_coef, keep_position: bool = True) -> None:
        self._update_vertices(
            T.scale(self._vertices, scale_coef, mean_vertex=self._mean_vertex,
                    keep_position=keep_position),
            recalculate_normals=False)

    def rotate(self, angles) -> None:
        assert len(angles) == 3
        self._update_vertices(T.rotate(self._vertices, angles),
                              recalculate_normals=True)

    # ------------------------------------------------------------------
    # batched accessors (the device pipeline feeds on these) — cached: the
    # gathers are device ops, and re-dispatching them per frame adds a
    # dispatch to every frame. Caches invalidate on transforms.
    # ------------------------------------------------------------------

    @property
    def vertices(self) -> jnp.ndarray:
        return self._vertices

    @property
    def normals(self) -> jnp.ndarray:
        return self._normals

    @property
    def vertices_by_triangles(self) -> jnp.ndarray:
        if getattr(self, "_vbt_cache", None) is None:
            self._vbt_cache = self._vertices[self._faces_v]
        return self._vbt_cache

    @property
    def normals_by_triangles(self) -> jnp.ndarray:
        if getattr(self, "_nbt_cache", None) is None:
            self._nbt_cache = self._normals[self._faces_n]
        return self._nbt_cache

    @property
    def colors_by_triangles(self) -> Optional[jnp.ndarray]:
        if self._colors is None:
            return None
        if getattr(self, "_cbt_cache", None) is None:
            self._cbt_cache = self._colors[self._faces_vt]
        return self._cbt_cache

    @property
    def texture(self) -> Optional[jnp.ndarray]:
        return self._texture

    # ------------------------------------------------------------------
    # reference-compatible scalar accessors
    # ------------------------------------------------------------------

    def get_vertex(self, index: int):
        colors = None
        if self._colors is not None:
            colors = np.asarray(self._colors[index])
        return (np.asarray(self._vertices[index]), colors,
                np.asarray(self._normals[index]))

    def get_triangle(self, index: int):
        colors = None
        if self._colors is not None:
            colors = np.asarray(self.colors_by_triangles[index])
        return (np.asarray(self.vertices_by_triangles[index]), colors,
                np.asarray(self.normals_by_triangles[index]))

    def n_triangles(self) -> int:
        return int(self._faces_v.shape[0])

    def n_vertices(self) -> int:
        return int(self._vertices.shape[0])

    def get_mean_vertex(self) -> np.ndarray:
        return np.asarray(self._mean_vertex)

    def get_max_span(self) -> float:
        return float(self._max_span)


def fit_model(model: Model) -> None:
    """Center, unit-scale and push to z=1 (reference ``run.py:30-33``)."""
    model.shift(-model.get_mean_vertex())
    model.scale(1.0 / model.get_max_span())
    model.shift([0.0, 0.0, 1.0])
