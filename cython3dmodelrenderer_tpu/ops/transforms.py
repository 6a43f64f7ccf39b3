"""Model-space transforms and normal computation — functional jnp core.

Matches the reference semantics:

* rotation uses the reference's ``[[c, s], [-s, c]]`` 2x2 blocks assembled into
  Rx·Ry·Rz (degrees) and applies ``v @ Rᵀ``
  (reference ``crender/py/data_structures/model.py:228-255``);
* shift/scale are affine on vertices only; ``scale(keep_position=True)``
  recenters around the mean vertex (``model.py:212-226``);
* vertex normals are recomputed from geometry: face normal
  ``-cross(t1-t0, t1-t2)`` normalized (``model.py:195-200``), vertex normal =
  normalized mean over the *deduplicated* adjacent face normals, where a face
  normal is dropped if its dot with an already-kept one is ``>= 1 - tol``
  (greedy in face order, default tol=0 — ``model.py:173-187``).

The reference recomputes normals with an O(T·V) pure-Python loop; here the
mesh topology is compiled once into a fixed-shape vertex→face incidence table
(host side) and the per-rotation recompute is a fully vectorized jnp program
(gather + pairwise dots + a short scan over the max vertex degree), so it runs
on the device instead of the Python interpreter.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# --------------------------------------------------------------------------
# Rigid-ish transforms (all pure functions of (vertices, params))
# --------------------------------------------------------------------------


def shift(vertices: jnp.ndarray, offset) -> jnp.ndarray:
    """Translate all vertices. Reference ``model.py:212-215``."""
    return vertices + jnp.asarray(offset, dtype=vertices.dtype)


def scale(vertices: jnp.ndarray, scale_coef, mean_vertex=None,
          keep_position: bool = True) -> jnp.ndarray:
    """Scale vertices, optionally about their mean. Reference ``model.py:217-226``."""
    scale_coef = jnp.asarray(scale_coef, dtype=vertices.dtype)
    if keep_position:
        if mean_vertex is None:
            mean_vertex = vertices.mean(axis=0)
        return (vertices - mean_vertex) * scale_coef + mean_vertex
    return vertices * scale_coef


def rotation_matrix(angles, degrees: bool = True) -> jnp.ndarray:
    """Build the reference's Euler XYZ rotation matrix (``model.py:228-251``).

    Each axis block is ``[[cos, sin], [-sin, cos]]`` placed on the remaining
    two coordinates; the combined matrix is ``Rx @ Ry @ Rz``.
    """
    angles = jnp.asarray(angles, dtype=jnp.float32)
    if degrees:
        angles = angles * (jnp.pi / 180.0)
    ax, ay, az = angles[0], angles[1], angles[2]

    def rot2(a):
        c, s = jnp.cos(a), jnp.sin(a)
        return c, s

    cx, sx = rot2(ax)
    cy, sy = rot2(ay)
    cz, sz = rot2(az)
    rx = jnp.array([[1, 0, 0], [0, 0, 0], [0, 0, 0]], jnp.float32).at[1:, 1:].set(
        jnp.stack([jnp.stack([cx, sx]), jnp.stack([-sx, cx])]))
    ry = jnp.eye(3, dtype=jnp.float32).at[0, 0].set(cy).at[0, 2].set(sy) \
        .at[2, 0].set(-sy).at[2, 2].set(cy)
    rz = jnp.eye(3, dtype=jnp.float32).at[:2, :2].set(
        jnp.stack([jnp.stack([cz, sz]), jnp.stack([-sz, cz])]))
    # full-f32 products: default matmul precision may round the inputs
    return jnp.matmul(jnp.matmul(rx, ry, precision="highest"), rz,
                      precision="highest")


def rotate(vertices: jnp.ndarray, angles, degrees: bool = True) -> jnp.ndarray:
    """Rotate vertices: ``v @ Rᵀ`` (reference ``model.py:253``)."""
    r = rotation_matrix(angles, degrees=degrees)
    return jnp.matmul(vertices, r.T, precision="highest")


def mean_and_span(vertices: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mean vertex and max distance from it (reference ``model.py:159-160``)."""
    mean = vertices.mean(axis=0)
    span = jnp.max(jnp.linalg.norm(vertices - mean, axis=-1))
    return mean, span


# --------------------------------------------------------------------------
# Normals
# --------------------------------------------------------------------------


def face_normals(tri_vertices: jnp.ndarray, normalize: bool = True) -> jnp.ndarray:
    """Per-face normals for (T, 3, 3) triangles.

    Reference convention: ``n = -cross(t1 - t0, t1 - t2)`` (``model.py:195-200``),
    normalized with a zero-guard (zero-norm normals pass through unscaled,
    ``model.py:189-193``).
    """
    t0, t1, t2 = tri_vertices[:, 0], tri_vertices[:, 1], tri_vertices[:, 2]
    n = -jnp.cross(t1 - t0, t1 - t2)
    # XLA fuses the cross product into FMAs, so cross(v, v) is ~1e-9 instead
    # of exactly 0 — normalizing that would fabricate a garbage unit normal.
    # NumPy (and the reference) cancel exactly for repeated vertices; zero
    # those faces explicitly.
    same = (jnp.all(t0 == t1, axis=-1) | jnp.all(t1 == t2, axis=-1)
            | jnp.all(t0 == t2, axis=-1))
    n = jnp.where(same[:, None], 0.0, n)
    if normalize:
        n = _normalize_rows(n)
    return n


def _normalize_rows(n: jnp.ndarray) -> jnp.ndarray:
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return jnp.where(norm == 0, n, n / jnp.where(norm == 0, 1.0, norm))


def build_incidence(faces_v: np.ndarray, n_vertices: int) -> Tuple[np.ndarray, np.ndarray]:
    """Compile mesh topology into a (V, D) vertex→face incidence table.

    Host-side, once per topology. ``D`` is the max vertex degree; entries are
    face indices in ascending face order (matching the reference's greedy
    iteration order in ``_compute_normals_by_vertex``), padded with -1.
    Returns (table int32 (V, D), valid mask bool (V, D)).
    """
    faces_v = np.asarray(faces_v)
    t = faces_v.shape[0]
    # (T*3,) incidences: vertex id per corner, face id per corner
    vert_ids = faces_v.reshape(-1)
    # Resolve negative (relative) indices the way NumPy indexing would.
    vert_ids = np.where(vert_ids < 0, vert_ids + n_vertices, vert_ids)
    face_ids = np.repeat(np.arange(t, dtype=np.int64), 3)
    # A vertex repeated within one face contributes once per corner in the
    # reference loop too (it appends the same normal for each corner, but the
    # dedup check removes the duplicates when dot==1; with tol=0 float32 this
    # is not guaranteed — we mirror the corner-level incidence and let the
    # dedup stage decide).
    order = np.argsort(vert_ids, kind="stable")
    vs, fs = vert_ids[order], face_ids[order]
    counts = np.bincount(vs, minlength=n_vertices)
    d = int(counts.max()) if counts.size else 0
    d = max(d, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(vs)) - starts[vs]
    table = np.full((n_vertices, d), -1, dtype=np.int32)
    table[vs, slot] = fs
    return table, table >= 0


@partial(jax.jit, static_argnames=("tol",))
def vertex_normals(vertices: jnp.ndarray, faces_v: jnp.ndarray,
                   incidence: jnp.ndarray, incidence_valid: jnp.ndarray,
                   tol: float = 1e-6) -> jnp.ndarray:
    """Smooth per-vertex normals with the reference's dedup rule, vectorized.

    For each vertex: gather adjacent face normals (in face order), greedily
    drop normal j when some kept normal i<j has ``dot(n_i, n_j) >= 1 - tol``,
    then return ``normalize(mean(kept))`` (zero-guarded). Vertices with no
    incident faces get a zero normal (reference ``model.py:186-187``).

    The reference default is ``tol=0`` with float64 dots — exact-duplicate
    normals dedup only when rounding lands the self-dot at ≥ 1.0. With
    float32-only arithmetic that is a coin flip, so the default here is a
    tiny positive tolerance: bitwise-identical normals always dedup (their
    self-dot is within 1e-7 of 1) and normals closer than ~1e-6 in dot —
    visually indistinguishable — dedup too.
    """
    if faces_v.shape[0] == 0:  # no faces → all-zero normals (reference
        return jnp.zeros_like(vertices)  # model.py:186-187 empty-mean case)

    tri_verts = vertices[faces_v]                      # (T, 3, 3)
    fn = face_normals(tri_verts, normalize=True)       # (T, 3)

    safe_idx = jnp.maximum(incidence, 0)
    adj = fn[safe_idx]                                 # (V, D, 3)
    valid = incidence_valid                            # (V, D)

    # Pairwise dots between incident normals: (V, D, D)
    dots = jnp.einsum("vdc,vec->vde", adj, adj, precision="highest")
    d = adj.shape[1]

    # Greedy keep along the D axis: kept[j] = valid[j] and no kept i<j with
    # dots[i, j] >= 1 - tol. Short sequential recurrence over D (D is small).
    def body(kept, j):
        # earlier kept anchors that collide with j
        collide = (dots[:, :, j] >= 1.0 - tol) & kept & \
            (jnp.arange(d) < j)[None, :]
        keep_j = valid[:, j] & ~jnp.any(collide, axis=1)
        kept = kept.at[:, j].set(keep_j)
        return kept, None

    kept0 = jnp.zeros(valid.shape, dtype=bool)
    kept, _ = jax.lax.scan(body, kept0, jnp.arange(d))

    w = kept.astype(adj.dtype)[..., None]              # (V, D, 1)
    count = jnp.sum(w, axis=1)                         # (V, 1)
    mean = jnp.sum(adj * w, axis=1) / jnp.maximum(count, 1.0)
    mean = jnp.where(count > 0, mean, 0.0)
    return _normalize_rows(mean)
