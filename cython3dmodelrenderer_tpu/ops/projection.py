"""Geometry stage: batched perspective projection + culling masks.

The reference projects one 3x4 matrix per triangle inside the per-triangle
loop (``crender/py/pixel_buffer_filler/advanced_pixel_buffer_filler.py:84-105``)
or an OpenMP prange over triangles
(``crender/cy/pixel_buffer_filler/advanced_pixel_buffer_filler.pyx:106-130``).
Here the *whole model* is projected with one ``[T·3, 4] @ [4, 4]`` matmul
(float32 at ``precision="highest"``) and both culling predicates become vectorized masks:

* degenerate cull: 2D cross of the unprojected triangle's edges == 0
  (reference py filler:59-61);
* backface cull: ``dot([0,0,1], mean(vertex normals)) >= 0``
  (reference py filler:66-68, cy pyx:202-204).

Projection math (py filler:28-37, 84-105): ``f = 1/tan(fov/2)``, ``a = h/w``,
``q = z_far/(z_far - z_near)``; homogeneous multiply, perspective divide by
w' (= the original z), then NDC → screen ``(x+1)·w/2, (y+1)·h/2``; depth maps
to ``q·(z - z_near)/z`` ∈ [0, 1] over the clip range.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig


def projection_matrix(config: RenderConfig) -> jnp.ndarray:
    """The reference's 4x4 row-vector projection matrix (py filler:28-37)."""
    f = 1.0 / np.tan(config.fov / 2.0 / 180.0 * np.pi)
    a = config.aspect
    q = config.z_far / (config.z_far - config.z_near)
    return jnp.array([
        [f / a, 0.0, 0.0, 0.0],
        [0.0,   f,   0.0, 0.0],
        [0.0,   0.0, q,   1.0],
        [0.0,   0.0, -config.z_near * q, 0.0],
    ], dtype=jnp.float32)


def project_to_screen(tri_vertices: jnp.ndarray,
                      config: RenderConfig) -> jnp.ndarray:
    """Project (T, 3, 3) model-space triangles to (T, 3, 3) screen coords.

    Output per vertex: (x_screen, y_screen, depth) with depth in [0, 1] for
    points inside the clip range. One batched matmul replaces the
    reference's per-triangle ``np.dot`` / OpenMP prange.
    """
    t = tri_vertices.shape[0]
    v = tri_vertices.reshape(t * 3, 3).astype(jnp.float32)
    homo = jnp.concatenate([v, jnp.ones((t * 3, 1), dtype=jnp.float32)], axis=1)
    # full-f32 matmul: screen coordinates need all 24 mantissa bits
    p = jnp.matmul(homo, projection_matrix(config), precision="highest")
    w = p[:, 3:4]                                      # original z
    xyz = p[:, :3] / w                                 # perspective divide
    x = (xyz[:, 0] + 1.0) * (config.width / 2.0)
    y = (xyz[:, 1] + 1.0) * (config.height / 2.0)
    z = xyz[:, 2]
    return jnp.stack([x, y, z], axis=1).reshape(t, 3, 3)


def visibility_masks(tri_vertices: jnp.ndarray,
                     tri_normals: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Vectorized culling predicates on *unprojected* triangles.

    Returns (degenerate, backfacing) boolean masks of shape (T,).
    A triangle is rasterized iff ``~degenerate & ~backfacing``.
    """
    e1 = tri_vertices[:, 1, :2] - tri_vertices[:, 0, :2]
    e2 = tri_vertices[:, 2, :2] - tri_vertices[:, 0, :2]
    cross = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    degenerate = cross == 0.0                          # py filler:59-61

    mean_nz = jnp.mean(tri_normals[:, :, 2], axis=1)
    backfacing = mean_nz >= 0.0                        # py filler:66-68
    return degenerate, backfacing
