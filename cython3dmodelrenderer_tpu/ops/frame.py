"""One frame body: cull → project → rasterize → (shade, quantize).

Shared by ``AdvancedPixelBufferFiller`` (single frames), the pose sweeps and
the sharded renders in ``parallel.multiview``, so every entry point runs the
same rasterizer. Two backends:

* ``"pallas"`` — the tile kernel (``raster_pallas``); its static capacity
  ``cap`` is the bin-pair capacity;
* ``"jnp"`` — the plain XLA oracle (``raster_ref``); its static capacity is
  the bbox window side.

Either way the frame also returns its *demand*, the value ``cap`` had to
cover; ``demand > cap`` means the frame dropped geometry and must be
re-rendered with ``capacity(demand, backend)``.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from . import binning, raster_pallas, raster_ref
from .illumination import lambert_shade
from .projection import project_to_screen, visibility_masks

BACKENDS = ("pallas", "jnp")


def resolve_backend(backend: str = "auto") -> str:
    """Map ``"auto"`` to a backend for the default JAX platform.

    ``gpu`` → ``"pallas"`` (the tile kernel); ``cpu`` → ``"jnp"`` (the
    oracle: the test platform, where the kernel runs only interpreted).
    Any other platform raises.
    """
    if backend != "auto":
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        return backend
    platform = jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "jnp"
    raise ValueError(f"no rasterizer backend for platform {platform!r}")


def jnp_chunk(bbox: int) -> int:
    """Oracle scan chunk: fragment memory scales as chunk x bbox², so
    large-triangle scenes scan fewer triangles per step."""
    return max(8, min(512, (1 << 20) // (bbox * bbox)))


def demand(tris_screen, active, config: RenderConfig, backend: str):
    """Device scalar the static capacity must cover for this frame."""
    if backend == "pallas":
        return raster_pallas.pair_total(tris_screen, active, config)
    return raster_ref.max_bbox_side(tris_screen, active, config)


def capacity(need: int, backend: str, config: RenderConfig) -> int:
    """Static capacity bucket covering a (host) demand value."""
    if backend == "pallas":
        return binning.capacity_bucket(need, raster_pallas.CHUNK)
    side = -(-max(config.height, config.width) // 32) * 32
    return min(max(-(-need // 32) * 32, 32), side)


def geometry(tri_verts, tri_norms, config: RenderConfig):
    """Culling mask and screen-space triangles: (tris_screen, active)."""
    degenerate, backfacing = visibility_masks(tri_verts, tri_norms)
    return (project_to_screen(tri_verts, config),
            jnp.logical_and(~degenerate, ~backfacing))


@partial(jax.jit, static_argnames=("config", "backend"))
def frame_demand(tri_verts, tri_norms, config: RenderConfig, backend: str):
    """Jitted ``demand`` of raw triangle arrays (one sizing dispatch)."""
    tris_screen, active = geometry(tri_verts, tri_norms, config)
    return demand(tris_screen, active, config, backend)


def frame_body(tri_verts, tri_norms, tri_colors, config: RenderConfig,
               backend: str, cap: int, post: str = "none", light=None,
               interpret: bool = False):
    """Traceable frame: ``(color, z, normal, post_image, demand)``.

    ``post``: "none" (``post_image`` is None), "u8" (quantized color) or
    "lambert_u8" (Lambert-shaded with ``light``, the pre-negated unit light
    direction, then quantized). ``interpret`` runs the tile kernel in the
    Pallas interpreter (CPU tests).
    """
    tris_screen, active = geometry(tri_verts, tri_norms, config)
    if backend == "pallas":
        (color, z, normal), need = raster_pallas.rasterize(
            tris_screen, tri_colors, tri_norms, active, config, p_cap=cap,
            interpret=interpret)
    else:
        color, z, normal = raster_ref.rasterize(
            tris_screen, tri_colors, tri_norms, active, config,
            bbox_size=cap, chunk=jnp_chunk(cap))
        need = raster_ref.max_bbox_side(tris_screen, active, config)
    if post == "none":
        image = None
    elif post == "u8":
        image = color.astype(jnp.uint8)
    elif post == "lambert_u8":
        image = lambert_shade(color, normal, light).astype(jnp.uint8)
    else:
        raise ValueError(f"unknown post mode {post!r}")
    return color, z, normal, image, need


render_frame = jax.jit(frame_body, static_argnames=(
    "config", "backend", "cap", "post", "interpret"))
