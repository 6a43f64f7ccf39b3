"""Triangle → screen-tile binning (the XLA stage feeding the tile kernel).

The reference parallelizes by OpenMP-threading the triangle loop and locking
pixels (``pyx:200,233-242``). The tile formulation inverts control: the image
is cut into tiles, and each tile owns the (sorted, fixed-order) list of
triangles whose clipped ceil-bbox overlaps it. Rasterization then needs no
locks at all — each tile is written by exactly one kernel program.

Stages (all jit, static shapes):

1. ``tile_spans`` — per triangle, the clipped ceil-bbox expressed as a span
   of tiles (empty for culled or off-screen triangles) and its pair count.
2. ``bin_pairs`` — expand triangles into (tile, triangle) pairs over their
   tile span, sort by tile (stable: within a tile, triangle order — and
   hence depth-tie priority — is preserved), and return the triangle index
   of every slot plus each tile's bin start and length. Capacity is a
   static bucket; pairs past it are dropped, and the caller detects that
   from the pair total (``sum(counts) > p_cap``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from .raster_ref import bbox_ceil


def tile_spans(tris_screen: jnp.ndarray, active: jnp.ndarray,
               config: RenderConfig, tile_h: int, tile_w: int):
    """Per-triangle tile spans of the clipped ceil-bbox.

    Returns ``(tx0, cx, ty0, cy, counts)`` int32 (T,) arrays: first tile
    column, column count, first tile row, row count, and ``cx * cy`` pairs.
    Inactive or empty-bbox triangles get a zero span.
    """
    xl, xr, yl, yr = bbox_ceil(tris_screen[..., :2], config.width,
                               config.height)
    nonempty = active & (xr > xl) & (yr > yl)
    tx0 = jnp.where(nonempty, xl // tile_w, 0)
    tx1 = jnp.where(nonempty, (xr - 1) // tile_w, -1)
    ty0 = jnp.where(nonempty, yl // tile_h, 0)
    ty1 = jnp.where(nonempty, (yr - 1) // tile_h, -1)
    cx = jnp.maximum(tx1 - tx0 + 1, 0)
    cy = jnp.maximum(ty1 - ty0 + 1, 0)
    return tx0, cx, ty0, cy, cx * cy


def capacity_bucket(total: int, chunk: int, bucket: int = 4096) -> int:
    """Static pair-capacity bucket: total + a chunk of tail headroom, rounded
    up so frame-to-frame jitter rarely recompiles."""
    return -(-(total + chunk) // bucket) * bucket


def bin_pairs(tx0, cx, ty0, cy, counts, p_cap: int, ntx: int, nty: int):
    """Expand triangle tile spans into (tile, triangle) pairs, sorted by tile.

    Returns ``(slot_tri (p_cap,), tile_starts (n_tiles,), tile_counts
    (n_tiles,))``, all int32: tile ``i``'s bin is
    ``slot_tri[tile_starts[i] : tile_starts[i] + tile_counts[i]]``, in
    ascending triangle order. Slots past the pair total belong to no tile.
    """
    n_tiles = ntx * nty
    csum = jnp.cumsum(counts)
    total = csum[-1]
    starts_excl = jnp.concatenate([jnp.zeros(1, counts.dtype), csum[:-1]])

    p = jnp.arange(p_cap, dtype=jnp.int32)
    # unrolled binary searches: a rolled search is a device while loop,
    # whose per-iteration predicate round trip dominates binning on a GPU
    tri = jnp.searchsorted(starts_excl, p, side="right",
                           method="scan_unrolled").astype(jnp.int32) - 1
    tri = jnp.clip(tri, 0, counts.shape[0] - 1)
    valid = p < total
    within = p - starts_excl[tri]
    cxg = jnp.maximum(cx[tri], 1)
    tx = tx0[tri] + within % cxg
    ty = ty0[tri] + within // cxg
    tile = jnp.where(valid, ty * ntx + tx, n_tiles).astype(jnp.int32)

    # Sort pairs by tile id. The pair index is packed into the low bits so a
    # single-operand UNstable sort yields a stable order (within a tile,
    # pairs keep ascending triangle order → depth ties resolve exactly like
    # the sequential reference) — cheaper than argsort's two-operand sort.
    shift = max(p_cap.bit_length(), 1)
    if shift + (n_tiles + 1).bit_length() <= 31:
        key = (tile << shift) | p
        skey = jax.lax.sort(key, is_stable=False)
        sorted_tile = (skey >> shift).astype(jnp.int32)
        sorted_p = (skey & ((1 << shift) - 1)).astype(jnp.int32)
    else:  # keys would overflow int32 — fall back to a stable argsort
        sorted_p = jnp.argsort(tile, stable=True).astype(jnp.int32)
        sorted_tile = tile[sorted_p]

    tile_ids = jnp.arange(n_tiles, dtype=jnp.int32)
    tile_starts = jnp.searchsorted(sorted_tile, tile_ids, side="left",
                                   method="scan_unrolled").astype(jnp.int32)
    tile_ends = jnp.searchsorted(sorted_tile, tile_ids, side="right",
                                 method="scan_unrolled").astype(jnp.int32)
    return tri[sorted_p], tile_starts, tile_ends - tile_starts
