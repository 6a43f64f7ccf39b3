"""Tile rasterizer — a Pallas kernel on the Triton route, lock-free.

This is the production backend replacing the reference's OpenMP scanline loop
with per-pixel locks (``crender/cy/.../advanced_pixel_buffer_filler.pyx:
177-242``). Design:

* the image is a grid of ``TILE_H x TILE_W`` tiles and the kernel runs one
  program per tile — no two programs ever write the same pixel, so the
  z-race the reference locks against (and still gets wrong — pyx:223 vs
  233) cannot exist;
* triangles arrive pre-binned per tile (``ops/binning.py``); each program
  reads its own bin start and length and walks the bin in chunks of
  ``CHUNK`` candidates with masked loads of the candidates' screen
  vertices, depths and ceil-bboxes;
* coverage, depth and the depth test are the oracle's own formulas
  (``raster_ref.barycentric_xy``, ``z = Σ λ_i z_i``, ``z ∈ [0, 1]``, the
  clipped ceil-bbox), evaluated for a (pixels x candidates) block with
  plain float32 arithmetic — no dot products, so no reduced-precision
  tensor-core math;
* the depth resolve is a running lexicographic (z, triangle index) minimum
  kept in registers: strict ``<`` beats, and on an exact tie the lower
  triangle index wins — the sequential first-writer semantics of the
  reference, since every bin is sorted by triangle index;
* the kernel writes only each pixel's winning triangle index; the XLA
  epilogue (``raster_ref.resolve``) gathers the winner and interpolates
  color, normal and depth exactly as the oracle does.

Binning has a static pair capacity ``p_cap``; ``rasterize`` returns the
frame's pair total so callers can detect (and repair) a frame whose pairs
overflowed it.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..config import RenderConfig
from . import binning, raster_ref

# Tile sides and the chunk are powers of two (Triton block dims). 16x32
# tiles with 8-candidate chunks on 4 warps measured fastest among the
# shapes tried on an H100 (16x16, 8x32, 16x32, 32x32; chunks 8 and 16).
TILE_H = 16
TILE_W = 32
CHUNK = 8
NUM_WARPS = 4
NUM_STAGES = 1

# candidate table rows: screen x/y of the three vertices, their depths and
# the clipped ceil-bbox [xl, xr) x [yl, yr) (small integers, exact in f32)
_X0, _Y0, _X1, _Y1, _X2, _Y2, _Z0, _Z1, _Z2, _XL, _XR, _YL, _YR = range(13)


def _raster_kernel(starts_ref, counts_ref, geo_ref, tri_ref, out_ref, *,
                   ntx: int):
    """One tile: lexicographic (z, triangle) minimum over the tile's bin."""
    i = pl.program_id(0)
    start = starts_ref[i]
    count = counts_ref[i]
    n_pix = TILE_H * TILE_W
    p = jax.lax.broadcasted_iota(jnp.int32, (n_pix, 1), 0)
    px = ((i % ntx) * TILE_W + p % TILE_W).astype(jnp.float32)
    py = ((i // ntx) * TILE_H + p // TILE_W).astype(jnp.float32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (CHUNK,), 0)

    def body(j, carry):
        zacc, tacc = carry
        off = start + j * CHUNK
        valid = j * CHUNK + lane < count

        def row(r):
            v = pltriton.load(geo_ref.at[r, pl.ds(off, CHUNK)], mask=valid,
                              other=0.0)
            return v[None, :]

        tri = pltriton.load(tri_ref.at[pl.ds(off, CHUNK)], mask=valid,
                            other=raster_ref.INT_MAX)[None, :]
        l0, l1, l2 = raster_ref.barycentric_xy(
            row(_X0), row(_Y0), row(_X1), row(_Y1), row(_X2), row(_Y2),
            px, py)
        z = l0 * row(_Z0) + l1 * row(_Z1) + l2 * row(_Z2)
        good = ((l0 >= 0) & (l1 >= 0) & (l2 >= 0)
                & (px >= row(_XL)) & (px < row(_XR))
                & (py >= row(_YL)) & (py < row(_YR))
                & (z >= 0.0) & (z <= 1.0) & valid[None, :])
        zc = jnp.where(good, z, jnp.inf)
        zmin = jnp.min(zc, axis=1)
        tmin = jnp.min(jnp.where(zc == zmin[:, None], tri, raster_ref.INT_MAX),
                       axis=1)
        # chunks walk the bin in ascending triangle order: strict < keeps
        # the earlier triangle on an exact tie across chunks
        better = zmin < zacc
        return jnp.where(better, zmin, zacc), jnp.where(better, tmin, tacc)

    init = (jnp.full((n_pix,), jnp.inf, jnp.float32),
            jnp.full((n_pix,), raster_ref.INT_MAX, jnp.int32))
    _, tacc = jax.lax.fori_loop(0, (count + CHUNK - 1) // CHUNK, body, init)
    out_ref[...] = tacc


def _raster_tiles(geo, tri, tile_starts, tile_counts, ntx: int, nty: int,
                  interpret: bool):
    """Run the tile kernel; returns (n_tiles, TILE_H * TILE_W) winners."""
    n_pix = TILE_H * TILE_W
    return pl.pallas_call(
        functools.partial(_raster_kernel, ntx=ntx),
        out_shape=jax.ShapeDtypeStruct((ntx * nty, n_pix), jnp.int32),
        grid=(ntx * nty,),
        out_specs=pl.BlockSpec((None, n_pix), lambda i: (i, 0)),
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=NUM_STAGES),
        interpret=interpret,
        name="raster_tiles",
    )(tile_starts, tile_counts, geo, tri)


def tile_grid(config: RenderConfig):
    """(ntx, nty): tile columns and rows covering the image."""
    return -(-config.width // TILE_W), -(-config.height // TILE_H)


def pair_total(tris_screen, active, config: RenderConfig):
    """Device scalar: (tile, triangle) pairs a frame bins — what ``p_cap``
    must cover."""
    return jnp.sum(binning.tile_spans(tris_screen, active, config,
                                      TILE_H, TILE_W)[4])


@functools.partial(jax.jit, static_argnames=("config", "p_cap", "interpret"))
def rasterize(tris_screen, colors, normals, active, config: RenderConfig,
              p_cap: int, interpret: bool = False):
    """Rasterize projected triangles into (color, z, normal) G-buffers.

    Same semantics as ``raster_ref.rasterize`` (ceil bbox, λ ≥ 0 coverage,
    z ∈ [0, 1], strict-< depth with first-writer ties). ``p_cap`` is the
    static bin capacity; returns ``((color, z, normal), pair_total)`` — the
    frame is complete iff ``pair_total <= p_cap``. ``interpret=True`` runs
    the kernel in the Pallas interpreter (CPU tests).
    """
    ntx, nty = tile_grid(config)
    tx0, cx, ty0, cy, counts = binning.tile_spans(tris_screen, active, config,
                                                  TILE_H, TILE_W)
    slot_tri, tile_starts, tile_counts = binning.bin_pairs(
        tx0, cx, ty0, cy, counts, p_cap, ntx, nty)
    xl, xr, yl, yr = raster_ref.bbox_ceil(tris_screen[..., :2], config.width,
                                          config.height)
    table = jnp.concatenate(
        [tris_screen[:, :, :2].reshape(-1, 6).T, tris_screen[:, :, 2].T,
         jnp.stack([xl, xr, yl, yr]).astype(jnp.float32)], axis=0)  # (13, T)
    # a chunk-sized tail keeps every chunk's slice in bounds (the masked
    # lanes past a bin's end read it but never use it)
    slot_tri = jnp.pad(slot_tri, (0, CHUNK))
    winners = _raster_tiles(table[:, slot_tri], slot_tri, tile_starts,
                            tile_counts, ntx, nty, interpret)
    winners = winners.reshape(nty, ntx, TILE_H, TILE_W).transpose(0, 2, 1, 3)
    winners = winners.reshape(nty * TILE_H, ntx * TILE_W)
    winners = winners[:config.height, :config.width].reshape(-1)
    out = raster_ref.resolve(tris_screen, colors, normals, winners, config)
    return out, jnp.sum(counts)
