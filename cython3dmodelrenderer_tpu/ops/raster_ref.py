"""Pure-jnp rasterizer — deterministic z-resolve, no locks.

This is the plain XLA backend and the semantic oracle for the tile kernel
(``ops/raster_pallas.py``). It reproduces the reference rasterization rules
(``crender/py/pixel_buffer_filler/advanced_pixel_buffer_filler.py:108-240``):

* candidate pixels = the ceil-based bounding box, clipped to the image
  (py filler:131-134): ``x ∈ [clip(ceil(min x)), clip(ceil(max x)))``;
* coverage = all three barycentric coordinates ≥ 0 (py filler:176-185), with
  each λ computed by the reference's own edge formula (one independent
  denominator per λ);
* depth = ``λ · z`` with the [0, 1] range check (py filler:224-227);
* depth resolve = **strict <** z-test. The reference serializes writes (py) or
  locks pixels (cy, with a check-then-act race — pyx:223 vs 233). Here the
  winner of every pixel is the lexicographic minimum of ``(z, priority)`` over
  all covering fragments — equivalent to the sequential strict-< semantics
  (earliest triangle wins depth ties) but order-free, deterministic, and
  race-free by construction.

Two-phase design keeps memory bounded: phase 1 scans triangle chunks,
expanding each triangle over a static BxB bounding-box window and scatter-
minimizing ``(z, priority)`` per pixel; phase 2 (``resolve``, shared with the
tile kernel) gathers the single winning triangle per pixel and recomputes its
barycentric interpolation (same formula and inputs as the fragment's) to emit
color/normal/depth G-buffers.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig

INT_MAX = jnp.iinfo(jnp.int32).max


def bbox_ceil(tri_xy: jnp.ndarray, width: int, height: int):
    """Clipped ceil-based bbox per triangle (reference py filler:131-134).

    tri_xy: (T, 3, 2) screen xy. Returns (xl, xr, yl, yr) int32 arrays; the
    candidate pixel range is [xl, xr) × [yl, yr).
    """
    x = tri_xy[..., 0]
    y = tri_xy[..., 1]
    xl = jnp.clip(jnp.ceil(jnp.min(x, axis=1)), 0, width).astype(jnp.int32)
    xr = jnp.clip(jnp.ceil(jnp.max(x, axis=1)), 0, width).astype(jnp.int32)
    yl = jnp.clip(jnp.ceil(jnp.min(y, axis=1)), 0, height).astype(jnp.int32)
    yr = jnp.clip(jnp.ceil(jnp.max(y, axis=1)), 0, height).astype(jnp.int32)
    return xl, xr, yl, yr


def barycentric(tri_xy: jnp.ndarray, px: jnp.ndarray, py: jnp.ndarray):
    """The reference's three-lambda edge formula (py filler:176-178).

    tri_xy: (..., 3, 2); px/py broadcastable against the leading dims.
    Returns (l0, l1, l2), each shaped like px.
    """
    return barycentric_xy(tri_xy[..., 0, 0], tri_xy[..., 0, 1],
                          tri_xy[..., 1, 0], tri_xy[..., 1, 1],
                          tri_xy[..., 2, 0], tri_xy[..., 2, 1], px, py)


def barycentric_xy(x0, y0, x1, y1, x2, y2, px, py):
    """``barycentric`` on separate vertex coordinates (broadcastable).

    The tile kernel evaluates the same expressions, so both backends test
    coverage with one formula.
    """
    l0 = ((x1 - x2) * (py - y2) - (y1 - y2) * (px - x2)) / \
         ((x1 - x2) * (y0 - y2) - (y1 - y2) * (x0 - x2))
    l1 = ((x2 - x0) * (py - y0) - (y2 - y0) * (px - x0)) / \
         ((x2 - x0) * (y1 - y0) - (y2 - y0) * (x1 - x0))
    l2 = ((x0 - x1) * (py - y1) - (y0 - y1) * (px - x1)) / \
         ((x0 - x1) * (y2 - y1) - (y0 - y1) * (x2 - x1))
    return l0, l1, l2


@partial(jax.jit, static_argnames=("config", "bbox_size", "chunk"))
def rasterize(tris_screen: jnp.ndarray,
              colors: jnp.ndarray,
              normals: jnp.ndarray,
              active: jnp.ndarray,
              config: RenderConfig,
              bbox_size: int = 64,
              chunk: int = 512) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Rasterize projected triangles into (color, z, normal) G-buffers.

    Args:
      tris_screen: (T, 3, 3) screen-space vertices (x, y, depth).
      colors:      (T, 3, 3) per-vertex colors (float, 0..255, BGR).
      normals:     (T, 3, 3) per-vertex normals.
      active:      (T,) bool — False for culled triangles.
      config:      static render config (image size, z clear value).
      bbox_size:   static per-triangle window side; triangles with a larger
                   clipped bbox are handled by the caller choosing a bigger
                   bucket (see ``required_bbox_size``).
      chunk:       static triangles per scan step.

    Triangle index doubles as priority: on exact depth ties the lowest index
    wins, matching sequential first-writer-stays semantics.

    Returns (color (H, W, 3) f32, z (H, W, 1) f32 init 1e6, normal (H, W, 3) f32).
    """
    h, w = config.height, config.width
    hw = h * w
    t = tris_screen.shape[0]
    b = bbox_size

    # Pad T to a (nonzero) multiple of chunk with inactive triangles.
    t_pad = -(-max(t, 1) // chunk) * chunk
    pad = t_pad - t
    if pad:
        tris_screen = jnp.pad(tris_screen, ((0, pad), (0, 0), (0, 0)))
        active = jnp.pad(active, (0, pad))

    prio = jnp.arange(t_pad, dtype=jnp.int32)

    xl, xr, yl, yr = bbox_ceil(tris_screen[..., :2], w, h)

    def scan_body(carry, chunk_idx):
        zbuf, pbuf = carry
        s = chunk_idx * chunk
        ts = jax.lax.dynamic_slice_in_dim(tris_screen, s, chunk)
        act = jax.lax.dynamic_slice_in_dim(active, s, chunk)
        cxl = jax.lax.dynamic_slice_in_dim(xl, s, chunk)
        cxr = jax.lax.dynamic_slice_in_dim(xr, s, chunk)
        cyl = jax.lax.dynamic_slice_in_dim(yl, s, chunk)
        cyr = jax.lax.dynamic_slice_in_dim(yr, s, chunk)
        cprio = jax.lax.dynamic_slice_in_dim(prio, s, chunk)

        # Fragment grid: (C, B, B) pixel coordinates offset from each bbox.
        di = jax.lax.broadcasted_iota(jnp.int32, (chunk, b, b), 1)   # rows
        dj = jax.lax.broadcasted_iota(jnp.int32, (chunk, b, b), 2)   # cols
        pyi = cyl[:, None, None] + di
        pxi = cxl[:, None, None] + dj
        in_bbox = (pxi < cxr[:, None, None]) & (pyi < cyr[:, None, None])

        pxf = pxi.astype(jnp.float32)
        pyf = pyi.astype(jnp.float32)
        l0, l1, l2 = barycentric(ts[..., :2][:, None, None], pxf, pyf)
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        z = (l0 * ts[:, None, None, 0, 2] + l1 * ts[:, None, None, 1, 2]
             + l2 * ts[:, None, None, 2, 2])
        z_ok = (z >= 0.0) & (z <= 1.0)

        good = in_bbox & inside & z_ok & act[:, None, None]
        idx = jnp.where(good, pyi * w + pxi, hw).reshape(-1)
        zflat = jnp.where(good, z, jnp.inf).reshape(-1)

        # Per-pixel min depth for this chunk, then min priority at that depth.
        zc = jnp.full(hw + 1, jnp.inf, jnp.float32).at[idx].min(zflat)[:hw]
        zc_at = zc[jnp.clip(idx, 0, hw - 1)]
        is_cand = (idx < hw) & (zflat == zc_at)
        pflat = jnp.where(is_cand,
                          jnp.broadcast_to(cprio[:, None, None], good.shape).reshape(-1),
                          INT_MAX)
        pc = jnp.full(hw + 1, INT_MAX, jnp.int32).at[idx].min(pflat)[:hw]

        # Merge into the carry: strict < beats, ties keep earlier chunk
        # (priorities increase monotonically across chunks).
        better = zc < zbuf
        zbuf = jnp.where(better, zc, zbuf)
        pbuf = jnp.where(better, pc, pbuf)
        return (zbuf, pbuf), None

    # Seed the carry from a (possibly device-varying) input so the scan is
    # legal inside shard_map: the carry must have the same varying-axes type
    # as the body output. `active` is bool — never NaN — so this is a no-op
    # numerically (sum, not [0]: must also work for empty triangle lists).
    vary_f = jnp.float32(0) * jnp.sum(active.astype(jnp.float32))
    vary_i = jnp.int32(0) * jnp.sum(active.astype(jnp.int32))
    zbuf0 = jnp.full(hw, jnp.inf, jnp.float32) + vary_f
    pbuf0 = jnp.full(hw, INT_MAX, jnp.int32) + vary_i
    (_zbuf, pbuf), _ = jax.lax.scan(scan_body, (zbuf0, pbuf0),
                                    jnp.arange(t_pad // chunk))

    return resolve(tris_screen, colors, normals, pbuf, config)


def resolve(tris_screen, colors, normals, pbuf, config: RenderConfig):
    """Phase 2: gather each pixel's winning triangle, interpolate attributes.

    ``pbuf`` is the (H*W,) winning triangle index per pixel (``INT_MAX`` =
    no triangle). Depth is re-evaluated from the winner's barycentrics with
    the phase-1 fragment formula, so it is the winning fragment's depth.
    Returns (color (H, W, 3), z (H, W, 1), normal (H, W, 3)) float32.
    """
    h, w = config.height, config.width
    if colors.shape[0] == 0:   # empty scene → background everywhere
        return (jnp.zeros((h, w, 3), jnp.float32),
                jnp.full((h, w, 1), config.z_init, jnp.float32),
                jnp.zeros((h, w, 3), jnp.float32))
    has = pbuf != INT_MAX
    win = jnp.where(has, pbuf, 0)

    twin = tris_screen[win]                       # (HW, 3, 3)
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1).reshape(-1).astype(jnp.float32)
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0).reshape(-1).astype(jnp.float32)
    l0, l1, l2 = barycentric(twin[..., :2], px, py)
    bar = jnp.stack([l0, l1, l2], axis=-1)        # (HW, 3)
    z = l0 * twin[:, 0, 2] + l1 * twin[:, 1, 2] + l2 * twin[:, 2, 2]

    # colors/normals are indexed by the *unpadded* triangle table; winners
    # always point at real triangles (padded ones are inactive).
    win_c = jnp.clip(win, 0, colors.shape[0] - 1)
    cwin = colors[win_c]                          # (HW, 3, 3)
    nwin = normals[win_c]
    interp_c = jnp.einsum("pk,pkd->pd", bar, cwin, precision="highest")
    interp_n = jnp.einsum("pk,pkd->pd", bar, nwin, precision="highest")

    color = jnp.where(has[:, None], interp_c, 0.0).reshape(h, w, 3)
    normal = jnp.where(has[:, None], interp_n, 0.0).reshape(h, w, 3)
    zout = jnp.where(has, z, config.z_init).reshape(h, w, 1)
    return color, zout, normal


def required_bbox_size(tris_screen: jnp.ndarray, active: jnp.ndarray,
                       config: RenderConfig, bucket: int = 32) -> int:
    """Smallest bucketed static bbox window covering all active triangles.

    Host-sync helper: call outside jit, round up to multiples of ``bucket`` so
    recompiles are rare across frames.
    """
    if tris_screen.shape[0] == 0:
        return bucket
    need = max(int(max_bbox_side(tris_screen, active, config)), 1)
    return -(-need // bucket) * bucket


def max_bbox_side(tris_screen: jnp.ndarray, active: jnp.ndarray,
                  config: RenderConfig):
    """Device scalar: the largest clipped bbox side over active triangles —
    the ``bbox_size`` a frame needs to drop no fragment."""
    xl, xr, yl, yr = bbox_ceil(tris_screen[..., :2], config.width, config.height)
    wmax = jnp.max(jnp.where(active, xr - xl, 0))
    hmax = jnp.max(jnp.where(active, yr - yl, 0))
    return jnp.maximum(wmax, hmax)
