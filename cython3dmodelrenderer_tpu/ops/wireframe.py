"""Wireframe rendering: vectorized Bresenham line rasterization.

The reference draws triangle edges with classic integer Bresenham stepping via
per-pixel ``Buffer.set_pixel`` calls
(``crender/py/pixel_buffer_filler/edge_only/line_drawer/bresenham/line_bresenham.py:6-45``).
Sequential pixel stepping is hostile to SIMD, but Bresenham has a closed form:
after ``t`` steps the major axis has advanced ``t`` and the minor axis
``m(t) = ceil((2·es·t − el) / (2·el))`` (with ``el = max(|dx|, |dy|)``,
``es = min(|dx|, |dy|)`` and the reference's ``error = el/2`` initialisation),
so every pixel of every line is computed independently on the device. Overwrite
order (later lines win crossings) is reproduced with a per-pixel priority
scatter-max instead of sequential writes.

``LineDrawer`` / ``LineBresenham`` keep the reference's scalar per-line API
(``line_drawer.py:4``) for compatibility.
"""
from __future__ import annotations

from abc import abstractmethod
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


def _line_params(p1: jnp.ndarray, p2: jnp.ndarray):
    """Per-line Bresenham constants. p1/p2: (..., 2) int32."""
    d = p2 - p1
    sign = jnp.sign(d)
    ad = jnp.abs(d)
    major_is_x = ad[..., 0] > ad[..., 1]
    el = jnp.where(major_is_x, ad[..., 0], ad[..., 1])
    es = jnp.where(major_is_x, ad[..., 1], ad[..., 0])
    return sign, el, es, major_is_x


def _floordiv_exact(num_f: jnp.ndarray, num_i: jnp.ndarray,
                    den: jnp.ndarray) -> jnp.ndarray:
    """``floor(num / den)`` where ``num`` may overflow int32.

    ``num_f`` is the numerator in float32 (approximate), ``num_i`` the same
    numerator computed with WRAPPING int32 arithmetic (exact mod 2^32), and
    ``den > 0`` a true int32. The float estimate lands within
    ``~num·2⁻²³`` of the truth, so the residual ``num − den·q̂`` recovers
    the exact value under two's-complement wraparound as long as that
    error stays below 2³¹ — i.e. the result is EXACT for ``num < ~2⁵³``
    and silently drifts beyond. For the line-clip numerators (products of
    a span and an off-screen distance) this bounds the exact envelope to
    endpoint coordinates within ~±2²⁴ (16.7M px) of the viewport; the
    reference's per-pixel walk would need minutes of stepping per line to
    even reach that regime (line_bresenham.py:6-45).
    """
    qhat = jnp.floor(num_f / den.astype(jnp.float32)).astype(jnp.int32)
    resid = num_i - den * qhat            # wraps; exact because it is small
    return qhat + jnp.floor_divide(resid, den)


@partial(jax.jit, static_argnames=("height", "width", "max_steps"))
def rasterize_lines(color: jnp.ndarray,
                    p1: jnp.ndarray, p2: jnp.ndarray,
                    line_colors: jnp.ndarray,
                    active: jnp.ndarray,
                    height: int, width: int,
                    max_steps: int) -> jnp.ndarray:
    """Draw L lines into a color image, vectorized over lines × steps.

    Args:
      color: (H, W, C) image to draw over.
      p1, p2: (L, 2) int32 endpoints (x, y).
      line_colors: (L, C) per-line colors.
      active: (L,) bool.
      max_steps: static bound on ON-SCREEN pixels per line; must be
        ≥ max(height, width) + 1. Lines are parametrically clipped to the
        viewport before stepping (phase-preserving: the step counter still
        runs from the original ``p1``), so far off-screen endpoints draw
        their visible segment exactly like the reference's per-pixel
        bounds-dropping walk (line_bresenham.py:6-45, buffer.py:66-69).
        Precision envelope: exact for endpoint coordinates within ~±2²⁴
        (16.7M px); beyond that the clip's float-corrected divisions (see
        ``_floordiv_exact``) can drift the visible segment's minor
        coordinate.

    Line index is the overwrite priority: the highest-index line covering a
    pixel wins, matching the reference's sequential draw order.
    """
    l = p1.shape[0]
    hw = height * width
    c = color.shape[-1]

    sign, el, es, major_is_x = _line_params(p1, p2)
    el_safe = jnp.maximum(el, 1)
    es_f = es.astype(jnp.float32)
    el_f = el.astype(jnp.float32)

    # --- viewport clip: first step t0 whose pixel can be on-screen --------
    # Major axis advances exactly 1 per step and the minor axis is
    # nondecreasing, so the visible steps form one contiguous t-window of
    # length ≤ max(h, w); enumerating max_steps steps from t0 covers it.
    maj1 = jnp.where(major_is_x, p1[:, 0], p1[:, 1])
    min1 = jnp.where(major_is_x, p1[:, 1], p1[:, 0])
    smaj = jnp.where(major_is_x, sign[:, 0], sign[:, 1])
    smin = jnp.where(major_is_x, sign[:, 1], sign[:, 0])
    mmaj = jnp.where(major_is_x, width, height)
    mmin = jnp.where(major_is_x, height, width)

    t_maj = jnp.maximum(jnp.where(smaj > 0, -maj1,
                                  jnp.where(smaj < 0, maj1 - (mmaj - 1), 0)),
                        0)
    # minor axis must advance by at least k before entering the viewport
    k = jnp.maximum(jnp.where(smin > 0, -min1,
                              jnp.where(smin < 0, min1 - (mmin - 1), 0)), 0)
    # smallest t with m(t) ≥ k  ⇔  t ≥ ceil((2·el·k − el + 1) / (2·es))
    kf = k.astype(jnp.float32)
    es_safe = jnp.maximum(es, 1)
    num_f = 2.0 * el_f * kf - el_f + 1.0 + (2.0 * es_f - 1.0)  # ceil → floor
    num_i = 2 * el * k - el + 1 + (2 * es - 1)
    t_min = _floordiv_exact(num_f, num_i, 2 * es_safe)
    # es == 0 with k > 0: the minor axis never advances → nothing visible
    t_min = jnp.where(k > 0, jnp.where(es > 0, t_min, el + 1), 0)
    # t0 beyond el ⇒ no visible pixel; clamping to el is safe (that step
    # fails the on-screen test by construction)
    t0 = jnp.clip(jnp.maximum(t_maj, t_min), 0, el)

    t = t0[:, None] + jax.lax.broadcasted_iota(jnp.int32, (l, max_steps), 1)
    step_ok = t <= el[:, None]
    # minor-axis advance after t steps (closed-form Bresenham, see module
    # doc); 2·es·t can exceed int32 for far off-screen endpoints, so use the
    # float-estimate + wrapped-residual exact division
    m = _floordiv_exact(
        2.0 * es_f[:, None] * t.astype(jnp.float32) + (el_f - 1.0)[:, None],
        2 * es[:, None] * t + (el - 1)[:, None],
        2 * el_safe[:, None])
    m = jnp.where(t == 0, 0, m)

    dmaj = t
    dmin = m
    dx = jnp.where(major_is_x[:, None], dmaj, dmin) * sign[:, 0:1]
    dy = jnp.where(major_is_x[:, None], dmin, dmaj) * sign[:, 1:2]
    px = p1[:, 0:1] + dx
    py = p1[:, 1:2] + dy

    on_screen = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    good = step_ok & on_screen & active[:, None]
    idx = jnp.where(good, py * width + px, hw).reshape(-1)

    # Priority scatter-max: winner per pixel = last (highest-index) line.
    prio = jax.lax.broadcasted_iota(jnp.int32, (l, max_steps), 0).reshape(-1)
    prio = jnp.where(good.reshape(-1), prio, -1)
    win = jnp.full(hw + 1, -1, jnp.int32).at[idx].max(prio)[:hw]

    has = win >= 0
    win_c = line_colors[jnp.clip(win, 0, l - 1)]              # (HW, C)
    flat = color.reshape(hw, c)
    out = jnp.where(has[:, None], win_c.astype(flat.dtype), flat)
    return out.reshape(color.shape)


def triangle_edges(tri_xy_int: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Expand (T, 3, 2) int vertices into (3T, 2) edge endpoint pairs.

    Edge order per triangle matches the reference filler: p0→p1, p1→p2, p2→p0
    (``edge_only_pixel_buffer_filler.py:21-28``).
    """
    p0, p1, p2 = tri_xy_int[:, 0], tri_xy_int[:, 1], tri_xy_int[:, 2]
    starts = jnp.stack([p0, p1, p2], axis=1).reshape(-1, 2)
    ends = jnp.stack([p1, p2, p0], axis=1).reshape(-1, 2)
    return starts, ends


# --------------------------------------------------------------------------
# Reference-compatible scalar API
# --------------------------------------------------------------------------


class LineDrawer:
    @abstractmethod
    def draw_line(self, p1, p2, image, color):
        ...


class LineBresenham(LineDrawer):
    """Scalar integer line walk over ``Buffer.set_pixel``.

    Single-line compat path; the batched wireframe uses ``rasterize_lines``.
    All-integer doubled-error accumulator: the walk takes ``major`` steps,
    each either diagonal (when the accumulated minor-axis error crosses a
    half-pixel) or along the major axis. Seeding the accumulator at
    ``major`` (= twice the half-pixel threshold) makes every comparison
    exact in integers, and the emitted pixels match the closed-form
    ``rasterize_lines`` derivation above bit-for-bit (pinned by
    ``tests/test_renderer.py``'s wireframe parity tests). Ties
    (``dx == dy``) walk y-major.
    """

    def draw_line(self, p1, p2, image, color):
        x, y = int(p1[0]), int(p1[1])
        xe, ye = int(p2[0]), int(p2[1])
        step_x = 1 if xe > x else (-1 if xe < x else 0)
        step_y = 1 if ye > y else (-1 if ye < y else 0)
        dx, dy = abs(xe - x), abs(ye - y)
        x_major = dx > dy
        major, minor = (dx, dy) if x_major else (dy, dx)
        err2 = major                      # 2 × the half-pixel threshold
        image.set_pixel(x, y, color)
        for _ in range(major):
            err2 -= 2 * minor
            if err2 < 0:                  # minor axis crossed a pixel center
                err2 += 2 * major
                x += step_x
                y += step_y
            elif x_major:
                x += step_x
            else:
                y += step_y
            image.set_pixel(x, y, color)
