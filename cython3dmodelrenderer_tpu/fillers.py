"""Pixel-buffer fillers: the rasterization backends behind the Renderer.

Mirrors the reference's filler hierarchy
(``crender/{py,cy}/pixel_buffer_filler/``):

* ``PixelBufferFiller`` — abstract per-triangle interface
  (``pixel_buffer_filler.py:7-11``);
* ``AdvancedPixelBufferFiller`` — the full z-buffered rasterizer. Like the
  compiled reference (Version C, ``advanced_pixel_buffer_filler.pyx:92``) it
  renders the *whole model* in one call (``render_model``) and owns persistent
  device G-buffers; a per-triangle ``compute_triangle_statistics`` compat path
  matches the pure-python reference filler
  (``py/advanced_pixel_buffer_filler.py:39``);
* ``EdgeOnlyPixelBufferFiller`` — wireframe (see ``ops/wireframe.py``).

Backend selection: ``backend="pallas"`` uses the tile kernel
(``ops/raster_pallas.py``); ``backend="jnp"`` the XLA scatter-min oracle
(``ops/raster_ref.py``); ``"auto"`` maps the JAX platform to one
(``ops.frame.resolve_backend``: GPU → pallas, CPU → jnp).
"""
from __future__ import annotations

import atexit
import queue
import threading
import time
import weakref
from abc import abstractmethod
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import RenderConfig
from .models.buffer import Buffer
from .ops import frame, raster_ref
from .ops.projection import project_to_screen, visibility_masks


class PixelBufferFiller:
    @abstractmethod
    def compute_triangle_statistics(self, triangle, colors, normals,
                                    color_buffer: Buffer, z_buffer: Buffer,
                                    n_buffer: Buffer):
        ...


class _DemandReader:
    """Background drain of per-frame bin-demand scalars.

    A blocking host read of a device scalar stalls for that frame's compute,
    so the reader thread does the blocking ``int()`` off the dispatch thread
    and records any demand that exceeded its frame's dispatch capacity.
    Owns NO reference back to its filler: the filler registers a
    ``weakref.finalize`` that posts the shutdown sentinel, so fillers (and
    their device buffers) stay collectable and no thread outlives its filler.
    """

    _SHUTDOWN = object()

    def __init__(self):
        self.q = queue.Queue()
        self.lock = threading.Lock()
        self.max_demand = 0   # peak overflowing demand since the last take()
        self.gen = 0          # bumps on model change; stale reports ignored
        self.seq_done = 0     # highest dispatch seq fully processed (FIFO)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        _LIVE_READERS.add(self)

    def put(self, total, cap, seq: int = 0) -> None:
        # called from the dispatch thread only (same thread as invalidate,
        # so the gen snapshot is consistent without the lock)
        self.q.put((total, cap, self.gen, seq, 0))

    def invalidate(self) -> None:
        with self.lock:
            self.gen += 1
            self.max_demand = 0

    def take(self):
        """Atomically (pending overflow demand, highest processed seq).

        One lock acquisition for both, so a caller seeing zero demand with
        seq_done >= its newest dispatch seq knows that frame was processed
        AND found complete.
        """
        with self.lock:
            demand, self.max_demand = self.max_demand, 0
            return demand, self.seq_done

    def stop(self) -> None:
        self.q.put(self._SHUTDOWN)

    def _loop(self) -> None:
        while True:
            item = self.q.get()
            try:
                if item is self._SHUTDOWN:
                    return
                total, cap, gen, seq, attempts = item
                try:
                    t = int(total)
                except Exception:
                    # A failed demand read is NOT a clean verdict. Retry a
                    # few times, keeping the item unfinished so strict joins
                    # still wait; after that, conservatively report the
                    # frame as overflowing — one spurious repair render
                    # beats serving a possibly truncated frame as complete.
                    if attempts + 1 < 3:
                        time.sleep(0.1 * (attempts + 1))
                        self.q.put((total, cap, gen, seq, attempts + 1))
                        continue
                    t = cap + 1
                with self.lock:
                    if gen == self.gen and t > cap:
                        self.max_demand = max(self.max_demand, t)
                    # seq is globally monotone across gens (a stale item's
                    # seq predates any newer dispatch), so unconditional
                    self.seq_done = max(self.seq_done, seq)
            finally:
                self.q.task_done()


_LIVE_READERS = weakref.WeakSet()


@atexit.register
def _drain_readers_at_exit(deadline_s: float = 30.0) -> None:
    """Let outstanding blocking scalar reads finish before interpreter
    teardown: killing a daemon thread inside one aborts the process with an
    unhandled C++ exception."""
    end = time.monotonic() + deadline_s
    for reader in list(_LIVE_READERS):
        while reader.q.unfinished_tasks and time.monotonic() < end:
            time.sleep(0.01)


class AdvancedPixelBufferFiller(PixelBufferFiller):
    """Z-buffered triangle rasterizer with persistent device G-buffers.

    Constructor signature matches the reference filler
    (``py filler:14``, ``pyx:39``); ``n_threads`` is accepted for drop-in
    compatibility but ignored — parallelism comes from the XLA/Pallas grid,
    not OpenMP threads.
    """

    def __init__(self, h: int, w: int, fov: float = 90.0, z_near: float = 0.1,
                 z_far: float = 1000.0, n_threads: Optional[int] = None,
                 backend: str = "auto"):
        del n_threads  # reference-API compat; the device picks parallelism
        self.config = RenderConfig(height=h, width=w, fov=fov, z_near=z_near,
                                   z_far=z_far, backend=backend)
        self._color = jnp.zeros((h, w, 3), jnp.float32)
        self._z = jnp.full((h, w, 1), self.config.z_init, jnp.float32)
        self._normals = jnp.zeros((h, w, 3), jnp.float32)
        # Cached static pair-capacity bucket for the tile kernel's binner:
        # lets steady-state frames run with zero host syncs (overflow →
        # repair, see _settle_pending).
        self._p_cap: Optional[int] = None
        self._sized_for: Optional[int] = None
        self._last_total = None
        # Overflow auto-recovery: every dispatched frame's pair-total scalar
        # is handed to a BACKGROUND reader thread, because a blocking host
        # read of a device scalar stalls for that frame's compute. The
        # reader records any demand that exceeded its frame's dispatch
        # capacity; the dispatch thread checks that record (a lock + int
        # compare, no device traffic) each render call, grows the bucket,
        # and re-renders the newest frame. validate_capacity() is the strict
        # sync point (joins the reader queue).
        self._reader = None          # _DemandReader, created on first use
        self._latest = None          # (tv, tn, tc, cap) of newest dispatch
        self._validated = True       # no un-validated dispatches outstanding
        self._dispatch_seq = 0       # monotone id per tracked dispatch
        # final image of the last frame (see render_model(post=))
        self._post_mode = ("none", None)
        self._post_image: Optional[jnp.ndarray] = None

    def get_size(self) -> Tuple[int, int]:
        return self.config.height, self.config.width

    # ------------------------------------------------------------------
    # whole-model path (Version C style)
    # ------------------------------------------------------------------

    def _resolve_backend(self) -> str:
        """The configured backend, ``"auto"`` resolved for the platform
        (GPU → "pallas", CPU → "jnp", see ``ops.frame.resolve_backend``)."""
        return frame.resolve_backend(self.config.backend)

    def render_model(self, model, order: Optional[jnp.ndarray] = None,
                     colors_override: Optional[jnp.ndarray] = None,
                     post: str = "none", light=None) -> None:
        """Rasterize the whole model into the filler's G-buffers.

        ``order`` is an optional triangle permutation (iterator order; only
        affects depth-tie resolution). ``colors_override`` supplies (T, 3, 3)
        colors for untextured models. ``post`` ("none" | "u8" |
        "lambert_u8", with ``light``) fuses the final-image shade/quantize
        into the frame's single dispatch — read it from
        ``get_post_image()``.
        """
        tri_verts = model.vertices_by_triangles
        tri_norms = model.normals_by_triangles
        tri_colors = model.colors_by_triangles
        if tri_colors is None:
            tri_colors = colors_override
        if tri_colors is None:
            raise ValueError(
                "model has no texture colors; pass colors_override "
                "(the Renderer provides random/white fallback colors)")
        tri_colors = jnp.asarray(tri_colors, jnp.float32)

        if order is not None:
            tri_verts = tri_verts[order]
            tri_norms = tri_norms[order]
            tri_colors = tri_colors[order]

        self.render_arrays(tri_verts, tri_norms, tri_colors,
                           post=post, light=light)

    def render_arrays(self, tri_verts, tri_norms, tri_colors,
                      post: str = "none", light=None) -> None:
        """Dispatch one frame from raw (T, 3, 3) triangle arrays.

        Stores the frame's G-buffers and fused ``post`` image. Returns
        nothing — read ``get_post_image()`` / ``snapshot_buffers()`` / the
        getters.
        """
        # Pick up overflow reports from the reader thread (a lock + int
        # compare — no device traffic). Growth alone suffices here: the
        # frame about to be dispatched replaces the G-buffers anyway.
        self._settle_pending(repair=False)
        self._post_mode = (post, light)
        self._post_image = None
        if tri_verts.shape[0] == 0:   # empty scene → background
            # drop any queued overflow reports from the PREVIOUS model: a
            # late report must not re-render superseded geometry over the
            # empty-scene buffers
            self._invalidate_pending()
            self._validated = True   # an empty frame is trivially complete
            h, w = self.get_size()
            if post != "none":
                self._post_image = jnp.zeros((h, w, 3), jnp.uint8)
            self._set_gbuffers(
                (jnp.zeros((h, w, 3), jnp.float32),
                 jnp.full((h, w, 1), self.config.z_init, jnp.float32),
                 jnp.zeros((h, w, 3), jnp.float32)))
            return
        backend = self._resolve_backend()
        if backend == "jnp":
            # the oracle sizes its bbox window exactly, every frame (one
            # host sync): its frames never drop geometry
            need = int(frame.frame_demand(tri_verts, tri_norms, self.config,
                                          backend))
            self._dispatch(tri_verts, tri_norms, tri_colors, backend,
                           frame.capacity(need, backend, self.config))
            self._validated = True
            return
        if self._p_cap is not None and self._sized_for != tri_verts.shape[0]:
            self._p_cap = None
            self._invalidate_pending()   # old-model demands are meaningless
        if self._p_cap is None:
            # One-time sizing sync: learn the scene's pair demand and cache
            # a static bucket with 5% headroom, so animation never re-syncs.
            # _settle_pending() grows the bucket when a later frame
            # overflows it and re-renders that frame.
            need = int(frame.frame_demand(tri_verts, tri_norms, self.config,
                                          backend))
            self._p_cap = frame.capacity(need * 21 // 20, backend,
                                         self.config)
            self._sized_for = tri_verts.shape[0]
        self._dispatch(tri_verts, tri_norms, tri_colors, backend, self._p_cap)
        self._track_pending(tri_verts, tri_norms, tri_colors)

    def _dispatch(self, tri_verts, tri_norms, tri_colors, backend: str,
                  cap: int) -> None:
        post, light = self._post_mode
        (self._color, self._z, self._normals, self._post_image,
         self._last_total) = frame.render_frame(
            tri_verts, tri_norms, tri_colors, config=self.config,
            backend=backend, cap=cap, post=post, light=light)

    def _set_gbuffers(self, out) -> None:
        """Store planar G-buffers (empty scene / reset)."""
        self._color, self._z, self._normals = out

    def get_post_image(self) -> Optional[jnp.ndarray]:
        """The fused final image of the last frame (uint8), or None when the
        frame was rendered with ``post="none"``."""
        self._settle_pending()
        return self._post_image

    def _track_pending(self, tri_verts, tri_norms, tri_colors) -> None:
        """Hand a dispatched frame's pair total to the reader thread.

        Only the newest frame's INPUTS are retained (the repair target —
        older frames' G-buffers are superseded); every frame's (pair total,
        dispatch capacity) goes to the queue. The reader does the blocking
        ``int()`` reads off the dispatch thread, so the render loop never
        waits on device scalars.
        """
        self._latest = (tri_verts, tri_norms, tri_colors, self._p_cap)
        if self._reader is None:
            self._reader = _DemandReader()
            # Stop the reader thread when THIS filler is collected — the
            # reader holds no reference back to the filler, so fillers
            # (and their device buffers) stay garbage-collectable.
            weakref.finalize(self, self._reader.stop)
        self._validated = False
        self._dispatch_seq += 1
        self._reader.put(self._last_total, self._p_cap, self._dispatch_seq)

    def _invalidate_pending(self) -> None:
        """Drop queued/recorded demands (model changed — they're meaningless)."""
        if self._reader is not None:
            self._reader.invalidate()
        self._latest = None

    def _settle_pending(self, strict: bool = False,
                        repair: bool = True) -> bool:
        """Act on overflow reports from the reader thread; grow + repair.

        A frame overflowed when its pair total exceeded the capacity it was
        DISPATCHED at. On overflow the bucket grows to 2x the observed
        demand and — when ``repair`` and the newest frame was dispatched
        below the grown capacity — the newest frame (the one in the
        G-buffers) is re-rendered. Non-strict mode (the render path) is a
        lock + integer compare: zero device traffic. ``strict=True`` (used
        by ``validate_capacity``) first joins the reader queue, so every
        dispatched frame's verdict is in. Returns True when any reported
        frame had overflowed.
        """
        if self._reader is None:
            return False
        if strict:
            self._reader.q.join()
        demand, seq_done = self._reader.take()
        if demand == 0:
            # the reader has processed the newest dispatch's demand and
            # found it complete → the served frame is no longer provisional
            if seq_done >= self._dispatch_seq:
                self._validated = True
            return False
        if demand > self._p_cap:
            self._p_cap = frame.capacity(2 * demand, "pallas", self.config)
        if repair and self._latest is not None:
            tv, tn, tc, cap = self._latest
            if cap < self._p_cap:
                # Re-render the newest frame (older frames are superseded);
                # its own demand re-queues for the next drain.
                self._dispatch(tv, tn, tc, "pallas", self._p_cap)
                self._track_pending(tv, tn, tc)
        return True

    def get_render_stats(self) -> dict:
        """Stats of the last rendered frame (host sync on a device scalar).

        Returns the frame's (tile, triangle) pair count for the tile kernel
        (None on the jnp path) and the pair capacity — the observability
        hook the reference lacked (SURVEY §5).
        """
        self.validate_capacity()
        pallas = self._resolve_backend() == "pallas"
        return {
            "pairs": (int(self._last_total)
                      if pallas and self._last_total is not None else None),
            "pair_capacity": self._p_cap,
        }

    def validate_capacity(self) -> bool:
        """Strict sync point: block until every dispatched frame's bins are
        verified to fit, repairing on overflow.

        Returns True when the latest frame was complete as dispatched. On
        overflow the capacity bucket grows AND the frame is re-rendered
        (repeatedly if needed) — unlike the reference, no truncated geometry
        survives this call. Costs a device round trip; the zero-cost lazy
        drain in the render path already detects overflow as soon as the
        reader thread's blocking read of each frame's demand scalar
        completes (typically within a frame or two) with automatic repair,
        so most callers never need this. Fixed-model scenes never overflow
        (the bucket has headroom over the sizing frame).
        """
        if self._validated:   # no dispatches since the last validation
            return True
        clean = True
        for _ in range(8):   # bounded: capacity doubles on every iteration
            grew = self._settle_pending(strict=True, repair=True)
            clean = clean and not grew
            if not grew:
                break
        self._validated = True
        return clean

    # buffer getters, cy-reference naming (pyx:246-253). Each getter picks up
    # any overflow report the reader thread has posted (a lock + int compare)
    # and repairs before returning — NOT a blocking sync, which would
    # serialize every animation frame. The reader detects an overflow about
    # one frame after it computes, so truncation is repaired within a frame
    # or two; validate_capacity() gives the immediate strict guarantee.
    @property
    def frame_provisional(self) -> bool:
        """True while the newest frame's completeness is still unconfirmed.

        The overflow detector is eventually consistent: a frame whose bin
        demand exceeded the static capacity renders truncated and is
        repaired a frame or two later, when the background reader's blocking
        demand read lands. Until ``validate_capacity()`` (or the next
        reader-confirmed drain) establishes the newest frame fit, buffers
        served by the getters are PROVISIONAL — complete in the common case
        (fixed-model scenes never overflow), but not yet guaranteed. Costs a
        lock-free bool read; no device traffic.
        """
        return not self._validated

    def snapshot_buffers(self, strict: bool = False):
        """One CONSISTENT (color, z, normals, post_image) snapshot.

        Settles queued overflow reports exactly once before reading, so all
        four tensors come from the same render generation — per-getter
        settling could repair between two reads and hand the caller a torn
        frame (e.g. pre-repair color with post-repair z).

        The snapshot may still be PROVISIONAL (see ``frame_provisional``):
        an overflow detected after this read repairs the next frame, not
        this one. ``strict=True`` calls ``validate_capacity()`` first —
        a device round trip — so the returned frame is guaranteed complete.
        """
        if strict:
            self.validate_capacity()
        else:
            self._settle_pending()
        return self._color, self._z, self._normals, self._post_image

    def get_color_buffer(self) -> jnp.ndarray:
        self._settle_pending()
        return self._color

    def get_normals_buffer(self) -> jnp.ndarray:
        self._settle_pending()
        return self._normals

    def get_z_buffer(self) -> jnp.ndarray:
        self._settle_pending()
        return self._z

    def reset_buffers(self) -> None:
        self._invalidate_pending()
        h, w = self.get_size()
        self._set_gbuffers(
            (jnp.zeros((h, w, 3), jnp.float32),
             jnp.full((h, w, 1), self.config.z_init, jnp.float32),
             jnp.zeros((h, w, 3), jnp.float32)))

    # ------------------------------------------------------------------
    # per-triangle compat path (py reference semantics)
    # ------------------------------------------------------------------

    def compute_triangle_statistics(self, triangle, colors, normals,
                                    color_buffer: Buffer, z_buffer: Buffer,
                                    n_buffer: Buffer):
        """Rasterize one triangle against caller-owned buffers.

        Matches ``py/pixel_buffer_filler/advanced_pixel_buffer_filler.py:39-82``
        including its culling rules. This is the compatibility path for code
        written against the per-triangle reference API — the batched
        ``render_model`` is the fast path.
        """
        assert color_buffer.get_size() == z_buffer.get_size() \
            == n_buffer.get_size() == self.get_size(), (
            "Buffers' spatial dimensions must be the same, but received: "
            f"color_buffer - {color_buffer.get_size()}, "
            f"z_buffer - {z_buffer.get_size()}, "
            f"n_buffer - {n_buffer.get_size()}.")

        tri = jnp.asarray(triangle, jnp.float32)[None]
        cols = jnp.asarray(colors, jnp.float32)[None]
        norms = jnp.asarray(normals, jnp.float32)[None]
        # Prelude (one small dispatch): cull + project + ceil-bbox. Culled or
        # off-screen triangles touch nothing — same as the reference's early
        # returns (py filler:59-68) and the old full-image masks.
        ts, active, xl, xr, yl, yr = _compat_prelude(tri, norms, self.config)
        if not bool(active) or int(xr) <= int(xl) or int(yr) <= int(yl):
            return
        h, w = self.config.height, self.config.width
        # Bucketed static window over the clipped ceil-bbox — the reference
        # restricts work to the bbox meshgrid (py filler:108-145); a
        # power-of-two bucket keeps jit recompiles to ~log(image dim).
        bh = _pow2_bucket(int(yr) - int(yl), h)
        bw = _pow2_bucket(int(xr) - int(xl), w)
        # Clamp the window origin so it stays inside the image; it still
        # covers the clipped bbox because the bbox fits in (bh, bw).
        y0 = min(int(yl), h - bh)
        x0 = min(int(xl), w - bw)
        color, z, normal = _raster_one_window(
            ts, cols[0], norms[0], color_buffer.array.astype(jnp.float32),
            z_buffer.array, n_buffer.array, y0, x0, self.config, bh, bw)
        color_buffer.array = color
        z_buffer.array = z
        n_buffer.array = normal


class EdgeOnlyPixelBufferFiller(PixelBufferFiller):
    """Wireframe filler — draws triangle edges (or vertices only).

    API parity with the reference
    (``edge_only/edge_only_pixel_buffer_filler.py:8-33``): vertex coordinates
    are truncated to ints and drawn *without* projection (the reference uses
    this with ``normalize_model=True`` fitting). The batched path
    (``fill_all``) replaces per-pixel ``set_pixel`` calls with the vectorized
    closed-form Bresenham in ``ops/wireframe.py``.
    """

    def __init__(self, line_drawer, line_color, draw_edges: bool = True,
                 force_triangle_colors: bool = False):
        self.line_drawer = line_drawer
        self.line_color = np.asarray(line_color)
        self.draw_edges = draw_edges
        self.force_triangle_colors = force_triangle_colors

    def compute_triangle_statistics(self, triangle, colors, normals,
                                    color_buffer: Buffer, z_buffer: Buffer,
                                    n_buffer: Buffer):
        p0 = [int(triangle[0][0]), int(triangle[0][1])]
        p1 = [int(triangle[1][0]), int(triangle[1][1])]
        p2 = [int(triangle[2][0]), int(triangle[2][1])]
        if self.draw_edges:
            self.line_drawer.draw_line(
                p0, p1, color_buffer,
                colors[0] if self.force_triangle_colors else self.line_color)
            self.line_drawer.draw_line(
                p1, p2, color_buffer,
                colors[1] if self.force_triangle_colors else self.line_color)
            self.line_drawer.draw_line(
                p2, p0, color_buffer,
                colors[2] if self.force_triangle_colors else self.line_color)
        else:
            color_buffer.set_pixel(*p0, colors[0] if self.force_triangle_colors
                                   else self.line_color)
            color_buffer.set_pixel(*p1, colors[1] if self.force_triangle_colors
                                   else self.line_color)
            color_buffer.set_pixel(*p2, colors[2] if self.force_triangle_colors
                                   else self.line_color)

    def fill_all(self, tri_verts: jnp.ndarray, tri_colors: jnp.ndarray,
                 color_arr: jnp.ndarray) -> jnp.ndarray:
        """Batched wireframe over all triangles into a color image array."""
        from .ops import wireframe

        h, w = color_arr.shape[0], color_arr.shape[1]
        t = tri_verts.shape[0]
        pts = tri_verts[..., :2].astype(jnp.int32)      # truncation, ref:20-22
        if self.draw_edges:
            starts, ends = wireframe.triangle_edges(pts)
            if self.force_triangle_colors:
                line_colors = tri_colors.reshape(t * 3, -1)
            else:
                line_colors = jnp.broadcast_to(
                    jnp.asarray(self.line_color, jnp.float32),
                    (t * 3, np.size(self.line_color)))
            active = jnp.ones((t * 3,), bool)
            # rasterize_lines clips each line to the viewport before
            # stepping (phase-preserving), so this only needs to cover the
            # ≤ max(h, w)+1 on-screen steps — endpoints up to ~16 million
            # px off-screen draw their visible segment exactly (see
            # wireframe._floordiv_exact for the precision envelope)
            max_steps = 2 * max(h, w)
            return wireframe.rasterize_lines(color_arr, starts, ends,
                                             line_colors, active, h, w,
                                             max_steps)
        # vertices only: zero-length "lines"
        pts_flat = pts.reshape(t * 3, 2)
        if self.force_triangle_colors:
            line_colors = tri_colors.reshape(t * 3, -1)
        else:
            line_colors = jnp.broadcast_to(
                jnp.asarray(self.line_color, jnp.float32),
                (t * 3, np.size(self.line_color)))
        active = jnp.ones((t * 3,), bool)
        return wireframe.rasterize_lines(color_arr, pts_flat, pts_flat,
                                         line_colors, active, h, w, 1)


def _pow2_bucket(need: int, cap: int) -> int:
    """Smallest power-of-two ≥ ``need``, clipped to ``cap`` (≥ 8)."""
    b = 8
    while b < need:
        b *= 2
    return min(b, cap)


@partial(jax.jit, static_argnames=("config",))
def _compat_prelude(tri, norms, config: RenderConfig):
    """Cull + project + ceil-bbox for one triangle (compat-path prelude)."""
    degenerate, backfacing = visibility_masks(tri, norms)
    active = jnp.logical_and(~degenerate, ~backfacing)[0]
    ts = project_to_screen(tri, config)[0]        # (3, 3)
    xl, xr, yl, yr = raster_ref.bbox_ceil(ts[None, :, :2],
                                          config.width, config.height)
    return ts, active, xl[0], xr[0], yl[0], yr[0]


@partial(jax.jit, static_argnames=("config", "bh", "bw"))
def _raster_one_window(ts, cols, norms, color_arr, z_arr, n_arr, y0, x0,
                       config: RenderConfig, bh: int, bw: int):
    """Single-triangle rasterization over a (bh, bw) bbox window.

    Mirrors the reference's bbox-meshgrid restriction (py filler:108-145):
    only the window around the triangle's clipped ceil-bbox is evaluated,
    with the same barycentric/z/strict-< rules as the batched oracle. Pixel
    coordinates are absolute, so results are bit-identical to the former
    full-image-grid formulation at ~(bbox/image)² of the cost.
    """
    c_win = jax.lax.dynamic_slice(color_arr, (y0, x0, 0), (bh, bw, 3))
    z_win = jax.lax.dynamic_slice(z_arr, (y0, x0, 0), (bh, bw, 1))
    n_win = jax.lax.dynamic_slice(n_arr, (y0, x0, 0), (bh, bw, 3))

    xl, xr, yl, yr = raster_ref.bbox_ceil(ts[None, :, :2],
                                          config.width, config.height)
    px = x0 + jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 1)
    py = y0 + jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 0)
    in_bbox = (px >= xl[0]) & (px < xr[0]) & (py >= yl[0]) & (py < yr[0])

    l0, l1, l2 = raster_ref.barycentric(ts[None, None, :, :2],
                                        px.astype(jnp.float32),
                                        py.astype(jnp.float32))
    inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
    z = l0 * ts[0, 2] + l1 * ts[1, 2] + l2 * ts[2, 2]
    z_ok = (z >= 0.0) & (z <= 1.0)
    win = in_bbox & inside & z_ok & (z[..., None] < z_win)[..., 0]

    bar = jnp.stack([l0, l1, l2], axis=-1)        # (bh, bw, 3)
    new_c = jnp.einsum("hwk,kd->hwd", bar, cols, precision="highest")
    new_n = jnp.einsum("hwk,kd->hwd", bar, norms, precision="highest")

    c_win = jnp.where(win[..., None], new_c, c_win)
    z_win = jnp.where(win[..., None], z[..., None], z_win)
    n_win = jnp.where(win[..., None], new_n, n_win)
    return (jax.lax.dynamic_update_slice(color_arr, c_win, (y0, x0, 0)),
            jax.lax.dynamic_update_slice(z_arr, z_win, (y0, x0, 0)),
            jax.lax.dynamic_update_slice(n_arr, n_win, (y0, x0, 0)))
