"""Render orchestration — the user-facing ``Renderer``.

API-compatible with both reference renderers
(``crender/py/renderer.py:9-66``, ``crender/cy/renderer.py:9-52``):
``Renderer(filler, illumination, iterator_type, image_height, image_width,
use_tqdm)`` with ``.render(model, normalize_model, random_colors)`` returning
the color ``Buffer`` and ``.reset_buffers()``.

Accelerator-first behavior: when the filler supports whole-model rendering
(``AdvancedPixelBufferFiller.render_model``, mirroring the compiled reference
— ``cy/renderer.py:47-49``), the frame is one batched device program:
project → rasterize → shade, with G-buffers persistent on device. The
per-triangle Python loop (``py/renderer.py:52-58``) survives only as the
compatibility path for custom per-triangle fillers. Unlike the compiled
reference — which accepts ``iterator_type`` but ignores it
(``cy/renderer.py:16,47``) — the batched path honors the iterator's triangle
ordering via a permutation (it only affects depth-tie resolution).
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from .fillers import AdvancedPixelBufferFiller, EdgeOnlyPixelBufferFiller, \
    PixelBufferFiller
from .models.buffer import Buffer
from .models.model import Model
from .ops.illumination import GuroIllumination, IlluminationDrawer
from .ops.illumination import cast_u8 as _cast_u8


class Renderer:
    def __init__(self, pixel_buffer_filler: PixelBufferFiller,
                 illumination: IlluminationDrawer,
                 triangle_iterator_type: type,
                 image_height: int = 512, image_width: int = 512,
                 use_tqdm: bool = True):
        self.pixel_buffer_filler = pixel_buffer_filler
        self.illumination = illumination
        self.triangle_iterator_type = triangle_iterator_type
        self.im_h = image_height
        self.im_w = image_width
        self.use_tqdm = use_tqdm
        self.color_buffer = Buffer(image_height, image_width, dim=3, dtype="uint8")
        self.z_buffer = Buffer(image_height, image_width, dim=1, init_val=1e6,
                               dtype="float32")
        self.n_buffer = Buffer(image_height, image_width, dim=3, dtype="float32")

    def render(self, model: Model, normalize_model: bool = False,
               random_colors: bool = True) -> Buffer:
        """Render the model; returns the color buffer.

        ``normalize_model`` applies the reference's orthographic-style fit
        (``py/renderer.py:44-49``) by mutating the model. ``random_colors``
        picks a random (else white) color per triangle for untextured models
        (``py/renderer.py:53-55``).
        """
        if normalize_model:
            image_center = (self.im_h // 2, self.im_w // 2)
            image_span = min(image_center)
            model.scale(image_span / model.get_max_span())
            model.shift(-model.get_mean_vertex()
                        + np.array([image_center[0], image_center[1],
                                    -image_span], dtype=np.float32))

        colors_override = self._fallback_colors(model, random_colors)

        if isinstance(self.pixel_buffer_filler, AdvancedPixelBufferFiller):
            self._render_batched(model, colors_override)
        elif isinstance(self.pixel_buffer_filler, EdgeOnlyPixelBufferFiller):
            self._render_wireframe(model, colors_override)
        else:
            self._render_per_triangle(model, colors_override)
        return self.color_buffer

    # ------------------------------------------------------------------

    def _fallback_colors(self, model: Model,
                         random_colors: bool) -> Optional[jnp.ndarray]:
        """(T, 3, 3) colors for untextured models, else None."""
        if model.colors_by_triangles is not None:
            return None
        t = model.n_triangles()
        if random_colors:
            per_tri = np.random.randint(256, size=(t, 3)).astype(np.float32)
        else:
            per_tri = np.full((t, 3), 255.0, dtype=np.float32)
        return jnp.asarray(np.repeat(per_tri[:, None, :], 3, axis=1))

    def _order(self, model: Model) -> Optional[jnp.ndarray]:
        cls = self.triangle_iterator_type
        # identity order → skip the permutation gather (and the dispatch
        # that would build it)
        if cls is None or cls.__name__ == "SimpleIterator":
            return None
        try:
            return cls.order_indices(model)
        except (AttributeError, NotImplementedError):
            return None

    def _render_batched(self, model: Model,
                        colors_override: Optional[jnp.ndarray]) -> None:
        filler = self.pixel_buffer_filler
        # Shade + uint8-quantize fused INTO the frame's single dispatch.
        # Exact-type checks: subclasses with overridden apply() must go
        # through the generic path, not the fused builtin formulas.
        from .ops.illumination import NoIllumination

        if type(self.illumination) is GuroIllumination:
            post, light = "lambert_u8", self.illumination.light_direction
        elif type(self.illumination) is NoIllumination:
            post, light = "u8", None
        else:
            post, light = "none", None
        if post == "none":
            # custom drawers shade the planar color/normal G-buffers —
            # generic two-dispatch path
            filler.render_model(model, order=self._order(model),
                                colors_override=colors_override,
                                post=post, light=light)
            snap = getattr(filler, "snapshot_buffers", None)
            if snap is not None:
                color, z, normals, _pi = snap()
            else:
                color, z, normals = (filler.get_color_buffer(),
                                     filler.get_z_buffer(),
                                     filler.get_normals_buffer())
            self.color_buffer.array = _cast_u8(
                self.illumination.apply(color, normals))
            self.z_buffer.array = z
            self.n_buffer.array = normals
            return
        # Builtin drawers: the frame's deliverable is the fused post image;
        # the z/normal buffers read the filler's G-buffers on first access,
        # so a capacity repair that lands before then is reflected.
        # Reference analogue: the cy renderer's only product is the color
        # buffer (cy/renderer.py:47-49); z/normals live inside the filler.
        filler.render_model(model, order=self._order(model),
                            colors_override=colors_override,
                            post=post, light=light)
        self.color_buffer.array = filler.get_post_image()
        self.z_buffer.set_lazy(filler.get_z_buffer)
        self.n_buffer.set_lazy(filler.get_normals_buffer)

    def _render_wireframe(self, model: Model,
                          colors_override: Optional[jnp.ndarray]) -> None:
        # A custom (non-built-in) LineDrawer must see every edge, like the
        # reference routes all lines through the injected drawer
        # (edge_only_pixel_buffer_filler.py:21-33) — fall back to the
        # per-triangle loop so its draw_line override is honored.
        from .ops.wireframe import LineBresenham

        drawer = getattr(self.pixel_buffer_filler, "line_drawer", None)
        if drawer is not None and type(drawer) is not LineBresenham:
            self._render_per_triangle(model, colors_override)
            return
        tri_colors = model.colors_by_triangles
        if tri_colors is None:
            tri_colors = colors_override
        color = self.pixel_buffer_filler.fill_all(
            model.vertices_by_triangles, jnp.asarray(tri_colors, jnp.float32),
            self.color_buffer.array.astype(jnp.float32))
        shaded = self.illumination.apply(color, self.n_buffer.array)
        self.color_buffer.array = shaded

    def _render_per_triangle(self, model: Model,
                             colors_override: Optional[jnp.ndarray]) -> None:
        """Reference-style per-triangle loop (py/renderer.py:51-58).

        ``use_tqdm`` is accepted for reference-API compatibility; no
        progress bar is drawn.
        """
        override = (np.asarray(colors_override)
                    if colors_override is not None else None)
        for i, (triangle, colors, normals) in enumerate(
                self.triangle_iterator_type(model)):
            if colors is None:
                colors = override[i]
            self.pixel_buffer_filler.compute_triangle_statistics(
                triangle, colors, normals,
                self.color_buffer, self.z_buffer, self.n_buffer)
        self.illumination.draw_illumination(self.color_buffer, self.n_buffer)

    def render_sequence(self, model: Model, angles, shifts=None,
                        random_colors: bool = True):
        """Render a pose sequence as ONE device dispatch.

        Convenience wrapper over ``parallel.multiview.render_sequence`` for
        Renderer users: sizes the capacity, derives the light from this
        Renderer's illumination drawer, and returns display-ready
        ``(N, H, W, 3)`` uint8 frames (rows in buffer order — flip with
        ``[::-1]`` before writing a file, as ``Buffer.write_to_file`` does).
        Frame i rotates the UN-rotated model by ``angles[i]`` (Euler XYZ
        degrees) and translates by ``shifts[i]`` (default ``[0, 0, 1]``,
        the reference demo's fit shift). Each frame goes through the same
        frame body and backend as the filler's single-frame path. Requires
        an ``AdvancedPixelBufferFiller``; the Renderer's own G-buffers are
        not touched.
        """
        from .ops.illumination import NoIllumination
        from .parallel import multiview

        filler = self.pixel_buffer_filler
        if not isinstance(filler, AdvancedPixelBufferFiller):
            raise TypeError("render_sequence needs AdvancedPixelBufferFiller")
        if type(self.illumination) is NoIllumination:
            light_direction = None
        elif type(self.illumination) is GuroIllumination:
            # multiview normalizes+negates internally; recover the raw
            # direction from the drawer's pre-negated unit vector
            light_direction = tuple(-np.asarray(
                self.illumination.light_direction, np.float32))
        else:
            raise TypeError("render_sequence supports GuroIllumination / "
                            "NoIllumination (custom drawers: render frames "
                            "individually)")
        tri_colors = model.colors_by_triangles
        if tri_colors is None:
            tri_colors = self._fallback_colors(model, random_colors)
        tv = model.vertices_by_triangles
        tn = model.normals_by_triangles
        angles = jnp.asarray(angles, jnp.float32)
        if shifts is None:
            shifts = jnp.broadcast_to(jnp.float32([0.0, 0.0, 1.0]),
                                      (angles.shape[0], 3))
        shifts = jnp.asarray(shifts, jnp.float32)
        config = filler.config
        backend = filler._resolve_backend()
        cap = multiview.sequence_capacity(tv, tn, angles, shifts, config,
                                          backend=backend)
        return multiview.render_sequence(
            tv, tn, jnp.asarray(tri_colors, jnp.float32), angles, shifts,
            config, cap=cap, backend=backend, post="u8",
            light_direction=light_direction)

    def reset_buffers(self) -> None:
        self.n_buffer.clear()
        self.z_buffer.clear()
        self.color_buffer.clear()
        if isinstance(self.pixel_buffer_filler, AdvancedPixelBufferFiller):
            self.pixel_buffer_filler.reset_buffers()
