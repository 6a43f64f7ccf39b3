"""Render configuration.

The reference passes plain kwargs everywhere (filler ``(h, w, fov=90, z_near=0.1,
z_far=1000)`` — reference ``crender/py/pixel_buffer_filler/advanced_pixel_buffer_filler.py:14``).
We keep the same defaults but bundle them into a frozen dataclass so the whole
config can be a static argument to ``jax.jit``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static per-frame render parameters.

    Attributes mirror the reference filler's constructor arguments
    (reference ``py/pixel_buffer_filler/advanced_pixel_buffer_filler.py:14-23``):
    ``height``/``width`` are the target image size, ``fov`` the vertical field of
    view in degrees, ``z_near``/``z_far`` the clip range mapped to depth [0, 1].
    """

    height: int = 512
    width: int = 512
    fov: float = 90.0
    z_near: float = 0.1
    z_far: float = 1000.0
    #: depth buffer clear value (reference ``py/renderer.py:20`` uses 1e6)
    z_init: float = 1e6
    #: rasterizer backend: "pallas" (tile kernel), "jnp" (XLA oracle) or
    #: "auto" (GPU → pallas, CPU → jnp; see ``ops.frame.resolve_backend``)
    backend: str = "auto"

    @property
    def aspect(self) -> float:
        # reference py filler:22 — a = h / w
        return self.height / self.width

    def __post_init__(self):
        if self.height <= 0 or self.width <= 0:
            raise ValueError("image dimensions must be positive")
        if self.backend not in ("auto", "pallas", "jnp"):
            raise ValueError(f"unknown backend {self.backend!r}")
