"""Image / depth / normal buffers — device-resident ndarray wrappers.

API-compatible with the reference ``Buffer``
(``crender/py/data_structures/buffer.py:7-78``): ``get/set_pixel``, ``clear``,
``get_size``, ``get_image``, ``write_to_file`` (vertical flip on write, BGR
PNG like the reference's OpenCV output), ``__getitem__``/``__setitem__``.

Difference from the reference: the backing array is a jnp device buffer that
stays on the device across frames (the reference's Version C keeps persistent C buffers
for the same reason — ``crender/cy/.../advanced_pixel_buffer_filler.pyx:65-67``).
The only host transfer happens in ``write_to_file``/``get_image``. Scalar
``set_pixel`` (a host-style convenience used by the wireframe path) uses
functional ``.at[...]`` updates.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np


class Buffer:
    def __init__(self, height: int, width: int, dim: int = 3,
                 dtype: str = "float32", init_val=0):
        self._height = height
        self._width = width
        self._dim = dim
        self._dtype = dtype
        self._init_val = init_val
        self._buffer: jnp.ndarray = None  # set by clear()
        self._pending = None              # lazy thunk (see set_lazy)
        self.clear()

    # -- lazy contents -----------------------------------------------------

    def set_lazy(self, thunk) -> None:
        """Defer this buffer's contents: ``thunk()`` runs once, on first
        access, and must return the (H, W, dim) array.

        The Renderer serves its z/normal buffers this way, so they read the
        filler's G-buffers on first access — after any capacity repair of
        the frame that landed in between (any access path settles first).
        """
        self._pending = thunk

    def _settle(self) -> None:
        if self._pending is not None:
            thunk, self._pending = self._pending, None
            self.array = thunk()      # shape/dtype-checked by the setter

    # -- array-style access ------------------------------------------------

    def __getitem__(self, val) -> np.ndarray:
        self._settle()
        return np.asarray(self._buffer)[val]

    def __setitem__(self, key, value) -> None:
        self._settle()
        self._buffer = self._buffer.at[key].set(jnp.asarray(value, dtype=self._buffer.dtype))

    # -- device-side API ---------------------------------------------------

    @property
    def array(self) -> jnp.ndarray:
        """The raw device array (no host transfer)."""
        self._settle()
        return self._buffer

    @array.setter
    def array(self, value: jnp.ndarray) -> None:
        assert value.shape == (self._height, self._width, self._dim), \
            f"expected {(self._height, self._width, self._dim)}, got {value.shape}"
        if value.dtype != jnp.dtype(self._dtype):
            value = value.astype(self._dtype)
        self._pending = None
        self._buffer = value

    # -- reference-compatible API -----------------------------------------

    def write_to_file(self, filename: str) -> None:
        """Write the buffer as a PNG (BGR channel order, like the reference's
        ``cv2.imwrite``).

        Row flip on write, like the reference (buffer.py:54-55) — the render
        uses a y-up screen space, image files are y-down.
        """
        from ..utils.png import write_png

        self._settle()
        write_png(filename, np.asarray(self._buffer)[::-1])

    def get_pixel(self, x: int, y: int) -> np.ndarray:
        self._settle()
        return np.asarray(self._buffer[y, x])

    def get_size(self) -> Tuple[int, int]:
        return self._height, self._width

    def get_image(self) -> np.ndarray:
        self._settle()
        return np.asarray(self._buffer)

    def set_pixel(self, x: int, y: int, value) -> None:
        # Bounds-checked silent drop, like the reference (buffer.py:66-69).
        if x not in range(self._width) or y not in range(self._height):
            return
        self._settle()
        self._buffer = self._buffer.at[y, x].set(
            jnp.asarray(value, dtype=self._buffer.dtype))

    def clear(self) -> None:
        self._pending = None
        self._buffer = jnp.full((self._height, self._width, self._dim),
                                self._init_val, dtype=self._dtype)

    # -- persistence (checkpoint/resume — SURVEY §5: the reference only had
    #    an image write of the final frame) ------------------------------------

    def save(self, filename: str) -> None:
        """Checkpoint the buffer (lossless, dtype-preserving .npz)."""
        self._settle()
        np.savez(filename, buffer=np.asarray(self._buffer),
                 init_val=self._init_val)

    @classmethod
    def load(cls, filename: str) -> "Buffer":
        """Restore a buffer checkpointed with :meth:`save`."""
        data = np.load(filename)
        arr = data["buffer"]
        buf = cls(arr.shape[0], arr.shape[1], dim=arr.shape[2],
                  dtype=str(arr.dtype), init_val=data["init_val"].item())
        buf._buffer = jnp.asarray(arr)
        return buf
