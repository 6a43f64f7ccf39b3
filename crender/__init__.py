"""Drop-in compatibility namespace for the reference ``crender`` package.

Code written against oKatanaaa/Cython3DModelRenderer imports ``crender.py``
(pure-NumPy tree) or ``crender.cy`` (compiled tree); both map here onto the
same JAX implementation in ``cython3dmodelrenderer_tpu``. The
top-level re-export mirrors the reference (``crender/__init__.py:1-2``
re-exports the py Renderer).
"""
from . import cy, py
from .py import Renderer

__all__ = ["py", "cy", "Renderer"]
