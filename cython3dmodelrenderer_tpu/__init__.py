"""cython3dmodelrenderer_tpu — a 3D software rasterizer for the GPU in JAX.

A from-scratch JAX/XLA/Pallas reimplementation of the capability surface of
oKatanaaa/Cython3DModelRenderer: OBJ/MTL/texture loading, model transforms,
perspective projection, z-buffered triangle rasterization with per-vertex
color/normal interpolation, Lambert ("Guro") illumination, and wireframe
rendering — designed for an accelerator (batched matmul geometry, a
deterministic lock-free tile z-resolve, device-resident buffers, shardable
multi-view rendering).

Top-level API mirrors the reference package layout
(``crender/__init__.py``, ``crender/{py,cy}/``).
"""

from .config import RenderConfig
from .fillers import (AdvancedPixelBufferFiller, EdgeOnlyPixelBufferFiller,
                      PixelBufferFiller)
from .models.buffer import Buffer
from .models.iterators import DepthIterator, SimpleIterator, TriangleIterator
from .models.model import Model, fit_model
from .ops.illumination import GuroIllumination, IlluminationDrawer, NoIllumination
from .ops.wireframe import LineBresenham, LineDrawer
from .renderer import Renderer

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "Model", "fit_model", "Buffer", "Renderer",
    "PixelBufferFiller", "AdvancedPixelBufferFiller", "EdgeOnlyPixelBufferFiller",
    "TriangleIterator", "SimpleIterator", "DepthIterator",
    "IlluminationDrawer", "NoIllumination", "GuroIllumination",
    "LineDrawer", "LineBresenham",
]
