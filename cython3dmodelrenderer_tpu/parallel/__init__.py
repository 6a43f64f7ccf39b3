"""Multi-view / multi-device rendering (see ``multiview`` and ``mesh``)."""
from .mesh import make_mesh
from .multiview import (render_sequence, render_triangle_sharded,
                        render_turntable, render_turntable_sharded,
                        render_view, sequence_capacity,
                        triangle_shard_capacity, turntable_angles,
                        turntable_capacity)

__all__ = [
    "make_mesh", "render_sequence", "render_triangle_sharded",
    "render_turntable", "render_turntable_sharded", "render_view",
    "sequence_capacity", "triangle_shard_capacity", "turntable_angles",
    "turntable_capacity",
]
