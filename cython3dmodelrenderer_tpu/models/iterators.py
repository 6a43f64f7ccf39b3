"""Triangle iterators — streaming order over a model's triangles.

API parity with the reference (``crender/py/triangle_iterator/``):
``TriangleIterator`` (abstract), ``SimpleIterator`` (model order,
``simple/simple_iterator.py:5``) and ``DepthIterator`` (sorted ascending by
each triangle's minimum vertex z — near-to-far painter order,
``depth/depth_iterator.py:10-11``).

The device render is batched, so iteration order is expressed as a permutation
array consumed by the batched pipeline (``order_indices``) rather than a
Python loop; the ``__iter__`` protocol is kept for reference-compatible
per-triangle use.
"""
from __future__ import annotations

from abc import abstractmethod

import jax.numpy as jnp
import numpy as np

from .model import Model


class TriangleIterator:
    @abstractmethod
    def __next__(self):
        ...

    @classmethod
    def order_indices(cls, model: Model) -> jnp.ndarray:
        """Permutation of [0, T) giving this iterator's triangle order."""
        raise NotImplementedError


class SimpleIterator(TriangleIterator):
    def __init__(self, model: Model):
        self._model = model
        self._counter = 0
        self._n_triangles = model.n_triangles()

    def __len__(self):
        return self._n_triangles

    def __iter__(self):
        return self

    def __next__(self):
        if self._counter >= self._n_triangles:
            raise StopIteration("There are no triangles left in the model.")
        tri = self._model.get_triangle(self._counter)
        self._counter += 1
        return tri

    @classmethod
    def order_indices(cls, model: Model) -> jnp.ndarray:
        return jnp.arange(model.n_triangles(), dtype=jnp.int32)


class DepthIterator(TriangleIterator):
    def __init__(self, model: Model):
        self._model = model
        self._counter = 0
        self._n_triangles = model.n_triangles()
        self._order = np.asarray(self.order_indices(model))

    def __len__(self):
        return self._n_triangles

    def __iter__(self):
        return self

    def __next__(self):
        if self._counter >= self._n_triangles:
            raise StopIteration("There are no triangles left in the model.")
        tri = self._model.get_triangle(int(self._order[self._counter]))
        self._counter += 1
        return tri

    @classmethod
    def order_indices(cls, model: Model) -> jnp.ndarray:
        # Ascending min vertex z; stable sort matches Python's list.sort on
        # the reference (depth_iterator.py:10-11).
        min_z = jnp.min(model.vertices_by_triangles[:, :, 2], axis=1)
        return jnp.argsort(min_z, stable=True).astype(jnp.int32)
