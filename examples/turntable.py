"""64-camera turntable of T-Rex on one device (BASELINE config 5).

Renders all views in a single jitted sweep through the filler's frame body
(the tile kernel on a GPU) and writes every 8th view as a PNG. Without the
reference's T-Rex mesh the committed ``assets/igor_sphere.obj`` stands in.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import time

import jax
import jax.numpy as jnp
import numpy as np

from cython3dmodelrenderer_tpu import Model
from cython3dmodelrenderer_tpu.config import RenderConfig
from cython3dmodelrenderer_tpu.ops import frame
from cython3dmodelrenderer_tpu.parallel import multiview
from cython3dmodelrenderer_tpu.utils.png import write_png

OBJECTS = os.environ.get("CRENDER_OBJECTS", "/root/reference/objects")
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "assets")
OUT = os.path.join(os.path.dirname(__file__), "..", "output")


def main(n_views: int = 64, size: int = 1024):
    path = os.path.join(OBJECTS, "T-Rex.obj")
    if not os.path.exists(path):
        path = os.path.join(ASSETS, "igor_sphere.obj")
    model = Model.read_model(path)
    model.rotate([-90, 180, 0])
    model.shift(-model.get_mean_vertex())
    model.scale(1.0 / model.get_max_span())
    # keep the model centered: the turntable applies the z shift per view

    tv = model.vertices_by_triangles
    tn = model.normals_by_triangles
    tc = model.colors_by_triangles
    if tc is None:   # untextured stand-in: seeded per-triangle colors
        rng = np.random.RandomState(0)
        tc = np.repeat(rng.uniform(0, 255, (model.n_triangles(), 1, 3)), 3,
                       axis=1)
    tc = jnp.asarray(tc, jnp.float32)
    config = RenderConfig(height=size, width=size, fov=45)

    backend = frame.resolve_backend()
    angles = multiview.turntable_angles(n_views)
    cap = multiview.sequence_capacity(tv, tn, angles, None, config,
                                      backend=backend)

    def sweep():
        return multiview.render_turntable(tv, tn, tc, angles, config,
                                          cap=cap, backend=backend, post="u8")

    frames = sweep()
    jax.block_until_ready(frames)

    t0 = time.perf_counter()
    frames = sweep()
    jax.block_until_ready(frames)
    dt = (time.perf_counter() - t0) * 1e3
    print(f"{n_views} views x {size}x{size} on "
          f"{jax.devices()[0].device_kind}: {dt:.1f} ms "
          f"({dt / n_views:.2f} ms/view)")

    os.makedirs(OUT, exist_ok=True)
    host = np.asarray(frames[::8])
    for k, image in enumerate(host):
        write_png(os.path.join(OUT, f"turntable_{8 * k:02d}.png"),
                  image[::-1])
    print(f"wrote {len(host)} frames to {OUT}/turntable_*.png")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=64)
    ap.add_argument("--size", type=int, default=1024)
    a = ap.parse_args()
    main(a.views, a.size)
