"""Demo driver — mirrors the reference's ``run.py`` T-Rex render.

Loads T-Rex, applies the README pose (``rotate([-90,180,0])`` →
``rotate([10,-80,0])`` → fit to unit span at z=1), renders 1024x1024 at
fov=45 with Lambert illumination, writes ``output/T-Rex.png``
(reference ``run.py:11-43``). Without the reference's T-Rex mesh the
committed ``assets/igor_sphere.obj`` stands in (written to
``output/igor_sphere.png``).
"""
import os
import time

import numpy as np

from cython3dmodelrenderer_tpu import (AdvancedPixelBufferFiller,
                                       GuroIllumination, Model, Renderer,
                                       SimpleIterator, fit_model)

OBJECTS_DIR = os.environ.get("CRENDER_OBJECTS",
                             "/root/reference/objects")


def render_demo(model, out_path="output/T-Rex.png", size=1024):
    filler = AdvancedPixelBufferFiller(size, size, fov=45)
    illumination = GuroIllumination([0, 0, 1])
    renderer = Renderer(filler, illumination, SimpleIterator,
                        *filler.get_size())
    image = renderer.render(model)

    # warm frames: compile before timing
    import jax

    for _ in range(2):
        image = renderer.render(model)
    jax.block_until_ready(image.array)

    # steady-state frame rate over a window of back-to-back frames
    n = 100
    t0 = time.perf_counter()
    for _ in range(n):
        image = renderer.render(model)
    jax.block_until_ready(image.array)
    dt = (time.perf_counter() - t0) / n
    print(f"frame time (compiled, amortized over {n}): {dt * 1e3:.2f} ms")

    # strict capacity validation (one sync) before the frame leaves the device
    filler.validate_capacity()
    image = renderer.render(model)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    image.write_to_file(out_path)
    print(f"wrote {out_path}")
    return image


if __name__ == "__main__":
    from cython3dmodelrenderer_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    path = os.path.join(OBJECTS_DIR, "T-Rex.obj")
    stand_in = not os.path.exists(path)
    if stand_in:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "assets", "igor_sphere.obj")
    model = Model.read_model(path)
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    fit_model(model)
    if stand_in:   # a radius-1 sphere at z=1 would touch the camera plane
        model.shift([0.0, 0.0, 1.0])
        render_demo(model, out_path="output/igor_sphere.png")
    else:
        render_demo(model)
