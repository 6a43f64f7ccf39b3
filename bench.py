"""Benchmarks for the BASELINE configs.

Default invocation prints ONE JSON line — the headline metric (T-Rex.obj @
1024x1024, README pose, fov=45; reference best: Version C / 8 threads at
9 ms per frame, README.md:76). ``--config {cube,bunny,trex,igor,turntable,
all}`` benchmarks the other BASELINE.md configs, one JSON line each.

The igor config's mesh is pruned from the mounted reference
(.MISSING_LARGE_BLOBS) — the committed, reproducible ``assets/igor_sphere.obj``
(displaced UV sphere, ``tools/make_igor_sphere.py``) stands in as the textured
mesh with igor's texture, exercising the same path (texture sampling at vertex
UVs + Lambert).
"""
import argparse
import json
import os
import time

import numpy as np

BASELINE_MS = 9.0  # Version C, 8 threads (reference README.md:76)
OBJECTS = os.environ.get("CRENDER_OBJECTS", "/root/reference/objects")


ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def _posed(name, pose=True):
    from cython3dmodelrenderer_tpu import Model, fit_model

    kwargs = {}
    base = OBJECTS
    if name == "igor_sphere.obj":  # committed mesh + reference texture
        base = ASSETS
        kwargs["external_texture_filename"] = os.path.join(
            OBJECTS, "igor_texture.png")
    model = Model.read_model(os.path.join(base, name), **kwargs)
    if pose:
        model.rotate([-90, 180, 0])
        model.rotate([10, -80, 0])
    fit_model(model)
    if name == "igor_sphere.obj":
        # fit_model normalizes RADIUS to 1 (reference model.py:160) and puts
        # the center at z=1 — a round mesh would touch the camera plane, so
        # push it one unit further back
        model.shift([0.0, 0.0, 1.0])
    return model


def _device():
    """Where the numbers were taken: platform and device kind."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind}


def _time_frames(fn, n_warm=3, n_iter=100, n_trials=3):
    """Best-of-N trials of a window of ``n_iter`` back-to-back frames
    (steady-state frame rate is the metric, matching the reference's loop
    timing)."""
    import jax

    for _ in range(n_warm):
        out = fn()
        jax.block_until_ready(out)
    best = float("inf")
    for _ in range(n_trials):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / n_iter * 1e3)
    return best


def _bench_single(model, size, fov, illum, metric, vs_baseline=None):
    import jax.numpy as jnp

    from cython3dmodelrenderer_tpu import (AdvancedPixelBufferFiller,
                                           GuroIllumination, NoIllumination)

    filler = AdvancedPixelBufferFiller(size, size, fov=fov)
    tv = model.vertices_by_triangles
    tn = model.normals_by_triangles
    tc = model.colors_by_triangles
    if tc is None:
        rng = np.random.RandomState(0)
        per_tri = rng.randint(256, size=(model.n_triangles(), 3))
        tc = jnp.asarray(np.repeat(per_tri[:, None, :], 3, axis=1)
                         .astype(np.float32))
    shader = GuroIllumination([0, 0, 1]) if illum else NoIllumination()

    post = "lambert_u8" if illum else "u8"
    light = shader.light_direction if illum else None

    def frame():
        # shade+quantize fused into the frame's single dispatch
        filler.render_arrays(tv, tn, tc, post=post, light=light)
        return filler._post_image

    first = frame()
    assert int(jnp.max(first)) > 0, f"{metric}: rendered an empty frame"
    ms = _time_frames(frame)
    tris = model.n_triangles()
    out = {
        "metric": metric,
        "value": round(ms, 3),
        "unit": "ms",
        "mtris_per_sec": round(tris / ms / 1e3, 3),
        **_device(),
    }
    if vs_baseline is not None:
        out["vs_baseline"] = round(vs_baseline / ms, 3)
    return out


def bench_trex():
    return _bench_single(_posed("T-Rex.obj"), 1024, 45, illum=False,
                         metric="T-Rex.obj 1024x1024 ms/frame "
                                "(README pose, fov=45)",
                         vs_baseline=BASELINE_MS)


def bench_cube():
    return _bench_single(_posed("cube.obj", pose=False), 256, 90, illum=False,
                         metric="cube.obj 256x256 ms/frame (flat color)")


def bench_bunny():
    return _bench_single(_posed("bunny.obj"), 512, 45, illum=False,
                         metric="bunny.obj 512x512 ms/frame (z-test)")


def bench_igor():
    return _bench_single(_posed("igor_sphere.obj"), 1024, 45, illum=True,
                         metric="igor-config (igor_sphere+igor texture) "
                                "1024x1024 ms/frame (textured + Lambert)")


def bench_turntable():
    import jax.numpy as jnp

    from cython3dmodelrenderer_tpu.config import RenderConfig
    from cython3dmodelrenderer_tpu.ops import frame
    from cython3dmodelrenderer_tpu.parallel import multiview

    model = _posed("T-Rex.obj")
    model.shift([0.0, 0.0, -1.0])  # recenter: turntable re-applies the shift
    tv = model.vertices_by_triangles
    tn = model.normals_by_triangles
    tc = jnp.asarray(model.colors_by_triangles, jnp.float32)
    config = RenderConfig(height=1024, width=1024, fov=45)
    angles = multiview.turntable_angles(64)
    backend = frame.resolve_backend()
    # exact per-pose sizing: every rendered angle's demand is evaluated, so
    # no sampling headroom is needed (the check_capacity assert below would
    # catch any sizing error)
    cap = multiview.sequence_capacity(tv, tn, angles, None, config,
                                      backend=backend, headroom=1.0)

    def sweep():
        # post="u8": display-ready uint8 frames, matching the reference's
        # uint8 BGR Buffer (and the single-frame bench's fused quantize)
        return multiview.render_turntable(tv, tn, tc, angles, config,
                                          cap=cap, backend=backend,
                                          check_capacity=True, post="u8")

    _imgs, used = sweep()
    assert int(used) <= cap, \
        f"turntable demand {int(used)} overflowed capacity {cap}"
    ms = _time_frames(sweep, n_warm=2, n_iter=3)
    return {
        "metric": "64-camera T-Rex turntable 1024x1024 ms/view",
        "value": round(ms / 64, 3),
        "unit": "ms",
        "views": 64,
        "sweep_ms": round(ms, 1),
        **_device(),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="trex",
                        choices=["trex", "cube", "bunny", "igor",
                                 "turntable", "all"])
    args = parser.parse_args()
    from cython3dmodelrenderer_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    benches = {
        "trex": bench_trex,
        "cube": bench_cube,
        "bunny": bench_bunny,
        "igor": bench_igor,
        "turntable": bench_turntable,
    }
    names = list(benches) if args.config == "all" else [args.config]
    for name in names:
        print(json.dumps(benches[name]()))


if __name__ == "__main__":
    main()
