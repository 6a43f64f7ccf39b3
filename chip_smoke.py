"""Smoke test of the rasterizer's main path on one GPU.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # phase 6 only, on four cards

Phases (any failure exits non-zero; no phase swallows its own failure):

1. device and environment: the card's name and power limit, JAX's devices;
   the default backend must be the GPU and ``backend="auto"`` must pick the
   tile kernel ("pallas");
2. golden scene (``tools/make_golden.build_scene``, 512², Lambert) through
   ``AdvancedPixelBufferFiller``: against ``assets/golden_sphere.png`` and
   against the XLA oracle ``raster_ref`` run on the card; kernel-path vs
   oracle frame times;
3. full width: a 13,824-triangle textured sphere (T-Rex class, generated
   from a seed by ``tools/make_igor_sphere.py``) at 1024², fov 45, README
   pose, through ``Model.read_model`` and ``Renderer.render`` with
   ``GuroIllumination([0, 0, 1])``; against the oracle on the card; frame
   times of both paths and peak device memory;
4. sweep: ``Renderer.render_sequence`` over a 16-view turntable at 1024²,
   every view bit-identical to ``AdvancedPixelBufferFiller.render_arrays``
   on the same posed triangle arrays;
5. the card-only tests, ``pytest -m gpu``, in this process;
6. ``--four-cards``: view-sharded (16 views, 4 per card) and
   triangle-sharded renders on a 4-card mesh against the single-card
   render.

The last line of standard output is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

#: oracle agreement bounds: the kernel's λ division rounds differently
#: from XLA's, which may move the winner at triangle edges
Z_DIFF_FRAC_MAX = 1e-4     # pixels whose depth differs by > Z_TOL
Z_TOL = 1e-6
COLOR_TOL = 1              # u8, on pixels whose depth agrees
N_TIMED = 50
FULL_WIDTH = 1024          # image side of phases 3, 4 and 6
N_VIEWS = 16


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def timed(fn, n=N_TIMED):
    """(mean, median) ms of ``fn`` ending in block_until_ready, after one
    warm-up call."""
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(ts)), float(np.median(ts))


def oracle_agreement(tv, tn, tc, config, z, image, light):
    """Compare a frame's z-buffer and shaded u8 image with ``raster_ref``
    on the same device; returns the measured values."""
    import numpy as np

    from cython3dmodelrenderer_tpu.ops import frame, raster_ref
    from cython3dmodelrenderer_tpu.ops.illumination import lambert_to_u8

    ts, act = frame.geometry(tv, tn, config)
    bbox = raster_ref.required_bbox_size(ts, act, config)
    rc, rz, rn = raster_ref.rasterize(ts, tc, tn, act, config, bbox_size=bbox,
                                      chunk=frame.jnp_chunk(bbox))
    ref_img = np.asarray(lambert_to_u8(rc, rn, light)).astype(int)
    dz = np.abs(np.asarray(rz) - np.asarray(z))[..., 0]
    agree = dz <= Z_TOL
    cdiff = np.abs(ref_img - np.asarray(image).astype(int)).max(-1)
    got = {"z_diff_frac": float((~agree).mean()),
           "max_u8_diff_where_z_agrees": int(cdiff[agree].max()),
           "covered_frac": float((np.asarray(rz) < config.z_init).mean())}
    print(f"  oracle agreement: {got} (bounds: z_diff_frac <= "
          f"{Z_DIFF_FRAC_MAX} at |dz| > {Z_TOL}, u8 diff <= {COLOR_TOL})")
    check(got["z_diff_frac"] <= Z_DIFF_FRAC_MAX, f"z-buffer differs: {got}")
    check(got["max_u8_diff_where_z_agrees"] <= COLOR_TOL,
          f"color differs: {got}")
    check(got["covered_frac"] > 0.05, f"scene barely covered: {got}")
    return got, bbox


def frame_times(tv, tn, tc, config, light, bbox):
    """ms/frame of the whole jitted frame (geometry → raster → shade → u8)
    on the kernel path and on the XLA oracle at its sized bbox."""
    from cython3dmodelrenderer_tpu.ops import frame

    need = int(frame.frame_demand(tv, tn, config, "pallas"))
    cap = frame.capacity(need, "pallas", config)
    out = {}
    for backend, c in (("pallas", cap), ("jnp", bbox)):
        mean, med = timed(lambda: frame.render_frame(
            tv, tn, tc, config=config, backend=backend, cap=c,
            post="lambert_u8", light=light)[3])
        out[backend] = {"mean_ms": mean, "median_ms": med}
    return out


def phase1():
    import jax

    from cython3dmodelrenderer_tpu import AdvancedPixelBufferFiller

    backend = AdvancedPixelBufferFiller(64, 64)._resolve_backend()
    print(f"  backend='auto' resolves to {backend!r}")
    check(backend == "pallas",
          f"auto backend on {jax.default_backend()} is {backend!r}")


def phase2(card):
    import numpy as np

    from cython3dmodelrenderer_tpu import (AdvancedPixelBufferFiller,
                                           GuroIllumination)
    from cython3dmodelrenderer_tpu.utils.png import read_png
    from make_golden import GOLDEN_BOUNDS, OUT, build_scene, compare

    model, colors = build_scene()
    light = GuroIllumination([0, 0, 1]).light_direction
    filler = AdvancedPixelBufferFiller(512, 512, fov=45, backend="auto")
    filler.render_model(model, colors_override=colors, post="lambert_u8",
                        light=light)
    check(filler.validate_capacity(), "golden frame overflowed its bins")
    _c, z, _n, image = filler.snapshot_buffers(strict=True)
    got = compare(np.asarray(image), read_png(OUT)[::-1])
    print(f"  vs golden png: {got} (bounds: iou > {GOLDEN_BOUNDS['iou']}, "
          f"mae < {GOLDEN_BOUNDS['mae']}, frac_big < "
          f"{GOLDEN_BOUNDS['frac_big']})")
    check(got["iou"] > GOLDEN_BOUNDS["iou"], f"golden IoU: {got}")
    check(got["mae"] < GOLDEN_BOUNDS["mae"], f"golden MAE: {got}")
    check(got["frac_big"] < GOLDEN_BOUNDS["frac_big"], f"golden big: {got}")
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    _agree, bbox = oracle_agreement(tv, tn, colors, filler.config, z, image,
                                    light)
    times = frame_times(tv, tn, colors, filler.config, light, bbox)
    print(f"  512² frame ms [{card}]: {json.dumps(times)}")


def _full_width_model(directory):
    from cython3dmodelrenderer_tpu import Model, fit_model
    from make_igor_sphere import write_textured_sphere

    model = Model.read_model(write_textured_sphere(directory, 128, 55,
                                                   seed=0))
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    fit_model(model)
    return model


def phase3(card, directory):
    import jax
    import numpy as np

    from cython3dmodelrenderer_tpu import (AdvancedPixelBufferFiller,
                                           GuroIllumination, Renderer,
                                           SimpleIterator)

    model = _full_width_model(directory)
    model.shift([0.0, 0.0, 1.0])   # radius-1 sphere: clear the camera plane
    check(model.n_triangles() == 13824, f"{model.n_triangles()} triangles")
    illum = GuroIllumination([0, 0, 1])
    renderers = {
        backend: Renderer(AdvancedPixelBufferFiller(FULL_WIDTH, FULL_WIDTH,
                                                    fov=45, backend=backend),
                          illum, SimpleIterator, FULL_WIDTH, FULL_WIDTH,
                          use_tqdm=False)
        for backend in ("auto", "jnp")}
    r = renderers["auto"]
    image = r.render(model)
    check(r.pixel_buffer_filler.validate_capacity(), "frame overflowed")
    image = r.render(model).get_image()
    z = r.z_buffer.get_image()
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    tc = model.colors_by_triangles
    _agree, bbox = oracle_agreement(tv, tn, tc, r.pixel_buffer_filler.config,
                                    z, image, illum.light_direction)
    stats = r.pixel_buffer_filler.get_render_stats()
    print(f"  bin pairs {stats['pairs']} of capacity "
          f"{stats['pair_capacity']}; oracle bbox {bbox}")
    render_ms = {}
    for backend, rr in renderers.items():
        mean, med = timed(lambda rr=rr: rr.render(model).array)
        render_ms[backend] = {"mean_ms": mean, "median_ms": med}
    print(f"  {FULL_WIDTH}² Renderer.render ms [{card}]: "
          f"{json.dumps(render_ms)}")
    times = frame_times(tv, tn, tc, r.pixel_buffer_filler.config,
                        illum.light_direction, bbox)
    print(f"  {FULL_WIDTH}² frame ms [{card}]: {json.dumps(times)}")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"  peak_bytes_in_use {peak} [{card}]")
    check(np.asarray(image).max() > 0, "empty image")


def phase4(directory):
    import jax.numpy as jnp
    import numpy as np

    from cython3dmodelrenderer_tpu import (AdvancedPixelBufferFiller,
                                           GuroIllumination, Renderer,
                                           SimpleIterator)
    from cython3dmodelrenderer_tpu.parallel import multiview

    model = _full_width_model(directory)
    model.shift(-model.get_mean_vertex())       # turntable about the center
    illum = GuroIllumination([0, 0, 1])
    filler = AdvancedPixelBufferFiller(FULL_WIDTH, FULL_WIDTH, fov=45)
    r = Renderer(filler, illum, SimpleIterator, FULL_WIDTH, FULL_WIDTH,
                 use_tqdm=False)
    angles = multiview.turntable_angles(N_VIEWS)
    shifts = jnp.broadcast_to(jnp.float32([0.0, 0.0, 2.0]), (N_VIEWS, 3))
    frames = np.asarray(r.render_sequence(model, angles, shifts))
    check(frames.shape == (N_VIEWS, FULL_WIDTH, FULL_WIDTH, 3),
          f"shape {frames.shape}")
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    tc = model.colors_by_triangles
    mismatched = []
    for i in range(N_VIEWS):
        v, n = multiview._pose_triangles(tv, tn, angles[i], shifts[i])
        filler.render_arrays(v, n, tc, post="lambert_u8",
                             light=illum.light_direction)
        filler.validate_capacity()   # a view that outgrew the bins re-renders
        if not np.array_equal(frames[i], np.asarray(filler.get_post_image())):
            mismatched.append(i)
    print(f"  {N_VIEWS} views; views differing from render_arrays: "
          f"{mismatched}")
    check(not mismatched, f"sweep views {mismatched} differ")


def phase5():
    import pytest

    class Outcomes:
        def __init__(self):
            self.passed, self.failed, self.skipped = [], [], []

        def pytest_runtest_logreport(self, report):
            if report.skipped:
                self.skipped.append(report.nodeid)
            elif report.failed:
                self.failed.append(report.nodeid)
            elif report.when == "call":
                self.passed.append(report.nodeid)

    out = Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")], plugins=[out])
    print(f"  pytest -m gpu: rc={rc} passed={len(out.passed)} "
          f"failed={out.failed} skipped={out.skipped}")
    check(rc == 0 and out.passed and not out.failed and not out.skipped,
          "gpu tests did not all pass")


def phase6(card, directory):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cython3dmodelrenderer_tpu.config import RenderConfig
    from cython3dmodelrenderer_tpu.ops import frame
    from cython3dmodelrenderer_tpu.ops.illumination import lambert_shade
    from cython3dmodelrenderer_tpu.parallel import multiview
    from cython3dmodelrenderer_tpu.parallel.mesh import make_mesh

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices")
    model = _full_width_model(directory)
    model.shift(-model.get_mean_vertex())
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    tc = model.colors_by_triangles
    config = RenderConfig(height=FULL_WIDTH, width=FULL_WIDTH, fov=45)

    mesh = make_mesh([("views", 4)])
    angles = multiview.turntable_angles(N_VIEWS)
    cap = multiview.sequence_capacity(tv, tn, angles, None, config,
                                      backend="pallas",
                                      post_shift=(0.0, 0.0, 2.0))
    shard, need = multiview.render_turntable_sharded(
        tv, tn, tc, angles, config, mesh, backend="pallas", cap=cap,
        post_shift=(0.0, 0.0, 2.0), post="u8", check_capacity=True)
    local = multiview.render_turntable(tv, tn, tc, angles, config, cap=cap,
                                       backend="pallas",
                                       post_shift=(0.0, 0.0, 2.0), post="u8")
    same = np.asarray(shard) == np.asarray(local)
    print(f"  view-sharded: {N_VIEWS} views on 4 cards, peak demand "
          f"{int(need)} <= cap {cap}; views bit-identical: "
          f"{bool(same.all())}")
    check(int(need) <= cap and same.all(), "view-sharded != single card")

    tmesh = make_mesh([("tris", 4)])
    tv2 = tv + jnp.float32([0.0, 0.0, 2.0])
    color, z, _n, need = multiview.render_triangle_sharded(
        tv2, tn, tc, config, tmesh, backend="pallas", check_capacity=True)
    ts, act = frame.geometry(tv2, tn, config)
    cap1 = frame.capacity(int(frame.demand(ts, act, config, "pallas")),
                          "pallas", config)
    c1, z1, n1, _img, _need = frame.render_frame(
        tv2, tn, tc, config=config, backend="pallas", cap=cap1)
    zeq = np.asarray(z) == np.asarray(z1)
    light = multiview._norm_light((0.0, 0.0, 1.0))
    cdiff = float(jnp.max(jnp.abs(color - lambert_shade(c1, n1, light))))
    print(f"  triangle-sharded: {tv.shape[0] // 4} triangles per card, z "
          f"equal to the single card on {zeq.mean():.6f} of pixels; max "
          f"color diff {cdiff}")
    check(zeq.all(), "triangle-sharded z != single card")
    check(cdiff <= 1e-3, "triangle-sharded color != single card")
    for name, fn in (
            (f"view-sharded {N_VIEWS} views", lambda: multiview.render_turntable_sharded(
                tv, tn, tc, angles, config, mesh, backend="pallas", cap=cap,
                post_shift=(0.0, 0.0, 2.0), post="u8", auto_resize=False)),
            (f"single-card {N_VIEWS} views", lambda: multiview.render_turntable(
                tv, tn, tc, angles, config, cap=cap, backend="pallas",
                post_shift=(0.0, 0.0, 2.0), post="u8"))):
        mean, med = timed(fn, n=10)
        print(f"  {name}: mean {mean:.3f} ms, median {med:.3f} ms [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args()

    import jax

    from cython3dmodelrenderer_tpu.utils.cache import enable_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX devices: {devices})", file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    card = card_line()
    print(f"card: {card}")
    card = card.replace("\n", " | ")   # one line per card in the tags
    print(f"jax {jax.__version__}; devices {devices}; "
          f"device_kind {devices[0].device_kind}; compile cache {cache}")
    directory = os.path.join(REPO, "build", "chip_smoke")
    if args.four_cards:
        phases = [("6 four-card sharding", lambda: phase6(card, directory))]
    else:
        phases = [("1 device", phase1),
                  ("2 golden 512²", lambda: phase2(card)),
                  ("3 full width 1024²", lambda: phase3(card, directory)),
                  ("4 sweep", lambda: phase4(directory)),
                  ("5 gpu tests", phase5)]
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"phase {name}:", flush=True)
        fn()
        print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
