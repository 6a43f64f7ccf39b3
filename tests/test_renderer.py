"""Renderer orchestration, illumination, wireframe, and golden-image tests."""
import numpy as np
import jax.numpy as jnp
import pytest

from cython3dmodelrenderer_tpu import (AdvancedPixelBufferFiller, Buffer,
                                       DepthIterator, EdgeOnlyPixelBufferFiller,
                                       GuroIllumination, LineBresenham, Model,
                                       NoIllumination, Renderer, SimpleIterator,
                                       fit_model)
from cython3dmodelrenderer_tpu.utils import oracle


def make_renderer(size=128, fov=45, illum=None, iterator=SimpleIterator):
    filler = AdvancedPixelBufferFiller(size, size, fov=fov, backend="jnp")
    illum = illum or NoIllumination()
    return Renderer(filler, illum, iterator, size, size, use_tqdm=False)


def posed_trex(trex_path):
    model = Model.read_model(trex_path)
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    fit_model(model)
    return model


def test_render_textured_cube_like(trex_path):
    renderer = make_renderer(size=128)
    model = posed_trex(trex_path)
    image = renderer.render(model)
    a = image.get_image()
    assert a.dtype == np.uint8
    assert (a.sum(-1) > 0).mean() > 0.1  # something visible
    # depth buffer was filled
    z = renderer.z_buffer.get_image()
    assert z.min() < 1.0


def test_render_untextured_random_colors(cube_path):
    model = Model.read_model(cube_path)
    model.rotate([30, 40, 0])
    fit_model(model)
    renderer = make_renderer(size=64)
    image = renderer.render(model, random_colors=True)
    assert image.get_image().max() > 0


def test_render_untextured_white(cube_path):
    model = Model.read_model(cube_path)
    model.rotate([30, 40, 0])
    fit_model(model)
    renderer = make_renderer(size=64)
    image = renderer.render(model, random_colors=False)
    a = image.get_image()
    lit = a[a.sum(-1) > 0]
    assert len(lit) > 0
    # white triangles → all channels equal
    assert np.all(lit[:, 0] == lit[:, 1]) and np.all(lit[:, 1] == lit[:, 2])


def test_guro_illumination_math():
    illum = GuroIllumination([0, 0, 1])
    color = jnp.full((4, 4, 3), 100.0)
    normals = jnp.zeros((4, 4, 3)).at[..., 2].set(-1.0)  # facing camera
    out = np.asarray(illum.apply(color, normals))
    np.testing.assert_allclose(out, 100.0 * (1.0 / (1.0 + 1e-6)), rtol=1e-5)

    # normal perpendicular to light → dark
    normals_side = jnp.zeros((4, 4, 3)).at[..., 0].set(1.0)
    out = np.asarray(illum.apply(color, normals_side))
    np.testing.assert_allclose(out, 0.0, atol=1e-4)

    # matches the numpy oracle on random data
    rng = np.random.RandomState(0)
    c = rng.uniform(0, 255, (8, 8, 3)).astype(np.float32)
    n = rng.randn(8, 8, 3).astype(np.float32)
    got = np.asarray(illum.apply(jnp.asarray(c), jnp.asarray(n)))
    want = oracle.lambert_np(c, n, light_direction=(0, 0, 1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_no_illumination_identity():
    illum = NoIllumination()
    color = jnp.full((2, 2, 3), 42.0)
    out = np.asarray(illum.apply(color, jnp.zeros((2, 2, 3))))
    np.testing.assert_array_equal(out, 42.0)


def test_depth_iterator_order(cube_path):
    model = Model.read_model(cube_path)
    order = np.asarray(DepthIterator.order_indices(model))
    min_z = np.asarray(model.vertices_by_triangles)[:, :, 2].min(axis=1)
    assert np.all(np.diff(min_z[order]) >= 0)


def test_iterator_protocol(cube_path):
    model = Model.read_model(cube_path)
    tris = list(SimpleIterator(model))
    assert len(tris) == 12
    tri, colors, normals = tris[0]
    assert tri.shape == (3, 3) and normals.shape == (3, 3)
    assert colors is None  # untextured

    tris_sorted = list(DepthIterator(model))
    assert len(tris_sorted) == 12


def test_reset_buffers(trex_path):
    renderer = make_renderer(size=64)
    model = posed_trex(trex_path)
    renderer.render(model)
    assert renderer.color_buffer.get_image().max() > 0
    renderer.reset_buffers()
    assert renderer.color_buffer.get_image().max() == 0
    assert renderer.z_buffer.get_image().min() == np.float32(1e6)


def test_buffer_api():
    buf = Buffer(4, 8, dim=3, dtype="float32", init_val=7)
    assert buf.get_size() == (4, 8)
    assert buf.get_image().shape == (4, 8, 3)
    assert buf.get_image()[0, 0, 0] == 7
    buf.set_pixel(2, 1, [1, 2, 3])
    np.testing.assert_array_equal(buf.get_pixel(2, 1), [1, 2, 3])
    buf.set_pixel(100, 100, [9, 9, 9])  # silently dropped
    buf[0, 0] = [5, 5, 5]
    np.testing.assert_array_equal(buf[0, 0], [5, 5, 5])
    buf.clear()
    assert buf.get_image()[2, 1, 0] == 7


def test_wireframe_matches_scalar_bresenham():
    """Batched closed-form Bresenham == the scalar reference algorithm."""
    from cython3dmodelrenderer_tpu.ops import wireframe

    rng = np.random.RandomState(5)
    h = w = 48
    for _ in range(20):
        p1 = rng.randint(-5, 53, size=2)
        p2 = rng.randint(-5, 53, size=2)
        # scalar path
        buf = Buffer(h, w, dim=3, dtype="float32")
        LineBresenham().draw_line(list(p1), list(p2), buf, [255.0, 0.0, 0.0])
        want = buf.get_image()
        # batched path
        img = jnp.zeros((h, w, 3), jnp.float32)
        got = np.asarray(wireframe.rasterize_lines(
            img, jnp.asarray([p1], jnp.int32), jnp.asarray([p2], jnp.int32),
            jnp.asarray([[255.0, 0.0, 0.0]]), jnp.ones((1,), bool),
            h, w, max_steps=128))
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"line {p1} -> {p2}")


def test_wireframe_far_offscreen_endpoints():
    """Lines with endpoints thousands of pixels off-screen draw their
    visible segment exactly like the scalar per-pixel walk.

    The reference steps every pixel and bounds-drops each one
    (line_bresenham.py:6-45, buffer.py:66-69); the batched path must match
    it via phase-preserving viewport clipping, not truncate at a step
    budget."""
    from cython3dmodelrenderer_tpu.ops import wireframe

    h = w = 48
    cases = [
        ((-10000, 20), (10000, 30)),     # near-horizontal, both far out
        ((25, -9000), (20, 9000)),       # near-vertical
        ((-8000, -7990), (8000, 8010)),  # diagonal
        ((-12000, -300), (12000, 400)),  # shallow slope crossing
        ((5, 5), (20000, 5011)),         # one endpoint far out
        ((-5000, 100), (-4000, 90)),     # fully off-screen → empty
        ((2, 3), (2, 3)),                # degenerate point, on-screen
    ]
    for p1, p2 in cases:
        buf = Buffer(h, w, dim=3, dtype="float32")
        LineBresenham().draw_line(list(p1), list(p2), buf, [255.0, 0.0, 0.0])
        want = buf.get_image()
        img = jnp.zeros((h, w, 3), jnp.float32)
        got = np.asarray(wireframe.rasterize_lines(
            img, jnp.asarray([p1], jnp.int32), jnp.asarray([p2], jnp.int32),
            jnp.asarray([[255.0, 0.0, 0.0]]), jnp.ones((1,), bool),
            h, w, max_steps=2 * max(h, w)))
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"line {p1} -> {p2}")


def test_edge_only_filler_batched(cube_path):
    model = Model.read_model(cube_path)
    filler = EdgeOnlyPixelBufferFiller(LineBresenham(), np.array([255, 255, 255]))
    renderer = Renderer(filler, NoIllumination(), SimpleIterator, 64, 64,
                        use_tqdm=False)
    image = renderer.render(model, normalize_model=True)
    a = image.get_image()
    assert a.max() == 255
    # wireframe: sparse coverage
    assert 0 < (a.sum(-1) > 0).mean() < 0.5


def test_per_triangle_compat_path(cube_path):
    """compute_triangle_statistics (py-reference API) vs batched render."""
    model = Model.read_model(cube_path)
    model.rotate([30, 40, 0])
    fit_model(model)
    size = 64
    rng = np.random.RandomState(7)
    colors = np.repeat(rng.uniform(0, 255, (12, 1, 3)), 3, axis=1).astype(np.float32)

    # batched
    filler_b = AdvancedPixelBufferFiller(size, size, fov=45, backend="jnp")
    filler_b.render_model(model, colors_override=jnp.asarray(colors))
    batched_color = np.asarray(filler_b.get_color_buffer())

    # per-triangle loop
    filler_s = AdvancedPixelBufferFiller(size, size, fov=45, backend="jnp")
    color_buf = Buffer(size, size, dim=3, dtype="float32")
    z_buf = Buffer(size, size, dim=1, dtype="float32", init_val=1e6)
    n_buf = Buffer(size, size, dim=3, dtype="float32")
    for i in range(model.n_triangles()):
        tri, _, normals = model.get_triangle(i)
        filler_s.compute_triangle_statistics(tri, colors[i], normals,
                                             color_buf, z_buf, n_buf)
    np.testing.assert_allclose(batched_color, color_buf.get_image(),
                               atol=0.05, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(filler_b.get_z_buffer()),
                               z_buf.get_image(), atol=1e-5)


def test_per_triangle_compat_path_512(trex_path):
    """The compat path at 512² on a real mesh subset, in seconds not hours.

    Guards the bbox-windowed formulation (the former full-image grids made
    this path ~(image/bbox)² slower — unusable beyond toy sizes): 250 T-Rex
    triangles at 512² must match the batched oracle exactly.
    """
    model = posed_trex(trex_path)
    size = 512
    n = 250
    tris = np.asarray(model.vertices_by_triangles)[:n]
    cols = np.asarray(model.colors_by_triangles)[:n]
    norms = np.asarray(model.normals_by_triangles)[:n]

    filler_b = AdvancedPixelBufferFiller(size, size, fov=45, backend="jnp")
    filler_b.render_arrays(jnp.asarray(tris), jnp.asarray(norms),
                           jnp.asarray(cols))
    batched_color = np.asarray(filler_b.get_color_buffer())

    filler_s = AdvancedPixelBufferFiller(size, size, fov=45, backend="jnp")
    color_buf = Buffer(size, size, dim=3, dtype="float32")
    z_buf = Buffer(size, size, dim=1, dtype="float32", init_val=1e6)
    n_buf = Buffer(size, size, dim=3, dtype="float32")
    for i in range(n):
        filler_s.compute_triangle_statistics(tris[i], cols[i], norms[i],
                                             color_buf, z_buf, n_buf)
    np.testing.assert_allclose(batched_color, color_buf.get_image(),
                               atol=0.05, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(filler_b.get_z_buffer()),
                               z_buf.get_image(), atol=1e-5)


def test_golden_trex(trex_path):
    """Our render vs the committed reference render (output/T-Rex.png).

    The golden was produced by the reference Cython renderer's ``run.py``
    (1024², fov=45, GuroIllumination). Compared at native resolution; the
    only tolerated differences are the reference's racy z-resolve and float
    ordering (<0.2% of pixels).
    """
    import os

    from cython3dmodelrenderer_tpu.utils.png import read_png

    path = "/root/reference/output/T-Rex.png"
    if not os.path.exists(path):
        pytest.skip("golden render unavailable")
    golden = read_png(path)[::-1]  # file rows are flipped on write

    model = posed_trex(trex_path)
    filler = AdvancedPixelBufferFiller(1024, 1024, fov=45, backend="jnp")
    renderer = Renderer(filler, GuroIllumination([0, 0, 1]), SimpleIterator,
                        1024, 1024, use_tqdm=False)
    ours = renderer.render(model).get_image()

    ours_mask = ours.sum(-1) > 15
    gold_mask = golden.sum(-1) > 15
    iou = (ours_mask & gold_mask).sum() / (ours_mask | gold_mask).sum()
    assert iou > 0.995, f"silhouette IoU too low: {iou}"

    both = ours_mask & gold_mask
    mae = np.abs(ours[both].astype(np.float32)
                 - golden[both].astype(np.float32)).mean()
    assert mae < 1.0, f"color MAE too high: {mae}"

    frac_big = (np.abs(ours.astype(np.float32) - golden.astype(np.float32))
                .max(-1) > 20).mean()
    assert frac_big < 0.002, f"too many >20-diff pixels: {frac_big}"


def test_golden_standalone():
    """SELF-CONTAINED golden: the tile kernel (interpret mode) through the
    frame body vs the committed ``assets/golden_sphere.png`` (generated from
    committed inputs by the pure-XLA oracle backend —
    ``tools/make_golden.py``). Runs with no reference mount at all."""
    from cython3dmodelrenderer_tpu import GuroIllumination
    from cython3dmodelrenderer_tpu.config import RenderConfig
    from cython3dmodelrenderer_tpu.ops import frame
    from cython3dmodelrenderer_tpu.utils.png import read_png
    from tools.make_golden import GOLDEN_BOUNDS, OUT, build_scene, compare

    golden = read_png(OUT)[::-1]   # file rows are flipped on write
    model, colors = build_scene()
    config = RenderConfig(height=512, width=512, fov=45)
    tv, tn = model.vertices_by_triangles, model.normals_by_triangles
    need = int(frame.frame_demand(tv, tn, config, "pallas"))
    _c, _z, _n, ours, used = frame.render_frame(
        tv, tn, colors, config=config, backend="pallas",
        cap=frame.capacity(need, "pallas", config), post="lambert_u8",
        light=GuroIllumination([0, 0, 1]).light_direction, interpret=True)
    assert int(used) == need
    ours = np.asarray(ours)
    assert ours.shape == golden.shape
    got = compare(ours, golden)
    assert got["iou"] > GOLDEN_BOUNDS["iou"], got
    assert got["mae"] < GOLDEN_BOUNDS["mae"], got
    assert got["frac_big"] < GOLDEN_BOUNDS["frac_big"], got


def test_buffer_save_load(tmp_path):
    buf = Buffer(8, 8, dim=3, dtype="float32", init_val=2)
    buf.set_pixel(3, 4, [9, 8, 7])
    path = str(tmp_path / "ckpt.npz")
    buf.save(path)
    restored = Buffer.load(path)
    np.testing.assert_array_equal(restored.get_image(), buf.get_image())
    assert restored.get_size() == (8, 8)
    # clear() restores the original init value
    restored.clear()
    assert restored.get_image()[0, 0, 0] == 2


def test_guro_draw_illumination_buffer_form():
    """py-reference call form: draw_illumination mutates a uint8 Buffer."""
    illum = GuroIllumination([0, 0, 1])
    color = Buffer(4, 4, dim=3, dtype="uint8", init_val=100)
    nbuf = Buffer(4, 4, dim=3, dtype="float32")
    nbuf.array = jnp.zeros((4, 4, 3)).at[..., 2].set(-1.0)
    illum.draw_illumination(color, nbuf)
    got = color.get_image()
    assert got.dtype == np.uint8
    # facing the light → shadow ≈ 1 → colors preserved (±1 quantization)
    assert np.all(np.abs(got.astype(int) - 100) <= 1)

    # perpendicular normal → black
    nbuf.array = jnp.zeros((4, 4, 3)).at[..., 0].set(1.0)
    color2 = Buffer(4, 4, dim=3, dtype="uint8", init_val=100)
    illum.draw_illumination(color2, nbuf)
    assert color2.get_image().max() == 0


def test_guro_draw_illumination_ndarray_form():
    """cy-reference call form: raw float arrays, returns shaded array."""
    illum = GuroIllumination([0, 0, 1])
    color = np.full((4, 4, 3), 100.0, np.float32)
    nbuf = np.zeros((4, 4, 3), np.float32)
    nbuf[..., 2] = -1.0
    out = np.asarray(illum.draw_illumination(color, nbuf))
    np.testing.assert_allclose(out, 100.0, atol=0.01)


def test_edge_only_vertices_mode(cube_path):
    filler = EdgeOnlyPixelBufferFiller(LineBresenham(),
                                       np.array([255, 255, 255]),
                                       draw_edges=False)
    renderer = Renderer(filler, NoIllumination(), SimpleIterator, 64, 64,
                        use_tqdm=False)
    model = Model.read_model(cube_path)
    image = renderer.render(model, normalize_model=True)
    a = image.get_image()
    # vertices only: at most 3*T lit pixels
    assert 0 < (a.sum(-1) > 0).sum() <= 3 * model.n_triangles()


def test_depth_iterator_through_renderer(trex_path):
    """DepthIterator order through the batched Renderer path: identical
    z-buffer to SimpleIterator (order only affects exact depth ties)."""
    model = posed_trex(trex_path)
    r1 = make_renderer(size=96)
    r2 = make_renderer(size=96, iterator=DepthIterator)
    r1.render(model)
    r2.render(model)
    z1 = r1.z_buffer.get_image()
    z2 = r2.z_buffer.get_image()
    np.testing.assert_allclose(z1, z2, atol=1e-6)


def test_custom_line_drawer_sees_every_edge(cube_path):
    """A non-built-in LineDrawer must receive every edge (reference routes
    all lines through the injected drawer, edge_only_pixel_buffer_filler.py:
    21-33) — the batched closed-form path only replaces LineBresenham."""
    from cython3dmodelrenderer_tpu import LineDrawer

    class RecordingDrawer(LineDrawer):
        def __init__(self):
            self.calls = []

        def draw_line(self, p1, p2, buffer, color):
            self.calls.append((tuple(p1), tuple(p2)))

    model = Model.read_model(cube_path)
    drawer = RecordingDrawer()
    filler = EdgeOnlyPixelBufferFiller(drawer, np.array([255, 255, 255]))
    renderer = Renderer(filler, NoIllumination(), SimpleIterator, 64, 64,
                        use_tqdm=False)
    renderer.render(model, normalize_model=True)
    assert len(drawer.calls) == model.n_triangles() * 3
