"""Degenerate inputs must not crash (lenient, like the reference)."""
import numpy as np
import jax.numpy as jnp
import pytest

from cython3dmodelrenderer_tpu import (AdvancedPixelBufferFiller, Model,
                                       NoIllumination, Renderer,
                                       SimpleIterator)
from cython3dmodelrenderer_tpu.config import RenderConfig
from cython3dmodelrenderer_tpu.ops import binning, raster_ref, raster_pallas
from cython3dmodelrenderer_tpu.ops.projection import (project_to_screen,
                                                      visibility_masks)


def render_both(tris, colors, normals, config):
    """(oracle, tile kernel in interpret mode) G-buffers of one scene."""
    tv, tn, tc = (jnp.asarray(tris), jnp.asarray(normals),
                  jnp.asarray(colors))
    degenerate, backfacing = visibility_masks(tv, tn)
    active = ~degenerate & ~backfacing
    ts = project_to_screen(tv, config)
    bbox = raster_ref.required_bbox_size(ts, active, config)
    ref = raster_ref.rasterize(ts, tc, tn, active, config,
                               bbox_size=bbox, chunk=8)
    total = int(raster_pallas.pair_total(ts, active, config))
    pal, used = raster_pallas.rasterize(
        ts, tc, tn, active, config,
        p_cap=binning.capacity_bucket(total, raster_pallas.CHUNK),
        interpret=True)
    assert int(used) == total
    return ref, pal


CONFIG = RenderConfig(height=64, width=64, fov=60)


def test_single_triangle_model():
    tris = np.array([[[-0.3, -0.3, 1.0], [0.3, -0.3, 1.0], [0.0, 0.3, 1.0]]],
                    np.float32)
    normals = np.full((1, 3, 3), [0, 0, -1], np.float32)
    colors = np.full((1, 3, 3), 128.0, np.float32)
    ref, pal = render_both(tris, colors, normals, CONFIG)
    np.testing.assert_allclose(np.asarray(ref[1]), np.asarray(pal[1]),
                               atol=1e-5)
    assert np.asarray(pal[0]).max() > 0


def test_all_backfacing():
    tris = np.array([[[-0.3, -0.3, 1.0], [0.3, -0.3, 1.0], [0.0, 0.3, 1.0]]],
                    np.float32)
    normals = np.full((1, 3, 3), [0, 0, 1], np.float32)   # away from camera
    colors = np.full((1, 3, 3), 128.0, np.float32)
    _, pal = render_both(tris, colors, normals, CONFIG)
    assert np.asarray(pal[0]).max() == 0
    assert float(np.asarray(pal[1]).min()) == CONFIG.z_init


def test_behind_camera():
    tris = np.array([[[-0.3, -0.3, -2.0], [0.3, -0.3, -2.0], [0.0, 0.3, -2.0]]],
                    np.float32)
    normals = np.full((1, 3, 3), [0, 0, -1], np.float32)
    colors = np.full((1, 3, 3), 128.0, np.float32)
    _, pal = render_both(tris, colors, normals, CONFIG)
    assert np.asarray(pal[0]).max() == 0


def test_screen_filling_triangle():
    tris = np.array([[[-50.0, -50.0, 1.0], [50.0, -50.0, 1.0],
                      [0.0, 80.0, 1.0]]], np.float32)
    normals = np.full((1, 3, 3), [0, 0, -1], np.float32)
    colors = np.full((1, 3, 3), 99.0, np.float32)
    ref, pal = render_both(tris, colors, normals, CONFIG)
    c = np.asarray(pal[0])
    assert (np.abs(c - 99.0) < 0.01).all()   # every pixel covered
    np.testing.assert_allclose(np.asarray(ref[0]), c, atol=0.05)


def test_vertex_at_camera_plane():
    """z=0 vertex → division by zero in projection; must not crash."""
    tris = np.array([[[-0.3, -0.3, 0.0], [0.3, -0.3, 1.0], [0.0, 0.3, 1.0]]],
                    np.float32)
    normals = np.full((1, 3, 3), [0, 0, -1], np.float32)
    colors = np.full((1, 3, 3), 128.0, np.float32)
    _, pal = render_both(tris, colors, normals, CONFIG)
    assert np.isfinite(np.asarray(pal[1])).all()


def test_empty_obj_model(tmp_path):
    path = tmp_path / "empty.obj"
    path.write_text("# nothing but a vertex\nv 0 0 0\n")
    model = Model.read_model(str(path))
    assert model.n_triangles() == 0
    renderer = Renderer(AdvancedPixelBufferFiller(32, 32, backend="jnp"),
                        NoIllumination(), SimpleIterator, 32, 32,
                        use_tqdm=False)
    image = renderer.render(model)
    assert image.get_image().max() == 0
