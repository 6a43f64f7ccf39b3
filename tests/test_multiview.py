"""Pose-sweep and sharded rendering tests (8-device CPU mesh, jnp backend).

The tile-kernel backend of the same paths runs on the GPU: the ``gpu``
tests in ``test_raster_kernel.py`` and ``chip_smoke.py --four-cards``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cython3dmodelrenderer_tpu.config import RenderConfig
from cython3dmodelrenderer_tpu.ops import frame
from cython3dmodelrenderer_tpu.parallel.mesh import make_mesh
from cython3dmodelrenderer_tpu.parallel import multiview


def tiny_scene(t=16, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.3, 0.3, size=(t, 1, 3)).astype(np.float32)
    centers[..., 2] = 0.0
    tris = centers + rng.uniform(-0.2, 0.2, size=(t, 3, 3)).astype(np.float32)
    normals = rng.randn(t, 3, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    colors = rng.uniform(0, 255, size=(t, 3, 3)).astype(np.float32)
    return jnp.asarray(tris), jnp.asarray(normals), jnp.asarray(colors)


CONFIG = RenderConfig(height=64, width=64, fov=45)


def _need_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def test_turntable_shapes_and_content():
    tv, tn, tc = tiny_scene()
    angles = multiview.turntable_angles(4)
    out = multiview.render_turntable(tv, tn, tc, angles, CONFIG, cap=32,
                                     backend="jnp")
    assert out.shape == (4, 64, 64, 3)
    assert float(jnp.max(out)) > 0
    # view 0 must equal a single-view render at the same pose
    v0, n0 = multiview._pose_triangles(tv, tn, jnp.zeros(3), (0.0, 0.0, 1.0))
    single, _, _ = multiview.render_view(v0, n0, tc, CONFIG,
                                         bbox_size=32, chunk=16)
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(single),
                               atol=1e-3)
    assert not np.allclose(np.asarray(out[0]), np.asarray(out[1]))


def test_sequence_frames_equal_single_frames():
    """Each sweep frame == the frame body on the same posed arrays."""
    tv, tn, tc = tiny_scene(t=24, seed=2)
    angles = multiview.turntable_angles(4)
    shifts = jnp.asarray(np.random.RandomState(1).uniform(
        -0.2, 0.2, (4, 3)).astype(np.float32)) + jnp.float32([0, 0, 1.5])
    cap = multiview.sequence_capacity(tv, tn, angles, shifts, CONFIG,
                                      backend="jnp")
    light = multiview._norm_light((0.0, 0.0, 1.0))
    seq, need = multiview.render_sequence(tv, tn, tc, angles, shifts, CONFIG,
                                          cap=cap, backend="jnp", post="u8",
                                          check_capacity=True)
    assert int(need) <= cap
    for i in range(4):
        v, n = multiview._pose_triangles(tv, tn, angles[i], shifts[i])
        img = frame.render_frame(v, n, tc, config=CONFIG, backend="jnp",
                                 cap=cap, post="lambert_u8", light=light)[3]
        np.testing.assert_array_equal(np.asarray(seq[i]), np.asarray(img))
    # float frames are the shaded color before quantization
    f32 = np.asarray(multiview.render_sequence(
        tv, tn, tc, angles, shifts, CONFIG, cap=cap, backend="jnp"))
    np.testing.assert_array_equal(f32.astype(np.uint8), np.asarray(seq))


def test_view_sharded_matches_single_device():
    _need_devices(8)
    tv, tn, tc = tiny_scene()
    mesh = make_mesh([("views", 8)])
    angles = multiview.turntable_angles(8)
    cap = multiview.sequence_capacity(tv, tn, angles, None, CONFIG,
                                      backend="jnp")
    sharded = np.asarray(multiview.render_turntable_sharded(
        tv, tn, tc, angles, CONFIG, mesh=mesh, axis="views", backend="jnp",
        cap=cap))
    local = np.asarray(multiview.render_turntable(
        tv, tn, tc, angles, CONFIG, cap=cap, backend="jnp"))
    np.testing.assert_array_equal(sharded, local)


def test_triangle_sharded_matches_single_device():
    _need_devices(8)
    tv, tn, tc = tiny_scene(t=32, seed=3)
    tv = tv + jnp.asarray([0.0, 0.0, 1.0])
    mesh = make_mesh([("tris", 8)])
    color_s, z_s, n_s = multiview.render_triangle_sharded(
        tv, tn, tc, CONFIG, mesh=mesh, axis="tris", backend="jnp")
    color_l, z_l, n_l = multiview.render_view(tv, tn, tc, CONFIG,
                                              bbox_size=32, chunk=4)
    np.testing.assert_array_equal(np.asarray(z_s), np.asarray(z_l))
    np.testing.assert_allclose(np.asarray(color_s), np.asarray(color_l),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(n_s), np.asarray(n_l), atol=1e-5)


def test_2d_mesh_views_by_tris():
    _need_devices(8)
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)


def test_sharded_overflow_detects_resizes_rerenders():
    """An undersized capacity under shard_map is DETECTED via the pmax'd
    peak demand and repaired by re-rendering at a grown bucket; with
    ``auto_resize`` off the truncation stays detectable."""
    _need_devices(4)
    rng = np.random.RandomState(4)
    big = jnp.asarray(rng.uniform(-0.6, 0.6, (8, 3, 3)).astype(np.float32))
    tn = jnp.asarray(np.tile(np.float32([0, 0, -1]), (8, 3, 1)))
    tc = jnp.asarray(rng.uniform(0, 255, (8, 3, 3)).astype(np.float32))
    mesh = make_mesh([("views", 4)])
    angles = multiview.turntable_angles(4)
    ref, need_ref = multiview.render_turntable_sharded(
        big, tn, tc, angles, CONFIG, mesh, backend="jnp",
        light_direction=None, check_capacity=True)
    assert int(need_ref) > 32, "scene too small to exercise overflow"
    repaired, _need = multiview.render_turntable_sharded(
        big, tn, tc, angles, CONFIG, mesh, backend="jnp", cap=32,
        light_direction=None, check_capacity=True)
    np.testing.assert_array_equal(np.asarray(repaired), np.asarray(ref))
    _trunc, need_off = multiview.render_turntable_sharded(
        big, tn, tc, angles, CONFIG, mesh, backend="jnp", cap=32,
        light_direction=None, check_capacity=True, auto_resize=False)
    assert int(need_off) > 32


def test_renderer_render_sequence_wrapper():
    """Renderer.render_sequence: the user-facing one-dispatch animation
    wrapper must match the functional multiview API exactly, derive its
    light from the illumination drawer, and support NoIllumination."""
    from cython3dmodelrenderer_tpu.fillers import AdvancedPixelBufferFiller
    from cython3dmodelrenderer_tpu.models.iterators import SimpleIterator
    from cython3dmodelrenderer_tpu.ops.illumination import (GuroIllumination,
                                                            NoIllumination)
    from cython3dmodelrenderer_tpu.renderer import Renderer

    tv, tn, tc = tiny_scene(t=20, seed=3)

    class _M:
        vertices_by_triangles = tv
        normals_by_triangles = tn
        colors_by_triangles = tc

    angles = multiview.turntable_angles(3)

    def make(illum):
        return Renderer(AdvancedPixelBufferFiller(64, 64, fov=45),
                        illum, SimpleIterator, image_height=64,
                        image_width=64, use_tqdm=False)

    got = np.asarray(make(GuroIllumination([0.2, 0.1, 1.0]))
                     .render_sequence(_M(), angles))
    assert got.shape == (3, 64, 64, 3) and got.dtype == np.uint8

    shifts = jnp.broadcast_to(jnp.float32([0.0, 0.0, 1.0]), (3, 3))
    cap = multiview.sequence_capacity(tv, tn, angles, shifts, CONFIG)
    want = np.asarray(multiview.render_sequence(
        tv, tn, tc, angles, shifts, CONFIG, cap=cap, backend="jnp",
        post="u8", light_direction=(0.2, 0.1, 1.0)))
    np.testing.assert_array_equal(got, want)

    # NoIllumination → unshaded colors (brighter than any lit render)
    raw = np.asarray(make(NoIllumination()).render_sequence(_M(), angles))
    want_raw = np.asarray(multiview.render_sequence(
        tv, tn, tc, angles, shifts, CONFIG, cap=cap, backend="jnp",
        post="u8", light_direction=None))
    np.testing.assert_array_equal(raw, want_raw)
    lit = want_raw.sum(-1) > 0
    assert (raw[lit].astype(int) >= got[lit].astype(int)).mean() > 0.99
