"""The tile kernel (``ops/raster_pallas.py``), its binning and its selection.

CPU tests run the kernel in the Pallas interpreter, where it evaluates the
oracle's own expressions in the oracle's order, so its G-buffers must equal
``raster_ref``'s exactly. ``gpu`` tests run the compiled kernel on the card.
"""
import functools
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cython3dmodelrenderer_tpu import AdvancedPixelBufferFiller
from cython3dmodelrenderer_tpu.config import RenderConfig
from cython3dmodelrenderer_tpu.ops import binning, frame, raster_pallas, \
    raster_ref
from cython3dmodelrenderer_tpu.ops.projection import (project_to_screen,
                                                      visibility_masks)
from cython3dmodelrenderer_tpu.parallel import multiview
from cython3dmodelrenderer_tpu.utils.png import read_png, write_png


def _scene(tris, seed=0):
    t = tris.shape[0]
    rng = np.random.RandomState(seed)
    normals = np.tile(np.float32([0, 0, -1]), (t, 3, 1))
    colors = rng.uniform(0, 255, (t, 3, 3)).astype(np.float32)
    return jnp.asarray(tris), jnp.asarray(normals), jnp.asarray(colors)


def _both(tv, tn, tc, config, interpret=True):
    degenerate, backfacing = visibility_masks(tv, tn)
    active = ~degenerate & ~backfacing
    ts = project_to_screen(tv, config)
    bbox = raster_ref.required_bbox_size(ts, active, config)
    ref = raster_ref.rasterize(ts, tc, tn, active, config, bbox_size=bbox,
                               chunk=frame.jnp_chunk(bbox))
    total = int(raster_pallas.pair_total(ts, active, config))
    out, used = raster_pallas.rasterize(
        ts, tc, tn, active, config,
        p_cap=binning.capacity_bucket(total, raster_pallas.CHUNK),
        interpret=interpret)
    assert int(used) == total
    return [np.asarray(a) for a in ref], [np.asarray(a) for a in out]


def _multi_tile_tris(t=40, seed=0, spread=0.5, size=0.35):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-spread, spread, (t, 1, 3)).astype(np.float32)
    centers[..., 2] = rng.uniform(1.2, 2.0, (t, 1))
    return centers + rng.uniform(-size, size, (t, 3, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", ["multi_tile", "screen_filling"])
def test_kernel_matches_oracle(kind):
    """Seeded overlapping triangles spanning several tiles (odd image size,
    partial edge tiles), and a screen-filling triangle behind them."""
    config = RenderConfig(height=72, width=88, fov=60)
    tris = _multi_tile_tris()
    if kind == "screen_filling":
        big = np.float32([[[-50, -50, 3], [50, -50, 3], [0, 80, 3]]])
        tris = np.concatenate([tris[:8], big])
    ref, got = _both(*_scene(tris), config)
    assert (ref[1] < config.z_init).mean() > 0.3
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_exact_depth_ties_pick_lower_triangle():
    """Coplanar duplicates: the lower triangle index wins every pixel, in
    either order and across chunk boundaries."""
    config = RenderConfig(height=32, width=64, fov=60)
    tri = np.float32([[-0.4, -0.4, 1.5], [0.4, -0.4, 1.5], [0.0, 0.4, 1.5]])
    n = 2 * raster_pallas.CHUNK + 3            # ties span several chunks
    tris = np.repeat(tri[None], n, axis=0)
    tv, tn, _ = _scene(tris)
    # triangle i has color i, so the winning index is visible in the image
    tc = jnp.asarray(np.repeat(np.arange(n, dtype=np.float32)[:, None, None],
                               9, axis=1).reshape(n, 3, 3))
    ref, got = _both(tv, tn, tc, config)
    covered = got[1][..., 0] < config.z_init
    assert covered.mean() > 0.05
    assert (got[0][covered] == 0).all()
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_bin_tails_not_multiple_of_chunk():
    """Tiles whose bins hold 1, CHUNK-1, CHUNK+1 and 2*CHUNK+3 candidates:
    the masked tail lanes of a chunk must never win a pixel."""
    k = raster_pallas.CHUNK
    th, tw = raster_pallas.TILE_H, raster_pallas.TILE_W
    config = RenderConfig(height=2 * th, width=2 * tw, fov=60)
    f = 1.0 / np.tan(np.pi / 6)
    rng = np.random.RandomState(3)
    parts = []
    for tile, count in enumerate([1, k - 1, k + 1, 2 * k + 3]):
        # triangles inside tile (tile % 2, tile // 2), placed in screen
        # space and un-projected at depth z
        sx = (tile % 2 + rng.uniform(0.2, 0.8, (count, 3))) * tw
        sy = (tile // 2 + rng.uniform(0.2, 0.8, (count, 3))) * th
        z = rng.uniform(1.0, 2.0, (count, 3))
        x = (sx / (config.width / 2) - 1) * config.aspect / f * z
        y = (sy / (config.height / 2) - 1) / f * z
        parts.append(np.stack([x, y, z], -1).astype(np.float32))
    tris = np.concatenate(parts)
    tv, tn, tc = _scene(tris, seed=1)
    degenerate, backfacing = visibility_masks(tv, tn)
    ts = project_to_screen(tv, config)
    spans = binning.tile_spans(ts, ~degenerate & ~backfacing, config,
                               raster_pallas.TILE_H, raster_pallas.TILE_W)
    ntx, nty = raster_pallas.tile_grid(config)
    _slots, _starts, counts = binning.bin_pairs(
        *spans, binning.capacity_bucket(int(jnp.sum(spans[4])), k), ntx, nty)
    assert sorted(np.asarray(counts).tolist()) == [1, k - 1, k + 1, 2 * k + 3]
    ref, got = _both(tv, tn, tc, config)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_bin_pairs_contract():
    """Every (tile, triangle) pair of the clipped ceil-bboxes lands in its
    tile's bin, in ascending triangle order; slots past the total are in no
    bin."""
    config = RenderConfig(height=48, width=80, fov=60)
    tv, tn, _ = _scene(_multi_tile_tris(t=25, seed=5))
    degenerate, backfacing = visibility_masks(tv, tn)
    active = ~degenerate & ~backfacing
    ts = project_to_screen(tv, config)
    th, tw = 16, 16
    spans = binning.tile_spans(ts, active, config, th, tw)
    ntx, nty = -(-80 // tw), -(-48 // th)
    total = int(jnp.sum(spans[4]))
    slots, starts, counts = map(np.asarray, binning.bin_pairs(
        *spans, total + 13, ntx, nty))
    xl, xr, yl, yr = map(np.asarray, raster_ref.bbox_ceil(
        ts[..., :2], config.width, config.height))
    act = np.asarray(active)
    for ty in range(nty):
        for tx in range(ntx):
            want = [i for i in range(len(act)) if act[i]
                    and xr[i] > xl[i] and yr[i] > yl[i]
                    and xl[i] < (tx + 1) * tw and xr[i] > tx * tw
                    and yl[i] < (ty + 1) * th and yr[i] > ty * th]
            i = ty * ntx + tx
            got = slots[starts[i]:starts[i] + counts[i]].tolist()
            assert got == want, (tx, ty)
    assert counts.sum() == total


@pytest.mark.parametrize("platform,want", [("gpu", "pallas"), ("cpu", "jnp"),
                                           ("quantum-abacus", None)])
def test_resolve_backend_by_platform(monkeypatch, platform, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    filler = AdvancedPixelBufferFiller(16, 16)
    if want is None:
        with pytest.raises(ValueError, match="no rasterizer backend"):
            filler._resolve_backend()
    else:
        assert filler._resolve_backend() == want
    # an explicit backend is never remapped
    assert AdvancedPixelBufferFiller(16, 16, backend="jnp") \
        ._resolve_backend() == "jnp"


def test_filler_capacity_overflow_is_repaired(monkeypatch):
    """The filler's pair-capacity protocol on the kernel path (interpreted):
    a frame whose pairs overflow the cached bucket is detected by the
    background reader, the bucket grows and the frame is re-rendered, so
    the validated buffers equal the oracle's."""
    monkeypatch.setattr(frame, "render_frame",
                        functools.partial(frame.render_frame, interpret=True))
    config = RenderConfig(height=256, width=256, fov=60)
    small = _multi_tile_tris(t=96, seed=2, size=0.05)
    large = _multi_tile_tris(t=96, seed=2, size=2.0)
    filler = AdvancedPixelBufferFiller(256, 256, fov=60, backend="pallas")
    tv, tn, tc = _scene(small)
    filler.render_arrays(tv, tn, tc)
    assert filler.validate_capacity()
    cap0 = filler.get_render_stats()["pair_capacity"]
    tv, tn, tc = _scene(large)       # same triangle count: bucket reused
    assert int(frame.frame_demand(tv, tn, config, "pallas")) > cap0
    filler.render_arrays(tv, tn, tc)
    assert not filler.validate_capacity()        # overflowed, repaired
    stats = filler.get_render_stats()
    assert stats["pair_capacity"] > cap0 >= 0
    assert stats["pairs"] <= stats["pair_capacity"]
    ref, _ = _both(tv, tn, tc, config)
    got = filler.snapshot_buffers(strict=True)[:3]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, np.asarray(b))


def _png_with_filters(img: np.ndarray, filters) -> bytes:
    """Encode an (H, W, 3) RGB image with the given per-row filter types."""
    h, w, _ = img.shape
    bpp, raw, prev = 3, bytearray(), np.zeros(w * 3, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def test_png_codec(tmp_path):
    """Round trip through write_png, and every PNG row filter decodes."""
    rng = np.random.RandomState(0)
    bgr = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, bgr)
    np.testing.assert_array_equal(read_png(path), bgr)
    rgb = bgr[..., ::-1]
    (tmp_path / "f.png").write_bytes(_png_with_filters(rgb, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(read_png(str(tmp_path / "f.png")), bgr)
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        read_png(str(tmp_path / "bad.png"))


# ---------------------------------------------------------------------------
# compiled kernel on the card
# ---------------------------------------------------------------------------


def _sphere_scene(size, directory):
    """Displaced UV sphere (13,824 triangles) at ``size``², README pose."""
    from tools.make_igor_sphere import write_sphere

    from cython3dmodelrenderer_tpu import Model, fit_model

    path = str(directory / "sphere.obj")
    write_sphere(path, 128, 55, mtllib=None)
    model = Model.read_model(path)
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    fit_model(model)
    model.shift([0.0, 0.0, 1.0])
    rng = np.random.RandomState(0)
    tc = np.repeat(rng.uniform(0, 255, (model.n_triangles(), 1, 3)), 3,
                   axis=1).astype(np.float32)
    return (model.vertices_by_triangles, model.normals_by_triangles,
            jnp.asarray(tc), RenderConfig(height=size, width=size, fov=45))


@pytest.mark.gpu
def test_gpu_kernel_matches_oracle_full_width(tmp_path):
    """Compiled kernel vs the oracle on the card at 1024²: the winning
    triangle may differ only at edge pixels (Triton's division rounding)."""
    tv, tn, tc, config = _sphere_scene(1024, tmp_path)
    ref, got = _both(tv, tn, tc, config, interpret=False)
    dz = np.abs(ref[1] - got[1])[..., 0]
    assert (dz > 1e-6).mean() <= 1e-4
    same = dz <= 1e-6
    assert np.abs(ref[0][same] - got[0][same]).max() <= 1.0


@pytest.mark.gpu
def test_gpu_auto_backend_is_kernel_and_sweep_matches_frames(tmp_path):
    tv, tn, tc, config = _sphere_scene(256, tmp_path)
    filler = AdvancedPixelBufferFiller(256, 256, fov=45)
    assert filler._resolve_backend() == "pallas"
    angles = multiview.turntable_angles(3)
    shifts = jnp.broadcast_to(jnp.float32([0, 0, 0]), (3, 3))
    cap = multiview.sequence_capacity(tv, tn, angles, shifts, config,
                                      backend="pallas")
    seq = np.asarray(multiview.render_sequence(
        tv, tn, tc, angles, shifts, config, cap=cap, backend="pallas",
        post="u8"))
    light = multiview._norm_light((0.0, 0.0, 1.0))
    for i in range(3):
        v, n = multiview._pose_triangles(tv, tn, angles[i], shifts[i])
        filler.render_arrays(v, n, tc, post="lambert_u8", light=light)
        assert filler.validate_capacity()
        np.testing.assert_array_equal(seq[i],
                                      np.asarray(filler.get_post_image()))
