"""OBJ/MTL loader tests (reference semantics: model.py:6-116,263-328)."""
import os
import textwrap

import numpy as np
import pytest

from cython3dmodelrenderer_tpu.models import obj_io
from cython3dmodelrenderer_tpu.models.model import Model
from cython3dmodelrenderer_tpu.utils.png import write_png


def write_obj(tmp_path, text, name="m.obj"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(text))
    return str(p)


def test_cube_parse(cube_path):
    data = obj_io.load_obj(cube_path)
    assert data.vertices.shape == (8, 3)
    # 6 quads fan-triangulated → 12 triangles
    assert data.faces_v.shape == (12, 3)
    assert data.texture_coords is None
    assert data.normals is None
    assert data.texture is None


def test_cube2_parse_vn_form(cube2_path):
    # Cube2 uses v//vn faces: normals indices present, texture absent
    data = obj_io.load_obj(cube2_path)
    assert data.vertices.shape == (8, 3)
    assert data.normals is not None and data.normals.shape == (8, 3)
    assert data.faces_vn is not None
    assert data.faces_vt is None


def test_fan_triangulation(tmp_path):
    path = write_obj(tmp_path, """\
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        v 0 0 1
        f 1 2 3 4 5
    """)
    data = obj_io.load_obj(path)
    # pentagon → 3 triangles, fan around vertex 0
    np.testing.assert_array_equal(
        data.faces_v, [[0, 1, 2], [0, 2, 3], [0, 3, 4]])


def test_negative_indices(tmp_path):
    path = write_obj(tmp_path, """\
        v 0 0 0
        v 1 0 0
        v 1 1 0
        f -3 -2 -1
    """)
    data = obj_io.load_obj(path)
    model = Model(data.vertices, data.faces_v)
    # negative indices resolve relative to the end of the pool
    np.testing.assert_array_equal(
        np.asarray(model.vertices_by_triangles[0]),
        np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0]], np.float32))


def test_malformed_lines_skipped(tmp_path):
    path = write_obj(tmp_path, """\
        # a comment
        v 0 0 0
        vbroken
        v 1 0 0
        v oops nan_parse
        v 1 1 0
        f 1 2 3
    """)
    data = obj_io.load_obj(path)
    assert data.vertices.shape == (3, 3)
    assert data.faces_v.shape == (1, 3)


def test_malformed_raises_when_not_silent(tmp_path):
    path = write_obj(tmp_path, """\
        v 0 0 oops
    """)
    with pytest.raises(RuntimeError):
        obj_io._load_obj_python(path, silent=False)


def test_malformed_raises_through_public_entry(tmp_path):
    """Strict mode must raise through ``load_obj`` too: the native C++
    fast path skips malformed lines without reporting them, so strict
    parses must route around it (it used to swallow the error and hand
    back a 0-vertex scene that crashed downstream)."""
    path = write_obj(tmp_path, """\
        v 0 0
        f 1 2 3
    """)
    with pytest.raises(RuntimeError):
        obj_io.load_obj(path, silent=False)


def test_partial_vt_drops_all_texture_coords(tmp_path):
    # one face without vt → the whole vt table is dropped (model.py:49-52)
    path = write_obj(tmp_path, """\
        v 0 0 0
        v 1 0 0
        v 1 1 0
        vt 0 0
        vt 1 0
        vt 1 1
        f 1/1 2/2 3/3
        f 1 2 3
    """)
    data = obj_io.load_obj(path)
    assert data.faces_vt is None
    assert data.faces_v.shape == (2, 3)


def test_mtllib_texture_loading(tmp_path):
    tex = np.zeros((4, 4, 3), np.uint8)
    tex[:, :, 2] = 200  # red in BGR
    write_png(str(tmp_path / "tex.png"), tex)
    (tmp_path / "m.mtl").write_text("newmtl a\nmap_Kd tex.png\n")
    path = write_obj(tmp_path, """\
        mtllib m.mtl
        v 0 0 0
        v 1 0 0
        v 1 1 0
        vt 0 0
        vt 1 0
        vt 1 1
        f 1/1 2/2 3/3
    """)
    data = obj_io.load_obj(path)
    assert data.texture is not None
    assert data.texture.shape == (4, 4, 3)
    assert data.texture[0, 0, 2] == 200


def test_trex_load_counts(trex_path):
    data = obj_io.load_obj(trex_path)
    assert data.faces_v.shape == (13814, 3)
    assert data.vertices.shape[0] == 6909
    assert data.texture is not None  # T-Rex.mtl → T-Rex.png


def test_vertex_color_sampling(tmp_path):
    # 2x2 texture with distinct corners (BGR)
    tex = np.array([[[10, 20, 30], [40, 50, 60]],
                    [[70, 80, 90], [100, 110, 120]]], np.uint8)
    write_png(str(tmp_path / "tex.png"), tex)
    (tmp_path / "m.mtl").write_text("map_Kd tex.png\n")
    path = write_obj(tmp_path, """\
        mtllib m.mtl
        v 0 0 0
        v 1 0 0
        v 1 1 0
        vt 0.0 0.99
        vt 0.99 0.99
        vt 0.0 0.0
        f 1/1 2/2 3/3
    """)
    model = Model.read_model(path)
    cols = np.asarray(model.colors_by_triangles)
    # vt (0, .99) → row clip((1-.99)*2)=0, col 0 → tex[0,0]
    np.testing.assert_array_equal(cols[0, 0], [10, 20, 30])
    # vt (.99, .99) → tex[0, 1]
    np.testing.assert_array_equal(cols[0, 1], [40, 50, 60])
    # vt (0, 0) → row clip((1-0)*2, max=1)=1 → tex[1, 0]
    np.testing.assert_array_equal(cols[0, 2], [70, 80, 90])
