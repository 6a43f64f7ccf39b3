"""The ``crender`` compatibility namespace — reference run.py ports verbatim."""
import numpy as np
import pytest


def test_reference_py_usage(trex_path):
    # transcription of the reference's py_renderer (run.py:11-17), small size
    import crender.py as py
    from crender.py.triangle_iterator import SimpleIterator

    from crender.py.data_structures import Model

    model = Model.read_model(trex_path)
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    model.shift(-model.get_mean_vertex())
    model.scale(1 / model.get_max_span())
    model.shift(shift=[0, 0, 1])  # keyword form, as the reference run.py:33

    filler = py.pixel_buffer_filler.AdvancedPixelBufferFiller(128, 128, fov=45)
    illumination = py.illumination.GuroIllumination([0, 0, 1])
    renderer = py.Renderer(filler, illumination, SimpleIterator,
                           *filler.get_size(), use_tqdm=False)
    image = renderer.render(model)
    arr = image.get_image()
    assert arr.dtype == np.uint8
    assert (arr.sum(-1) > 0).mean() > 0.1


def test_reference_cy_usage(trex_path, tmp_path):
    # transcription of the reference's cy_renderer (run.py:20-26)
    from crender.cy import Renderer
    from crender.cy.data_structures import Model
    from crender.cy.pixel_buffer_filler import AdvancedPixelBufferFiller
    from crender.cy.triangle_iterator import SimpleIterator
    from crender.cy.illumination import GuroIllumination

    model = Model.read_model(trex_path)
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    model.shift(-model.get_mean_vertex())
    model.scale(1 / model.get_max_span())
    model.shift([0, 0, 1])

    filler = AdvancedPixelBufferFiller(128, 128, fov=45, n_threads=8)
    illumination = GuroIllumination([0, 0, 1])
    renderer = Renderer(filler, illumination, SimpleIterator,
                        *filler.get_size(), use_tqdm=False)
    image = renderer.render(model)
    # cy contract: raw float ndarray, caller flips + casts (run.py:26)
    assert isinstance(image, np.ndarray)
    assert image.dtype == np.float32
    out = image[::-1].astype("uint8")
    assert out.max() > 0

    from cython3dmodelrenderer_tpu.utils.png import read_png, write_png

    write_png(str(tmp_path / "compat.png"), out)
    np.testing.assert_array_equal(read_png(str(tmp_path / "compat.png")),
                                  out)


def test_top_level_reexport():
    import crender

    from cython3dmodelrenderer_tpu import Renderer

    assert crender.Renderer is Renderer
