"""Generate the repo's SELF-CONTAINED golden render (assets/golden_sphere.png).

The reference's committed golden (``/root/reference/output/T-Rex.png``) needs
the reference mount; this one is reproducible from committed inputs alone:
the committed ``assets/igor_sphere.obj`` mesh, deterministic seeded
per-triangle colors, Lambert light [0, 0, 1], 512², fov=45, the README-style
pose — rendered by the pure-XLA oracle backend (``backend="jnp"``, the
py-filler-semantics rasterizer) on CPU.

``tests/test_renderer.py::test_golden_standalone`` re-renders the same scene
through the tile kernel (interpret mode) and compares; ``chip_smoke.py``
does the same on the GPU. Regenerate (only after an intentional semantics
change) with:  JAX_PLATFORMS=cpu python tools/make_golden.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "assets", "golden_sphere.png")


def build_scene():
    """The golden scene (shared with the test — import it from here)."""
    import jax.numpy as jnp

    from cython3dmodelrenderer_tpu import Model, fit_model

    model = Model.read_model(os.path.join(REPO, "assets", "igor_sphere.obj"),
                             external_texture_filename=None)
    model.rotate([-90, 180, 0])
    model.rotate([10, -80, 0])
    fit_model(model)
    model.shift([0.0, 0.0, 1.0])   # sphere radius 1: push off the camera
    rng = np.random.RandomState(0)
    per_tri = rng.randint(256, size=(model.n_triangles(), 3))
    colors = jnp.asarray(np.repeat(per_tri[:, None, :], 3, axis=1)
                         .astype(np.float32))
    return model, colors


def render(backend: str) -> np.ndarray:
    """The golden scene's Lambert-shaded uint8 image through the filler."""
    from cython3dmodelrenderer_tpu import (AdvancedPixelBufferFiller,
                                           GuroIllumination)

    model, colors = build_scene()
    filler = AdvancedPixelBufferFiller(512, 512, fov=45, backend=backend)
    shader = GuroIllumination([0, 0, 1])
    filler.render_model(model, colors_override=colors, post="lambert_u8",
                        light=shader.light_direction)
    filler.validate_capacity()
    return np.asarray(filler.get_post_image())


def compare(ours: np.ndarray, golden: np.ndarray) -> dict:
    """Silhouette IoU, color MAE inside both silhouettes, and the fraction of
    pixels off by more than 20 in some channel."""
    ours_mask = ours.sum(-1) > 15
    gold_mask = golden.sum(-1) > 15
    both = ours_mask & gold_mask
    diff = np.abs(ours.astype(np.float32) - golden.astype(np.float32))
    return {"iou": float(both.sum() / (ours_mask | gold_mask).sum()),
            "mae": float(diff[both].mean()),
            "frac_big": float((diff.max(-1) > 20).mean())}


#: bounds a render of the golden scene must meet against the golden image
GOLDEN_BOUNDS = {"iou": 0.998, "mae": 0.5, "frac_big": 0.002}


if __name__ == "__main__":
    from cython3dmodelrenderer_tpu.utils.png import write_png

    img = render("jnp")
    write_png(OUT, img[::-1])   # same row flip as Buffer.write_to_file
    print(f"wrote {OUT} ({img.shape}, nonzero {float((img > 0).mean()):.3f})")
