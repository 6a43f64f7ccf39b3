"""Multi-chip rendering demo over a device mesh.

With real multi-chip hardware this runs as-is; without it, emulate a mesh
with virtual CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/multichip.py

Two modes are shown (SURVEY §5 'distributed communication backend'):
* views sharded over the mesh (data parallel over cameras, no collectives);
* triangles sharded with an exact z-argmin merge (pmin/psum collectives) —
  the collective equivalent of the reference's locked z-buffer writes.

It runs on the visible devices of JAX's default platform: every GPU of the
host, or the virtual CPU devices above. The backend follows the platform
(GPU → tile kernel, CPU → XLA oracle).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

import jax
import jax.numpy as jnp
import numpy as np

from cython3dmodelrenderer_tpu import Model
from cython3dmodelrenderer_tpu.config import RenderConfig
from cython3dmodelrenderer_tpu.parallel import multiview
from cython3dmodelrenderer_tpu.parallel.mesh import make_mesh

OBJECTS = os.environ.get("CRENDER_OBJECTS", "/root/reference/objects")
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "assets")


def main():
    n_dev = len(jax.devices())
    print(f"{n_dev} devices: {jax.devices()}")

    path = os.path.join(OBJECTS, "cube.obj")
    if not os.path.exists(path):     # the vendored copy
        path = os.path.join(ASSETS, "cube.obj")
    model = Model.read_model(path)
    model.rotate([30, 40, 0])
    model.shift(-model.get_mean_vertex())
    model.scale(1.0 / model.get_max_span())

    tv = model.vertices_by_triangles
    tn = model.normals_by_triangles
    rng = np.random.RandomState(0)
    tc = jnp.asarray(np.repeat(rng.uniform(0, 255, (model.n_triangles(), 1, 3)),
                               3, axis=1).astype(np.float32))
    config = RenderConfig(height=128, width=128, fov=45)

    # 1) view sharding: each device renders n_views/n_dev cameras
    mesh = make_mesh([("views", n_dev)])
    angles = multiview.turntable_angles(2 * n_dev)
    frames = multiview.render_turntable_sharded(
        tv, tn, tc, angles, config, mesh=mesh, axis="views")
    jax.block_until_ready(frames)
    print(f"view-sharded turntable: {frames.shape} across {n_dev} devices")

    # 2) triangle sharding + z-argmin merge collectives
    # (pad the triangle list to a multiple of the mesh; zero-normal padding
    # triangles are backface-culled)
    mesh2 = make_mesh([("tris", n_dev)])
    t = tv.shape[0]
    pad = (-t) % n_dev
    tv2 = jnp.pad(tv + jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                  ((0, pad), (0, 0), (0, 0)))
    tn2 = jnp.pad(tn, ((0, pad), (0, 0), (0, 0)))
    tc2 = jnp.pad(tc, ((0, pad), (0, 0), (0, 0)))
    color, z, normal = multiview.render_triangle_sharded(
        tv2, tn2, tc2, config, mesh=mesh2, axis="tris")
    jax.block_until_ready(color)
    covered = float(jnp.mean((z < config.z_init).astype(jnp.float32)))
    print(f"triangle-sharded render: color {color.shape}, "
          f"{covered:.1%} pixels covered")


if __name__ == "__main__":
    main()
