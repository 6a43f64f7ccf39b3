"""Multi-view and multi-device rendering.

The reference's only parallelism is OpenMP threads over triangles with a
per-pixel lock grid (SURVEY §2). The scaling axes here are:

* **pose sweeps** — one device renders a sequence of views (the 64-camera
  turntable benchmark) as a single jitted scan;
* **view-sharded mesh** — ``shard_map`` over a device mesh axis ``views``:
  each device renders its own subset of cameras; no communication needed
  until the final gather (data parallelism over views);
* **triangle-sharded mesh** — mesh axis ``tris``: each device rasterizes a
  shard of the triangle list into a full-size partial G-buffer, then the
  buffers merge with an exact z-argmin (``pmin`` over depth, then over the
  shard index) — the collective equivalent of the reference's locked
  z-buffer writes.

Every path renders through the single frame body ``ops.frame.frame_body``,
the same one ``AdvancedPixelBufferFiller`` dispatches, with its backend
("pallas" tile kernel or "jnp" oracle) and static capacity ``cap`` (see
``ops.frame``). ``backend="auto"`` resolves per platform like the filler.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..ops import frame, raster_ref
from ..ops.illumination import lambert_shade
from ..ops.projection import project_to_screen, visibility_masks
from ..ops.transforms import rotation_matrix


# --------------------------------------------------------------------------
# Single-view functional core
# --------------------------------------------------------------------------


def render_view(tri_verts: jnp.ndarray, tri_norms: jnp.ndarray,
                tri_colors: jnp.ndarray, config: RenderConfig,
                bbox_size: int = 64, chunk: int = 512,
                light_direction=(0.0, 0.0, 1.0)):
    """Project → rasterize (XLA oracle) → shade one view.

    Returns (shaded color, z, normal)."""
    degenerate, backfacing = visibility_masks(tri_verts, tri_norms)
    active = jnp.logical_and(~degenerate, ~backfacing)
    ts = project_to_screen(tri_verts, config)
    color, z, normal = raster_ref.rasterize(ts, tri_colors, tri_norms, active,
                                            config, bbox_size=bbox_size,
                                            chunk=chunk)
    return lambert_shade(color, normal, _norm_light(light_direction)), z, normal


def turntable_angles(n_views: int) -> jnp.ndarray:
    """(N, 3) Euler XYZ angle triples for a y-axis turntable sweep."""
    deg = jnp.linspace(0.0, 360.0, n_views, endpoint=False)
    zeros = jnp.zeros_like(deg)
    return jnp.stack([zeros, deg, zeros], axis=1)


def _pose_triangles(tri_verts: jnp.ndarray, tri_norms: jnp.ndarray,
                    angles: jnp.ndarray, post_shift) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rotate triangles (and normals) by Euler angles, then translate.

    The reference has no camera matrix — views are model rotations
    (``run.py:36-38``); rotating normals by R matches recomputing them from
    rotated geometry up to float error, without re-running the normal pass
    per view.
    """
    r = rotation_matrix(angles)
    rt = r.T
    v = jnp.einsum("tkc,cd->tkd", tri_verts, rt, precision="highest")
    n = jnp.einsum("tkc,cd->tkd", tri_norms, rt, precision="highest")
    return v + jnp.asarray(post_shift, jnp.float32), n


def _norm_light(light_direction):
    """Pre-negated unit light, or None → no illumination (colors pass
    through unshaded — the sweeps' ``NoIllumination`` analogue)."""
    if light_direction is None:
        return None
    light = -jnp.asarray(light_direction, jnp.float32)
    return light / jnp.linalg.norm(light)


def _broadcast_shifts(shifts, n: int, post_shift=(0.0, 0.0, 1.0)):
    if shifts is None:
        return jnp.broadcast_to(jnp.asarray(post_shift, jnp.float32), (n, 3))
    return jnp.asarray(shifts, jnp.float32)


# --------------------------------------------------------------------------
# Pose sweeps (one device)
# --------------------------------------------------------------------------


def _sweep(tri_verts, tri_norms, tri_colors, angles, shifts,
           config: RenderConfig, backend: str, cap: int, light, post: str):
    """Scan the frame body over poses: (images (N, H, W, 3), demand (N,))."""

    def step(carry, pose):
        angle3, shift3 = pose
        v, n = _pose_triangles(tri_verts, tri_norms, angle3, shift3)
        if post == "u8":
            fpost = "u8" if light is None else "lambert_u8"
        else:
            fpost = "none"
        color, _z, normal, image, need = frame.frame_body(
            v, n, tri_colors, config, backend, cap, post=fpost, light=light)
        if image is None:
            image = color if light is None else lambert_shade(color, normal,
                                                              light)
        return carry, (image, need)

    _, (images, need) = jax.lax.scan(step, 0, (angles, shifts))
    return images, need


@partial(jax.jit, static_argnames=("config", "cap", "backend", "post",
                                   "check_capacity"))
def render_sequence(tri_verts: jnp.ndarray, tri_norms: jnp.ndarray,
                    tri_colors: jnp.ndarray, angles: jnp.ndarray,
                    shifts: jnp.ndarray, config: RenderConfig, cap: int,
                    backend: str = "pallas",
                    light_direction=(0.0, 0.0, 1.0), post: str = "f32",
                    check_capacity: bool = False):
    """Arbitrary pose-sequence animation as ONE dispatch (one device).

    Frame i rotates the model by ``angles[i]`` (Euler XYZ degrees, the
    reference's convention) and translates by ``shifts[i]``; the frames
    render through the filler's frame body on ``backend`` with the static
    capacity ``cap`` (size it with ``sequence_capacity``). Returns
    (N, H, W, 3) shaded color images — float32, or uint8 with
    ``post="u8"`` (display-ready frames, 4x less output traffic).
    ``light_direction=None`` skips illumination (the ``NoIllumination``
    analogue). ``check_capacity=True`` also returns the sweep's peak
    demand; a frame is complete iff its demand ``<= cap``.
    """
    images, need = _sweep(tri_verts, tri_norms, tri_colors, angles, shifts,
                          config, backend, cap, _norm_light(light_direction),
                          post)
    if check_capacity:
        return images, jnp.max(need)
    return images


def render_turntable(tri_verts, tri_norms, tri_colors, angles,
                     config: RenderConfig, cap: int, backend: str = "pallas",
                     post_shift=(0.0, 0.0, 1.0),
                     light_direction=(0.0, 0.0, 1.0), post: str = "f32",
                     check_capacity: bool = False):
    """``render_sequence`` with one fixed ``post_shift`` for every view.

    ``tri_verts`` should be centered (fit_model without the final z shift);
    each view rotates the model by its angle triple then shifts.
    """
    shifts = _broadcast_shifts(None, angles.shape[0], post_shift)
    return render_sequence(tri_verts, tri_norms, tri_colors, angles, shifts,
                           config, cap=cap, backend=backend,
                           light_direction=light_direction, post=post,
                           check_capacity=check_capacity)


@partial(jax.jit, static_argnames=("config", "backend"))
def _peak_demand(tri_verts, tri_norms, angles, shifts, config: RenderConfig,
                 backend: str):
    def one(pose):
        v, n = _pose_triangles(tri_verts, tri_norms, *pose)
        ts, act = frame.geometry(v, n, config)
        return frame.demand(ts, act, config, backend)

    return jnp.max(jax.lax.map(one, (angles, shifts)))


def sequence_capacity(tri_verts, tri_norms, angles, shifts,
                      config: RenderConfig, backend: str = "auto",
                      headroom: float = 1.5,
                      post_shift=(0.0, 0.0, 1.0)) -> int:
    """Static capacity covering every pose of a sequence (one host sync).

    Evaluates the frame demand at every given pose (``shifts=None`` → the
    fixed ``post_shift``), takes the peak and applies ``headroom``.
    """
    backend = frame.resolve_backend(backend)
    shifts = _broadcast_shifts(shifts, angles.shape[0], post_shift)
    peak = int(_peak_demand(tri_verts, tri_norms, angles, shifts,
                            config=config, backend=backend))
    return frame.capacity(int(peak * headroom), backend, config)


def turntable_capacity(tri_verts, tri_norms, config: RenderConfig,
                       backend: str = "auto", n_samples: int = 8,
                       headroom: float = 1.5,
                       post_shift=(0.0, 0.0, 1.0)) -> int:
    """Static capacity for a turntable sweep from ``n_samples`` sampled
    angles with ``headroom`` (the view-sharded sweep checks the true peak
    and re-renders if a view overflows)."""
    return sequence_capacity(tri_verts, tri_norms,
                             turntable_angles(n_samples), None, config,
                             backend=backend, headroom=headroom,
                             post_shift=post_shift)


# --------------------------------------------------------------------------
# View-sharded rendering (data parallel over cameras)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("config", "mesh", "axis", "backend", "cap",
                                   "light_direction", "post"))
def _view_sharded_sweep(tri_verts, tri_norms, tri_colors, angles, shifts, *,
                        config: RenderConfig, mesh: Mesh, axis: str,
                        backend: str, cap: int, light_direction, post: str):
    """One compiled program per (mesh, capacity, ...): each device sweeps
    its views; returns (images, mesh-peak demand)."""

    # check_vma=False for the kernel: pallas_call out_shapes carry no
    # varying-mesh-axes annotation; the body's only collective is the pmax
    # on the demand scalar, so the check adds nothing here.
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P(axis), P(axis)),
             out_specs=(P(axis), P()), check_vma=(backend != "pallas"))
    def shard(tv, tn, tc, ang, shf):
        imgs, need = _sweep(tv, tn, tc, ang, shf, config, backend, cap,
                            _norm_light(light_direction), post)
        return imgs, jax.lax.pmax(jnp.max(need), axis)

    return shard(tri_verts, tri_norms, tri_colors, angles, shifts)


def render_turntable_sharded(tri_verts, tri_norms, tri_colors, angles,
                             config: RenderConfig, mesh: Mesh,
                             axis: str = "views", post_shift=(0.0, 0.0, 1.0),
                             backend: str = "auto", cap: int = None,
                             light_direction=(0.0, 0.0, 1.0),
                             post: str = "f32",
                             check_capacity: bool = False,
                             auto_resize: bool = True):
    """shard_map the turntable over a mesh axis: each device renders N/D views.

    Geometry is replicated (it is small); views are sharded. No collectives
    are needed for the render itself — the output stays sharded over views
    for the caller to gather or write out per shard. Each device runs the
    single-device sweep (``render_sequence``) on its views, so a view is
    bit-identical to its single-device render at the same ``cap``. ``cap``
    is derived via ``turntable_capacity`` when not given (one host sync).

    CAPACITY SAFETY: every sharded sweep evaluates its true peak demand
    on-device and ``pmax``-merges it across the mesh. With ``auto_resize``
    (default) an undersized ``cap`` is detected after the sweep (one host
    scalar read per attempt), the bucket grows to the observed demand +
    headroom, and the sweep re-renders — no silently truncated frames.
    ``check_capacity=True`` additionally returns the mesh-peak demand.
    """
    backend = frame.resolve_backend(backend)
    n_dev = mesh.shape[axis]
    if angles.shape[0] % n_dev:
        raise ValueError(f"views ({angles.shape[0]}) must divide over "
                         f"{n_dev} devices")
    if cap is None:
        cap = turntable_capacity(tri_verts, tri_norms, config,
                                 backend=backend, post_shift=post_shift)
    shifts = _broadcast_shifts(None, angles.shape[0], post_shift)
    if light_direction is not None:
        light_direction = tuple(float(x) for x in light_direction)

    def sweep(c):
        return _view_sharded_sweep(
            tri_verts, tri_norms, tri_colors, angles, shifts, config=config,
            mesh=mesh, axis=axis, backend=backend, cap=c,
            light_direction=light_direction, post=post)

    images, need = sweep(cap)
    if auto_resize:
        for _ in range(4):                # bounded: bucket grows every pass
            peak = int(need)              # one host sync per attempt
            if peak <= cap:
                break
            cap = frame.capacity(peak * 5 // 4, backend, config)
            images, need = sweep(cap)
    if check_capacity:
        return images, need
    return images


# --------------------------------------------------------------------------
# Triangle-sharded rendering (z-argmin merge over the mesh)
# --------------------------------------------------------------------------


def triangle_shard_capacity(tri_verts, tri_norms, config: RenderConfig,
                            mesh: Mesh, axis: str = "tris",
                            backend: str = "auto", headroom_num: int = 5,
                            headroom_den: int = 4) -> int:
    """Static per-shard capacity for triangle-sharded rendering.

    Computes each shard's frame demand on its own device, takes the mesh
    max (one ``pmax``), and buckets with headroom. One host sync.
    """
    backend = frame.resolve_backend(backend)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(axis), P(axis)),
             out_specs=P())
    def peak(tv, tn):
        ts, act = frame.geometry(tv, tn, config)
        return jax.lax.pmax(frame.demand(ts, act, config, backend), axis)

    need = int(peak(tri_verts, tri_norms))
    return frame.capacity(need * headroom_num // headroom_den, backend,
                          config)


@partial(jax.jit, static_argnames=("config", "mesh", "axis", "backend", "cap",
                                   "light_direction"))
def _triangle_sharded_frame(tri_verts, tri_norms, tri_colors, *,
                            config: RenderConfig, mesh: Mesh, axis: str,
                            backend: str, cap: int, light_direction):
    """One compiled program per (mesh, capacity, ...): per-shard frames,
    z-argmin merge, then shading; returns (color, z, normal, demand)."""

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis)), out_specs=P(),
             check_vma=(backend != "pallas"))
    def shard(tv, tn, tc):
        color, z, normal, _img, need = frame.frame_body(
            tv, tn, tc, config, backend, cap)
        need = jax.lax.pmax(need, axis)
        my = jax.lax.axis_index(axis)
        # Exact two-step z-argmin: min depth across shards, then the lowest
        # shard index among exact-depth winners.
        zmin = jax.lax.pmin(z[..., 0], axis)
        cand = z[..., 0] == zmin
        shard_key = jnp.where(cand, my, jnp.iinfo(jnp.int32).max)
        smin = jax.lax.pmin(shard_key, axis)
        win = cand & (smin == my)
        color = jax.lax.psum(jnp.where(win[..., None], color, 0.0), axis)
        normal = jax.lax.psum(jnp.where(win[..., None], normal, 0.0), axis)
        return color, zmin[..., None], normal, need

    color, z, normal, need = shard(tri_verts, tri_norms, tri_colors)
    light = _norm_light(light_direction)
    if light is not None:
        color = lambert_shade(color, normal, light)
    return color, z, normal, need


def render_triangle_sharded(tri_verts, tri_norms, tri_colors,
                            config: RenderConfig, mesh: Mesh,
                            axis: str = "tris",
                            light_direction=(0.0, 0.0, 1.0),
                            backend: str = "auto", cap: int = None,
                            check_capacity: bool = False):
    """Shard triangles across the mesh; merge partial G-buffers by z-argmin.

    Each device rasterizes its triangle shard into a full-resolution partial
    G-buffer through the frame body. The merge is a ``pmin`` over depth,
    then a ``pmin`` over the shard index among exact-depth winners, then a
    select — the deterministic, lock-free equivalent of the reference's
    per-pixel OpenMP lock grid (pyx:69-77,233-242). Depth ties resolve
    exactly like the sequential reference, because shards hold contiguous
    triangle ranges: within a shard the rasterizer's triangle-order
    tiebreak applies, across shards the lower shard index (= lower triangle
    indices) wins. ``cap`` is derived via ``triangle_shard_capacity`` when
    not given. Returns (shaded color, z, normal); ``check_capacity=True``
    appends the mesh-max demand (the frame is complete iff it is
    ``<= cap``).
    """
    backend = frame.resolve_backend(backend)
    t = tri_verts.shape[0]
    n_dev = mesh.shape[axis]
    if t % n_dev:
        raise ValueError(f"triangles ({t}) must divide over {n_dev} devices")
    if cap is None:
        cap = triangle_shard_capacity(tri_verts, tri_norms, config, mesh,
                                      axis=axis, backend=backend)
    if light_direction is not None:
        light_direction = tuple(float(x) for x in light_direction)
    color, z, normal, need = _triangle_sharded_frame(
        tri_verts, tri_norms, tri_colors, config=config, mesh=mesh, axis=axis,
        backend=backend, cap=cap, light_direction=light_direction)
    if check_capacity:
        return color, z, normal, need
    return color, z, normal
