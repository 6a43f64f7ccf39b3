"""Generate displaced UV-sphere meshes; by default assets/igor_sphere.obj —
the reproducible mesh for BASELINE config 4 (1024², textured + Lambert).

The reference's igor.obj is pruned from the mounted repo
(``/root/reference/.MISSING_LARGE_BLOBS``); only ``igor.mtl`` and
``igor_texture.png`` survive. This deterministic displaced UV sphere stands
in as the textured mesh: full-range UVs (so the texture pre-sampling path is
exercised end to end), smooth non-trivial normals (radial displacement), and
a triangle count in the same class as the reference character meshes.

The same generator, at ``segments=128, rings=55``, makes the T-Rex-class
full-width scene (13,824 triangles; ``2 * segments * (rings - 1)`` in all)
that ``chip_smoke.py`` renders at 1024².

Run from the repo root: ``python tools/make_igor_sphere.py``
"""
import os

import numpy as np

SEGMENTS = 64          # longitude steps
RINGS = 48             # latitude steps (including poles)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "..", "assets", "igor_sphere.obj")


def displaced_radius(theta, phi):
    """Deterministic bumpy radius so normals are not trivially radial."""
    return 1.0 + 0.08 * np.sin(6.0 * theta) * np.sin(5.0 * phi)


def sphere_obj_lines(segments: int = SEGMENTS, rings: int = RINGS,
                     mtllib: str = "igor.mtl"):
    """OBJ lines of the displaced UV sphere (``mtllib=None`` omits the
    material reference)."""
    lines = ["# igor_sphere.obj — generated by tools/make_igor_sphere.py",
             "# displaced UV sphere standing in for the pruned igor.obj"]
    if mtllib is not None:
        lines.append(f"mtllib {mtllib}")

    # vertices: rings of latitude (poles included as single vertices)
    verts = []            # (ring, seg) -> index (1-based)
    index = {}
    for r in range(rings + 1):
        phi = np.pi * r / rings                 # 0 (north) .. pi (south)
        for s in range(segments):
            if r in (0, rings) and s > 0:
                continue                        # poles are one vertex
            theta = 2.0 * np.pi * s / segments
            rad = displaced_radius(theta, phi)
            x = rad * np.sin(phi) * np.cos(theta)
            y = rad * np.cos(phi)
            z = rad * np.sin(phi) * np.sin(theta)
            index[(r, s)] = len(verts) + 1
            verts.append((x, y, z))
    for x, y, z in verts:
        lines.append(f"v {x:.6f} {y:.6f} {z:.6f}")

    # texture coordinates: a (RINGS+1) x (SEGMENTS+1) grid incl. the seam
    tc_index = {}
    n_tc = 0
    for r in range(rings + 1):
        v = 1.0 - r / rings
        for s in range(segments + 1):
            u = s / segments
            n_tc += 1
            tc_index[(r, s)] = n_tc
            lines.append(f"vt {u:.6f} {v:.6f}")

    def vid(r, s):
        if r == 0:
            return index[(0, 0)]
        if r == rings:
            return index[(rings, 0)]
        return index[(r, s % segments)]

    # faces: quads in the body (fan-triangulated by the loader), triangles
    # at the poles; v/vt form (normals recomputed by the loader by default)
    for r in range(rings):
        for s in range(segments):
            a, b = vid(r, s), vid(r, s + 1)
            c, d = vid(r + 1, s + 1), vid(r + 1, s)
            ta, tb = tc_index[(r, s)], tc_index[(r, s + 1)]
            tc_, td = tc_index[(r + 1, s + 1)], tc_index[(r + 1, s)]
            if r == 0:
                lines.append(f"f {a}/{ta} {c}/{tc_} {d}/{td}")
            elif r == rings - 1:
                lines.append(f"f {a}/{ta} {b}/{tb} {d}/{td}")
            else:
                lines.append(f"f {a}/{ta} {b}/{tb} {c}/{tc_} {d}/{td}")
    return lines


def write_sphere(path: str, segments: int = SEGMENTS, rings: int = RINGS,
                 mtllib: str = "igor.mtl") -> int:
    """Write the sphere OBJ to ``path``; returns its triangle count."""
    lines = sphere_obj_lines(segments, rings, mtllib)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return sum(len(ln.split()) - 3 for ln in lines if ln.startswith("f "))


def write_textured_sphere(directory: str, segments: int, rings: int,
                          seed: int = 0, texture_size: int = 256) -> str:
    """Write ``sphere.obj`` + ``sphere.mtl`` + a seeded ``sphere.png``
    texture (smooth color bands plus noise) into ``directory``; returns the
    OBJ path."""
    from cython3dmodelrenderer_tpu.utils.png import write_png

    os.makedirs(directory, exist_ok=True)
    rng = np.random.RandomState(seed)
    u = np.linspace(0.0, 1.0, texture_size, dtype=np.float32)
    phase = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    bands = 0.5 + 0.5 * np.sin(2 * np.pi * (3 * u[:, None, None]
                                            + 5 * u[None, :, None]) + phase)
    noise = rng.uniform(-0.15, 0.15, (texture_size, texture_size, 3))
    tex = np.clip(40 + 200 * (bands + noise), 0, 255).astype(np.uint8)
    write_png(os.path.join(directory, "sphere.png"), tex)
    with open(os.path.join(directory, "sphere.mtl"), "w") as f:
        f.write("newmtl sphere\nmap_Kd sphere.png\n")
    path = os.path.join(directory, "sphere.obj")
    write_sphere(path, segments, rings, mtllib="sphere.mtl")
    return path


def main():
    n_tris = write_sphere(OUT)
    print(f"wrote {os.path.normpath(OUT)}: {n_tris} triangles")


if __name__ == "__main__":
    main()
