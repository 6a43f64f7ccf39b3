"""Packaging for cython3dmodelrenderer_tpu.

The native OBJ parser (native/objparse.cpp) is built lazily at import time
via g++ + ctypes (no compile-time dependency); ship the source with the
package. Reference equivalent: the Cython build in the reference's setup.py
(setup.py:8-16) — here the compute path is JAX/Pallas, so there is nothing
to cythonize.
"""
from setuptools import find_packages, setup

setup(
    name="cython3dmodelrenderer-tpu",
    version="0.1.0",
    description="3D software rasterizer for the GPU (JAX/XLA/Pallas)",
    packages=find_packages(include=["cython3dmodelrenderer_tpu*"]),
    package_data={"cython3dmodelrenderer_tpu.native": ["*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
    ],
)
