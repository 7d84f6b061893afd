"""Device-mesh helpers for multi-device scaling.

The reference's parallelism axes (SURVEY §2) map onto a 2-D
``jax.sharding.Mesh``:

- ``data``  — frame-level data parallelism: the worker-thread pool over the
  frame queue (``OpenCVequalHist.cpp:396-402``) becomes batch sharding over
  devices; the device interconnect replaces the shared GAsyncQueue.
- ``space`` — intra-frame spatial parallelism: CLAHE's own N x N tile
  decomposition (``CLAHECompare.cpp:144-150``) becomes row-band sharding of
  the Y plane, with per-tile LUTs exchanged by a (tiny) all-gather and
  global histograms reduced by psum.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "best_mesh_shape", "mesh_from_cli"]


def best_mesh_shape(n: int) -> tuple[int, int]:
    """Split n devices into (data, space) as close to square as possible,
    biasing the data axis (frame DP scales perfectly; spatial sharding pays
    one all-gather)."""
    best = (n, 1)
    for space in range(1, n + 1):
        if n % space:
            continue
        data = n // space
        if data >= space:
            best = (data, space)
    return best


def make_mesh(
    n_devices: int | None = None,
    shape: tuple[int, int] | None = None,
    axis_names: tuple[str, str] = ("data", "space"),
) -> Mesh:
    """Create a 2-D (data, space) mesh over the first n devices."""
    devs = jax.devices()
    if n_devices is not None:
        n = n_devices
    elif shape is not None:
        n = shape[0] * shape[1]  # an explicit shape names its own size
    else:
        n = len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if shape is None:
        shape = best_mesh_shape(n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.array(devs[:n]).reshape(shape)
    return Mesh(arr, axis_names)


def mesh_from_cli(spec: str) -> Mesh:
    """Parse a ``--mesh`` flag value ('auto' or 'DxS', e.g. '4x2') and
    build the mesh.  Raises ValueError with a user-facing message for a
    malformed spec or an unsatisfiable device count — one parser shared
    by every app exposing the flag."""
    shape = None
    if spec != "auto":
        try:
            d, s = spec.lower().split("x", 1)
            shape = (int(d), int(s))
        except ValueError:
            raise ValueError(
                f"--mesh={spec!r} invalid: use 'auto' or DxS (e.g. 4x2)"
            ) from None
        if shape[0] < 1 or shape[1] < 1:
            raise ValueError(
                f"--mesh={spec!r} invalid: axes must be >= 1")
    return make_mesh(shape=shape)
