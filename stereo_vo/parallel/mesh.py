"""Device mesh helpers.

The communication layer of the distributed BA (SURVEY.md §5 "Distributed
communication backend"): a ``jax.sharding.Mesh`` whose collectives are XLA
``psum`` / ``all_gather`` inserted by the partitioner (NCCL on GPUs), with no
hand-written communication.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("lm",),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    Default: a 1-D ``("lm",)`` mesh over all devices — the landmark-sharding
    axis of the distributed bundle adjuster. Pass ``shape=(dp, lm)`` with
    ``axis_names=("dp", "lm")`` for data-parallel sweeps over sharded solves.
    """
    devs = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devs),)
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devs)}")
    arr = np.array(devs[:n]).reshape(shape)
    return Mesh(arr, tuple(axis_names))
