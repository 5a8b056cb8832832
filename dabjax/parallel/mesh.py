"""Device-mesh helpers for multi-chip scaling (SURVEY.md §2.5 mapping).

The reference's parallelism is thread-pipelining on one CPU; here the
axes are:

* ``time``  — contiguous frame blocks sharded across chips (sequence
  parallelism with overlap-save halos for the de-interleaver history)
* ``subch`` — subchannels of the CIF sharded across chips (the
  expert-parallel-shaped axis; the reference decodes one subchannel total)

Cross-host channel sharding (multiple ensembles) composes on top by running
independent meshes per channel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "pick_grid"]


def pick_grid(n_devices: int, max_subch: int = 4) -> Tuple[int, int]:
    """Factor n_devices into (time, subch) with subch <= max_subch."""
    subch = 1
    for s in range(min(max_subch, n_devices), 0, -1):
        if n_devices % s == 0:
            subch = s
            break
    return n_devices // subch, subch


def make_mesh(n_devices: Optional[int] = None,
              grid: Optional[Tuple[int, int]] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if grid is None:
        grid = pick_grid(n_devices)
    t, s = grid
    assert t * s == n_devices, (grid, n_devices)
    arr = np.array(devs[:n_devices]).reshape(t, s)
    return Mesh(arr, axis_names=("time", "subch"))
