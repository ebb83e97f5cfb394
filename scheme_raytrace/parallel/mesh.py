"""Device mesh construction (the reference has no parallelism to mirror —
SURVEY §2.4: one never-started display thread, main.scm:633-634).

The renderer is data-parallel over rays/pixels: a 1-D mesh whose single
axis shards the ray pool; scene parameters are replicated and their
gradients all-reduced (psum).  Every card of a host reaches every other
at the same rate, so the mesh follows the algorithm alone.  Multi-host:
call `parallel.distributed.initialize(...)` before `make_mesh` and the
same code spans the hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh

RAY_AXIS = "rays"


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None
              ) -> Mesh:
    """1-D mesh over `n_devices` (default: all visible devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (RAY_AXIS,))
