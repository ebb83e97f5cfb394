"""Multi-process entry point (SURVEY §5.8: the reference is single-process;
this build can span hosts via jax.distributed + XLA collectives).

Call `initialize(...)` once per process before building meshes; all
`parallel/` code then sees the global device set and the same shard_map
programs span every process.  Nothing in the environment names a cluster,
so a multi-process run starts only when a coordinator is given; without
one this is a no-op (jax.devices() already has every local card).
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Start jax.distributed when a coordinator is given.

    coordinator_address is "host:port" (e.g. "localhost:<free port>" for
    several processes on one machine); num_processes and process_id must
    be given with it.  Returns True if a multi-process runtime was
    initialized, False when running single-process.
    """
    if not coordinator_address:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("initialize: num_processes and process_id are "
                         "required with a coordinator_address")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def is_multi_process() -> bool:
    return jax.process_count() > 1


def assemble_image(raw) -> "jax.Array":
    """Gather a row-sharded frame onto every host (final image assembly).

    Under fully-addressable single-host meshes this is a device_get away;
    across processes it is the one all_gather of the pipeline (BASELINE:
    "all_gather for final image assembly").
    """
    from jax.experimental import multihost_utils
    if jax.process_count() == 1:
        return raw
    return multihost_utils.process_allgather(raw, tiled=True)
