"""Multi-host bootstrap + per-host data sharding.

The reference is a multi-process system wired over ROS TCPROS
(``launch/vo_rviz.launch:9-11``, ``src/vo_node.cpp:28-29``); SURVEY.md §5's
plan replaces that with ``jax.distributed`` + a device mesh whose collectives
XLA lowers to the interconnect. This module is the process-level
half: coordinator bootstrap (idempotent, guarded so single-process runs are
no-ops) and the host-side data plane (per-host dataset sharding for benchmark
sweeps — each host feeds only its shard of sequences, the mesh does the rest).

Tested single-host (process_count == 1) in CI; the multi-host path is the
standard JAX coordinator protocol and needs no VO-specific logic beyond this.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> Tuple[int, int]:
    """Bring up ``jax.distributed`` if (and only if) a multi-process run is
    requested; returns ``(process_index, process_count)``.

    Three modes:
    - explicit args -> ``jax.distributed.initialize(coordinator, n, id)``;
    - env-driven (``SVO_COORDINATOR``/``SVO_NUM_PROCESSES``/``SVO_PROCESS_ID``,
      or a cluster environment where ``jax.distributed.initialize()``
      auto-detects) -> zero-arg initialize;
    - neither -> no-op (single process), so the same entry point serves
      laptops, single cards and clusters.
    """
    import jax

    if coordinator_address is None:
        coordinator_address = os.environ.get("SVO_COORDINATOR")
        if num_processes is None and os.environ.get("SVO_NUM_PROCESSES"):
            num_processes = int(os.environ["SVO_NUM_PROCESSES"])
        if process_id is None and os.environ.get("SVO_PROCESS_ID"):
            process_id = int(os.environ["SVO_PROCESS_ID"])

    already = getattr(jax.distributed, "is_initialized", None)
    initialized = bool(already()) if callable(already) else False

    if not initialized and coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    return jax.process_index(), jax.process_count()


def shard_for_host(
    items: Sequence,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List:
    """Contiguous per-host slice of a work list (sequences, frame chunks).

    Host ``i`` of ``n`` gets items ``[ceil splits]`` — every host gets
    ``len(items)//n`` items, the first ``len(items) % n`` hosts one extra.
    Deterministic and disjoint: the union over hosts is exactly ``items``.
    """
    import jax

    i = jax.process_index() if process_index is None else process_index
    n = jax.process_count() if process_count is None else process_count
    base, extra = divmod(len(items), n)
    start = i * base + min(i, extra)
    stop = start + base + (1 if i < extra else 0)
    return list(items[start:stop])


def host_local_problem_to_global(batch, mesh, dp_axis: str = "dp"):
    """Assemble per-host batched landmark-major problems into one global
    dp-sharded array set (``jax.make_array_from_process_local_data``): each
    host contributes its local batch along the ``dp`` axis without any host
    ever materializing the global batch.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    def to_global(x):
        sharding = NamedSharding(mesh, P(dp_axis, *([None] * (x.ndim - 1))))
        return jax.make_array_from_process_local_data(sharding, x)

    return jax.tree.map(to_global, batch)
