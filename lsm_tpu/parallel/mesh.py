"""Device mesh and sharding helpers.

The workload's parallelism (SURVEY.md section 2.4): data parallelism over
utterances is the primary axis; model parallelism over reservoir neurons is
available for scaled (10k+) reservoirs. Collectives are XLA's
(psum/all_gather under shard_map), which it lowers to NCCL on GPUs. The
mesh follows the algorithm alone: the cards of one host are joined all to
all, so no axis needs a particular device order within a host.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, model) mesh. Defaults to all devices on the data axis."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data * n_model > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, "
            f"have {len(devices)}"
        )
    grid = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def auto_mesh(min_devices: int = 2) -> Optional[Mesh]:
    """The production default mesh: all devices on the data axis.

    Returns None on a single device (the single-device jit path needs no
    mesh). The pipeline calls this so that `python main.py` on a host with
    several cards shards every stage across them without any flags — the reference
    is a serial one-process loop (extract_lsm_features.py:78), this is the
    SURVEY.md section 2.4a data-parallel replacement.
    """
    n = jax.device_count()
    if n < min_devices:
        return None
    return make_mesh(n_data=n, n_model=1)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over the data axis; replicate the rest."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> Tuple[np.ndarray, int]:
    """Pad `axis` up to a multiple (so shards are equal); returns (padded, n_real)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad), n


def shard_batch(x: np.ndarray, mesh: Mesh) -> jax.Array:
    """Place a host batch onto the mesh, sharded along the data axis.

    Contract: `x` is the FULL batch, present identically on every process.
    Every batch-pipeline caller satisfies this — the file index, synthetic
    corpora and sharded-dataset reads are deterministic and every process
    loads the same rows (pipeline._place_batch, bench.py,
    __graft_entry__.py). Multi-host, each process therefore materializes
    only its addressable shards of the global array (the others are never
    transferred); single-host keeps the direct device_put fast path. The
    streaming engines' per-process-rows placement is separate and
    documented on StreamingKWS._place_chunk."""
    if jax.process_count() > 1:
        return shard_host_array(np.asarray(x), mesh)
    return jax.device_put(x, batch_sharding(mesh))


def shard_host_array(
    x: np.ndarray, mesh: Mesh, spec: Optional[P] = None
) -> jax.Array:
    """A host array (the FULL value, present on every process) -> global
    sharded array. Multi-host: each process materializes only its
    addressable shards via the callback; single-host is a device_put."""
    x = np.asarray(x)
    sharding = NamedSharding(mesh, spec if spec is not None else P(DATA_AXIS))
    if jax.process_count() > 1:
        return jax.make_array_from_callback(x.shape, sharding, lambda i: x[i])
    return jax.device_put(x, sharding)


@functools.lru_cache(maxsize=None)
def _identity_jit(sharding: NamedSharding):
    """Cached jitted identity with a fixed output sharding.

    XLA lowers it to the all-gather that materializes a cross-process
    sharded array as replicated. Cached per sharding so hot serving loops
    (one call per step) hit the jit trace cache instead of re-tracing a
    fresh lambda every step."""
    return jax.jit(lambda x: x, out_shardings=sharding)


def host_local(x):
    """Make a device array materializable on THIS process.

    Single-host (or already replicated / fully addressable): the array
    itself, untouched — np.asarray and device-side slicing keep their
    usual fast paths. Multi-host sharded: one all-gather to replicated
    (across hosts) via the cached jitted identity, so every process
    holds the full value. This is the device->host twin of shard_batch's
    full-batch contract."""
    if (
        isinstance(x, jax.Array)
        and not x.is_fully_addressable
        and not x.is_fully_replicated
    ):
        sharding = x.sharding
        if not isinstance(sharding, NamedSharding):
            raise TypeError(
                f"host_local needs a NamedSharding to all-gather, got "
                f"{type(sharding).__name__}"
            )
        x = _identity_jit(NamedSharding(sharding.mesh, P()))(x)
    return x


def local_stream_rows(n_streams: int, mesh: Optional[Mesh]) -> int:
    """Stream rows each process feeds per serving chunk: the full stream
    axis on one host, this process's partition on a multi-host mesh
    (stream slots are partitioned process-major, matching multihost_mesh's
    device order). The single definition BOTH serving engines share so the
    multi-host ingest contract cannot drift between them."""
    if mesh is not None and jax.process_count() > 1:
        return n_streams // jax.process_count()
    return n_streams


def place_stream_chunk(chunk: np.ndarray, sharding: Optional[NamedSharding]):
    """Move a host serving chunk to device, stream-sharded when serving on
    a mesh (the H2D transfer splits across cards and the jitted step sees
    its operands already laid out — no resharding inside the program).

    Multi-host: each process passes its PROCESS-LOCAL stream rows (see
    local_stream_rows) — the per-process twin of shard_batch's full-batch
    contract — and the result is the global sharded chunk. Shared by
    StreamingKWS and ContinuousKWS."""
    if sharding is not None:
        if jax.process_count() > 1:
            return jax.make_array_from_process_local_data(
                sharding, np.asarray(chunk)
            )
        return jax.device_put(chunk, sharding)
    import jax.numpy as jnp

    return jnp.asarray(chunk)


def replicate_to_mesh(tree, mesh: Mesh):
    """Replicate a (possibly pytree) host value onto every mesh device.

    Multi-host: every process must hold the same value (reservoir params
    are derived from a shared seed + calibration constant, so they do);
    single-host is a plain replicated device_put."""
    sharding = replicated(mesh)
    if jax.process_count() > 1:
        return jax.tree.map(
            lambda x: jax.make_array_from_process_local_data(
                sharding, np.asarray(x)
            ),
            tree,
        )
    return jax.device_put(tree, sharding)


# ---------------------------------------------------------------------------
# Multi-host runtime — SURVEY.md sections 2.4 / 5.8
# ---------------------------------------------------------------------------

def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the multi-host runtime (one call per process, before backend use).

    Pass the coordinator address + process grid explicitly. The layout is
    ONE PROCESS PER HOST, driving every card of its host: no
    `local_device_ids` is passed, so a second process on the same host
    would claim the same cards (and a JAX process reserves most of each
    card's memory at start-up). After this, `jax.devices()` is the GLOBAL
    device list, so `auto_mesh`/`make_mesh`/`multihost_mesh` span every
    host and XLA routes collectives within a host over its interconnect
    and across hosts over the network. Exercised by
    tests/test_multihost.py on a 2-process x 2-CPU-device grid (gloo
    collectives stand in for the network).
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def maybe_init_distributed_from_env() -> bool:
    """Env-driven `init_distributed` for the CLI entry points.

    Set LSM_TPU_COORDINATOR=host:port, LSM_TPU_NUM_PROCESSES and
    LSM_TPU_PROCESS_ID on every process — one process per host (see
    init_distributed) — or LSM_TPU_DISTRIBUTED=1 where the cluster
    environment lets initialize() discover them, and every stage CLI
    becomes a multi-host SPMD program with no code changes. Returns True
    when the runtime was initialized."""
    import os

    coord = os.environ.get("LSM_TPU_COORDINATOR")
    if coord:
        init_distributed(
            coordinator_address=coord,
            num_processes=int(os.environ["LSM_TPU_NUM_PROCESSES"]),
            process_id=int(os.environ["LSM_TPU_PROCESS_ID"]),
        )
        return True
    if os.environ.get("LSM_TPU_DISTRIBUTED"):
        init_distributed()
        return True
    return False


def multihost_mesh(n_model: int = 1) -> Mesh:
    """(data, model) mesh over the global device list, laid out so every
    model group is INTRA-process: the per-timestep TP all_gathers stay on
    the host's card-to-card links, while the data axis (per-utterance
    independent work + small psum'd readout reductions) is what crosses
    hosts — put the chatty axis on the fast interconnect.

    Requires n_model to divide the per-process device count; devices are
    ordered process-major so reshaping (n_data, n_model) row-major keeps
    each model group within one process."""
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    local = jax.local_device_count()
    if n_model > 1 and local % n_model != 0:
        raise ValueError(
            f"n_model={n_model} must divide the per-process device count "
            f"({local}) so TP all_gathers stay intra-host"
        )
    n_data = len(devices) // n_model
    grid = np.asarray(devices).reshape(n_data, n_model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))
