"""Device mesh construction and sharding rules.

The reference has NO distributed training (SURVEY.md §2: no DDP, no
NCCL/MPI anywhere) — multi-device scaling is a new capability here.
Strategy: a 2-D ``(data, model)`` mesh; batches shard over ``data``, large
parameter matrices optionally shard over ``model`` (tensor parallelism),
everything else replicates. XLA inserts the all-reduces (NCCL on GPUs).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: int = 1) -> Mesh:
    """Build a (data, model) mesh over the first n_devices devices."""
    devices = jax.devices()
    n = len(devices) if n_devices is None else n_devices
    devices = devices[:n]
    if n % model_parallel != 0:
        raise ValueError(f"n_devices={n} not divisible by "
                         f"model_parallel={model_parallel}")
    grid = np.asarray(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) dim over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_shardings(params, mesh: Mesh, tp_threshold: int = 256):
    """Per-leaf shardings: tensor-parallel on wide kernels, replicate rest.

    A 2-D kernel whose output dim is >= tp_threshold and divisible by the
    model-axis size is sharded column-wise over MODEL_AXIS; XLA then runs the
    matmul locally and all-gathers activations only where needed.
    """
    tp = mesh.shape[MODEL_AXIS]

    def rule(leaf):
        if (tp > 1 and leaf.ndim >= 2 and leaf.shape[-1] >= tp_threshold
                and leaf.shape[-1] % tp == 0):
            spec = [None] * (leaf.ndim - 1) + [MODEL_AXIS]
            return NamedSharding(mesh, P(*spec))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(rule, params)


def opt_shardings(opt_state, mesh: Mesh, tp_threshold: int = 256):
    """Per-leaf shardings for optimizer state.

    Moment buffers (AdamW mu/nu, momentum, …) have the same shape as the
    parameter they track, so the `param_shardings` shape rule places them on
    the same devices as that parameter — no resharding per update, and TP
    params don't pay replicated-moment HBM. Scalar leaves (step counts,
    schedule state) fall through to replicated.
    """
    return param_shardings(opt_state, mesh, tp_threshold=tp_threshold)
