"""Process groups and the framework's axis convention (port of
``ctpa/core/mesh.py``).

ctpa's "backend" is a ``jax.sharding.Mesh`` whose collectives XLA compiles
into one program over every device.  The port runs one process per device,
PyTorch's own idiom: ``initialize_distributed`` starts the process group
(NCCL on the card, gloo on the CPU), and a ``Mesh`` holds this rank's
process groups along the two axes of a (data, model) grid of ranks.  The
collectives are explicit calls (``comms/collectives.py``).

Axis convention, as ctpa's:
  - ``data``  : data parallelism (each rank its rows of the batch, gradient
                and EMA reductions, the contrastive all-gather of latents,
                context parallelism's sequence shards).
  - ``model`` : tensor parallelism (sharded projections and attention heads).

A mesh made by ``single_device_mesh`` has no process group: its axes have
size 1 and every collective over it is the identity, with no call into
``torch.distributed``.  A mesh from ``create_mesh`` calls the group's
backend even at size 1, so a one-rank NCCL mesh still runs NCCL.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ctpa_torch.core.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a 2-D grid of ranks: each axis's size, the
    rank's index along it and the process group of the ranks that share
    its other coordinate (None in a ``single_device_mesh``)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    coords: tuple[int, ...]
    groups: tuple[Any, ...]
    backend: Optional[str]
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} is not one of the mesh's {self.axis_names}")
        return self.axis_names.index(axis)

    def size(self, axis: str) -> int:
        return self.sizes[self._axis(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self._axis(axis)]

    def group(self, axis: str):
        return self.groups[self._axis(axis)]

    def check(self, t: torch.Tensor) -> None:
        """Raise unless ``t`` lies where the mesh's backend can reach it:
        on a CUDA device for NCCL, on the CPU for gloo.  Nothing moves a
        tensor between the two for a collective."""
        if self.backend == "nccl" and t.device.type != "cuda":
            raise ValueError(f"an NCCL mesh takes CUDA tensors, got one on {t.device}")
        if self.backend == "gloo" and t.device.type != "cpu":
            raise ValueError(f"a gloo mesh takes CPU tensors, got one on {t.device}")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda") -> None:
    """Start this process's default process group: NCCL when ``device`` is a
    card (the process takes card ``process_id`` mod the host's count), gloo
    on the CPU; no fallback from one to the other.  ``coordinator_address``
    is ``HOST:PORT`` (rank 0 listens there) or a URL (``tcp://...``,
    ``file:///path``, a rendezvous file every process can reach); None
    reads ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` from
    the environment, as torchrun sets them.  Safe to call when a group
    exists already (ctpa's "already initialized" guard)."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is None:
        init = "env://"
    else:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("an NCCL process group needs a CUDA device")
        index = torch.device(device).index
        torch.cuda.set_device(index if index is not None
                              else (process_id or 0) % torch.cuda.device_count())
    kw = {} if coordinator_address is None else dict(world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, init_method=init, **kw)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def create_mesh(cfg: MeshConfig = MeshConfig(),
                ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """A (data, model) mesh over ``ranks`` (default: every rank of the
    default group) laid out row-major, data-parallel rows of
    ``model_parallel`` ranks each.  Every rank of the default group must
    call it (each group is made collectively); a rank outside ``ranks``
    gets None."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs initialize_distributed first")
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    n = len(ranks)
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} ranks")
    grid = np.asarray(ranks).reshape(dp, mp)
    me = dist.get_rank()
    data_group = model_group = None
    # every rank makes every group, in one order
    for j in range(mp):
        g = dist.new_group([int(r) for r in grid[:, j]])
        if me in grid[:, j]:
            data_group = g
    for i in range(dp):
        g = dist.new_group([int(r) for r in grid[i]])
        if me in grid[i]:
            model_group = g
    if me not in ranks:
        return None
    i, j = (int(x[0]) for x in np.nonzero(grid == me))
    backend = dist.get_backend()
    device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
              else torch.device("cpu"))
    return Mesh((cfg.data_axis, cfg.model_axis), (dp, mp), (i, j), (data_group, model_group),
                backend, device)


def single_device_mesh(device="cuda") -> Mesh:
    """A 1 x 1 mesh with no process group: every collective over it is the
    identity."""
    return Mesh((DATA_AXIS, MODEL_AXIS), (1, 1), (0, 0), (None, None), None,
                torch.device(device))


@dataclass(frozen=True)
class BatchSharding:
    """The leading (batch) dim split over ``axis`` of ``mesh``: rank i of the
    axis holds rows [i b/p, (i + 1) b/p) of a global batch of b rows."""

    mesh: Mesh
    axis: str = DATA_AXIS

    def rows(self, x):
        """This rank's rows of a global array or tensor (other values as
        they are)."""
        if not (torch.is_tensor(x) or isinstance(x, np.ndarray)):
            return x
        i = self.mesh.index(self.axis)
        local = local_batch_size(x.shape[0], self.mesh, self.axis)
        return x[i * local:(i + 1) * local]


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> BatchSharding:
    """The batch dim over the data axis, the rest replicated."""
    return BatchSharding(mesh, axis)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of a global batch (a dict of arrays or tensors),
    where ctpa places the global batch sharded over 'data'."""
    sh = batch_sharding(mesh)
    return {k: sh.rows(v) for k, v in batch.items()}


def global_batch_from_local(mesh: Mesh, local_batch: dict) -> dict:
    """This rank's rows, as they are: each process reads only its own
    samples (e.g. a ``data.datasets.ProcessShard``), and the global batch is
    the ranks' rows in rank order, never assembled in one place (ctpa builds
    a global ``jax.Array`` from the processes' rows)."""
    del mesh
    return dict(local_batch)


def is_primary() -> bool:
    """Rank 0 of the default group (or no group): the one that writes
    checkpoints and evaluation artifacts."""
    return process_index() == 0


@contextlib.contextmanager
def maybe_mesh(mesh: Optional[Mesh]):
    """ctpa enters the mesh as JAX's ambient context; PyTorch has none, so
    the mesh is passed to what uses it and this does nothing."""
    del mesh
    yield


def local_batch_size(global_batch: int, mesh: Mesh, axis: str = DATA_AXIS) -> int:
    dp = mesh.size(axis)
    if global_batch % dp != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {dp}")
    return global_batch // dp
