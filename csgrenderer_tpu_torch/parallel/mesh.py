"""The ("tile", "sample") rank mesh for multi-device rendering.

Twin of ``csgrenderer_tpu/parallel/mesh.py``. JAX's mesh is one program
over many devices (``shard_map``); here every rank is a process of its own
(``torch.distributed``), which renders its row slab and its share of the
samples and then joins collectives over process groups. A mesh of
``tile x sample`` ranks places rank ``ranks[p]`` at (p // sample,
p % sample), as JAX's ``reshape(tile_ways, sample_ways)`` over the sorted
devices does, so the sample axis stays inside a host. Image rows shard
over "tile" and samples per pixel over "sample"; ray tracing needs no halo
exchange, so the mesh shape is a pure throughput knob.

Building a mesh is collective: every rank of the job calls ``make_mesh``
with the same arguments, in the same order as every other rank, because
``torch.distributed.new_group`` must be entered by every rank for every
group, members or not, in one order. A rank that skips a call hangs them
all. ``single_device_mesh`` needs no process group and makes no
collective call.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "gloo",
    **kwargs,
) -> None:
    """Join a multi-process rendering job: ``torch.distributed.init_process_group``
    with a ``tcp://coordinator_address`` init method ("host:port"; rank 0
    listens there). Idempotent: a second call, or a call in a process
    whose default group is up, returns at once.

    With no ``coordinator_address`` the job is described by the
    environment that ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``), and ``num_processes``/``process_id`` default
    to ``WORLD_SIZE``/``RANK`` there. ``kwargs`` go to
    ``init_process_group`` (``timeout=`` bounds every collective).

    ``backend``: "gloo" (the default) serves CPU ranks and ranks that
    share one card: NCCL refuses two ranks on one device. "nccl" is for
    ranks that each own a card; no test here runs it, since the machines
    this package is tested on have one card.
    """
    if dist.is_initialized():
        return
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if coordinator_address is None:
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id), **kwargs,
    )


def render_device(device="cuda") -> torch.device:
    """This rank's render device: "cuda" is ``cuda:{local rank % cards}``
    (``LOCAL_RANK``, else the global rank; on a one-card host every rank
    takes ``cuda:0``), and raises where CUDA is absent; "cpu" runs the
    kernels' plain versions."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available "
                           "(device='cpu' runs the kernels' plain versions)")
    if dev.index is not None:
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclass(frozen=True, eq=False)
class RankMesh:
    """A ``tile x sample`` mesh over ``ranks`` (sorted global ranks), seen
    from rank ``rank``.

    ``tile_group`` holds the ranks of this rank's sample index (one per
    tile: the rows gather over it), ``sample_group`` those of its tile
    index (the sample sum runs over it) and ``group`` the whole mesh (the
    ray count sums over it). A group of one rank is None: its collective
    is the identity and is skipped. On a rank outside ``ranks`` every
    group is None and ``member`` is False.
    """

    tile_ways: int
    sample_ways: int
    ranks: tuple[int, ...]
    rank: int
    device: torch.device
    tile_group: object = None
    sample_group: object = None
    group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {TILE_AXIS: self.tile_ways, SAMPLE_AXIS: self.sample_ways}

    @property
    def member(self) -> bool:
        return self.rank in self.ranks

    @property
    def index(self) -> tuple[int, int]:
        """This rank's (tile index, sample index)."""
        if not self.member:
            raise ValueError(f"rank {self.rank} is not in this mesh (ranks {list(self.ranks)})")
        p = self.ranks.index(self.rank)
        return p // self.sample_ways, p % self.sample_ways

    @property
    def tile_index(self) -> int:
        return self.index[0]


def _world() -> tuple[int, int]:
    """(this rank, world size); (0, 1) where no process group is up."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(tile_ways: int | None = None, sample_ways: int = 1, ranks=None,
              device="cuda") -> RankMesh:
    """Build a ("tile", "sample") mesh over ``ranks`` (default: every rank
    of the job).

    With no ``tile_ways`` all ranks go to the tile axis. Every rank of the
    job must call this with the same arguments, in the same order (see the
    module docstring); the arguments are checked, and ``device`` resolved,
    before any group is made, so a bad call raises on every rank alike.
    """
    rank, world = _world()
    ranks = tuple(sorted(range(world) if ranks is None else (int(r) for r in ranks)))
    if len(set(ranks)) != len(ranks) or any(not 0 <= r < world for r in ranks):
        raise ValueError(f"ranks {list(ranks)} are not distinct ranks of a world of {world}")
    n = len(ranks)
    if tile_ways is None:
        if n % sample_ways:
            raise ValueError(f"{n} devices not divisible by sample_ways={sample_ways}")
        tile_ways = n // sample_ways
    if tile_ways * sample_ways != n:
        raise ValueError(f"mesh {tile_ways}x{sample_ways} != {n} available devices")
    dev = render_device(device)
    t, s = tile_ways, sample_ways
    mine = {}

    def group(key, members):
        # every rank enters new_group for every group, in this order
        if len(members) > 1:
            g = dist.new_group(list(members))
            if rank in members:
                mine[key] = g

    for i in range(t):
        group(SAMPLE_AXIS, ranks[i * s:(i + 1) * s])
    for j in range(s):
        group(TILE_AXIS, ranks[j::s])
    group("mesh", ranks)
    return RankMesh(t, s, ranks, rank, dev, mine.get(TILE_AXIS), mine.get(SAMPLE_AXIS),
                    mine.get("mesh"))


def single_device_mesh(device="cuda") -> RankMesh:
    """A 1x1 mesh of this rank alone: no process group, no collective."""
    rank, _ = _world()
    return RankMesh(1, 1, (rank,), rank, render_device(device))
