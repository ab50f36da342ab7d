"""Data-parallel process groups (port of boxsegliver_tpu/parallel/mesh.py:
18-62; reference utils/distribution_utils.py:27-206).

JAX shards the batch axis of one program over a 1-D device mesh.  The port
runs one process per device in a ``torch.distributed`` process group and
gives each rank its rows of every global batch:

- ``resolve_replicas`` is JAX's ``make_mesh`` device rule: 0 means every
  visible device (all visible GPUs on the card, one process on the CPU), and
  more replicas than devices raises JAX's ``ValueError``.
- ``per_device_batch_size`` keeps JAX's error text.
- ``Group`` wraps a process group: the rank's rows of a global batch, the
  collectives the port uses on device tensors (``all_reduce_``,
  ``gather_rows``, ``broadcast_``: the ones gloo carries on CUDA tensors
  too) and, over a gloo group beside an NCCL one, host objects
  (``broadcast_object``, ``gather_to_chief``, ``barrier``).
- Spatial sharding (JAX's height- and depth-sharded forwards, whose halos
  XLA's partitioner inserts): ``split_blocks`` cuts one axis into a block a
  rank of whole multiples of the network's total stride (``Group.block``);
  ``Group.halo`` pads a rank's block with its neighbours' edge rows, zeros
  at the global edges; ``Group.gather_blocks`` puts the blocks together on
  every rank.  Both are one all-reduce of a zero buffer that each rank
  fills at its own place, the one form gloo (whose send / recv takes CPU
  tensors only) and NCCL both carry on CUDA tensors.
- ``launch`` starts N spawned workers with a FileStore rendezvous in a
  fresh temporary directory; ``init_group`` joins one.  NCCL where each
  rank has its own GPU, gloo on the CPU and for ranks that share a card.

A gloo collective cannot be captured in a CUDA graph; asked to, ``Group``
raises.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def device_count(device) -> int:
    """Devices a data-parallel run may take: the visible GPUs for a CUDA
    device, the CPU cores for the CPU (each rank a process)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def resolve_replicas(num_replicas: int, device) -> int:
    """Ranks of a run (JAX make_mesh, mesh.py:18-26): ``num_replicas``, or
    with 0 every visible GPU on the card and one process on the CPU."""
    if num_replicas and num_replicas > 0:
        n, have = int(num_replicas), device_count(device)
        if n > have:
            raise ValueError(f"Requested {n} replicas but only {have} devices")
        return n
    return device_count(device) if torch.device(device).type == "cuda" else 1


def per_device_batch_size(batch_size: int, num_replicas: int) -> int:
    """Global batch must divide mesh size (reference per_device_batch_size,
    distribution_utils.py:107-134 — same error contract)."""
    remainder = batch_size % num_replicas
    if remainder:
        err = ("When running with multiple replicas, batch size must be a "
               "multiple of the number of available devices. Found {} replicas "
               "with a batch size of {}; try --batch_size={} instead."
               .format(num_replicas, batch_size, batch_size - remainder))
        raise ValueError(err)
    return batch_size // num_replicas


def split_blocks(size: int, ranks: int, unit: int = 1
                 ) -> List[Tuple[int, int]]:
    """[start, stop) of each rank's block of an axis of ``size``: whole
    multiples of ``unit`` (the network's total stride along the axis), as
    equal as possible (the first ranks take one unit more), the ragged
    remainder ``size % unit`` on the last rank.  More ranks than whole
    units raise ValueError."""
    units = size // unit
    if ranks > max(units, 1):
        raise ValueError(f"cannot split an axis of {size} over {ranks} ranks "
                         f"in blocks of whole multiples of {unit}")
    q, r = divmod(units, ranks)
    blocks, start = [], 0
    for i in range(ranks):
        stop = size if i == ranks - 1 else start + (q + (i < r)) * unit
        blocks.append((start, stop))
        start = stop
    return blocks


class Group:
    """One rank's view of a data-parallel group.  ``pg`` carries device
    tensors (NCCL or gloo), ``host_pg`` host objects (gloo; ``pg`` itself
    when that is gloo)."""

    def __init__(self, pg=None, host_pg=None):
        self.pg = pg
        self.host_pg = host_pg if host_pg is not None else pg
        self.rank = dist.get_rank(pg)
        self.size = dist.get_world_size(pg)
        self.backend = dist.get_backend(pg)

    @property
    def chief(self) -> bool:
        return self.rank == 0

    # -- rows ---------------------------------------------------------------
    def rows(self, n: int) -> slice:
        """This rank's rows [r·b, (r+1)·b) of a global batch of ``n`` (JAX's
        error when the group does not divide ``n``)."""
        b = per_device_batch_size(n, self.size)
        return slice(self.rank * b, (self.rank + 1) * b)

    def take_rows(self, tree: dict, n: Optional[int] = None) -> dict:
        """This rank's rows of every array of a batch dict (leading axis
        ``n``, by default the first array's)."""
        if n is None:
            n = len(next(iter(tree.values())))
        sl = self.rows(n)
        return {k: v[sl] for k, v in tree.items()}

    # -- device collectives --------------------------------------------------
    def _check_capture(self, t: torch.Tensor):
        if (t.is_cuda and self.backend == "gloo"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("a gloo collective cannot be captured in a "
                               "CUDA graph; use an NCCL group (one GPU a "
                               "rank) or run the steps eagerly")

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        self._check_capture(t)
        dist.all_reduce(t, group=self.pg)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        self._check_capture(t)
        dist.broadcast(t, src=src, group=self.pg)
        return t

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch [size·b, ...] of every rank's rows [b, ...], on
        every rank: each rank's rows in a zero buffer, summed (exact: the
        other ranks add zeros)."""
        b = t.shape[0]
        out = t.new_zeros((self.size * b,) + tuple(t.shape[1:]))
        out[self.rank * b:(self.rank + 1) * b] = t
        return self.all_reduce_(out)

    # -- spatial blocks ----------------------------------------------------
    def block(self, size: int, unit: int = 1) -> slice:
        """This rank's block of an axis of ``size`` (split_blocks)."""
        return slice(*split_blocks(size, self.size, unit)[self.rank])

    def halo(self, x: torch.Tensor, dim: int, lo: int, hi: int,
             last_hi: Optional[int] = None) -> torch.Tensor:
        """``x`` (this rank's block along ``dim``) with the previous rank's
        last ``lo`` rows before it and the next rank's first ``hi`` rows
        after it; zeros at the global start, and ``last_hi`` (default
        ``hi``) zero rows after the last rank's block.  One all-reduce of
        every rank's edge rows, whenever ``lo`` or ``hi`` is not 0."""
        r, n = self.rank, self.size
        if last_hi is None:
            last_hi = hi
        size = x.shape[dim]
        buf = None
        if (lo or hi) and n > 1:
            if size < max(lo, hi):
                raise ValueError(f"a block of {size} rows cannot lend a halo "
                                 f"of ({lo}, {hi})")
            edges = torch.cat([x.narrow(dim, size - lo, lo),
                               x.narrow(dim, 0, hi)], dim)
            buf = edges.new_zeros((n,) + tuple(edges.shape))
            buf[r] = edges
            self.all_reduce_(buf)

        def zeros(k):
            shape = list(x.shape)
            shape[dim] = k
            return x.new_zeros(shape)

        parts = []
        if lo:
            parts.append(buf[r - 1].narrow(dim, 0, lo) if r > 0
                         else zeros(lo))
        parts.append(x)
        if r < n - 1 and hi:
            parts.append(buf[r + 1].narrow(dim, lo, hi))
        elif r == n - 1 and last_hi:
            parts.append(zeros(last_hi))
        return torch.cat(parts, dim) if len(parts) > 1 else x

    def gather_blocks(self, t: torch.Tensor, dim: int, size: int,
                      unit: int = 1) -> torch.Tensor:
        """The whole axis ``dim`` of ``size`` on every rank, from every
        rank's block ``t`` (split_blocks): each rank's block in a zero
        buffer, summed (exact: the other ranks add zeros)."""
        blk = self.block(size, unit)
        shape = list(t.shape)
        shape[dim] = size
        out = t.new_zeros(shape)
        out.narrow(dim, blk.start, blk.stop - blk.start).copy_(t)
        return self.all_reduce_(out)

    def broadcast_module(self, module: torch.nn.Module):
        """Rank 0's parameters and buffers on every rank."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                self.broadcast_(t.data)

    # -- host objects -----------------------------------------------------
    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.host_pg)
        return box[0]

    def gather_to_chief(self, arr: np.ndarray) -> Optional[List[np.ndarray]]:
        """Every rank's host array, in rank order, on rank 0 (None
        elsewhere).  The arrays may differ in shape."""
        out = [None] * self.size if self.chief else None
        dist.gather_object(arr, out, dst=0, group=self.host_pg)
        return out

    def barrier(self):
        dist.barrier(group=self.host_pg)


def rank_draws(draws: Optional[dict], group: Optional[Group]) -> Optional[dict]:
    """This rank's rows of a batch's random draws, made for the global batch
    from the generator every rank shares (JAX draws them over the global
    batch with one key, train/trainer.py:102-109)."""
    if draws is None or group is None:
        return draws
    return {k: v[group.rows(v.shape[0])] for k, v in draws.items()}


class RankGenerator:
    """The generator every rank shares, for draws the model makes itself
    (dropout masks): ``rand_rows`` draws the global batch's uniforms and
    keeps this rank's rows, as JAX's one dropout key over the sharded
    batch does."""

    def __init__(self, generator: torch.Generator, group: Group):
        self.generator = generator
        self.group = group

    def rand_rows(self, shape, device) -> torch.Tensor:
        n = shape[0] * self.group.size
        u = torch.rand((n,) + tuple(shape[1:]), generator=self.generator,
                       device=device)
        return u[self.group.rows(n)]


def init_group(rank: int, world: int, store: str, device,
               backend: Optional[str] = None) -> Group:
    """Join the group of ``world`` ranks rendezvousing at the FileStore
    ``store``.  On the card each rank takes GPU ``rank`` (set before any
    allocation or launch) and NCCL; on the CPU gloo.  ``backend="gloo"``
    on the card makes ranks that share one GPU (``device`` then names it)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else rank
        torch.cuda.set_device(index)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world, **kw)
    host_pg = dist.new_group(backend="gloo") if backend == "nccl" else None
    return Group(dist.group.WORLD, host_pg)


def close_group():
    if dist.is_initialized():
        dist.destroy_process_group()


def _entry(rank: int, fn: Callable, world: int, root: str, device,
           backend: Optional[str], args: Sequence):
    try:
        if torch.device(device).type == "cpu":
            # ranks on the CPU share its cores: more threads than cores
            # make every rank's parallel regions wait on the others'
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        group = init_group(rank, world, str(Path(root) / "store"), device,
                           backend)
        out = fn(group, *args)
        if group.chief:
            with open(Path(root) / "result.pkl", "wb") as f:
                pickle.dump(out, f)
    except Exception as e:
        try:
            data = pickle.dumps(e)
        except (pickle.PicklingError, TypeError, AttributeError):
            data = None           # the spawn error carries the traceback
        if data is not None:
            (Path(root) / f"error{rank}.pkl").write_bytes(data)
        raise
    finally:
        close_group()


def launch(fn: Callable, world: int, device, *args,
           backend: Optional[str] = None) -> Any:
    """Run ``fn(group, *args)`` in ``world`` spawned processes, one a rank,
    and return rank 0's result (it must pickle).  ``fn`` must be importable
    by name.  A worker's exception is raised here as it was raised there
    (the lowest failing rank's), chained to the spawn error."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    root = tempfile.mkdtemp(prefix="boxseg_group_")
    try:
        try:
            mp.start_processes(_entry, args=(fn, world, root, device,
                                             backend, args),
                               nprocs=world, join=True,
                               start_method="spawn")
        except ProcessException as spawn_error:
            for rank in range(world):
                path = Path(root) / f"error{rank}.pkl"
                if path.exists():
                    with open(path, "rb") as f:
                        raise pickle.load(f) from spawn_error
            raise
        with open(Path(root) / "result.pkl", "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
