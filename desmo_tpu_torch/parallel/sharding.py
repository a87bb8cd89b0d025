"""Row sharding of DESMO training over the ``space`` axis of a device mesh,
on ``torch.distributed``. Port of what the sharded kernel path needs from
``desmo_tpu/parallel/sharding.py`` (``make_mesh``, ``shard_batch``).

The mesh is one process per device, all of them on ``space``: rank k owns
rows ``row_range(n, d, k)`` of X, of the POD modes and of phi with its
Adamax moments; everything else is replicated, and stays equal on every
rank because it is computed only from all-reduced sums and from rank 0's
broadcast. The rows split unevenly where d does not divide n
(``torch.tensor_split``'s rule: the first ``n % d`` ranks hold one row
more), so nothing is padded.

``make_mesh`` reads the process group from the environment that
``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``); a single process without it makes a
one-rank group through a ``FileStore`` in a temporary directory. The backend
is NCCL on CUDA (rank k on ``cuda:LOCAL_RANK``) and gloo on the CPU. The
``time`` axis, the parameter shardings of the eager path and multi-host
setup are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist

from desmo_tpu_torch import device as device_mod

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass
class SpaceMesh:
    """The ranks of the ``space`` axis: one process each, on ``device``."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the ranks in place (``op``: 'sum' or 'max');
        every rank gets the same bits."""
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` overwritten in place with rank ``src``'s."""
        dist.broadcast(t, src, group=self.group)
        return t

    def gather_rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The whole of a row-sharded tensor whose last axis holds this
        rank's rows of ``n``: every rank gets all ``n``."""
        if self.size == 1:
            return t
        width = -(-n // self.size)
        padded = torch.zeros(t.shape[:-1] + (width,), dtype=t.dtype, device=t.device)
        padded[..., :t.shape[-1]] = t
        parts = [torch.empty_like(padded) for _ in range(self.size)]
        dist.all_gather(parts, padded, group=self.group)
        spans = [row_range(n, self.size, k) for k in range(self.size)]
        return torch.cat([p[..., :hi - lo] for p, (lo, hi) in zip(parts, spans)], dim=-1)


def make_mesh(n_space: int | None = None, n_time: int = 1, device: str | torch.device = "cuda") -> SpaceMesh:
    """The ``space`` mesh of this process group (the ``torchrun``
    environment's, one already initialised, or, for ``n_space`` 1 alone, a
    one-rank group of its own). ``n_space`` defaults to the number of
    processes. A CUDA ``device`` makes an NCCL group, the CPU a gloo one;
    asking for CUDA without a GPU raises, as ``device.resolve`` does."""
    if n_time != 1:
        raise NotImplementedError(
            "desmo_tpu_torch does not shard the time axis (n_time > 1) yet "
            "(ROADMAP queue 1, item 5.2: the eager path over a mesh and the time axis)"
        )
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    dev = torch.device(device)
    if dev.type == "cuda" and launched and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = device_mod.resolve(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if n_space is None:
        n_space = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))
    if n_space < 1:
        raise ValueError(f"space={n_space}: a mesh needs at least one rank")
    if not dist.is_initialized():
        if launched:
            dist.init_process_group(backend, init_method="env://")
        elif n_space == 1:
            store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="desmo_mesh_"), "store"), 1)
            dist.init_process_group(backend, store=store, rank=0, world_size=1)
        else:
            raise ValueError(
                f"space={n_space} needs {n_space} processes, one per device: launch with "
                f"torchrun --nproc-per-node {n_space} -m desmo_tpu_torch run ... --mesh space={n_space}"
            )
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group's backend is {dist.get_backend()}, a mesh on {dev} needs {backend}")
    size = dist.get_world_size()
    if size != n_space:
        raise ValueError(f"space={n_space} but the process group has {size} ranks")
    return SpaceMesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size, device=dev)


def row_range(n: int, size: int, rank: int) -> tuple[int, int]:
    """Rows ``[lo, hi)`` of ``n`` that ``rank`` of ``size`` ranks owns:
    contiguous blocks in rank order, the first ``n % size`` one row longer."""
    base, extra = divmod(n, size)
    if base == 0:
        raise ValueError(f"{n} rows do not give each of {size} ranks one")
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (1 if rank < extra else 0)


def local_rows(t: torch.Tensor, mesh: SpaceMesh) -> torch.Tensor:
    """This rank's rows of a tensor whose last axis holds all ``n`` rows."""
    lo, hi = row_range(t.shape[-1], mesh.size, mesh.rank)
    return t[..., lo:hi].contiguous()


def _map_phi(state, fn):
    """``state`` (a ``train.TrainState``) with ``fn`` applied to phi and its
    moments."""
    return dataclasses.replace(
        state,
        params={**state.params, "phi": fn(state.params["phi"])},
        mu={**state.mu, "phi": fn(state.mu["phi"])},
        nu={**state.nu, "phi": fn(state.nu["phi"])},
    )


def local_state(state, mesh: SpaceMesh):
    """A training state, one model's or stacked, whose phi and moments hold
    all rows (last axis), cut to this rank's rows of them."""
    return _map_phi(state, lambda t: local_rows(t, mesh))


def gather_state(state, mesh: SpaceMesh, n: int):
    """The whole of a training state whose phi and moments hold this rank's
    rows of ``n``: every rank gets all rows (``SpaceMesh.gather_rows``)."""
    return _map_phi(state, lambda t: mesh.gather_rows(t, n))


def shard_batch(batch: dict, mesh: SpaceMesh) -> dict:
    """This rank's rows of the training batch: ``x`` (n, m) and
    ``pod_modes`` (n, r) cut to ``row_range``; ``x_sq``, the sum of X*X over
    every row, stays whole (rec adds it once)."""
    x, pod = batch["x"], batch["pod_modes"]
    lo, hi = row_range(x.shape[0], mesh.size, mesh.rank)
    return {"x": x[lo:hi].contiguous(), "x_sq": batch["x_sq"], "pod_modes": pod[lo:hi].contiguous()}
