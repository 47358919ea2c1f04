"""Data parallelism across processes (the twin of the JAX package's
`parallel/mesh.py`).

JAX shards the batch over a 1-axis `data` mesh with the parameters
replicated, and XLA inserts the gradient all-reduce; across hosts
`jax.distributed` joins the processes and each one feeds its own slice of
the global batch. Here each process is one rank of a `torch.distributed`
process group that holds its slice (`local_rows`) on its own card, and the
port makes the step's cross-batch operations global explicitly:

  - the optimizers average each gradient across ranks before the update
    (`average_gradients`: one flat buffer per optimizer, one all-reduce);
  - BatchNorm in a train step normalizes by the global batch's statistics
    and moves its running buffers by them (`models/layers.py`, inside
    `global_batch_stats()`), the all-reduce differentiable
    (`all_reduce_sum`);
  - the metrics a step returns are the global means (`global_metrics`).

So a step at world size N on N local batches computes what the world-1
step computes on their concatenation, up to float32 sums in another order.

Backends: NCCL on the card, gloo on the CPU; a caller may ask for gloo on
the card by argument (two ranks sharing one card, which NCCL refuses).
Nothing picks one in place of the other. gloo takes CUDA tensors for
every collective used here (it stages them through pinned host memory
itself; `parallel/ranks.py`'s `collectives` job checks which it takes).
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import os
import socket
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# Rendezvous and collective timeout: a rank that never arrives, or a
# collective that one rank never reaches, raises after this long instead
# of waiting forever.
TIMEOUT = datetime.timedelta(minutes=10)
_sync_batch_stats = False


def init_distributed(coordinator_address: str = "", num_processes: int = 1,
                     process_id: int = -1, platform: str = "",
                     backend: Optional[str] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the process group, as `jax.distributed.initialize` does for the
    JAX package (main.py:165-170). `coordinator_address` is rank 0's
    host:port (`tcp://` rendezvous); `process_id` -1 takes the rank, and
    with `num_processes` 1 the world size, from the environment torchrun
    sets (RANK, WORLD_SIZE; MASTER_ADDR / MASTER_PORT when no address is
    given). One process with no address and no such environment is a
    no-op, as in JAX; it raises where WORLD_SIZE > 1 says that it is one
    of several. The backend is NCCL for the card (`platform` '') and
    gloo for the CPU unless `backend` names one. On the card each rank
    takes card LOCAL_RANK, else rank % device count. Returns whether a
    group was started."""
    if dist.is_initialized():
        return False
    env_rank = process_id < 0 and "RANK" in os.environ
    if num_processes <= 1 and not coordinator_address and not env_rank:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise ValueError(
                f"WORLD_SIZE={os.environ['WORLD_SIZE']} is set but this "
                f"process would run alone (--process_id={process_id}, "
                "--num_processes=1, no --coordinator_address): give "
                "--process_id=-1 to take torchrun's rank")
        return False
    if process_id < 0:
        if "RANK" not in os.environ:
            raise ValueError("--process_id=-1 takes the rank from the "
                             "environment (RANK, as torchrun sets it), "
                             "which is not set")
        process_id = int(os.environ["RANK"])
        if num_processes <= 1:
            num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id={process_id} is not a rank of "
                         f"--num_processes={num_processes}")
    if backend is None:
        if platform not in ("", "cpu"):
            raise ValueError(f"--platform must be '' (the card) or 'cpu', "
                             f"got {platform!r}")
        backend = "nccl" if platform == "" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_card_index(process_id))
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return True


def shutdown() -> None:
    """Leave the process group (all ranks)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world() -> int:
    return dist.get_world_size() if is_distributed() else 1


def _card_index(r: int) -> int:
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else r % torch.cuda.device_count()


def rank_device() -> torch.device:
    """This rank's card, made the current one: `cuda` outside a process
    group, else cuda:<LOCAL_RANK or rank % device count>."""
    if not is_distributed():
        return torch.device("cuda")
    index = _card_index(rank())
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def free_port() -> int:
    """A free TCP port on this host for a `127.0.0.1:<port>` rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------- collectives
def _all_reduce_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum over ranks, in place."""
    dist.all_reduce(tensor)
    return tensor


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def average_gradients(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean of each gradient over the ranks, the psum XLA inserts
    (mesh.py:3-6): one flat buffer, one all-reduce, one division. Outside
    a process group, the gradients as given."""
    grads = list(grads)
    if not is_distributed() or not grads:
        return grads
    if len({(g.dtype, g.device) for g in grads}) != 1:
        raise ValueError("gradients of several dtypes or devices")
    flat = _all_reduce_(_flat(grads))
    return _unflat(flat.div_(world()), grads)


@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor]) -> None:
    """Give every rank rank 0's values, in place (parameters, buffers,
    optimizer moments), one broadcast per dtype and device. JAX relies on
    the same seed or checkpoint on every host (mesh.py:53-60); this makes
    it so whatever each rank started from."""
    if not is_distributed():
        return
    groups: Dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for like in groups.values():
        flat = _flat(like)
        dist.broadcast(flat, 0)
        for t, v in zip(like, _unflat(flat, like)):
            t.copy_(v)


def same_on_all_ranks(value: int, what: str) -> None:
    """Raise on every rank unless every rank holds the same `value`."""
    if not is_distributed():
        return
    seen = [None] * world()
    dist.all_gather_object(seen, int(value))
    if len(set(seen)) != 1:
        raise RuntimeError(f"the ranks disagree on {what}: {seen} (rank "
                           "order)")


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Sum over ranks, differentiable: the backward pass sums the
    gradient over the ranks too, so each rank's backward carries every
    rank's dependence on the sum (as SyncBatchNorm's does)."""
    return _AllReduceSum.apply(tensor)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor):
        return _all_reduce_(tensor.clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.clone())


def gather_rows(tensor: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors concatenated along dim 0, in rank order (every
    rank holds the same number of rows)."""
    if not is_distributed():
        return tensor
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(world())]
    dist.all_gather(parts, tensor)
    return torch.cat(parts)


def global_metrics(metrics: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """A step's metrics over the global batch: each scalar the mean over
    the ranks (the global mean: every rank's batch has the same size),
    one all-reduce for all of them, in float32 or the metrics' wider
    type; each array (the `hist/` embeddings) the ranks' rows
    concatenated. Outside a process group, as given."""
    if not is_distributed():
        return metrics
    scalars = [k for k, v in metrics.items() if v.dim() == 0]
    out = dict(metrics)
    if scalars:
        dtype = functools.reduce(torch.promote_types, (
            metrics[k].dtype for k in scalars), torch.float32)
        flat = _all_reduce_(torch.stack([metrics[k].detach().to(dtype)
                                         for k in scalars]))
        flat.div_(world())
        out.update({k: flat[i] for i, k in enumerate(scalars)})
    for k, v in metrics.items():
        if v.dim() > 0:
            out[k] = gather_rows(v.detach())
    return out


def barrier() -> None:
    if is_distributed():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def local_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's slice of a global tensor along `dim` (rows r*n/N up to
    (r+1)*n/N): the JAX package's `shard_batch`, seen from one process."""
    n, w = x.shape[dim], world()
    if n % w:
        raise ValueError(f"{n} rows do not split over {w} ranks")
    return x.narrow(dim, rank() * (n // w), n // w)


# ------------------------------------------------------------ BatchNorm
@contextlib.contextmanager
def global_batch_stats():
    """Inside the block, BatchNorm in train mode normalizes by the global
    batch's statistics when the world holds more than one rank (what a
    flax BatchNorm computes on a batch sharded over a mesh). The train
    steps enter it; the testers do not: the JAX package's testers take no
    mesh, each process scoring its own batch. Also a decorator."""
    global _sync_batch_stats
    saved, _sync_batch_stats = _sync_batch_stats, world() > 1
    try:
        yield
    finally:
        _sync_batch_stats = saved


def batch_stats_are_global() -> bool:
    return _sync_batch_stats
