"""Data parallelism over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/mesh.py``).

The JAX package runs one ``dp`` mesh axis over every chip: the parameters
and optimizer state are replicated, the batch is sharded over ``dp``, and
the GSPMD partitioner inserts the gradient reduction.  PyTorch has no mesh.
The port runs one process a card in a process group instead:

* ``init_distributed``: ``jax.distributed.initialize`` becomes
  ``init_process_group`` over ``tcp://<coordinator>``; ``nccl`` for a CUDA
  device, ``gloo`` for the CPU, ``backend=`` for anything else (``gloo``
  where two ranks share one card, which NCCL refuses).  A failure to
  initialise, or of any collective, propagates: no other backend is tried;
* ``make_mesh`` / ``batch_sharding``: the group itself, ``world_size()``,
  ``rank()`` and each rank's card, ``local_device()``;
* ``shard_batch`` / ``shard_host_local_batch``: each rank's own batch, the
  sampler's batch of that rank (``data/sampler.py``) padded to the shapes
  every rank computes alike without communication
  (``training/trainer.py:Trainer._global_shape_targets``), so the global
  batch is the ranks' batches concatenated in rank order;
* ``make_train_step``'s implicit gradient psum: ``all_reduce_mean_`` of the
  accumulated gradients in ``TrainState.apply_gradients``, before the clip,
  one collective an update;
* ``replicated_sharding``: ``broadcast_`` of the parameters and the AdamW
  state from rank 0 after a restore (``Trainer.fit``).

Every collective here is a no-op in a process that is not in a group of
more than one rank.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

Device = Union[str, torch.device, None]


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_device(device: Device = None, process_id: Optional[int] = None) -> torch.device:
    """This process's device.  ``device`` names a device (``cuda:1``,
    ``cpu``) or its type (``cuda``, the default); a CUDA type without an
    index becomes ``cuda:$LOCAL_RANK`` where a launcher set it, else
    ``cuda:{process_id % device_count}`` (``process_id`` defaults to the
    rank).  Raises without CUDA unless the caller asked for another device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the port on the CPU")
    if dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return torch.device("cuda", int(local))
    pid = rank() if process_id is None else process_id
    return torch.device("cuda", pid % torch.cuda.device_count())


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None, *,
                     device: Device = None, init_method: Optional[str] = None) -> None:
    """Join a process group of ``num_processes`` ranks as rank
    ``process_id``, rendezvous at ``tcp://<coordinator>`` (``host:port``)
    or ``init_method``.  A no-op for ``num_processes <= 1``.  The backend
    is ``nccl`` when this process's device (:func:`local_device` of
    ``device``) is a card, which becomes the current CUDA device, and
    ``gloo`` on the CPU, unless ``backend`` names one."""
    if not num_processes or num_processes <= 1:
        return
    if process_id is None or not 0 <= int(process_id) < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
    if init_method is None:
        if not coordinator:
            raise ValueError("a group of more than one process needs a coordinator host:port")
        init_method = f"tcp://{coordinator}"
    dev = local_device(device, int(process_id))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev  # binds the group's barrier to this card
    dist.init_process_group(backend, init_method=init_method, world_size=int(num_processes),
                            rank=int(process_id), **kw)


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where ``t`` is reduced: NCCL takes CUDA tensors only."""
    if t.device.type != "cuda" and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _flat_groups(tensors: Sequence[torch.Tensor]):
    """``tensors`` grouped by dtype and device, in order of first sight."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


def _collective_(tensors: Sequence[torch.Tensor], op) -> None:
    """``op(flat)`` on one flat buffer of each dtype, copied back in place."""
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group]).to(_comm_device(group[0]))
        op(flat)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Replace each tensor by its mean over the ranks, in place: one
    flattened buffer and one collective (a dtype)."""
    n = world_size()
    if n > 1 and tensors:
        def mean(flat):
            dist.all_reduce(flat)
            flat.div_(n)
        _collective_(tensors, mean)
    return tensors


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The largest value of ``t`` over the ranks (elementwise); ``t``
    itself at one rank."""
    if world_size() == 1:
        return t
    out = t.detach().clone().to(_comm_device(t))
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out.to(t.device)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> List[torch.Tensor]:
    """Overwrite each tensor with rank ``src``'s, in place."""
    tensors = list(tensors)
    if world_size() > 1 and tensors:
        with torch.no_grad():
            _collective_(tensors, lambda flat: dist.broadcast(flat, src))
    return tensors


def any_flag(flags: Sequence[bool], device: Device = None) -> List[bool]:
    """Each flag set on any rank (one collective); ``flags`` at one rank.
    ``device``: where the flags are reduced (the trainer's device)."""
    if world_size() == 1:
        return [bool(f) for f in flags]
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                     device=torch.device("cpu" if device is None else device))
    t = t.to(_comm_device(t))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


def barrier() -> None:
    """Wait until every rank reaches this point."""
    if world_size() > 1:
        dist.barrier()
