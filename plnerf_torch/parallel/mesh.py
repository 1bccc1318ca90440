"""Data parallelism over a process group (port of
``plnerf/parallel/mesh.py``).

The JAX package lays a 1-D mesh (axis ``DATA_AXIS``, "dp") over every
chip of one program: the ray batch is sharded along rays, the parameters
are replicated, and the loss is a mean over the global batch, whose
gradient all-reduce XLA inserts.  The port does the same in PyTorch's
idiom: one process per device under ``torchrun``, a
``torch.distributed`` process group (NCCL on CUDA, gloo on the CPU), rank
``r`` on ``cuda:LOCAL_RANK``, and the collectives called explicitly:

* ``replicate``: the parameters broadcast from rank 0;
* ``shard_batch``: each rank's row range of the global batch (every rank
  draws the same global batch from the same seed);
* ``all_reduce_mean``: one flat buffer per step, summed over the ranks
  and scaled by 1 / world: the gradients (the mean of the ranks' equal
  shard means is the global mean) and the step's scalar metrics;
* ``all_reduce_sum`` (differentiable) and ``all_reduce_max_``: the
  space-carving loss's per-hypothesis ray sums and the occupancy grid's
  per-voxel observations, which do not split across shards;
* ``gather_round_robin``: the row all-gather of chunked renders and
  density grids (chunk ``i`` on rank ``i % world``).

A ``Mesh`` of one rank is a valid world (``torchrun --nproc_per_node
1``): every collective then leaves its input as it is, so the run is
bit-equal to the same run without a process group.

The three collectives a train step calls (``all_reduce_mean``,
``all_reduce_sum`` and its backward, ``all_reduce_max_``) read no value
on the host and run in place on tensors of fixed shapes, so a CUDA graph
of a window of steps (``train/graph.py``) captures them: NCCL enqueues
each on the capturing stream.  ``make_mesh`` hands NCCL the process's
device, which makes its communicator when the group is made, before any
capture.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world: its ``rank`` of
    ``size`` and its ``device``; ``group`` None is the default group."""
    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None


def launched_world_size() -> int:
    """``WORLD_SIZE`` as ``torchrun`` sets it; 0 outside a launch."""
    return int(os.environ.get("WORLD_SIZE", "0"))


def make_mesh(device_type: Optional[str] = None) -> Mesh:
    """This process's ``Mesh``: joins the process group of a ``torchrun``
    launch (NCCL for CUDA, gloo for the CPU; rendezvous from the
    environment) unless one is already initialised, as a test's
    ``init_process_group`` does.  On CUDA the process's device is
    ``cuda:LOCAL_RANK``, made current first.  A failed init raises."""
    cuda = (device_type or ("cuda" if torch.cuda.is_available()
                            else "cpu")) == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA data-parallel world needs CUDA; pass "
                               "device='cpu' to run on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if cuda else "gloo",
                                device_id=device if cuda else None)
    return Mesh(dist.get_rank(), dist.get_world_size(), device)


def get_mesh(no_mesh: bool, device_type: Optional[str]) -> Optional[Mesh]:
    """The drivers' mesh: a ``Mesh`` under ``torchrun`` (``WORLD_SIZE``
    set), else None, one device.  ``--no_mesh`` under a launch of more
    than one process is refused: the ranks would all train alone.
    Outside a launch, a machine with several cards prints how to use
    them."""
    world = launched_world_size()
    if no_mesh and world > 1:
        raise SystemExit(f"--no_mesh under torchrun with WORLD_SIZE {world}:"
                         " launch one process or drop --no_mesh")
    if world and not no_mesh:
        return make_mesh(device_type)
    if (not world and device_type != "cpu" and torch.cuda.is_available()
            and torch.cuda.device_count() > 1):
        print(f"NOTE: {torch.cuda.device_count()} CUDA devices visible; this "
              "run uses one. Launch with `torchrun --nproc_per_node "
              f"{torch.cuda.device_count()} -m <driver> ...` to train and "
              "evaluate data-parallel on all of them")
    return None


def refuse_unsplit(n_rand: int) -> None:
    """Refuse a train batch of ``n_rand`` rays that does not split evenly
    over the processes of a ``torchrun`` launch."""
    world = launched_world_size()
    if world > 1 and n_rand % world:
        raise SystemExit(f"--N_rand {n_rand} does not split over the {world} "
                         f"ranks of this launch (WORLD_SIZE {world}): pick a "
                         f"multiple of {world}")


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if mesh is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0, group=mesh.group)
    return box[0]


def is_main(mesh: Optional[Mesh]) -> bool:
    """Rank 0, or no mesh: the process that writes files and prints."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        dist.barrier(group=mesh.group)


@contextlib.contextmanager
def main_stdout(mesh: Optional[Mesh]) -> Iterator[None]:
    """Standard output of every rank but 0 goes nowhere while active
    (standard error stays)."""
    if is_main(mesh):
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield
    sys.stdout.flush()


def row_range(n: int, mesh: Mesh) -> slice:
    """This rank's rows of an ``n``-row batch; ``n`` must divide by the
    world size (the JAX package shards evenly too)."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rays does not split evenly over "
                         f"{mesh.size} ranks")
    m = n // mesh.size
    return slice(mesh.rank * m, (mesh.rank + 1) * m)


# batch entries whose ray axis is not the leading one
_RAY_AXIS = {"target_h": 1}
# batch entries every rank keeps whole
_REPLICATED = ("occ_grid", "img_idx")


def shard_batch(batch: Dict, mesh: Optional[Mesh]) -> Dict:
    """This rank's rows of a global batch of tensors: axis 1 of
    ``target_h`` [H, R, 1], axis 0 of the others; the grid, the image
    index and 0-d entries replicated."""
    if mesh is None:
        return batch
    out = {}
    for k, v in batch.items():
        if k in _REPLICATED or not isinstance(v, torch.Tensor) or v.dim() == 0:
            out[k] = v
            continue
        axis = _RAY_AXIS.get(k, 0)
        rows = row_range(v.shape[axis], mesh)
        out[k] = v.narrow(axis, rows.start, rows.stop - rows.start)
    return out


def replicate(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Broadcast every tensor from rank 0, in place."""
    if mesh is None:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, 0, group=mesh.group)


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]
                    ) -> List[torch.Tensor]:
    """The ranks' mean of every tensor (float32) through one flat buffer
    and one all-reduce; returns new tensors (views of the buffer) in the
    input's shapes.  One rank: the inputs' values exactly."""
    if mesh is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    if mesh.size > 1:
        flat.mul_(1.0 / mesh.size)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


class _SumOverRanks(torch.autograd.Function):
    """The ranks' sum of a tensor, whose backward is the ranks' sum of the
    cotangents (``torch.distributed.nn.functional.all_reduce``, which
    torch deprecates)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Differentiable sum over the ranks: its backward sums the ranks'
    cotangents, so every rank's share of a loss computed from the sum
    reaches its own rows."""
    if mesh is None:
        return t
    return _SumOverRanks.apply(t, mesh.group)


def all_reduce_max_(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Elementwise max over the ranks, in place; returns ``t``."""
    if mesh is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t


def gather_round_robin(local: Sequence[torch.Tensor], sizes: Sequence[int],
                       cols: int, mesh: Mesh) -> torch.Tensor:
    """The row all-gather of a chunked computation: chunk ``i`` of
    ``sizes[i]`` rows ran on rank ``i % world``, which passes its chunks
    in order (``local``, each [sizes[i], cols] float32).  Every rank gets
    all chunks concatenated in chunk order, [sum(sizes), cols]: one
    all-gather of each rank's chunks padded to [rounds, max(sizes),
    cols]."""
    w, n = mesh.size, len(sizes)
    buf = torch.zeros((pad_to_multiple(n, w) // w, max(sizes), cols),
                      device=mesh.device)
    for j, c in enumerate(local):
        buf[j, :c.shape[0]] = c
    parts = [torch.empty_like(buf) for _ in range(w)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat([parts[i % w][i // w, :sizes[i]] for i in range(n)], 0)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
