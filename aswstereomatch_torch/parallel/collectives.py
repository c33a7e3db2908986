"""The tile axis's transport: the counterparts of the reference's
``lax.ppermute``, ``lax.all_gather`` and ``lax.all_to_all`` over one data
row's shards (``Group``), for the SPMD layouts of parallel/tiling.py,
parallel/dshard.py and parallel/reshard.py.

Every process runs the same exchange with the same list of messages, each
a (source shard, destination shard) pair:

  - between two shards of one process the message is the block moved to
    the destination's device (``to_device``);
  - between processes it is a point-to-point ``isend`` / ``irecv`` through
    the default ``torch.distributed`` group, all of one exchange's posted as
    one ``dist.batch_isend_irecv`` list in one global order, (source,
    destination, part) ascending, on every process.  NCCL ignores tags and
    matches the messages between two ranks in the order they were posted;
    gloo matches them by the tag made from the same triple.  A tag recurs
    in the next exchange, whose messages both deliver after this one's;
  - a process that owns neither end of a message takes no part in it, so
    one that owns no shard communicates nothing.

Receive buffers take their shapes from the layout's arithmetic (the caller's
``like``), never from a message of their own.  Gathers are point-to-point
too, from each shard to the first shard of each other owner, so no process
has to join a ``dist.new_group``.

``sent_bytes`` counts the bytes this process posted to other processes,
by exchange kind ("halo", "strip", "gather", "all_to_all").
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# Tensors a message may carry; its parts' tags follow its pair's.
MAX_PARTS = 8

sent_bytes: collections.Counter = collections.Counter()


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A block moved to ``device`` (a no-op on its own device).  A copy to a
    card is asynchronous; a copy to the CPU is not, since a non-blocking
    one would hand back a buffer that the card has yet to fill."""
    device = torch.device(device)
    return t.to(device, non_blocking=device.type == "cuda")


class Group:
    """One data row's tile shards: shard k is computed by ``owners[k]``, a
    (rank, device); ``rank`` is this process's, ``local`` the shards it owns
    in tile order, and ``rep[k]`` the first shard of k's owner, where a
    gather lands and replicated work runs once per owner."""

    def __init__(self, owners, rank: int):
        self.owners = [(int(r), torch.device(d)) for r, d in owners]
        self.rank = rank
        self.size = len(self.owners)
        self.local = [k for k, (r, _) in enumerate(self.owners) if r == rank]
        first: dict = {}
        self.rep = [first.setdefault(o, k) for k, o in enumerate(self.owners)]

    @classmethod
    def of(cls, device_mesh, data_index: int = 0) -> "Group":
        """The tile group of one data row of a ``mesh.Mesh``."""
        return cls(device_mesh.owners(data_index), device_mesh.rank)

    def device(self, k: int) -> torch.device:
        return self.owners[k][1]

    def is_local(self, k: int) -> bool:
        return self.owners[k][0] == self.rank


def _outgoing(t: torch.Tensor, nccl: bool) -> torch.Tensor:
    """The tensor a send posts: the block itself on NCCL; on gloo, whose
    send takes host tensors, a card's block is staged through pinned host
    memory (gloo's copy, not the layout's)."""
    if nccl or t.device.type != "cuda":
        return t.contiguous()
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    staged.copy_(t)
    return staged


def _incoming(shape, dtype, device: torch.device, nccl: bool) -> torch.Tensor:
    """A receive buffer: on the destination's device on NCCL; on gloo in
    host memory, pinned where the destination is a card (gloo's copy)."""
    if nccl or device.type != "cuda":
        return torch.empty(shape, dtype=dtype, device=device if nccl else "cpu")
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def exchange(group: Group, msgs, part, like, kind: str) -> dict:
    """One exchange over ``group``.  ``msgs`` lists every (src, dst) shard
    pair that sends a message, the same list on every process;
    ``part(src, dst)`` gives the message's tensors where ``src`` is local,
    ``like(src, dst)`` their (shape, dtype)s where only ``dst`` is.
    Returns {(src, dst): the tensors on dst's device} for every message to
    a local shard."""
    out, ops, pending = {}, [], []
    nccl = None
    for src, dst in sorted(msgs):
        src_here, dst_here = group.is_local(src), group.is_local(dst)
        if src_here and dst_here:
            out[(src, dst)] = [to_device(t, group.device(dst)) for t in part(src, dst)]
            continue
        if not (src_here or dst_here):
            continue
        if nccl is None:
            nccl = dist.get_backend() == "nccl"
        tag = (src * group.size + dst) * MAX_PARTS
        if src_here:
            parts = part(src, dst)
            if len(parts) > MAX_PARTS:
                raise ValueError(f"a message carries at most {MAX_PARTS} tensors, got {len(parts)}")
            for slot, t in enumerate(parts):
                if t.numel():
                    ops.append(dist.P2POp(dist.isend, _outgoing(t, nccl),
                                          group.owners[dst][0], tag=tag + slot))
                    sent_bytes[kind] += t.numel() * t.element_size()
        else:
            dev = group.device(dst)
            bufs = [_incoming(shape, dtype, dev, nccl) for shape, dtype in like(src, dst)]
            ops += [dist.P2POp(dist.irecv, b, group.owners[src][0], tag=tag + slot)
                    for slot, b in enumerate(bufs) if b.numel()]
            pending.append(((src, dst), dev, bufs))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for key, dev, bufs in pending:
        out[key] = [to_device(b, dev) for b in bufs]
    return out


def all_gather(group: Group, parts: dict) -> dict:
    """Every shard's parts ({k: [tensors]} for the local shards, each part
    of one shape and dtype on every shard) gathered onto the first shard of
    each local owner: {rep: [shard 0's parts, ..., shard n-1's]}."""
    reps = sorted({group.rep[k] for k in range(group.size)})
    got = exchange(group, [(s, d) for d in reps for s in range(group.size)],
                   lambda s, d: parts[s],
                   lambda s, d: [(p.shape, p.dtype) for p in parts[d]], "gather")
    return {d: [got[(s, d)] for s in range(group.size)]
            for d in reps if group.is_local(d)}


def replicated(group: Group, parts: dict, fn) -> dict:
    """``fn`` of every shard's parts, gathered in shard order, run once per
    local owner (the reference's all_gather + replicated compute):
    {k: the result on k's device} for the local shards."""
    done = {rep: fn(gathered) for rep, gathered in all_gather(group, parts).items()}
    return {k: done[group.rep[k]] for k in group.local}


def all_to_all(group: Group, pieces: dict, like) -> dict:
    """``pieces``: {i: [the piece for shard 0, ..., shard n-1]} for the local
    shards; ``like(i, j)`` the (shape, dtype) of i's piece for j.  Returns
    {j: [the piece from shard 0, ..., shard n-1]} for the local shards."""
    n = group.size
    got = exchange(group, [(i, j) for i in range(n) for j in range(n)],
                   lambda i, j: [pieces[i][j]], lambda i, j: [like(i, j)], "all_to_all")
    return {j: [got[(i, j)][0] for i in range(n)] for j in group.local}
