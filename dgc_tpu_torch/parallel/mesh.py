"""The vertex mesh and its helpers (port of ``dgc_tpu.parallel.mesh``).

A mesh is the process group of ``torch.distributed``: each rank is one
device of the 1-D vertex mesh and owns the contiguous block
``[rank·V/n, (rank+1)·V/n)`` of a vertex axis padded to a multiple of
``n``. Exchange is the group's collectives on device tensors: NCCL for
tensors on a card, gloo for tensors on the CPU (``group_backend``), and
the ring's point-to-point rotation (``VertexMesh.rotate``). With no
group initialized (no launcher), ``make_mesh`` initializes a one-rank group
itself over an in-memory store, so a plain run of a sharded engine needs
no launcher; ``parallel.multihost`` initializes a group of many ranks from
``torchrun``'s environment.
"""

from __future__ import annotations

import atexit
import os

import numpy as np
import torch
import torch.distributed as dist

from dgc_tpu_torch.device import resolve_device

VERTEX_AXIS = "v"

# the all-gather into one tensor: ``all_gather_single`` where torch has it,
# which deprecates ``all_gather_into_tensor`` in its favour
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def group_backend() -> str:
    """The process group's backend: NCCL for tensors on a card and gloo for
    tensors on the CPU where this torch has NCCL and a card for each of
    this host's ranks, else gloo. NCCL refuses two ranks on one card,
    which ``local_device`` gives when the ranks outnumber the cards."""
    if not (dist.is_nccl_available() and torch.cuda.is_available()):
        return "gloo"
    ranks = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1")))
    if ranks > torch.cuda.device_count():
        return "gloo"
    return "cpu:gloo,cuda:nccl"


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def init_group(**kwargs) -> None:
    """``dist.init_process_group`` with ``group_backend()`` and ``kwargs``;
    the group is destroyed at exit."""
    dist.init_process_group(backend=group_backend(), **kwargs)
    atexit.register(_destroy)


def local_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda`` becomes ``cuda:LOCAL_RANK`` under
    a launcher (modulo the cards present, so that several ranks may share
    one card), or the current card without one; anything else is left as
    it is."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None \
            or not torch.cuda.is_available():
        return dev
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", torch.cuda.current_device() if local is None
                        else int(local) % torch.cuda.device_count())


class VertexMesh:
    """The 1-D vertex mesh of the default process group, seen from this
    rank: its ``size`` (the mesh's devices), ``rank`` (this shard) and
    ``device`` (where its tensors live). ``staged``: the group is gloo and
    the tensors are on a card, so ``rotate`` goes through host buffers."""

    def __init__(self, size: int, rank: int, device: torch.device,
                 staged: bool = False):
        self.size = size
        self.rank = rank
        self.device = device
        self.staged = staged
        self.shape = {VERTEX_AXIS: size}
        self._host = None  # rotate's pinned send and receive buffers

    def block(self, n: int) -> slice:
        """This rank's rows of a vertex axis of ``n`` rows (a multiple of
        the mesh size)."""
        rows = n // self.size
        return slice(self.rank * rows, (self.rank + 1) * rows)

    def all_gather(self, out: torch.Tensor, local: torch.Tensor) -> None:
        """Every rank's ``local`` block, in rank order, into ``out``."""
        _all_gather(out, local)

    def all_reduce(self, t: torch.Tensor, op: str) -> None:
        """``t`` reduced in place over the ranks (``op``: sum or max)."""
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op])

    def rotate(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """One step of the ring (``dgc_tpu``'s ``ppermute`` to ``i + 1``):
        ``src`` goes to rank ``(rank + 1) % n`` and ``dst`` receives rank
        ``(rank − 1) % n``'s, by ``torch.distributed.batch_isend_irecv``;
        at n = 1 there is nothing to send and no call is made. On NCCL the
        transfer is ordered on the card's stream and the host does not
        wait. gloo's point-to-point does not take card tensors (a send of
        one never completes), so on the ``staged`` route (a gloo group,
        tensors on a card: several ranks sharing one card) the words go
        through pinned host buffers and the host waits for them."""
        if self.size == 1:
            return
        send, recv = src, dst
        if self.staged:
            if self._host is None or self._host.shape[1] != src.shape[0]:
                self._host = torch.empty((2, src.shape[0]), dtype=src.dtype,
                                         pin_memory=True)
            send, recv = self._host
            send.copy_(src)  # waits for the card's work up to here
        ops = [dist.P2POp(dist.isend, send, (self.rank + 1) % self.size),
               dist.P2POp(dist.irecv, recv, (self.rank - 1) % self.size)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if self.staged:
            dst.copy_(recv)

    def fetch_global(self, local: torch.Tensor) -> np.ndarray:
        """The vertex-sharded tensor whose block on this rank is ``local``,
        gathered from every rank to the host."""
        if self.size == 1:
            return local.cpu().numpy()
        out = torch.empty((self.size * local.shape[0], *local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        self.all_gather(out, local.contiguous())
        return out.cpu().numpy()


def make_mesh(num_devices: int | None = None, device="cuda") -> VertexMesh:
    """1-D mesh over the vertex axis: every rank of the default process
    group (initialized here as a one-rank group if no launcher did it).
    ``num_devices=None`` uses them all; more than the group has raises as
    ``dgc_tpu``'s ``make_mesh`` does. A rank is one device of the mesh, so
    ``num_devices`` below the group's size raises too: run fewer ranks."""
    # failure-domain test plane (resilience.faults): a mesh@N=device_loss
    # schedule makes the Nth mesh construction fail like a host whose
    # device dropped between attempts. One None check when no plane is
    # armed.
    from dgc_tpu_torch.resilience.faults import fault_point

    dev = resolve_device(local_device(device))
    size = dist.get_world_size() if dist.is_initialized() else 1
    if num_devices is not None:
        if num_devices > size:
            raise ValueError(f"requested {num_devices} devices, have {size}")
        if num_devices < size:
            raise ValueError(f"requested {num_devices} devices of a group of "
                             f"{size} ranks: each rank is one device of the "
                             f"mesh (run {num_devices} ranks)")
    fault_point("mesh", devices=size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        init_group(store=dist.HashStore(), rank=0, world_size=1)
    mesh = VertexMesh(size, dist.get_rank(), dev, staged=dev.type == "cuda"
                      and "nccl" not in str(dist.get_backend()))
    # one collective on the mesh's device, so that the backend's lazy
    # set-up (NCCL's communicator) falls in the engine's build and not in
    # its first superstep
    mesh.all_reduce(torch.zeros(1, dtype=torch.int32, device=dev), "sum")
    return mesh


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def fetch_global(x: torch.Tensor, mesh: VertexMesh | None = None) -> np.ndarray:
    """Host copy of a kernel output: a vertex-sharded one (``mesh``
    given) gathered from every rank, a replicated one read from this
    rank."""
    if mesh is None:
        return x.cpu().numpy()
    return mesh.fetch_global(x)
