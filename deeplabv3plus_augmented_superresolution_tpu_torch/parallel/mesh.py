"""The ("data", "aug") process mesh (port of the JAX package's
``parallel/mesh.py``).

JAX lays a 2-D mesh over the devices of one program. The port runs one
process per card (a rank, as torchrun launches them) and lays the ranks
out as JAX's ``make_mesh`` lays devices: rank = data_index * a + aug_index
on a (d, a) mesh. Images shard over "data" (each data group serves its
slice of a batch); each image's copies over "aug" (the ranks of a data
group warp and forward one block of the copies each). The collectives are
``all_reduce`` (sum, max) and ``broadcast`` only, which NCCL and gloo both
support, on CUDA tensors too: NCCL for ranks on cards, gloo on the CPU.
A mesh of one rank outside a process group runs no collective.
"""

import dataclasses
import os
import socket
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# What torchrun exports to each rank.
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def default_backend(device) -> str:
    """NCCL for ranks on cards, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device="cuda", local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: the CPU, or card LOCAL_RANK (``local_rank``, else
    the environment's, else 0). Raises when that card does not exist: two
    ranks are never put on one card here."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(f"LOCAL_RANK {local_rank} names no card: "
                           f"{count} visible")
    return torch.device("cuda", local_rank)


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def initialize_distributed(device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group that torchrun's environment describes
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK). Returns False
    and does nothing when none of them is set (an ordinary one-process
    run), True once the group is up (already up: True). The backend
    follows the device unless given; a rank on cards takes card
    LOCAL_RANK (``rank_device``)."""
    if not any(key in os.environ for key in TORCHRUN_ENV):
        return False
    if dist.is_initialized():
        return True
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or default_backend(dev), init_method="env://")
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, aug) layout of the ranks. ``aug_group`` holds the ranks that
    share this rank's images (its data index), ``data_group`` those that
    share its block of copies (its aug index); None outside a process
    group."""
    shape: Dict[str, int]
    rank: int
    aug_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["aug"]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["aug"]

    @property
    def aug_index(self) -> int:
        return self.rank % self.shape["aug"]

    def index(self, axis: str) -> int:
        return self.data_index if axis == "data" else self.aug_index

    def block(self, axis: str, n: int) -> Tuple[int, int]:
        """(start, length) of this rank's block of n items split over axis."""
        parts = self.shape[axis]
        if n % parts:
            raise ValueError(f"{n} items do not split over the {parts}-rank "
                             f"{axis!r} axis")
        length = n // parts
        return self.index(axis) * length, length

    def _group(self, axis: Optional[str]):
        return {None: None, "aug": self.aug_group, "data": self.data_group}[axis]

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum",
                   axis: Optional[str] = None) -> torch.Tensor:
        """In place over the ranks of this rank's ``axis`` group (None: every
        rank); returns the tensor."""
        if dist.is_initialized():
            dist.all_reduce(tensor, op=_OPS[op], group=self._group(axis))
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place from rank src to every rank; returns the tensor."""
        if dist.is_initialized():
            dist.broadcast(tensor, src)
        return tensor


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """The (data, aug) mesh over every rank of the process group (one rank
    outside one). The default puts everything on "aug" (1, world); a shape
    (d, a) needs d * a == world. Every rank must call it, in the same
    order, as it creates the process groups of the rows and columns."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (1, world)
    d, a = shape
    if d * a != world:
        raise ValueError(f"mesh shape {tuple(shape)} != device count {world}")
    aug_group = data_group = None
    if dist.is_initialized():
        for i in range(d):
            group = dist.new_group([i * a + j for j in range(a)])
            if i == rank // a:
                aug_group = group
        for j in range(a):
            group = dist.new_group([i * a + j for i in range(d)])
            if j == rank % a:
                data_group = group
    return Mesh({"data": d, "aug": a}, rank, aug_group, data_group)


def multihost_mesh_shape(num_processes: int, local_devices: int
                         ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(across hosts, inside a host) factors of the mesh, as JAX's: the
    images ("data") span hosts, so no per-step collective crosses them; the
    copies ("aug") stay inside a host, where the gather of their masks runs."""
    return (num_processes, 1), (1, local_devices)


def make_multihost_mesh() -> Mesh:
    """The mesh of a torchrun job over several hosts: (hosts, ranks a host),
    torchrun's rank order (host-major) being the mesh's. One host, or no
    process group: ``make_mesh``'s (1, world)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world == 1 or local == world:
        return make_mesh()
    (hosts, _), (_, per_host) = multihost_mesh_shape(world // local, local)
    return make_mesh((hosts, per_host))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array lies on the mesh: spec names the mesh axis that splits
    each leading dimension (None: not split; () replicated). Called on the
    whole array, it returns this rank's shard (a view)."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                x = x.narrow(dim, *self.mesh.block(axis, x.shape[dim]))
        return x


def data_sharding(mesh: Mesh) -> Sharding:
    """(B, ...) arrays: the images on "data"."""
    return Sharding(mesh, ("data",))


def aug_sharding(mesh: Mesh) -> Sharding:
    """(B, N, ...) arrays: images on "data", copies on "aug"."""
    return Sharding(mesh, ("data", "aug"))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def host_local_batch_to_global(mesh: Mesh, array: torch.Tensor,
                               spec: Sequence[Optional[str]]) -> torch.Tensor:
    """This rank's shard of a batch that its process loaded itself (the
    multi-host input path: every process loads only its own images). With
    one process per rank the loaded images are the rank's data slice, so
    only the dimensions on "aug" are split here."""
    return Sharding(mesh, tuple(None if axis == "data" else axis
                                for axis in spec))(array)
