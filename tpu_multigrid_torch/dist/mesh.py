"""A 2D grid of ranks for spatial domain decomposition, and its transport.

The grid is sharded (y, x) over an ``(my, mx)`` grid of ranks, the
counterpart of the JAX package's ``jax.sharding.Mesh`` over the axes
``("gy", "gx")`` (``tpu_multigrid/dist/mesh.py``).  A :class:`GridMesh`
holds the grid's shape, this rank's coordinates ``(cy, cx)`` (row-major in
the process group's ranks, as the JAX package lays its devices out), the
``torch.distributed`` process group and the device the rank works on.

The transport is the counterpart of ``shard_map``'s collectives:

* :func:`shift_from_prev` / :func:`shift_from_next`: the ring permutations
  of ``lax.ppermute`` along one axis, from ``dist.P2POp`` and
  ``dist.batch_isend_irecv``; an axis of size 1 is a local copy, which is
  what ``ppermute`` does there;
* :func:`all_gather_rows_cols`: the tiled two-axis all-gather;
* :func:`all_reduce_sum`: ``psum`` over both axes (the identity on one
  rank).

Tensors travel on the group's backend: NCCL for CUDA tensors, gloo for CPU
tensors.  One case is staged: a gloo group holding CUDA tensors (several
ranks sharing one card, as ``chip_smoke.py``'s 2 x 2 check runs them)
copies each message through host memory here, explicitly.  An NCCL group
given CPU tensors raises; no backend or device is switched silently.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import default_device

GRID_AXES = ("gy", "gx")


def _factor2(n: int) -> Tuple[int, int]:
    """Most-square factorization (a, b) with a * b = n, a <= b."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """An (my, mx) grid of ranks; this rank sits at ``coords``.

    ``peers[r]`` is the global rank of the group's rank ``r`` (row-major
    grid position ``r``).  ``group`` is None only for the one-rank mesh
    without a process group."""

    shape: Tuple[int, int]
    coords: Tuple[int, int]
    group: Any
    device: torch.device
    peers: Tuple[int, ...]
    backend: Optional[str]

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def rank(self) -> int:
        """This rank's row-major position in the grid (its group rank)."""
        return self.coords[0] * self.shape[1] + self.coords[1]

    def peer(self, cy: int, cx: int) -> int:
        """The global rank at grid position (cy, cx), taken cyclically."""
        my, mx = self.shape
        return self.peers[(cy % my) * mx + cx % mx]

    def staged(self, x: torch.Tensor) -> bool:
        """Whether ``x`` travels through host memory: a CUDA tensor on a
        gloo group."""
        return self.backend == "gloo" and x.device.type == "cuda"


def make_grid_mesh(shape: Optional[Tuple[int, int]] = None, *, group=None,
                   device=None) -> GridMesh:
    """The grid of ranks of ``group`` (the default group when None).

    ``shape`` defaults to the most square factorisation of the group's size
    (``my <= mx``).  A mesh of more than one rank needs an initialised
    process group of ``my * mx`` ranks; the (1, 1) mesh may have none.
    ``device`` is where this rank's blocks live (the card when None, as
    everywhere in this package)."""
    device = default_device(device)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    size = 1 if group is None else dist.get_world_size(group)
    if shape is None:
        shape = _factor2(size)
    my, mx = (int(s) for s in shape)
    if my * mx != size:
        raise ValueError(f"mesh shape {(my, mx)} != {size} ranks"
                         + ("" if group is not None else
                            " (no process group is initialised)"))
    if group is None:
        return GridMesh((1, 1), (0, 0), None, device, (0,), None)
    rank = dist.get_rank(group)
    peers = tuple(dist.get_global_rank(group, r) for r in range(size))
    backend = str(dist.get_backend(group))
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL group carries CUDA tensors; got device "
                         f"{device}")
    return GridMesh((my, mx), (rank // mx, rank % mx), group, device, peers,
                    backend)


# The 3D tiers' (mz, my) grid of ranks (the JAX package's
# ``dist/shard_cycle3.py::make_grid_mesh3``) is the same mesh: axis 0 runs
# along z, axis 1 along y, x is not decomposed, and the transport takes 3D
# blocks as they are (the gather joins dims 0 and 1).
make_grid_mesh3 = make_grid_mesh


def _shift(mesh: GridMesh, x: torch.Tensor, axis: int, step: int):
    """Each rank receives ``x`` from the rank ``step`` before it along
    ``axis`` (cyclically)."""
    n = mesh.shape[axis]
    if n == 1:
        return x.clone()
    cy, cx = mesh.coords
    dst = (cy + step, cx) if axis == 0 else (cy, cx + step)
    src = (cy - step, cx) if axis == 0 else (cy, cx - step)
    send = x.contiguous()
    if mesh.staged(send):
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, mesh.peer(*dst), mesh.group),
           dist.P2POp(dist.irecv, recv, mesh.peer(*src), mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if recv.device != x.device else recv


def shift_from_prev(mesh: GridMesh, x: torch.Tensor, axis: int):
    """Each rank receives its previous neighbour's ``x`` along ``axis``
    (0 = gy, 1 = gx), wrapping at 0."""
    return _shift(mesh, x, axis, 1)


def shift_from_next(mesh: GridMesh, x: torch.Tensor, axis: int):
    """Each rank receives its next neighbour's ``x`` along ``axis``,
    wrapping at the end."""
    return _shift(mesh, x, axis, -1)


def all_gather_rows_cols(mesh: GridMesh, x: torch.Tensor) -> torch.Tensor:
    """The (my * r, mx * c) array of every rank's (r, c) block ``x``, placed
    at its grid position, on every rank."""
    if mesh.size == 1:
        return x.clone()
    send = x.contiguous()
    if mesh.staged(send):
        send = send.cpu()
    blocks = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(blocks, send, group=mesh.group)
    my, mx = mesh.shape
    rows = [torch.cat(blocks[cy * mx:(cy + 1) * mx], dim=1)
            for cy in range(my)]
    return torch.cat(rows, dim=0).to(x.device)


def all_reduce_sum(mesh: GridMesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over every rank, on every rank (a new tensor)."""
    if mesh.size == 1:
        return x.clone()
    t = x.detach().clone()
    if mesh.staged(t):
        t = t.cpu()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t.to(x.device)
