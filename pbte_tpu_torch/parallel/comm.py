"""A grid of ranks over ``torch.distributed``: the port's counterpart of the
collectives pbte_tpu's sharded solvers run under ``shard_map``.

A ``Grid`` lays the ``world_size`` ranks out row-major over named axes, as
pbte_tpu's ``Mesh(devices.reshape(n_dir, n_space), ("dir", "space"))``
does: with axes ``dir`` x ``space`` rank r sits at ``(r // n_space,
r % n_space)``. Each axis has a process group per line of ranks along it.
The operations are the three the JAX code uses, with its semantics:

- ``psum(x, axis)``: ``lax.psum``, an all-reduce SUM over the axis (or a
  tuple of axes);
- ``ppermute(x, axis, perm)``: ``lax.ppermute``, each ``(src, dst)`` pair of
  axis indices sends src's x to dst; a rank that no pair sends to receives
  zeros;
- ``all_gather(x, axis, dim)``: ``lax.all_gather(..., tiled=True)``, the
  axis' blocks concatenated along ``dim`` in axis order;

and ``pmax`` for the residual's scale. A 1 x 1 grid needs no process group:
every operation is then local.

The backend is NCCL where every rank owns a GPU of its own and gloo
otherwise (the CPU tests, and several ranks sharing one card, which NCCL
refuses). Gloo does not take every collective on CUDA tensors: under gloo
``ppermute`` copies a CUDA tensor through the host, here and nowhere else,
so the solvers' compute stays on the card. On an H100 with four
ranks sharing ``cuda:0``, gloo ran ``all_reduce``, ``all_gather`` and
``broadcast`` on CUDA tensors with the right values, and its point-to-point
send (``batch_isend_irecv``) aborted the process (``writev ... Bad
address``: it hands the device pointer to a socket).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

AXES = ("dir", "space", "band")


class Grid:
    """``Grid(dir=2, space=2)``: the ranks of the default process group
    (or one rank, for a 1 x 1 grid) over the named axes, in the order
    given. Call it on every rank, in the same order as every other grid
    (process groups are created collectively)."""

    def __init__(self, **sizes):
        for name in sizes:
            if name not in AXES:
                raise ValueError(f"unknown grid axis {name!r}; one of {AXES}")
        self.axes = tuple(sizes)
        self.shape = {a: int(n) for a, n in sizes.items()}
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        if self.size == 1:
            self.rank, self.backend = 0, None
        else:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"a grid of {self.size} ranks needs torch.distributed: "
                    "call comm.init_process_group first (or run under "
                    "torchrun)")
            if dist.get_world_size() != self.size:
                raise ValueError(
                    f"grid {self.describe()} needs {self.size} ranks, the "
                    f"process group has {dist.get_world_size()}")
            self.rank = dist.get_rank()
            self.backend = dist.get_backend()
        # row-major coordinates of this rank
        self.coords, r = {}, self.rank
        for a in reversed(self.axes):
            self.coords[a] = r % self.shape[a]
            r //= self.shape[a]
        self._groups = {}
        if self.size > 1:
            for a in self.axes:
                self._groups[a] = self._line_groups(a)

    def describe(self) -> str:
        return " x ".join(f"{a}={n}" for a, n in self.shape.items())

    def index(self, axis) -> int:
        """This rank's index along ``axis`` (0 on an axis the grid lacks)."""
        return self.coords.get(axis, 0)

    def n(self, axis) -> int:
        """The grid's extent along ``axis`` (1 on an axis it lacks)."""
        return self.shape.get(axis, 1)

    def rank_at(self, **coords) -> int:
        """The global rank at the given coordinates (others as this
        rank's)."""
        r = 0
        for a in self.axes:
            r = r * self.shape[a] + int(coords.get(a, self.coords[a]))
        return r

    def _line_groups(self, axis):
        """A process group for each line of ranks along ``axis``, created
        on every rank in one order; returns this rank's."""
        others = [a for a in self.axes if a != axis]
        mine = None
        lines = [{}]
        for a in others:
            lines = [dict(c, **{a: i}) for c in lines
                     for i in range(self.shape[a])]
        for fixed in lines:
            ranks = [self.rank_at(**fixed, **{axis: i})
                     for i in range(self.shape[axis])]
            g = dist.new_group(ranks) if self.shape[axis] > 1 else None
            if self.rank in ranks:
                mine = (g, ranks)
        return mine

    # -- collectives ----------------------------------------------------------

    def _reduce(self, x, axis, op):
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        axes = [a for a in axes if self.n(a) > 1]
        if not axes:
            return x
        x = x.clone().contiguous()
        if len(axes) == len([a for a in self.axes if self.n(a) > 1]):
            dist.all_reduce(x, op=op)
        else:
            for a in axes:
                dist.all_reduce(x, op=op, group=self._groups[a][0])
        return x

    def psum(self, x, axis):
        """All-reduce SUM over ``axis`` (a name or a tuple of names)."""
        return self._reduce(x, axis, dist.ReduceOp.SUM)

    def pmax(self, x, axis):
        """All-reduce MAX over ``axis`` (a name or a tuple of names)."""
        return self._reduce(x, axis, dist.ReduceOp.MAX)

    def ppermute(self, x, axis, perm):
        """``lax.ppermute`` along ``axis``: ``perm`` holds (src, dst) axis
        indices; returns what this rank receives, zeros if nothing."""
        me = self.index(axis)
        if self.n(axis) == 1:
            return x.clone() if (0, 0) in perm else torch.zeros_like(x)
        # gloo's send and recv take host memory only
        host = self.backend == "gloo" and x.is_cuda
        send = x.contiguous().cpu() if host else x.contiguous()
        recv = torch.zeros_like(send)
        ops = []
        for src, dst in perm:
            if src == me and dst == me:
                recv.copy_(send)
            elif src == me:
                ops.append(dist.P2POp(dist.isend, send,
                                      self.rank_at(**{axis: dst})))
            elif dst == me:
                ops.append(dist.P2POp(dist.irecv, recv,
                                      self.rank_at(**{axis: src})))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return recv.to(x.device) if host else recv

    def all_gather(self, x, axis, dim=0):
        """The axis' blocks of x concatenated along ``dim`` in axis
        order (``lax.all_gather(..., tiled=True)``)."""
        if self.n(axis) == 1:
            return x
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.n(axis))]
        dist.all_gather(parts, src, group=self._groups[axis][0])
        return torch.cat(parts, dim=dim)

    def barrier(self):
        if self.size > 1:
            dist.barrier()


class DirShard:
    """This rank's share of the direction slots and bands under
    ``SourceIterationSolver``'s ``dir_sharding`` grid (``grid`` None: all
    of them). A Km bucket of ``km_b`` slots (a multiple of the ``dir``
    ranks) gives each ``dir`` rank a contiguous ``km_b / n_dir`` of them,
    and the ``BS`` bands (a multiple of the ``band`` ranks) each ``band``
    rank ``BS / n_band``, as pbte_tpu's ``NamedSharding`` of the slot and
    band axes does. Other axes of the grid hold replicas."""

    def __init__(self, grid, BS):
        self.grid = grid
        self.n_dir = grid.n("dir") if grid is not None else 1
        self.n_band = grid.n("band") if grid is not None else 1
        self.bl = BS // self.n_band  # this rank's bands
        b0 = grid.index("band") * self.bl if grid is not None else 0
        self.bsl = slice(b0, b0 + self.bl)
        self._d0 = grid.index("dir") if grid is not None else 0

    def kss(self, km_b):
        """This rank's slots of a bucket of ``km_b`` slots."""
        kl = km_b // self.n_dir
        return slice(self._d0 * kl, (self._d0 + 1) * kl)

    def psum(self, x):
        """x summed over the slot and band ranks (x itself unsharded)."""
        if self.grid is None:
            return x
        return self.grid.psum(x, ("dir", "band"))

    def gather(self, x, dir_dim, band_dim):
        """Every rank's slots (along ``dir_dim``) and bands (along
        ``band_dim``) of x, in grid order (collective)."""
        if self.grid is None:
            return x
        x = self.grid.all_gather(x.contiguous(), "dir", dim=dir_dim)
        return self.grid.all_gather(x, "band", dim=band_dim)


def init_process_group(world_size, rank, device):
    """Join ``world_size`` ranks through torchrun's environment rendezvous
    (no-op for one rank, or when already joined): NCCL when ``device`` is
    a GPU and every rank has one of its own on this host, else gloo (NCCL
    refuses two ranks on one card)."""
    if world_size <= 1 or dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        dist.init_process_group("nccl", init_method="env://",
                                world_size=world_size, rank=rank,
                                device_id=device)
    else:
        dist.init_process_group("gloo", init_method="env://",
                                world_size=world_size, rank=rank)


def env_rank():
    """(rank, world size, local rank) from torchrun's environment; (0, 1,
    0) outside it."""
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))
