"""Device-mesh distribution layer: the JAX package's (data, rays) mesh as
data-parallel training over `torch.distributed`.

* `data` axis: the views of a step's global batch, and their draws, are
  split over the data index (`data_rows`, `shard_views`, `shard_draws`);
* `rays` axis: the pixels of each frame are split over the rays index
  (`row_band`): the NeRF render marches only its band and `gather_rows`
  rebuilds the frame within the rays row before guidance; the paint
  renders rasterize the whole frame and keep only the gradient of their
  rows (`band_grad`);
* parameters, buffers and Adam's state are replicated: `replicate_`
  broadcasts rank 0's, and `all_reduce_grads` sums the gradients over the
  world after each backward pass, where the JAX package's XLA inserts its
  psum.

Ranks are laid out row-major as data x rays: rank = data_index * n_rays +
rays_index. A rank's rays row is the n_rays ranks of its data index (their
frames are the same views), its data row the n_data ranks of its rays index.

The losses are sums over the global batch (the SDS term is
sum(latents * grad)), so every term a rank computes is its share: the world's
sum of the shares, and of their gradients, is the one-rank term and
gradient. A term the n_rays ranks of a rays row compute whole from the
gathered frame is divided by n_rays (`sum_share`); a mean over the batch or
its rays is taken over the global count (`mean_share`, `world_share`); a
term every rank computes whole is divided by the world size (`world_share`).
`gather_rows`' backward, and `band_grad`'s, hand the rank n_rays times its
own band of the frame's gradient: the sum over the row of its n_rays equal
copies.

Gloo runs only `broadcast` and `all_reduce` on CUDA tensors (`all_gather` is
CPU-only in its table), so every collective here is one of those two: one
code path runs on NCCL, on gloo over CUDA tensors and on gloo over the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from datetime import timedelta
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from tpunerf_torch.utils import resolve_device


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or no process group: the process that writes files."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if initialized() and world_size() > 1:
        dist.barrier()


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_from_env() -> int:
    """torchrun's `RANK` (0 where unset)."""
    return int(os.environ.get("RANK", "0"))


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               rank_: Optional[int] = None, world: Optional[int] = None,
               device: Union[str, torch.device, None] = "cuda",
               timeout_s: Optional[float] = None) -> bool:
    """Join the process group (the counterpart of `initialize_multihost`).
    The rank and world size default to torchrun's `RANK` and `WORLD_SIZE`;
    at world size 1 without an `init_method` this is a no-op. The backend is
    NCCL for a CUDA `device` and gloo for the CPU unless named (gloo runs on
    CUDA tensors too: two ranks on one card need it, NCCL refuses them).
    Returns whether a process group is up. A failed rendezvous raises."""
    if initialized():
        return True
    rank_ = rank_from_env() if rank_ is None else rank_
    world = int(os.environ.get("WORLD_SIZE", "1")) if world is None else world
    if world == 1 and init_method is None:
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank_, world_size=world, **kwargs)
    return True


@contextlib.contextmanager
def launched(device: Optional[str]) -> Iterator[Optional[str]]:
    """An entry point's device and process group. Outside torchrun (no
    `WORLD_SIZE`, or 1) nothing changes. Under torchrun a rank runs on
    `cuda:$LOCAL_RANK` over NCCL, or on the CPU over gloo with `--device
    cpu`; a rank that finds no card and was not told `--device cpu` raises
    before the rendezvous. The process group is destroyed at the end."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        yield device
        return
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        resolve_device(device)           # raises without a card
        torch.cuda.set_device(local_rank())
        device = f"cuda:{local_rank()}"
    initialize(device="cpu" if cpu else "cuda")
    try:
        yield device
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def main_process_first() -> Iterator[None]:
    """Rank 0 runs the block first, the other ranks after it (a cache rank 0
    builds and writes, the others then read)."""
    if not is_main_process():
        barrier()
    yield
    if is_main_process():
        barrier()


@dataclasses.dataclass
class MeshLayout:
    """A rank's place on the (data, rays) mesh, and the group of its rays
    row (None where the row is this rank alone)."""
    rank: int
    world_size: int
    n_data: int
    n_rays: int
    rays_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_rays

    @property
    def rays_index(self) -> int:
        return self.rank % self.n_rays

    @property
    def splits(self) -> bool:
        """Whether the step is split at all (more than one rank)."""
        return self.world_size > 1

    # ---- the data axis ---- #
    def data_rows(self, batch: int) -> slice:
        """This rank's 1/n_data of a global batch's views (the trainer
        builds no mesh whose data axis does not divide the batch)."""
        if batch % self.n_data:
            raise ValueError(f"{self.n_data} data ranks do not divide a "
                             f"batch of {batch}")
        b = batch // self.n_data
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def shard_views(self, views):
        """This rank's slice of a global `ViewBatch` (← `shard_views`)."""
        return views[self.data_rows(views.batch_size)]

    def shard_draws(self, draws: dict, batch: int) -> dict:
        """This rank's slice of a step's global draws: the views' rows of
        each batched draw; a 0-dim draw (the SDS timestep) is every
        view's."""
        rows = self.data_rows(batch)
        return {k: v[rows] if torch.is_tensor(v) and v.dim() else v
                for k, v in draws.items()}

    # ---- the rays axis ---- #
    def row_band(self, n: int) -> slice:
        """This rank's 1/n_rays of a frame's n rows (or pixels); see
        `bands`."""
        if not self.bands(n):
            raise ValueError(f"{self.n_rays} rays ranks do not split {n}")
        k = n // self.n_rays
        return slice(self.rays_index * k, (self.rays_index + 1) * k)

    def bands(self, n: int) -> bool:
        return self.n_rays > 1 and n % self.n_rays == 0

    def gather_rows(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole frame from each rank's band along `dim` (the rays
        row's bands in order); autograd gives back this rank's band."""
        if self.n_rays == 1:
            return x
        return _GatherRows.apply(x, self, dim)

    def band_grad(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """`x`, a whole frame every rank of the rays row holds alike, with
        its gradient kept to this rank's band along `dim` (n_rays times
        it, as `gather_rows` gives it back)."""
        if self.n_rays == 1:
            return x
        return _BandGrad.apply(x, self, dim)

    # ---- shares of the loss terms ---- #
    def sum_share(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's views that every rank of its rays row
        computes whole."""
        return x / self.n_rays

    def mean_share(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of the mean over the global batch's rays of
        the values `x` it holds (its views, its band or the whole frame)."""
        return x.sum() / (x.numel() * self.world_size)

    def world_share(self, x: torch.Tensor) -> torch.Tensor:
        """A term every rank computes whole, or a mean over this rank's
        views computed whole by its rays row."""
        return x / self.world_size

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The world's sum of `x` (a copy; no gradient)."""
        out = x.detach().clone()
        if initialized():
            dist.all_reduce(out)
        return out


class _GatherRows(torch.autograd.Function):
    """all_reduce of a zero-filled frame into which each rank wrote its
    band; backward: n_rays times this rank's band of the gradient (the sum
    over the rays row of its equal copies)."""

    @staticmethod
    def forward(ctx, x, layout: MeshLayout, dim: int):
        k = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = k * layout.n_rays
        out = x.new_zeros(shape)
        out.narrow(dim, layout.rays_index * k, k).copy_(x)
        dist.all_reduce(out, group=layout.rays_group)
        ctx.layout, ctx.dim, ctx.k = layout, dim, k
        return out

    @staticmethod
    def backward(ctx, g):
        layout = ctx.layout
        band = g.narrow(ctx.dim, layout.rays_index * ctx.k, ctx.k)
        return band * layout.n_rays, None, None


class _BandGrad(torch.autograd.Function):
    """The identity; backward: n_rays times this rank's band of the
    gradient, zero elsewhere."""

    @staticmethod
    def forward(ctx, x, layout: MeshLayout, dim: int):
        ctx.layout, ctx.dim = layout, dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        layout, dim = ctx.layout, ctx.dim
        out = torch.zeros_like(g)
        band = layout.row_band(g.shape[dim])
        k = band.stop - band.start
        out.narrow(dim, band.start, k).copy_(
            g.narrow(dim, band.start, k) * layout.n_rays)
        return out, None, None


def make_mesh(n_data: Optional[int] = None, n_rays: int = 1) -> MeshLayout:
    """The (data, rays) mesh over the world (the process group's ranks, or
    this process alone). Default: every rank on `data`. Every rank must
    call this, in the same order as the others' calls (it creates the rays
    rows' groups)."""
    n = world_size()
    if n_data is None:
        n_data = n // n_rays
    assert n_data * n_rays == n, (n_data, n_rays, n)
    r = rank()
    rays_group = None
    if initialized() and n_rays > 1:
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_rays, (d + 1) * n_rays)))
            if d == r // n_rays:
                rays_group = g
    return MeshLayout(rank=r, world_size=n, n_data=n_data, n_rays=n_rays,
                      rays_group=rays_group)


def _as_wire(t: torch.Tensor) -> torch.Tensor:
    """A view every backend's collectives carry (a bool as its bytes)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


@torch.no_grad()
def replicate_(tensors: Iterable[torch.Tensor]) -> None:
    """Rank 0's values in every rank's `tensors`, in place (←
    `shard_params_replicated`). Every rank passes its tensors in the same
    order."""
    if not initialized():
        return
    for t in tensors:
        dist.broadcast(_as_wire(t), src=0)


def state_tensors(module_state: dict, optimizer: torch.optim.Optimizer
                  ) -> List[torch.Tensor]:
    """What `replicate_` broadcasts for a trainer: the app's parameters and
    buffers (its state dict, in order) and Adam's state tensors (in the
    optimizer's parameter order)."""
    out = [v for v in module_state.values() if torch.is_tensor(v)]
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            out.extend(st[k] for k in sorted(st) if torch.is_tensor(st[k]))
    return out


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.Tensor],
                     *extra: torch.Tensor) -> List[torch.Tensor]:
    """Sum every parameter's gradient over the world, in place, in one
    fixed order: one flat buffer a dtype (by the dtype's name), the
    parameters in order, `extra` (0-dim float tensors, such as the step's
    loss) at the end of the float32 buffer. Returns the summed `extra`.
    Parameters without a gradient take no part; every rank must hold the
    same set. No process group: the gradients and `extra` as they are."""
    if not initialized():
        return list(extra)
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    by_dtype.setdefault(torch.float32, [])
    out: List[torch.Tensor] = []
    for dtype in sorted(by_dtype, key=str):
        grads = by_dtype[dtype]
        parts = [g.reshape(-1) for g in grads]
        if dtype == torch.float32:
            parts += [e.detach().reshape(-1).to(dtype) for e in extra]
        if not parts:
            continue
        flat = torch.cat(parts)
        dist.all_reduce(flat)
        off = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[off:off + n].view_as(g))
            off += n
        if dtype == torch.float32:
            out = [flat[off + i].reshape(e.shape).to(e.dtype)
                   for i, e in enumerate(extra)]
    return out
