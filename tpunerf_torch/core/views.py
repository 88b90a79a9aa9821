"""View (camera pose) sampling — the training loop's "data" layer."""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from tpunerf_torch.core.camera import get_view_direction


@dataclasses.dataclass
class ViewBatch:
    """A batch of spherical camera poses (all shapes (B,))."""
    theta: torch.Tensor    # polar angle from +Y, radians
    phi: torch.Tensor      # azimuth, radians
    radius: torch.Tensor
    dirs: torch.Tensor     # int64 view-direction bucket
    is_body: torch.Tensor  # bool — body vs head camera

    @property
    def batch_size(self) -> int:
        return self.theta.shape[0]

    def to(self, device: torch.device) -> "ViewBatch":
        return ViewBatch(*(getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)))

    def __getitem__(self, idx) -> "ViewBatch":
        """The poses at `idx` (a slice or an index tensor)."""
        return ViewBatch(*(getattr(self, f.name)[idx]
                           for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class ViewSamplerConfig:
    radius_range: Tuple[float, float] = (1.0, 1.5)
    theta_range: Tuple[float, float] = (0.0, 150.0)   # degrees
    phi_range: Tuple[float, float] = (0.0, 360.0)     # degrees
    angle_overhead: float = 30.0                      # degrees
    angle_front: float = 60.0                         # degrees
    body_prob: float = 1.0
    eval_theta: float = 60.0   # degrees — fixed polar angle of the eval orbit
    eval_radius_scale: float = 1.2  # eval radius = radius_range[1] * scale


def rand_poses(size: int, cfg: ViewSamplerConfig, device: torch.device,
               generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> ViewBatch:
    """Uniform random poses. `u` (4, size) holds the U[0, 1) draws for
    radius, theta, phi and the body coin, in that order; drawn from
    `generator` when not given."""
    if u is None:
        u = torch.rand((4, size), generator=generator, device=device)
    u = u.to(device=device, dtype=torch.float32)
    lo_r, hi_r = cfg.radius_range
    lo_t, hi_t = (math.radians(v) for v in cfg.theta_range)
    lo_p, hi_p = (math.radians(v) for v in cfg.phi_range)
    radius = u[0] * (hi_r - lo_r) + lo_r
    theta = u[1] * (hi_t - lo_t) + lo_t
    phi = u[2] * (hi_p - lo_p) + lo_p
    dirs = get_view_direction(theta, phi, math.radians(cfg.angle_overhead),
                              math.radians(cfg.angle_front))
    return ViewBatch(theta=theta, phi=phi, radius=radius, dirs=dirs,
                     is_body=u[3] < cfg.body_prob)


def train_view_stream(seed: int, batch_size: int, cfg: ViewSamplerConfig,
                      device: torch.device, host_id: Optional[int] = None,
                      draws: Optional[Iterable[torch.Tensor]] = None
                      ) -> Iterator[ViewBatch]:
    """Infinite per-step pose stream (← the JAX package's
    `train_view_stream`): one generator seeded from `seed` and, where
    `host_id` is given, the host id, so that each host draws other views
    (the data-parallel axis) and a host draws the same views each time.
    `draws` (an iterable of (4, batch_size) U[0, 1) tensors, as
    `rand_poses` takes them) replaces the generator's."""
    if draws is not None:
        for u in draws:
            yield rand_poses(batch_size, cfg, device, u=u)
        return
    if host_id is not None:
        seed = int(np.random.SeedSequence([seed, host_id]).generate_state(
            1, np.uint64)[0] >> 1)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    while True:
        yield rand_poses(batch_size, cfg, device, generator=generator)


def circle_poses(size: int, cfg: ViewSamplerConfig, device: torch.device
                 ) -> ViewBatch:
    """Fixed eval orbit: phi = i/size · 360° at the eval polar angle."""
    theta = torch.full((size,), math.radians(cfg.eval_theta),
                       dtype=torch.float32, device=device)
    phi = (torch.arange(size, dtype=torch.float32, device=device) / size
           * (2 * math.pi))
    radius = torch.full((size,), cfg.radius_range[1] * cfg.eval_radius_scale,
                        dtype=torch.float32, device=device)
    dirs = get_view_direction(theta, phi, math.radians(cfg.angle_overhead),
                              math.radians(cfg.angle_front))
    return ViewBatch(theta=theta, phi=phi, radius=radius, dirs=dirs,
                     is_body=torch.ones((size,), dtype=torch.bool,
                                        device=device))
