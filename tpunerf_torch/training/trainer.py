"""Trainer — the eager step loop.

The app supplies `loss_fn(views, generator=…)`; each step draws poses,
renders, runs guidance, back-propagates, takes an Adam step and calls the
app's `post_step` (the occupancy refresh). Every random draw comes from one
`torch.Generator` seeded with `optim.seed`. Metric rows (`loss`,
`grad_norm`, `steps_per_s`, `rays_per_s` and the app's scalars) go to
`<exp_dir>/metrics.jsonl` every 50 steps.

For an app with an `eval_render` (latent-paint) the trainer also renders
the eval orbit: `log.eval_size` frames before the first step into
`vis/eval/`, and after the last step `log.full_eval_size` frames into
`results/` (a video where an encoder is installed, PNGs otherwise) and the
mesh export of `log.save_mesh`. Checkpoints, train-render images, the
chunked trainer and profiler traces are not ported yet; a config that asks
for one of them is refused at construction.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpunerf_torch.core.config import dump_yaml
from tpunerf_torch.core.views import (ViewSamplerConfig, circle_poses,
                                      rand_poses)
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.utils import (MetricsWriter, init_logger, make_generator,
                                 make_path, resolve_device, seed_everything,
                                 write_png)

METRIC_INTERVAL = 50


def unported_settings(cfg: TrainConfig, app: Any = None) -> list:
    """The settings of `cfg` that need trainer features the port does not
    have yet. The eval orbit and the mesh export are there for apps with an
    `eval_render`."""
    log, optim = cfg.log, cfg.optim
    can_eval = hasattr(app, "eval_render")
    asks = {
        "log.eval_size != 0 (eval frames)":
            log.eval_size != 0 and not can_eval,
        "log.full_eval_size != 0 (final eval orbit)":
            log.full_eval_size != 0 and not can_eval,
        "log.save_mesh (mesh export)": log.save_mesh and not can_eval,
        "log.log_images (train-render images)": log.log_images,
        "log.save_interval <= optim.iters (checkpoints)":
            log.save_interval <= optim.iters,
        "log.eval_only": log.eval_only,
        "log.trace_steps (profiler traces)": log.trace_steps is not None,
        "optim.resume / optim.ckpt (checkpoints)":
            optim.resume or optim.ckpt is not None,
        "optim.check_nan (last-good checkpoint)": optim.check_nan,
        "optim.train_chunk > 1 (chunked trainer)": optim.train_chunk > 1,
    }
    return [k for k, v in asks.items() if v]


class Trainer:
    def __init__(self, cfg: TrainConfig, app: Any,
                 device: Optional[torch.device] = None):
        self.device = resolve_device(device)
        missing = unported_settings(cfg, app)
        if missing:
            raise NotImplementedError(
                "not ported yet, comes with a later slice of the port (see "
                "ROADMAP.md): " + "; ".join(missing))
        self.cfg = cfg
        self.app = app
        seed_everything(cfg.optim.seed)

        self.exp_dir = make_path(cfg.log.exp_dir)
        self.eval_vis_dir = make_path(self.exp_dir / "vis" / "eval")
        self.results_dir = make_path(self.exp_dir / "results")
        self.logger = init_logger(self.exp_dir)
        self.metrics = MetricsWriter(self.exp_dir / "metrics.jsonl")
        dump_yaml(cfg, self.exp_dir / "config.yaml")

        self.view_cfg = self.view_config(cfg)

        self.generator = make_generator(cfg.optim.seed, self.device)
        app.init_params(self.generator)
        self.optimizer = app.make_optimizer()
        self.params = [p for g in self.optimizer.param_groups
                       for p in g["params"]]
        n_params = sum(p.numel() for p in self.params)
        self.logger.info(f"Scene has {n_params} learnable parameters")
        self.train_step_idx = 0

    @staticmethod
    def view_config(cfg: TrainConfig) -> ViewSamplerConfig:
        return ViewSamplerConfig(
            radius_range=cfg.render.radius_range,
            theta_range=cfg.render.theta_range,
            phi_range=cfg.render.phi_range,
            angle_overhead=cfg.render.angle_overhead,
            angle_front=cfg.render.angle_front,
            body_prob=cfg.render.body_prob)

    # ------------------------------------------------------------------ #
    def train_step(self) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One step: poses → loss → backward → Adam → post-step hook."""
        self.train_step_idx += 1
        gen = self.generator
        views = rand_poses(self.cfg.render.batch_size, self.view_cfg,
                           self.device, generator=gen)
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.app.loss_fn(views, generator=gen)
        loss.backward()
        self.optimizer.step()
        post = getattr(self.app, "post_step", None)
        if post is not None:
            post(self.train_step_idx, generator=gen)
        return loss.detach(), aux

    def grad_norm(self) -> float:
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            return 0.0
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads])).item()

    def train(self, on_step: Optional[Callable[[int, torch.Tensor], None]]
              = None) -> None:
        """Run to `optim.iters`. `on_step(step, loss)` is called after each
        step (the loss is a device tensor). Apps with an `eval_render` get
        the eval frames before the first step and the full eval after the
        last."""
        cfg = self.cfg
        can_eval = hasattr(self.app, "eval_render")
        if can_eval:
            self.evaluate(self.train_step_idx, size=cfg.log.eval_size)
        last_time, last_step = time.perf_counter(), self.train_step_idx
        while self.train_step_idx < cfg.optim.iters:
            loss, _ = self.train_step()
            if on_step is not None:
                on_step(self.train_step_idx, loss)
            if self.train_step_idx % METRIC_INTERVAL == 0:
                loss_f = loss.item()       # synchronises the device
                now = time.perf_counter()
                dt = now - last_time
                steps = self.train_step_idx - last_step
                last_time, last_step = now, self.train_step_idx
                self.metrics.write(
                    self.train_step_idx, loss=loss_f,
                    grad_norm=self.grad_norm(), steps_per_s=steps / dt,
                    rays_per_s=steps * cfg.render.batch_size
                    * cfg.render.train_grid_size ** 2 / dt,
                    **self._app_metric_scalars(),
                    **self._device_memory_scalars())
        self.logger.info("Finished Training ^_^")
        if can_eval:
            self.logger.info("Evaluating the last model...")
            self.full_eval()
            self.logger.info("\tDone!")

    # ------------------------------------------------------------------ #
    def evaluate(self, step: int, size: int, save_as_video: bool = False,
                 out_dir: Optional[Path] = None) -> List[np.ndarray]:
        """Render and save `size` frames of the eval orbit, in chunks of
        `log.eval_batch` poses (the tail chunk is padded by repeating the
        last pose, so every chunk has one shape). Frames are uint8 by
        clip-then-truncate; the first chunk's decoded texture is saved
        beside them. Returns the frames."""
        cfg = self.cfg
        out_dir = out_dir or self.eval_vis_dir
        frames: List[np.ndarray] = []
        if size <= 0:
            return frames
        views = circle_poses(size, self.view_cfg, self.device)
        dims = (cfg.render.eval_grid_size, cfg.render.eval_grid_size)
        chunk = max(1, min(size, cfg.log.eval_batch))
        for s in range(0, size, chunk):
            idx = torch.clamp(torch.arange(s, s + chunk, device=self.device),
                              max=size - 1)
            out = self.app.eval_render(views[idx], dims)
            img = (out["image"].clamp(0.0, 1.0) * 255).to(torch.uint8)
            frames.extend(img[:min(chunk, size - s)].cpu().numpy())
            if s == 0 and out.get("texture_map") is not None:
                tex = out["texture_map"][0]
                if tex.min() < 0:          # [−1, 1] → [0, 1]
                    tex = tex * 0.5 + 0.5
                self._save_image(
                    out_dir / f"step_{step:06d}_texture.png",
                    (tex.clamp(0.0, 1.0) * 255).to(torch.uint8).cpu().numpy())
        if save_as_video:
            # mp4 → gif → pngs, first available (a failed video encode is
            # not fatal)
            try:
                import imageio
                imageio.mimwrite(self.results_dir /
                                 f"step_{step:06d}_rgb.mp4", frames, fps=25)
            except Exception:
                try:
                    import imageio
                    imageio.mimwrite(
                        self.results_dir / f"step_{step:06d}_rgb.gif",
                        frames, duration=40, loop=0)
                except Exception as e:
                    self.logger.warning(
                        f"video encode failed ({e}); saving pngs")
                    save_as_video = False
        if not save_as_video:
            for i, f in enumerate(frames):
                self._save_image(out_dir / f"step_{step:06d}_{i:03d}_rgb.png",
                                 f)
        return frames

    def full_eval(self) -> None:
        cfg = self.cfg
        self.evaluate(self.train_step_idx, size=cfg.log.full_eval_size,
                      save_as_video=True, out_dir=self.results_dir)
        if cfg.log.save_mesh:
            export_dir = make_path(self.exp_dir / "mesh")
            self.app.export(export_dir)
            self.logger.info(f"mesh exported to {export_dir}")

    @staticmethod
    def _save_image(path: Path, img: np.ndarray) -> None:
        write_png(path, img)

    def _app_metric_scalars(self) -> Dict[str, float]:
        hook = getattr(self.app, "metric_scalars", None)
        return hook() if hook is not None else {}

    def _device_memory_scalars(self) -> Dict[str, float]:
        if self.device.type != "cuda":
            return {}
        return {"peak_mem_mb": torch.cuda.max_memory_allocated(self.device)
                / 2 ** 20,
                "mem_mb": torch.cuda.memory_allocated(self.device) / 2 ** 20}
