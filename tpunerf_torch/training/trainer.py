"""Trainer — the eager step loop and the work around it.

The app supplies `loss_fn(views, generator=…)`; each step draws poses,
renders, runs guidance, back-propagates, takes an Adam step and calls the
app's `post_step` (the occupancy refresh). Every random draw comes from one
`torch.Generator` seeded with `optim.seed`; a resumed run restarts it from
the seed, as the JAX package restarts its key (neither keeps it in a
checkpoint). Metric rows (`loss`, `grad_norm`, `steps_per_s`, `rays_per_s`,
the app's scalars, device memory) go to `<exp_dir>/metrics.jsonl` every 50
steps; their rates leave out the time of the checkpoints, evals and images
written in the interval (`aside_s`).

Around the step, as the JAX package's trainer does (`<exp_dir>/` below):

* the eval orbit, under `no_grad`: `log.eval_size` frames into `vis/eval/`
  before the first step and after each checkpoint, in chunks of
  `log.eval_batch` poses (at most the app's `max_eval_batch`); after the
  last step `log.full_eval_size` frames into `results/` (a video where an
  encoder is installed, PNGs otherwise) and the mesh export of
  `log.save_mesh` into `mesh/` (an app that cannot export yet raises
  NotImplementedError, and the export is logged as skipped);
* checkpoints (`training/checkpoints.py`): `checkpoints/step_%06d.ckpt`
  every `log.save_interval` steps, written on a background thread where
  `log.async_ckpt`, the last `log.max_keep_ckpts` kept; `optim.resume`
  loads the newest with the Adam state and continues after its step,
  `optim.ckpt` loads the named file's parameters and buffers only (fresh
  Adam, step 0);
* `log.log_images`: a step writes its render (decoded by the app's
  `preview_latents` where it is latent) to `vis/train/step_%06d.png` with
  probability `log.vis_train_prob`, drawn from
  `numpy.random.default_rng(optim.seed + 1)` as the JAX package draws (so
  on the same steps); PNG where the JAX package writes JPEG, because the
  port writes images with the standard library only;
* `optim.check_nan`: the parameters are copied before each step, and a
  non-finite loss saves the copy as `checkpoints/nan_debug.ckpt` and
  raises FloatingPointError.

Image files are written by a pool of two threads. Every write is joined
before a failure is raised, and the pool is shut down, with the checkpoint
writer joined, at the end of `train()` and of `full_eval()`, and by
`close()`, which a run that raises reaches too. The chunked trainer
(`optim.train_chunk > 1`) and profiler traces (`log.trace_steps`) are
ROADMAP.md item A.4 and text-token optimisation (`optim.use_opt_txt`) item
A.6: a config that asks for one is refused at construction.
"""
from __future__ import annotations

import concurrent.futures
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpunerf_torch.core.config import dump_yaml
from tpunerf_torch.core.views import (ViewSamplerConfig, circle_poses,
                                      rand_poses)
from tpunerf_torch.training.checkpoints import CheckpointManager
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.utils import (MetricsWriter, init_logger, make_generator,
                                 make_path, resolve_device, seed_everything,
                                 tensor2numpy, write_png)

METRIC_INTERVAL = 50


def unported_settings(cfg: TrainConfig, app: Any = None) -> list:
    """The settings of `cfg` that need what the port does not have yet,
    each with the ROADMAP.md item that brings it, and the eval settings
    where the app has no `eval_render`."""
    log, optim = cfg.log, cfg.optim
    no_eval = not hasattr(app, "eval_render")
    asks = {
        "log.trace_steps (profiler traces) comes with ROADMAP.md item A.4":
            log.trace_steps is not None,
        "optim.train_chunk > 1 (the chunked trainer) comes with ROADMAP.md "
        "item A.4": optim.train_chunk > 1,
        "optim.use_opt_txt (text-token optimisation) comes with ROADMAP.md "
        "item A.6": optim.use_opt_txt,
        "log.eval_size != 0 (eval frames) needs an app with an eval_render":
            log.eval_size != 0 and no_eval,
        "log.full_eval_size != 0 (the final eval orbit) needs an app with "
        "an eval_render": log.full_eval_size != 0 and no_eval,
        "log.save_mesh (the mesh export) needs an app with an eval_render":
            log.save_mesh and no_eval,
    }
    return [k for k, v in asks.items() if v]


class Trainer:
    def __init__(self, cfg: TrainConfig, app: Any,
                 device: Optional[torch.device] = None):
        self.device = resolve_device(device)
        missing = unported_settings(cfg, app)
        if missing:
            raise NotImplementedError("not ported yet: " + "; ".join(missing))
        self.cfg = cfg
        self.app = app
        seed_everything(cfg.optim.seed)

        self.exp_dir = make_path(cfg.log.exp_dir)
        self.ckpt_dir = make_path(self.exp_dir / "checkpoints")
        self.train_vis_dir = make_path(self.exp_dir / "vis" / "train")
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

        self.ckpts = CheckpointManager(self.ckpt_dir,
                                       max_keep=cfg.log.max_keep_ckpts)
        # PNG writes overlap the next steps; created at the first write
        self._io_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._io_futures: List[concurrent.futures.Future] = []
        if cfg.optim.resume or cfg.optim.ckpt:
            self._load_checkpoint(cfg.optim.ckpt,
                                  model_only=cfg.optim.ckpt is not None)

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

    def _timed(self, fn: Callable, *args) -> float:
        """Run `fn(*args)` between two device synchronisations; its wall
        seconds."""
        self._sync()
        t0 = time.perf_counter()
        fn(*args)
        self._sync()
        return time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, on_step: Optional[Callable[[int, torch.Tensor], None]]
              = None) -> None:
        """Run to `optim.iters`, then the full eval. `on_step(step, loss)`
        is called after each step (the loss is a device tensor), before
        that step's checkpoint, eval and image: their time falls into the
        next step's interval."""
        cfg = self.cfg
        try:
            self.evaluate(self.train_step_idx, size=cfg.log.eval_size)
            rng = np.random.default_rng(cfg.optim.seed + 1)
            last_time, last_step = time.perf_counter(), self.train_step_idx
            aside = 0.0       # seconds of checkpoints, evals and images
            while self.train_step_idx < cfg.optim.iters:
                # kept so that a non-finite step can save the last good
                # parameters: the step updates them in place
                prev = ({k: v.detach().clone()
                         for k, v in self.app.state_dict().items()}
                        if cfg.optim.check_nan else None)
                loss, aux = self.train_step()
                step = self.train_step_idx
                if cfg.optim.check_nan and not math.isfinite(loss.item()):
                    # under a name outside rolling retention: a poisoned
                    # step_*.ckpt could evict the last good one and then be
                    # what optim.resume loads
                    path, failed = self.ckpts.save_debug("nan_debug",
                                                         step - 1, prev)
                    raise FloatingPointError(
                        f"non-finite loss at step {step} (last-good params "
                        f"saved to {path})") from failed
                if on_step is not None:
                    on_step(step, loss)
                if step % METRIC_INTERVAL == 0:
                    loss_f = loss.item()       # synchronises the device
                    now = time.perf_counter()
                    dt = now - last_time - aside
                    steps = step - last_step
                    self.metrics.write(
                        step, loss=loss_f, grad_norm=self.grad_norm(),
                        steps_per_s=steps / dt,
                        rays_per_s=steps * cfg.render.batch_size
                        * cfg.render.train_grid_size ** 2 / dt,
                        aside_s=aside, **self._app_metric_scalars(),
                        **self._device_memory_scalars())
                    last_time, last_step, aside = now, step, 0.0
                if step % cfg.log.save_interval == 0:
                    aside += self._timed(self.save_checkpoint, True)
                    aside += self._timed(self.evaluate, step,
                                         cfg.log.eval_size)
                if (cfg.log.log_images and "image" in aux
                        and rng.random() < cfg.log.vis_train_prob):
                    aside += self._timed(self._log_train_render, aux)
            self.logger.info("Finished Training ^_^")
            self.logger.info("Evaluating the last model...")
            self.full_eval()
            self.logger.info("\tDone!")
        finally:
            self.close()

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def evaluate(self, step: int, size: int, save_as_video: bool = False,
                 out_dir: Optional[Path] = None) -> List[np.ndarray]:
        """Render and save `size` frames of the eval orbit, in chunks of
        `log.eval_batch` poses, at most the app's `max_eval_batch(dims)`
        (the tail chunk is padded by repeating the last pose, so every
        chunk has one shape). Frames are uint8 by clip-then-truncate; the
        first chunk's decoded texture is saved beside them. The frames'
        PNGs are queued on the image pool (the previous evaluation's are
        joined first). Returns the frames."""
        cfg = self.cfg
        out_dir = out_dir or self.eval_vis_dir
        frames: List[np.ndarray] = []
        if size <= 0:
            return frames
        self._drain_io()
        views = circle_poses(size, self.view_cfg, self.device)
        dims = (cfg.render.eval_grid_size, cfg.render.eval_grid_size)
        chunk = max(1, min(size, cfg.log.eval_batch))
        cap = getattr(self.app, "max_eval_batch", None)
        if cap is not None:
            chunk = max(1, min(chunk, cap(dims)))
        for s in range(0, size, chunk):
            idx = torch.clamp(torch.arange(s, s + chunk, device=self.device),
                              max=size - 1)
            out = self.app.eval_render(views[idx], dims)
            img = (out["image"].clamp(0.0, 1.0) * 255).to(torch.uint8)
            frames.extend(img[:min(chunk, size - s)].cpu().numpy())
            if s == 0 and out.get("texture_map") is not None:
                self._submit(out_dir / f"step_{step:06d}_texture.png",
                             tensor2numpy(out["texture_map"][0]))
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
                self._submit(out_dir / f"step_{step:06d}_{i:03d}_rgb.png", f)
        return frames

    def full_eval(self) -> None:
        """The final orbit into `results/` and the mesh export; then every
        checkpoint and image write is joined (a failure raised) and the
        image pool shut down."""
        cfg = self.cfg
        try:
            self.evaluate(self.train_step_idx, size=cfg.log.full_eval_size,
                          save_as_video=True, out_dir=self.results_dir)
            if cfg.log.save_mesh:
                try:
                    export_dir = make_path(self.exp_dir / "mesh")
                    self.app.export(export_dir)
                    self.logger.info(f"mesh exported to {export_dir}")
                except NotImplementedError as e:
                    self.logger.info(f"mesh export skipped: {e}")
            self.flush()
        finally:
            self.close()

    def flush(self) -> None:
        """Wait for the checkpoint write and every queued image write;
        raise the first failure."""
        self.ckpts.flush()
        self._drain_io()

    def close(self) -> None:
        """Join the checkpoint writer and every image write, shut the image
        pool down; failures are logged, not raised (a run that raises
        reaches this with its own error). Safe to call more than once."""
        failed = self.ckpts.join()
        if failed is not None:
            self.logger.error(f"a checkpoint write failed: {failed!r}")
        if self._io_pool is not None:
            self._io_pool.shutdown(wait=True)
            self._io_pool = None
        futures, self._io_futures = self._io_futures, []
        for f in futures:
            if f.exception() is not None:
                self.logger.error(f"an image write failed: "
                                  f"{f.exception()!r}")

    # ------------------------------------------------------------------ #
    def _submit(self, path: Path, img: np.ndarray) -> None:
        """Queue one PNG write on the image pool (created at the first)."""
        if self._io_pool is None:
            self._io_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="imgio")
        self._io_futures.append(self._io_pool.submit(self._save_image,
                                                     path, img))

    def _drain_io(self) -> None:
        """Wait for every queued image write, then raise the first
        failure."""
        futures, self._io_futures = self._io_futures, []
        concurrent.futures.wait(futures)
        for f in futures:
            if f.exception() is not None:
                raise f.exception()

    def _log_train_render(self, aux: Dict[str, Any]) -> None:
        img = aux["image"]
        if img.shape[-1] == 4:        # latent → preview decode
            img = self.app.preview_latents(img)
        self._submit(self.train_vis_dir / f"step_{self.train_step_idx:06d}"
                     ".png", tensor2numpy(img[0]))

    @staticmethod
    def _save_image(path: Path, img: np.ndarray) -> None:
        write_png(path, img)

    # ------------------------------------------------------------------ #
    def save_checkpoint(self, full: bool = True) -> None:
        """The scene's state (and with `full` the optimizer's) as this
        step's checkpoint; the tensors are copied before this returns."""
        self.ckpts.save(self.train_step_idx, self.app.state_dict(),
                        self.optimizer.state_dict(), full=full,
                        async_write=self.cfg.log.async_ckpt)

    def _load_checkpoint(self, path: Optional[Path], model_only: bool
                         ) -> None:
        """`path` (model only: parameters and buffers) or the newest
        checkpoint (with the optimizer state where it fits, and the step).
        The app's `migrate_params` sees every load."""
        params, opt_state, next_step = self.ckpts.load(
            path, optimizer=None if model_only else self.optimizer)
        if params is None:
            self.logger.info("No checkpoint found, starting from scratch")
            return
        self.app.load_state_dict(self.app.migrate_params(params))
        if not model_only:
            # the loop is increment-then-run: restoring to the SAVED step
            # makes the next executed step `saved + 1`
            self.train_step_idx = next_step - 1
            if opt_state is not None:
                self.optimizer.load_state_dict(opt_state)
        self.logger.info(f"Restored checkpoint (step {next_step - 1}, "
                         f"model_only={model_only})")

    def _app_metric_scalars(self) -> Dict[str, float]:
        hook = getattr(self.app, "metric_scalars", None)
        return hook() if hook is not None else {}

    def _device_memory_scalars(self) -> Dict[str, float]:
        if self.device.type != "cuda":
            return {}
        return {"peak_mem_mb": torch.cuda.max_memory_allocated(self.device)
                / 2 ** 20,
                "mem_mb": torch.cuda.memory_allocated(self.device) / 2 ** 20}
