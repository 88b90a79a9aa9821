"""Trainer — the step loop (eager, or replays of a CUDA graph) and the work
around it.

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
  `log.save_mesh` into `mesh/` (an app with nothing to export, as a
  latent-NeRF field with no surface at the iso level, raises
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
* `optim.check_nan`: the parameters are copied before each step (each
  chunk), and a non-finite loss saves the copy as
  `checkpoints/nan_debug.ckpt` and raises FloatingPointError naming the
  step;
* `optim.train_chunk` k > 1, the chunked trainer: the loop runs chunks of
  min(k, steps to the next `log.save_interval` boundary, steps to
  `optim.iters`) steps, as the JAX package's does, so that checkpoints,
  evals and metric rows land on the same steps as its chunked trainer's;
  metric rows come after the chunk that crosses a multiple of 50, the NaN
  guard reads the chunk's losses at its end, and a train image (drawn once
  a chunk) is the chunk's last step's. On a card one training step
  (poses, render, guidance, backward, Adam) is captured once in a CUDA
  graph after a warm-up, with the trainer's generator registered, and a
  chunk is k replays with no host synchronisation between them, the
  app's `post_step` (the occupancy refresh) running eagerly between
  replays; a card that cannot capture raises, the trainer never falls
  back to eager steps there. An app whose loss branches on a draw (its
  `branches()`: Paint-by-Example's CLIP branch at low t) gives that draw
  through its `draw_branch` hook: the poses and it are a small graph of
  their own, the step one graph a branch, and a replay reads the branch
  flag between the two (one read from the device a step). On the CPU a
  chunk is k eager steps;
* `log.trace_steps` [a, b): a `torch.profiler` trace of those steps into
  `<exp_dir>/trace/trace.json`, started and stopped at chunk granularity
  in a chunked run, and stopped as well at the end of the run (an upper
  bound past `optim.iters`) and when a step raises;
* a process group (`dist.mesh.initialize`, torchrun): the (data, rays) mesh
  of `cfg.dist` over its ranks, as the JAX package's trainer builds it over
  its devices. Rank 0's parameters and buffers are broadcast, the app is
  wired to the mesh (`set_layout`: each rank takes its slice of the global
  draws), and each step sums the gradients and the loss over the world
  (`all_reduce_grads`) before Adam, in a captured step too (NCCL only: a
  CUDA graph cannot capture gloo's collectives). A mesh that does not tile
  the world, or a data axis that does not divide `render.batch_size`, logs
  the JAX package's warning and every rank runs the whole batch. Only rank
  0 writes files (checkpoints, metric rows, images, evals, the orbit, the
  export, the trace); the others wait at a barrier where it writes. A
  resume reads after a barrier and broadcasts rank 0's state again.

On a card Adam is `capturable` (its step count a device tensor), in eager
steps too, so that an eager and a replayed step compute alike.

Image files are written by a pool of two threads. Every write is joined
before a failure is raised, and the pool is shut down, with the checkpoint
writer joined, at the end of `train()` and of `full_eval()`, and by
`close()`, which a run that raises reaches too. `optim.use_opt_txt` is
refused at construction (the JAX package's trainer never reads it;
text-token optimisation is the function
`training.text_token_opt.optimize_text_token`).
"""
from __future__ import annotations

import concurrent.futures
import logging
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from tpunerf_torch import profiling
from tpunerf_torch.core.config import dump_yaml
from tpunerf_torch.core.views import (ViewSamplerConfig, circle_poses,
                                      rand_poses)
from tpunerf_torch.dist import mesh as dist_mesh
from tpunerf_torch.kernels import _build
from tpunerf_torch.training.checkpoints import CheckpointManager
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.utils import (MetricsWriter, init_logger, make_generator,
                                 make_path, resolve_device, seed_everything,
                                 tensor2numpy, write_png)

METRIC_INTERVAL = 50


def unported_settings(cfg: TrainConfig, app: Any = None) -> list:
    """The settings of `cfg` that the port does not run: `optim.use_opt_txt`,
    and the eval settings where the app has no `eval_render`."""
    log, optim = cfg.log, cfg.optim
    no_eval = not hasattr(app, "eval_render")
    asks = {
        "optim.use_opt_txt: the JAX package's trainer never reads this "
        "flag, so no trainer step optimises text tokens; call "
        "tpunerf_torch.training.text_token_opt.optimize_text_token "
        "instead": optim.use_opt_txt,
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

        # only rank 0 (or a process without a process group) writes files
        self.is_main = dist_mesh.is_main_process()
        self.exp_dir = Path(cfg.log.exp_dir)
        self.ckpt_dir = self.exp_dir / "checkpoints"
        self.train_vis_dir = self.exp_dir / "vis" / "train"
        self.eval_vis_dir = self.exp_dir / "vis" / "eval"
        self.results_dir = self.exp_dir / "results"
        self.metrics: Optional[MetricsWriter] = None
        if self.is_main:
            for d in (self.ckpt_dir, self.train_vis_dir, self.eval_vis_dir,
                      self.results_dir):
                make_path(d)
            self.logger = init_logger(self.exp_dir)
            self.metrics = MetricsWriter(self.exp_dir / "metrics.jsonl")
            dump_yaml(cfg, self.exp_dir / "config.yaml")
        else:
            self.logger = init_logger(None)
            self.logger.setLevel(logging.WARNING)

        self.view_cfg = self.view_config(cfg)

        self.generator = make_generator(cfg.optim.seed, self.device)
        app.init_params(self.generator)
        self.optimizer = app.make_optimizer()
        self.params = [p for g in self.optimizer.param_groups
                       for p in g["params"]]
        self._set_capturable()
        n_params = sum(p.numel() for p in self.params)
        self.logger.info(f"Scene has {n_params} learnable parameters")
        self.train_step_idx = 0
        self.layout = self._make_layout(cfg)

        self.ckpts = CheckpointManager(self.ckpt_dir,
                                       max_keep=cfg.log.max_keep_ckpts)
        # PNG writes overlap the next steps; created at the first write
        self._io_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._io_futures: List[concurrent.futures.Future] = []
        self.graph: Optional[GraphedStep] = None
        self._trace: Optional[torch.profiler.profile] = None
        if cfg.optim.resume or cfg.optim.ckpt:
            self._load_checkpoint(cfg.optim.ckpt,
                                  model_only=cfg.optim.ckpt is not None)

    def _make_layout(self, cfg: TrainConfig
                     ) -> Optional[dist_mesh.MeshLayout]:
        """The mesh of `cfg.dist` over the process group's ranks (←
        trainer.py:106-138): `dist.rays_axis` ranks on rays, the rest (or
        `dist.data_axis`) on data; rank 0's state broadcast and the app
        wired to it. None without a process group, or, with the JAX
        package's warning, where the mesh does not tile the ranks or its
        data axis does not divide the batch."""
        if not dist_mesh.initialized():
            return None
        n_dev = dist_mesh.world_size()
        n_rays = max(1, cfg.dist.rays_axis)
        n_data = (n_dev // n_rays if cfg.dist.data_axis == -1
                  else cfg.dist.data_axis)
        if n_data * n_rays != n_dev:
            self.logger.warning(
                f"dist mesh ({n_data}×{n_rays}) does not tile the {n_dev} "
                f"ranks — running SINGLE-device (every rank the whole "
                f"batch); set dist.data_axis/dist.rays_axis to factor "
                f"{n_dev}")
            return None
        if cfg.render.batch_size % n_data != 0:
            self.logger.warning(
                f"batch_size {cfg.render.batch_size} not divisible by the "
                f"data axis ({n_data}) — running SINGLE-device (every rank "
                f"the whole batch); set render.batch_size to a multiple of "
                f"{n_data} to enable the {n_dev}-rank mesh")
            return None
        layout = dist_mesh.make_mesh(n_data=n_data, n_rays=n_rays)
        self.replicate()
        if hasattr(self.app, "set_layout"):
            self.app.set_layout(layout)
        self.logger.info(f"device mesh: data={n_data} × rays={n_rays} "
                         f"(batch {cfg.render.batch_size})")
        return layout

    def replicate(self) -> None:
        """Rank 0's parameters, buffers and Adam state on every rank."""
        dist_mesh.replicate_(dist_mesh.state_tensors(self.app.state_dict(),
                                                     self.optimizer))

    @staticmethod
    def view_config(cfg: TrainConfig) -> ViewSamplerConfig:
        return ViewSamplerConfig(
            radius_range=cfg.render.radius_range,
            theta_range=cfg.render.theta_range,
            phi_range=cfg.render.phi_range,
            angle_overhead=cfg.render.angle_overhead,
            angle_front=cfg.render.angle_front,
            body_prob=cfg.render.body_prob)

    def _set_capturable(self) -> None:
        """Adam capturable on a card (the graph needs it; eager steps take
        the same arithmetic), not on the CPU (where PyTorch refuses it); a
        loaded state's step counts moved where that puts them."""
        on = self.device.type == "cuda"
        self.optimizer.defaults["capturable"] = on
        for group in self.optimizer.param_groups:
            group["capturable"] = on
        for p, state in self.optimizer.state.items():
            step = state.get("step")
            if torch.is_tensor(step):
                state["step"] = step.to(p.device if on else "cpu",
                                        torch.float32)

    # ------------------------------------------------------------------ #
    def branches(self) -> bool:
        """Whether the app's loss branches on a draw (its `branches()`)."""
        hook = getattr(self.app, "branches", None)
        return hook is not None and hook()

    def draw(self) -> Tuple[Any, Dict[str, torch.Tensor],
                            Optional[torch.Tensor]]:
        """The step's leading draws: the poses and, where the app's loss
        branches on a draw, that draw (`app.draw_branch`) and the branch
        flag, a bool on the device (else {} and None)."""
        views = rand_poses(self.cfg.render.batch_size, self.view_cfg,
                           self.device, generator=self.generator)
        if not self.branches():
            return views, {}, None
        lead, flag = self.app.draw_branch(self.generator)
        return views, lead, flag

    def step_body(self, drawn: Optional[Tuple] = None,
                  branch: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """A step as a CUDA graph captures it: poses → loss → backward →
        Adam. The gradients must be unset (`zero_grad(set_to_none=True)`)
        before. `drawn` is `draw()`'s result (drawn here where not given);
        where the app branches, `branch` is the branch its flag names (read
        here from the flag where not given). On a mesh the gradients and the
        loss are summed over the world before Adam. Returns the loss (the
        world's) and the app's aux (this rank's), as device tensors."""
        views, lead, flag = self.draw() if drawn is None else drawn
        kwargs: Dict[str, Any] = {}
        if flag is not None:
            kwargs = dict(draws=lead,
                          branch=bool(flag) if branch is None else branch)
        loss, aux = self.app.loss_fn(views, generator=self.generator,
                                     **kwargs)
        loss.backward()
        loss = loss.detach()
        if self.layout is not None:
            (loss,) = dist_mesh.all_reduce_grads(self.params, loss)
        self.optimizer.step()
        return loss, aux

    def post_step(self) -> None:
        """The app's post-step hook (the occupancy refresh) after step
        `train_step_idx`."""
        post = getattr(self.app, "post_step", None)
        if post is not None:
            post(self.train_step_idx, generator=self.generator)

    def train_step(self) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One eager step: poses → loss → backward → Adam → post-step
        hook."""
        self.train_step_idx += 1
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.step_body()
        self.post_step()
        return loss, aux

    def snapshot(self) -> Dict[str, Any]:
        """Copies of what a step and its post-step hook change: the app's
        parameters and buffers, Adam's state and the generator's state."""
        return {"app": {n: v.detach().clone()
                        for n, v in self.app.state_dict().items()},
                "adam": {p: {n: v.clone() for n, v in st.items()
                             if torch.is_tensor(v)}
                         for p, st in self.optimizer.state.items()},
                "generator": self.generator.get_state()}

    @torch.no_grad()
    def restore(self, snap: Dict[str, Any]) -> None:
        """Put a `snapshot` back in place (a captured graph reads these
        storages). Adam state made since the snapshot is zeroed, which is
        the state a fresh Adam starts a parameter with."""
        for n, v in self.app.state_dict().items():
            v.copy_(snap["app"][n])
        for p, st in self.optimizer.state.items():
            old = snap["adam"].get(p, {})
            for n, v in st.items():
                if torch.is_tensor(v):
                    if n in old:
                        v.copy_(old[n])
                    else:
                        v.zero_()
        self.generator.set_state(snap["generator"])

    def grad_norm(self) -> torch.Tensor:
        """The global norm of the gradients the parameters hold (the last
        eager step's), a device tensor."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            return torch.zeros((), device=self.device)
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))

    def graphed(self) -> bool:
        """Whether chunks replay a CUDA graph: on a card with
        `optim.train_chunk > 1`."""
        return self.device.type == "cuda" and self.cfg.optim.train_chunk > 1

    def capture(self) -> "GraphedStep":
        """The captured step (captured at the first call). On a mesh the
        process group must be NCCL's: a CUDA graph cannot capture gloo's
        collectives (they run on the host)."""
        if self.graph is None:
            if (self.layout is not None
                    and dist_mesh.dist.get_backend() != "nccl"):
                raise RuntimeError(
                    f"optim.train_chunk > 1 on a card with the "
                    f"{dist_mesh.dist.get_backend()} backend: a CUDA graph "
                    f"captures only NCCL's collectives; use the nccl "
                    f"backend or --optim.train_chunk 1")
            self.graph = GraphedStep(self)
        return self.graph

    def run_chunk(self, k: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Steps `train_step_idx + 1 … + k`: k replays of the captured step
        where `graphed()`, else k eager steps, the post-step hook after
        each. Returns the k losses (a device tensor) and the last step's
        aux, cloned out of the graph's static output."""
        losses = torch.empty(k, device=self.device)
        if self.graphed():
            graph = self.capture()
            replays: Dict[Optional[bool], int] = {}
            for i in range(k):
                self.train_step_idx += 1
                branch = graph.replay()
                replays[branch] = replays.get(branch, 0) + 1
                losses[i].copy_(graph.loss)
                self.post_step()
            graph.count_launches(replays)
            aux = {n: v.clone() if torch.is_tensor(v) else v
                   for n, v in graph.aux.items()}
            return losses, aux
        aux: Dict[str, Any] = {}
        for i in range(k):
            loss, aux = self.train_step()
            losses[i].copy_(loss)
        return losses, aux

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

    def _chunk_len(self) -> int:
        """The next chunk's steps: `optim.train_chunk`, clipped at the next
        `log.save_interval` boundary and at `optim.iters`."""
        cfg, step = self.cfg, self.train_step_idx
        boundary = (step // cfg.log.save_interval + 1) * cfg.log.save_interval
        return max(1, min(cfg.optim.train_chunk, cfg.optim.iters - step,
                          boundary - step))

    def _start_trace(self, k: int) -> None:
        """Open the `log.trace_steps` window [a, b) before the chunk that
        holds step a."""
        ts = self.cfg.log.trace_steps
        if (ts and self._trace is None and self.is_main
                and self.train_step_idx < ts[0] <= self.train_step_idx + k):
            self._trace = profiling.start_trace()

    def _stop_trace(self, end: bool = False) -> None:
        """Close the window once the next step is b (eager) or after the
        chunk that reaches b (chunked), or with `end`."""
        ts = self.cfg.log.trace_steps
        if self._trace is None:
            return
        last = self.train_step_idx + (self.cfg.optim.train_chunk <= 1)
        if end or last >= ts[1]:
            prof, self._trace = self._trace, None
            path = profiling.stop_trace(prof, self.exp_dir / "trace")
            self.logger.info(f"profiler trace written to {path}")

    def train(self, on_step: Optional[Callable[[int, torch.Tensor], None]]
              = None) -> None:
        """Run to `optim.iters` in chunks (of one step unless
        `optim.train_chunk` > 1), then the full eval. `on_step(step, loss)`
        is called after each step (the loss is a device tensor; in a
        chunked run after the chunk), before that step's checkpoint, eval
        and image: their time falls into the next step's interval."""
        cfg = self.cfg
        try:
            self.evaluate(self.train_step_idx, size=cfg.log.eval_size)
            dist_mesh.barrier()
            if self.graphed():
                self.capture()
            rng = np.random.default_rng(cfg.optim.seed + 1)
            last_time, last_step = time.perf_counter(), self.train_step_idx
            aside = 0.0       # seconds of checkpoints, evals and images
            while self.train_step_idx < cfg.optim.iters:
                k = self._chunk_len()
                self._start_trace(k)
                step0 = self.train_step_idx
                # kept so that a non-finite step can save the parameters of
                # the chunk's start: the steps update them in place
                prev = ({n: v.detach().clone()
                         for n, v in self.app.state_dict().items()}
                        if cfg.optim.check_nan else None)
                losses, aux = self.run_chunk(k)
                step = self.train_step_idx
                self._stop_trace()
                if cfg.optim.check_nan:
                    self._nan_guard(losses, step0, prev)
                if on_step is not None:
                    for i in range(k):
                        on_step(step0 + i + 1, losses[i])
                if step // METRIC_INTERVAL > step0 // METRIC_INTERVAL:
                    loss_f = losses[-1].item()   # synchronises the device
                    # the last step's: each replay computes it, an eager
                    # step's is computed here from the gradients it left
                    gnorm = (self.graph.grad_norm if self.graphed()
                             else self.grad_norm())
                    now = time.perf_counter()
                    dt = now - last_time - aside
                    steps = step - last_step
                    if self.metrics is not None:     # rank 0's rows
                        self.metrics.write(
                            step, loss=loss_f, grad_norm=gnorm.item(),
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
                    dist_mesh.barrier()
                if (cfg.log.log_images and "image" in aux
                        and rng.random() < cfg.log.vis_train_prob
                        and self.is_main):
                    aside += self._timed(self._log_train_render, aux)
            self._stop_trace(end=True)
            self.logger.info("Finished Training ^_^")
            self.logger.info("Evaluating the last model...")
            self.full_eval()
            self.logger.info("\tDone!")
        finally:
            self._stop_trace(end=True)
            self.close()

    def _nan_guard(self, losses: torch.Tensor, step0: int,
                   prev: Dict[str, torch.Tensor]) -> None:
        """Raise FloatingPointError at the chunk's first non-finite loss,
        after saving `prev` (the parameters before step `step0 + 1`) as
        `nan_debug`, under a name outside rolling retention: a poisoned
        step_*.ckpt could evict the last good one and then be what
        optim.resume loads."""
        finite = torch.isfinite(losses).cpu()
        if bool(finite.all()):
            return
        bad = step0 + 1 + int(torch.argmin(finite.to(torch.int8)))
        # the losses are the world's: every rank raises here, rank 0 saves
        path, failed = self.ckpts.save_debug(
            "nan_debug", step0, prev, is_main_process=self.is_main)
        if len(losses) == 1:
            msg = f"last-good params saved to {path}"
        else:
            msg = (f"chunk-start params saved to {path}; rerun with "
                   f"--optim.train_chunk 1 to localize with step-granular "
                   f"last-good params")
        raise FloatingPointError(
            f"non-finite loss at step {bad} ({msg})") from failed

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
        joined first). Returns the frames. Rank 0 alone renders and writes
        (other ranks return no frame)."""
        cfg = self.cfg
        out_dir = out_dir or self.eval_vis_dir
        frames: List[np.ndarray] = []
        if size <= 0 or not self.is_main:
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
            if cfg.log.save_mesh and self.is_main:
                try:
                    export_dir = make_path(self.exp_dir / "mesh")
                    self.app.export(export_dir)
                    self.logger.info(f"mesh exported to {export_dir}")
                except NotImplementedError as e:
                    self.logger.info(f"mesh export skipped: {e}")
            self.flush()
            dist_mesh.barrier()
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
                        async_write=self.cfg.log.async_ckpt,
                        is_main_process=self.is_main)

    def _load_checkpoint(self, path: Optional[Path], model_only: bool
                         ) -> None:
        """`path` (model only: parameters and buffers) or the newest
        checkpoint (with the optimizer state where it fits, and the step).
        The app's `migrate_params` sees every load. On a mesh every rank
        reads after a barrier, then rank 0's state is broadcast again (←
        trainer.py:635-646)."""
        dist_mesh.barrier()
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
                self._set_capturable()
        if self.layout is not None:
            self.replicate()
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


class _Captured:
    """One captured step graph and its static outputs: the loss, the app's
    aux, the gradients' global norm, the gradients, and the repo's kernels
    one replay launches."""

    def __init__(self, trainer: "Trainer", body: Callable, pool=None):
        trainer.optimizer.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(trainer.generator)
        before = dict(_build.CAPTURED)
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode="thread_local"):
            self.out = body()
        # the static gradients: an eager step between replays unsets the
        # parameters' .grad, the graph goes on writing these
        self.grads = [p.grad for p in trainer.params]
        self.launches = {n: c - before.get(n, 0)
                         for n, c in _build.CAPTURED.items()
                         if c > before.get(n, 0)}


class GraphedStep:
    """One training step of a trainer (`Trainer.step_body`: poses, render,
    guidance, backward, Adam) captured in a CUDA graph.

    Whole-network capture as PyTorch's recipe has it: one warm-up step on a
    side stream (lazy state: Adam's moments, cuBLAS and cuDNN handles, the
    kernels' occupancy queries), undone in place afterwards, so that
    capturing changes no state and draws nothing; the gradients unset, so
    that the captured backward writes them into the graph's own memory;
    then the capture, with the trainer's generator registered, so that each
    replay draws from the generator's offset at that moment and moves it on
    as an eager step would. Everything the graph reads (parameters, Adam's
    state, the occupancy buffers, the text embeddings) must only be updated
    in place from then on. `loss`, `grad_norm` (the gradients' global
    norm, which only the graph computes every step) and `aux` are the step's
    static outputs, which the next replay overwrites. `launches` counts the
    repo's kernels one replay runs (`_build.CAPTURED` during the capture):
    `count_launches` adds the replays' worth to `_build.LAUNCHES`.

    Where the app's loss branches on a draw (`Trainer.branches`), the
    step's leading draws (`Trainer.draw`: the poses, the draw and its flag)
    are a graph of their own, `draw_graph`, whose static outputs the step
    graphs read, and there is a step graph for each branch, warmed up and
    captured from the same state (each in its own memory). `replay` replays
    the draw graph, reads the flag (one read from the device) and replays
    that branch's step graph; the static outputs and `launches` are then
    the last replayed branch's (`branch`), and `launches_by_branch` holds
    each branch's."""

    def __init__(self, trainer: "Trainer"):
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} cannot register a generator "
                f"with a CUDA graph (CUDAGraph.register_generator_state), "
                f"which optim.train_chunk > 1 needs on a card: run with "
                f"--optim.train_chunk 1")
        dev, opt = trainer.device, trainer.optimizer
        branches = (False, True) if trainer.branches() else (None,)
        saved = trainer.snapshot()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for branch in branches:
                opt.zero_grad(set_to_none=True)
                trainer.step_body(branch=branch)
                trainer.grad_norm()
                trainer.restore(saved)
        torch.cuda.current_stream(dev).wait_stream(side)
        del saved
        self.draw_graph: Optional[torch.cuda.CUDAGraph] = None
        self.flag: Optional[torch.Tensor] = None
        drawn = None
        if branches != (None,):
            self.draw_graph = torch.cuda.CUDAGraph()
            self.draw_graph.register_generator_state(trainer.generator)
            with torch.cuda.graph(self.draw_graph,
                                  capture_error_mode="thread_local"):
                drawn = trainer.draw()
            self.flag = drawn[2]

        def body(branch):
            def run():
                loss, aux = trainer.step_body(drawn, branch)
                return loss, aux, trainer.grad_norm()
            return run

        self.steps = {b: _Captured(trainer, body(b)) for b in branches}
        self.launches_by_branch = {b: c.launches
                                   for b, c in self.steps.items()}
        self.branch: Optional[bool] = branches[0]

    @property
    def _last(self) -> _Captured:
        return self.steps[self.branch]

    @property
    def loss(self) -> torch.Tensor:
        return self._last.out[0]

    @property
    def aux(self) -> Dict[str, Any]:
        return self._last.out[1]

    @property
    def grad_norm(self) -> torch.Tensor:
        return self._last.out[2]

    @property
    def grads(self) -> List[Optional[torch.Tensor]]:
        return self._last.grads

    @property
    def launches(self) -> Dict[str, int]:
        return self._last.launches

    def replay(self) -> Optional[bool]:
        """One step: the step graph (after the draw graph and the read of
        its flag, where the step branches). Returns the branch replayed
        (None where the step does not branch)."""
        if self.draw_graph is not None:
            self.draw_graph.replay()
            self.branch = bool(self.flag)
        self._last.graph.replay()
        return self.branch

    def count_launches(self, replays: Mapping[Optional[bool], int]) -> None:
        """Add the launches of `replays` (replays by branch) to
        `_build.LAUNCHES`."""
        for branch, k in replays.items():
            for name, n in self.launches_by_branch[branch].items():
                _build.count_launch(name, n * k)
