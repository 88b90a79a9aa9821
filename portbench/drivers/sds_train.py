"""SDS training of tpunerf_torch, as its users run it with
`--optim.train_chunk k`: the app's step captured in one CUDA graph
(`Trainer.capture`, `GraphedStep`), chunks of k replays through
`Trainer.run_chunk` with the app's eager post-step refresh between them.

Set-up builds the guidance stack from the cell's weights (made from the
seed on the device, `portbench.weights`), the app and its trainer, puts
the cell's weights into the trainable parameters, seeds the trainer's
generator from the seed, captures the step and runs its first steps
through `run_chunk` (1, then 2): what they read is what the reference
follows. The window then runs chunks of k.

A planted fault (`FAULTS`) breaks the program under the harness, for the
tests and for the readings that set the limits.
"""
from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench import weights

FAULTS = ("unchanged", "half_batch", "altered")
BETA1 = 0.9


def _tuple(v):
    return tuple(v) if isinstance(v, list) else v


def build_guidance(cfg: dict, seed: int, device, latent_mode: bool):
    """The program's SD-v1 stack with the cell's weights: the UNet, the
    text tower and the VAE built without storage, then given the drawn
    weights in the dtypes the configuration serves them in."""
    from tpunerf_torch.guidance import vae as vae_lib
    from tpunerf_torch.guidance.clip_text import (CLIPTextConfig,
                                                  CLIPTextModel,
                                                  make_tokenizer)
    from tpunerf_torch.guidance.schedulers import NoiseSchedule
    from tpunerf_torch.guidance.stable_diffusion import \
        StableDiffusionGuidance
    from tpunerf_torch.guidance.unet import UNet2DCondition, UNetConfig
    dtypes = cfg["dtypes"]
    parts = {}
    for stream, cls, conf in (
            ("unet", UNet2DCondition, UNetConfig(
                **{k: _tuple(v) for k, v in cfg["unet"].items()})),
            ("clip", CLIPTextModel, CLIPTextConfig(**cfg["clip"])),
            ("vae", vae_lib.AutoencoderKL, vae_lib.VAEConfig(
                **{k: _tuple(v) for k, v in cfg["vae"].items()}))):
        with torch.device("meta"):
            module = cls(conf)
        drawn = weights.draw(weights.named_shapes(module), seed, stream,
                             getattr(torch, dtypes[stream]), device)
        parts[stream] = weights.install(module, drawn).eval()
    sched = NoiseSchedule.scaled_linear(device=device)
    return StableDiffusionGuidance(
        unet=parts["unet"], vae=parts["vae"], text_encoder=parts["clip"],
        tokenizer=make_tokenizer(None, vocab_size=cfg["clip"]["vocab_size"],
                                 max_length=cfg["clip"]["max_length"]),
        sched=sched, latent_mode=latent_mode, min_step=cfg["min_step"],
        max_step=cfg["max_step"], latent_size=cfg["latent_size"],
        image_size=cfg["image_size"])


def resolve(cfg: dict, work: dict) -> dict:
    """The configuration as the cell runs it: the field's channels (3 in
    the RGB refine, else 4) and the scene's sizes that the traffic sets."""
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in cfg.items()}
    if work["app"] == "latent_nerf":
        out["field"]["out_channels"] = 3 if work["nerf_type"] == "rgb" else 4
        S = work["num_samples"]
        out["scene"].update(train_grid_size=work["train_grid_size"],
                            num_samples=S, num_compacted=max(S // 2, 8))
    else:
        out["scene"]["train_grid_size"] = work["train_grid_size"]
    return out


def train_argv(cfg: dict, work: dict, exp_root: Path) -> List[str]:
    """The command-line settings of the cell, as a user passes them."""
    view = work["view"]
    argv = ["--render.train_grid_size", str(work["train_grid_size"]),
            "--render.batch_size", str(work["batch_size"]),
            "--render.radius_range", ",".join(map(str, view["radius_range"])),
            "--render.theta_range", ",".join(map(str, view["theta_range"])),
            "--render.phi_range", ",".join(map(str, view["phi_range"])),
            "--render.angle_overhead", str(view["angle_overhead"]),
            "--render.angle_front", str(view["angle_front"]),
            "--render.body_prob", str(view["body_prob"]),
            "--guide.text", work["text"],
            "--guide.guidance_scale", str(work["guidance_scale"]),
            "--guide.tiny_diffusion", str(cfg.get("tiny", False)).lower(),
            "--optim.lr", str(work["lr"]),
            "--optim.train_chunk", str(work["chunk"]),
            "--optim.iters", str(1 << 30),
            "--optim.seed", "0",
            "--log.exp_root", str(exp_root), "--log.exp_name", "cell",
            "--log.eval_size", "0", "--log.full_eval_size", "0",
            "--log.log_images", "false", "--log.save_mesh", "false"]
    if work["app"] == "latent_nerf":
        argv += ["--render.backbone", "latent-nerf",
                 "--render.nerf_type", work["nerf_type"],
                 "--render.num_samples_per_ray", str(work["num_samples"]),
                 "--optim.lambda_sparsity", str(work["lambda_sparsity"])]
    else:
        argv += ["--optim.mode", str(work["mode"]),
                 "--guide.shape_path", work["shape"],
                 "--guide.texture_resolution",
                 str(cfg["scene"]["texture_resolution"]),
                 "--optim.disp_lr", str(work["disp_lr"]),
                 "--optim.lambda_laplacian", str(work["lambda_laplacian"]),
                 "--optim.lambda_displacement",
                 str(work["lambda_displacement"])]
    return argv


class Program:
    """One set-up of the program for a cell and a seed: the trainer, its
    captured step and the readings of its first steps."""

    def __init__(self, cfg: dict, work: dict, seed: int, device,
                 fault: Optional[str] = None):
        """`cfg` is the configuration as `resolve` gives it."""
        from tpunerf_torch.core.config import parse
        from tpunerf_torch.training.config import TrainConfig
        from tpunerf_torch.training.trainer import Trainer
        self.cfg, self.work, self.device = cfg, work, torch.device(device)
        self._pending: List[torch.Tensor] = []
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench_")
        tc = parse(TrainConfig, train_argv(cfg, work, Path(self._tmp.name)))
        nerf = work["app"] == "latent_nerf"
        latent = work["nerf_type"] == "latent" if nerf else work["mode"] == 0
        self.guidance = build_guidance(cfg, seed, self.device, latent)
        if nerf:
            from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
            self.app = LatentNeRFApp.create(tc, guidance=self.guidance,
                                            device=self.device)
            self.model = self.app.scene.field
        else:
            from tpunerf_torch.training.latent_paint_mesh import \
                LatentPaintMeshApp
            self.app = LatentPaintMeshApp.create(tc, guidance=self.guidance,
                                                 device=self.device)
            self.model = self.app.scene
        self.trainer = Trainer(tc, self.app, device=self.device)
        self._check_shapes()
        self.params = self._trainable()
        init = scene_init(cfg, work, seed, self.device,
                          weights.named_shapes_of(self.params))
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(init[name])
        self.trainer.generator.manual_seed(weights.stream_seed(seed, "draws"))
        if fault is not None:
            plant(self, fault)
        if self.trainer.graphed():
            self.trainer.capture()

    def _trainable(self) -> Dict[str, torch.nn.Parameter]:
        """The parameters Adam updates, by their names in the model."""
        owned = {id(p) for g in self.trainer.optimizer.param_groups
                 for p in g["params"]}
        return {n: p for n, p in self.model.named_parameters()
                if id(p) in owned}

    def _check_shapes(self) -> None:
        """Raise where the program's model differs from the
        configuration file (which the reference and the counts read)."""
        if self.work["app"] == "latent_nerf":
            s = self.app.scene
            f = s.field.config
            want = self.cfg["field"]
            got = {"grid": dataclasses.asdict(f.grid),
                   **{k: getattr(f, k) for k in want if k != "grid"}}
            scene = {"train_grid_size": s.train_grid_size,
                     "num_samples": s.march.num_samples,
                     "num_compacted": s.march.num_compacted,
                     "bound": s.march.bound,
                     "occupancy_resolution": s.occ_cfg.resolution,
                     "occupancy_decay": s.occ_cfg.ema_decay,
                     "density_threshold": s.occ_cfg.density_threshold,
                     "occupancy_interval": s.occ_update_interval,
                     "dy": s.dy}
            wscene = {k: self.cfg["scene"][k] for k in scene}
            mlp = getattr(torch, self.cfg["dtypes"]["field_mlp"])
            if (got != want or scene != wscene
                    or s.field.sigma_mlp.dtype != mlp):
                raise ValueError(f"the program's field {got} / scene {scene} "
                                 f"/ MLP dtype {s.field.sigma_mlp.dtype} is "
                                 f"not the configuration's {want} / {wscene} "
                                 f"/ {mlp}")
        else:
            s = self.app.scene
            scene = {"texture_resolution": s.texture_resolution,
                     "soft_mask_sigma": s.soft_mask_sigma,
                     "mesh_faces": s.mesh.num_faces,
                     "dome_faces": s.env_sphere.num_faces,
                     "train_grid_size": s.render_grid_size}
            wscene = {k: self.cfg["scene"][k] for k in scene}
            if scene != wscene:
                raise ValueError(f"the program's scene {scene} is not the "
                                 f"configuration's {wscene}")

    # ------------------------------------------------------------------ #
    def first_steps(self) -> dict:
        """Steps 1, then 2 and 3, through the window's own call: the
        losses, the first gradient (from Adam's first moment after step
        1: m₁ = (1 − β₁)·g₁) and the parameters before and after."""
        tr = self.trainer
        start = {n: p.detach().float().cpu().clone()
                 for n, p in self.params.items()}
        losses = [tr.run_chunk(1)[0]]
        first = {}
        for n, p in self.params.items():
            m = tr.optimizer.state.get(p, {}).get("exp_avg")
            first[n] = (torch.zeros_like(p) if m is None
                        else m / (1 - BETA1)).detach().float().cpu().clone()
        losses.append(tr.run_chunk(2)[0])
        end = {n: p.detach().float().cpu().clone()
               for n, p in self.params.items()}
        return {"losses": [float(v) for v in torch.cat(losses).cpu()],
                "first_grad": first, "start": start, "end": end}

    def chunk(self) -> int:
        """One chunk of the window. Its losses are read back (a non-finite
        one raises) where the steps cross a multiple of the trainer's
        metric interval, as `Trainer.train` reads a loss for its metric
        row, and by `read_back`. Returns its steps."""
        from tpunerf_torch.training.trainer import METRIC_INTERVAL
        tr = self.trainer
        before = tr.train_step_idx
        losses, _ = tr.run_chunk(self.work["chunk"])
        self._pending.append(losses)
        if tr.train_step_idx // METRIC_INTERVAL > before // METRIC_INTERVAL:
            self.read_back()
        return len(losses)

    def read_back(self) -> None:
        """Read the chunks' losses back (this waits for the device)."""
        pending, self._pending = self._pending, []
        if pending and not bool(torch.isfinite(torch.cat(pending)).all()):
            raise FloatingPointError(
                f"non-finite loss by step {self.trainer.train_step_idx}")

    def close(self) -> None:
        self.trainer.close()
        self._tmp.cleanup()

    # ------------------------------------------------------------------ #
    def parts(self) -> Dict[str, Callable]:
        """The step's layers and kernel entries alone, each a call that a
        CUDA graph can capture, on inputs shaped as the window's."""
        from portbench.drivers import parts
        return parts.of(self)


def scene_init(cfg: dict, work: dict, seed: int, device,
               shapes) -> Dict[str, torch.Tensor]:
    """The cell's starting trainable parameters, from the seed: the field's
    (`weights.draw`), or the painted mesh's (`mesh_init`)."""
    if work["app"] == "latent_nerf":
        return weights.draw(shapes, seed, "field", torch.float32, device)
    return weights.mesh_init(shapes, seed, device)


def plant(program: Program, fault: str) -> None:
    """Break the program under the harness: "unchanged", Adam's step does
    nothing; "half_batch", the guidance term sees only the upper half of
    the rendered rows, doubled (the rest left out, the mean over what is
    left); "altered", the UNet's ε̂ comes out with two channels swapped."""
    g = program.guidance
    if fault == "unchanged":
        program.trainer.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":
        real = g.train_step_loss

        def half(text_z, inputs, *args, **kwargs):
            h = inputs.shape[1] // 2
            kept = torch.cat([inputs[:, :h] * 2.0 - inputs[:, :h].detach(),
                              inputs[:, h:].detach()], dim=1)
            return real(text_z, kept, *args, **kwargs)

        g.train_step_loss = half
    elif fault == "altered":
        real_unet = g.unet_apply

        def swapped(latents, t, context):
            eps = real_unet(latents, t, context)
            return eps.roll(1, dims=-1)

        g.unet_apply = swapped
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
