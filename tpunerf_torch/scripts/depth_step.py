"""Config #5's training step at the tiny size, on the CPU and on another
device from one state.

`tiny_depth_steps` builds the tiny depth-conditioned stack and the
latent-paint-mesh app of `nascar_depth.yaml` (sphere, 24² train grid, 32²
texture, B = 2 views: one body and one head camera, mode 0, f32) on both
devices with the same weights, scene and draws, and takes one loss and its
gradients on each. `chip_smoke.py` and the card tests hold a card's step
against the CPU's with it; the trainer does not use it.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from tpunerf_torch.core.config import parse
from tpunerf_torch.core.views import ViewBatch
from tpunerf_torch.guidance.depth import (StableDiffusionDepthGuidance,
                                          normalize_depth)
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp

NASCAR_DEPTH = (Path(__file__).resolve().parents[2] / "demo_configs"
                / "latent_paint_mesh" / "nascar_depth.yaml")

# the loss within LOSS_TOL of the scale of its summed terms, each gradient
# within GRAD_TOL of its largest value: paint-mesh's tolerances
LOSS_TOL = 1e-4
GRAD_TOL = 2e-4

Step = Tuple[float, Dict[str, torch.Tensor]]


def tiny_depth_steps(device: torch.device, seed: int,
                     load_stack: Optional[Callable] = None
                     ) -> Tuple[Step, Step, float]:
    """One step of the tiny config #5 on the CPU and on `device`. The
    weights, the scene's parameters (the displacement made non-zero) and the
    SDS draws come from one CPU generator seeded with `seed`, in that order.
    `load_stack(cpu_stack, device)`, where given, builds `device`'s stack
    holding the CPU stack's weights (from a directory it writes); else they
    are copied by `load_state_dict`.
    Returns (loss, {name: gradient on the CPU}) of the CPU's step and of
    `device`'s, and Σ|latents·∂loss/∂latents| of the CPU's SDS term: the
    scale that its signed sum, and so the loss, is read on."""
    cpu = torch.device("cpu")
    cfg = parse(TrainConfig, [
        "--config_path", str(NASCAR_DEPTH), "--guide.tiny_diffusion", "true",
        "--guide.unet_dtype", "float32", "--guide.shape_path", "sphere",
        "--guide.texture_resolution", "32", "--render.train_grid_size", "24",
        "--render.body_prob", "0.5"])
    gen = torch.Generator().manual_seed(seed)
    stacks = {cpu: StableDiffusionDepthGuidance.create(
        tiny=True, unet_dtype="float32", device=cpu, generator=gen)}
    if load_stack is not None:
        stacks[device] = load_stack(stacks[cpu], device)
    else:
        stacks[device] = StableDiffusionDepthGuidance.create(
            tiny=True, unet_dtype="float32", device=device)
        for name in ("unet", "text_encoder", "vae"):
            getattr(stacks[device], name).load_state_dict(
                getattr(stacks[cpu], name).state_dict())
    apps = {d: LatentPaintMeshApp.create(cfg, depth_guidance=stacks[d],
                                         device=d) for d in (cpu, device)}
    scene = apps[cpu].scene
    scene.init_params(gen)
    with torch.no_grad():
        scene.displacement.normal_(0.0, 0.01, generator=gen)
    apps[device].scene.load_state_dict(scene.state_dict())
    views = ViewBatch(theta=torch.tensor([1.2, 0.9]),
                      phi=torch.tensor([0.4, 2.5]),
                      radius=torch.tensor([1.4, 1.3]),
                      dirs=torch.tensor([0, 2]),
                      is_body=torch.tensor([True, False]))
    draws = {"t": torch.tensor(500),
             "noise": torch.randn((2, 16, 16, 4), generator=gen)}
    out = {}
    for d, app in apps.items():
        loss, _ = app.loss_fn(views.to(d), draws={
            k: v.to(d) for k, v in draws.items()})
        loss.backward()
        out[d] = (loss.item(), {k: p.grad.cpu() for k, p in
                                app.scene.named_parameters()
                                if p.grad is not None})
    # the CPU's SDS term again, on the render's latents as a leaf:
    # ∂loss/∂latents is the guarded w·(ε̂ − ε)
    with torch.no_grad():
        render = scene.render_train(views)
        depth = normalize_depth(render["depth"], render["mask"])
    lat = render["image"].clone().requires_grad_(True)
    stacks[cpu].train_step_loss(apps[cpu]._select_text(views), lat, depth,
                                t=draws["t"], noise=draws["noise"]).backward()
    scale = (render["image"] * lat.grad).abs().sum().item()
    return out[cpu], out[device], scale
