"""The Paint-by-Example step at the tiny size, on the CPU and on another
device from one state.

`tiny_pbe_steps` builds the tiny Paint-by-Example stack and the
latent-paint-mesh app of the cell's command (`guide.use_sd false`,
`guide.image`, `optim.use_clip true`, the sphere; a 24² train grid, 32²
texture, one body-camera view, mode 0, f32) on both devices with the same
weights, exemplar, scene and draws, and takes one loss and its gradients
on each at t = 250 (the CLIP branch: the DDIM step, the VAE decode and the
CLIP tower differentiated) and at t = 500 (the SDS branch). The SDS branch
renders the app's 64² latent grid, whose 4096-token self-attention in the
tiny UNet goes through the attention kernel. The CLIP branch renders a 16²
grid: at 64² the tiny VAE's mid-attention (C = 32, 4096 tokens) would go to
the kernel by shape, as it goes to the flash kernel in JAX, and the kernel
has no backward; at 256 tokens both packages take the plain path.
`chip_smoke.py` and the card tests hold a card's step against the CPU's
with it; the trainer does not use it.
"""
from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpunerf_torch.core.config import parse
from tpunerf_torch.core.views import ViewBatch
from tpunerf_torch.guidance.paint_by_example import PaintByExampleGuidance
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
from tpunerf_torch.utils import write_png

# the loss within LOSS_TOL of its scale, each gradient within GRAD_TOL of
# its largest value: paint-mesh's tolerances
LOSS_TOL = 1e-4
GRAD_TOL = 2e-4
# a t of each branch: 250 ≤ 0.4·T takes the CLIP branch, 500 the SDS one
BRANCH_T = {"clip": 250, "sds": 500}
# the latent grid each branch renders (see the module's docstring)
BRANCH_LATENT = {"clip": 16, "sds": 64}

Step = Tuple[float, Dict[str, torch.Tensor]]


def tiny_pbe_steps(device: torch.device, seed: int,
                   load_stack: Optional[Callable] = None
                   ) -> Dict[str, Tuple[Step, Step, float]]:
    """One step of the tiny Paint-by-Example cell on the CPU and on
    `device` for each branch. The weights, the exemplar (a 64² PNG), the
    scene's parameters (the displacement made non-zero) and each branch's
    SDS noise come from one CPU generator seeded with `seed`, in that
    order; the CLIP
    tower is the CPU app's. Returns, by branch, (loss, {name: gradient on
    the CPU}) of the CPU's step and of `device`'s, and the scale the loss is
    read on: max(|main term|, Σ|latents·∂main/∂latents|) of the CPU's
    guidance term. `load_stack(cpu_stack, device)`, where given, builds
    `device`'s stack holding the CPU stack's weights (from a directory it
    writes); else they are copied by `load_state_dict`."""
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(seed)
    stacks = {cpu: PaintByExampleGuidance.create(
        tiny=True, unet_dtype="float32", device=cpu, generator=gen)}
    if load_stack is not None:
        stacks[device] = load_stack(stacks[cpu], device)
    else:
        stacks[device] = PaintByExampleGuidance.create(
            tiny=True, unet_dtype="float32", device=device)
        for name in ("unet", "vae", "image_encoder"):
            getattr(stacks[device], name).load_state_dict(
                getattr(stacks[cpu], name).state_dict())
    exemplar = (torch.rand((64, 64, 3), generator=gen) * 255).to(torch.uint8)
    with tempfile.TemporaryDirectory(prefix="pbe_step_") as tmp:
        image = Path(tmp) / "exemplar.png"
        write_png(image, exemplar.numpy())
        cfg = parse(TrainConfig, [
            "--guide.use_sd", "false", "--guide.image", str(image),
            "--optim.use_clip", "true", "--guide.shape_path", "sphere",
            "--guide.tiny_diffusion", "true", "--guide.unet_dtype",
            "float32", "--guide.texture_resolution", "32",
            "--render.train_grid_size", "24", "--render.body_prob", "0.7",
            "--log.exp_root", tmp])
        apps = {d: LatentPaintMeshApp.create(cfg, pbe=stacks[d], device=d)
                for d in (cpu, device)}
    apps[device].clip.load_state_dict(apps[cpu].clip.state_dict())
    scene = apps[cpu].scene
    scene.init_params(gen)
    with torch.no_grad():
        scene.displacement.normal_(0.0, 0.01, generator=gen)
    apps[device].scene.load_state_dict(scene.state_dict())
    views = ViewBatch(theta=torch.tensor([1.2]), phi=torch.tensor([0.4]),
                      radius=torch.tensor([1.4]), dirs=torch.tensor([0]),
                      is_body=torch.tensor([True]))
    noises = {b: torch.randn((1, n, n, 4), generator=gen)
              for b, n in BRANCH_LATENT.items()}
    out = {}
    for branch, t in BRANCH_T.items():
        noise = noises[branch]
        draws = {"t": torch.tensor(t), "noise": noise}
        for app in apps.values():
            app.scene.latent_size = BRANCH_LATENT[branch]
        steps = {}
        for d, app in apps.items():
            app.scene.zero_grad(set_to_none=True)
            loss, aux = app.loss_fn(views.to(d), draws={
                k: v.to(d) for k, v in draws.items()})
            if aux["clip_branch"] != (branch == "clip"):
                raise AssertionError(f"t = {t} did not take the {branch} "
                                     "branch")
            loss.backward()
            steps[d] = (loss.item(), {k: p.grad.cpu() for k, p in
                                      app.scene.named_parameters()
                                      if p.grad is not None})
        # the CPU's guidance term again, on the render's latents as a leaf
        app = apps[cpu]
        with torch.no_grad():
            render = scene.render_train(views)
        lat = render["image"].clone().requires_grad_(True)
        main = app.guidance.train_step_loss(
            lat, render["mask"], app.image_embeds,
            guidance_scale=cfg.guide.guidance_scale, use_clip=True,
            clip_embed_fn=app.clip, ref_image01=app.ref_image,
            clip_image_size=app.clip.config.image_size,
            t=draws["t"], noise=noise)
        main.backward()
        scale = max(abs(main.item()),
                    (render["image"] * lat.grad).abs().sum().item())
        out[branch] = (steps[cpu], steps[device], scale)
    return out


def exemplar_png(path: Path, seed: int, size: int = 512) -> np.ndarray:
    """Write a `size`² RGB exemplar drawn from `seed` (smooth colour
    ramps with noise) as a PNG; returns its pixels."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.0, 1.0, size)
    base = np.stack([ramp[None, :].repeat(size, 0),
                     ramp[:, None].repeat(size, 1),
                     np.full((size, size), rng.uniform())], axis=-1)
    img = np.clip(base + 0.1 * rng.normal(size=base.shape), 0.0, 1.0)
    img = (img * 255).astype(np.uint8)
    write_png(path, img)
    return img
