"""The reference training run: a cell's first steps, computed plainly from
the cell's seed, with the same weights and the same draws as the program's
first steps.

Draws: one generator on the device, seeded from the run's seed, feeds a
step's random numbers in the order the port's step takes them: the poses'
U[0, 1) (4, B), then the app's step draws (`step_draws`), and after the
steps that refresh the occupancy grid, that refresh's jitter (G³, 3). On
the card the port draws the same numbers inside its CUDA graph as eagerly,
so a replayed step and this one see the same inputs.

Adam is written out: m ← β₁m + (1−β₁)g, v ← β₂v + (1−β₂)g², p ← p −
lr/(1−β₁ᵗ)·m/(√v/√(1−β₂ᵗ) + ε).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference import nerf, sd
from portbench.reference.precision import set_kind

BETAS = (0.9, 0.99)
EPS = 1e-15


def adam(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         state: Dict[str, Dict[str, torch.Tensor]], lr: Dict[str, float],
         step: int) -> None:
    b1, b2 = BETAS
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            st = state.setdefault(name, {"m": torch.zeros_like(p),
                                         "v": torch.zeros_like(p)})
            st["m"].mul_(b1).add_(g, alpha=1 - b1)
            st["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = st["v"].sqrt() / math.sqrt(1 - b2 ** step) + EPS
            p.sub_(lr[name] / (1 - b1 ** step) * st["m"] / denom)


def frozen(build: Callable, shapes_of, seed: int, stream: str,
           dtype: torch.dtype, device) -> torch.nn.Module:
    """A frozen module with the cell's weights of `stream`, drawn in the
    dtype the program serves them in, computed in float32."""
    with torch.device("meta"):
        module = build()
    drawn = weights.draw(shapes_of(module), seed, stream, dtype, device)
    return weights.install(module, {n: t.float() for n, t in drawn.items()})


def guidance(cfg: dict, seed: int, device, rgb: bool):
    """(UNet, the direction bank, the VAE or None, ᾱ) of the configuration
    file `cfg`."""
    dtypes = cfg["dtypes"]
    unet = frozen(lambda: sd.unet_from(cfg["unet"]), weights.named_shapes,
                  seed, "unet", getattr(torch, dtypes["unet"]), device)
    clip = frozen(lambda: sd.clip_from(cfg["clip"]), weights.named_shapes,
                  seed, "clip", getattr(torch, dtypes["clip"]), device)
    vae = (frozen(lambda: sd.vae_from(cfg["vae"]), weights.named_shapes,
                  seed, "vae", getattr(torch, dtypes["vae"]), device)
           if rgb else None)
    return unet, clip, vae, sd.alphas_cumprod(device)


def nerf_steps(cfg: dict, work: dict, seed: int, device, steps: int = 3,
               kinds: Optional[Dict[str, Optional[str]]] = None,
               probe: Optional[Callable] = None) -> dict:
    """The first `steps` steps of a latent-NeRF cell (stage 1, or the RGB
    refine where the field has 3 channels). `kinds` rounds the products of
    "unet", "clip", "vae", "field" (the control); `probe(name, tensor)`
    may alter the named intermediate ("latents", "grad") and returns it.
    Returns the losses, the first step's gradient of each parameter and
    each parameter before and after the steps."""
    kinds = kinds or {}
    scene, view, field_cfg = cfg["scene"], work["view"], cfg["field"]
    rgb = field_cfg["out_channels"] == 3
    unet, clip, vae, abar = guidance(cfg, seed, device, rgb)
    set_kind(unet, kinds.get("unet"))
    set_kind(clip, kinds.get("clip"))
    if vae is not None:
        set_kind(vae, kinds.get("vae"))
    bank = sd.direction_embeddings(clip, cfg["clip"], work["text"])
    del clip
    field = nerf.Field(field_cfg).to(device)
    set_kind(field, kinds.get("field"))
    drawn = weights.draw(weights.named_shapes(field), seed, "field",
                         torch.float32, device)
    with torch.no_grad():
        for name, p in field.named_parameters():
            p.copy_(drawn[name])
    params = dict(field.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    G = scene["occupancy_resolution"]
    grid = torch.ones(G ** 3, device=device)
    gen = weights.generator(seed, "draws", device)
    B, H, S = work["batch_size"], scene["train_grid_size"], \
        scene["num_samples"]
    h = cfg["latent_size"]
    probe = probe or (lambda name, t: t)
    losses, scales, first, state = [], [], None, {}
    lr = {n: work["lr"] for n in params}
    for step in range(1, steps + 1):
        pose = nerf.poses(torch.rand((4, B), generator=gen, device=device),
                          view)
        u = torch.rand((B, H * H, S), generator=gen, device=device)
        vae_noise = (torch.randn((B, h, h, 4), generator=gen, device=device)
                     if rgb else None)
        t = torch.randint(cfg["min_step"], cfg["max_step"] + 1, (),
                          generator=gen, device=device)
        noise = torch.randn((B, h, h, 4), generator=gen, device=device)
        out = nerf.render(field, pose, u, grid, scene)
        latents = out["image"]
        if rgb:
            size = cfg["image_size"]
            big = F.interpolate(latents.permute(0, 3, 1, 2), size=(size, size),
                                mode="bilinear", align_corners=False)
            latents = vae.encode(big.permute(0, 2, 3, 1), vae_noise)
        latents = probe("latents", latents)
        grad = sd.sds_grad(unet, abar, latents,
                           sd.select_text(bank, pose["dirs"]), t, noise,
                           work["guidance_scale"])
        reg = work["lambda_sparsity"] * out["sparsity"]
        loss = torch.sum(latents * grad) + reg
        scales.append(float(torch.sum(torch.abs(latents.detach() * grad))
                            + reg.detach()))
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        grads = {n: probe("grad", g) for n, g in grads.items()}
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        adam(params, grads, state, lr, step)
        losses.append(float(loss.detach()))
        if step == 1 or step % scene["occupancy_interval"] == 0:
            ju = torch.rand((G ** 3, 3), generator=gen, device=device)
            grid = nerf.refresh(grid, field.density, ju, G, scene["bound"],
                                scene["occupancy_decay"])
    return {"losses": losses, "scales": scales, "first_grad": first,
            "start": start,
            "end": {n: p.detach().clone() for n, p in params.items()}}


def run(kind: str, cfg: dict, work: dict, seed: int, device, **kw) -> dict:
    """The reference's first steps of a cell of app `kind`."""
    if kind == "latent_nerf":
        return nerf_steps(cfg, work, seed, device, **kw)
    from portbench.reference import mesh
    return mesh.mesh_steps(cfg, work, seed, device, **kw)
