"""The pieces of a cell's step, each alone as a call that a CUDA graph can
capture, on inputs drawn from the run's seed at the shapes the window runs:
the layers (the guidance's CFG pass, the render forward and backward, the
VAE encode forward and backward) and the kernel entries whose rooflines the
benchmark reads (attention, the hash grid, the rasterizer). Each call
returns what it computed, so that nothing of it is dead.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from portbench import weights


def of(program) -> Dict[str, Callable]:
    work, cfg, dev = program.work, program.cfg, program.device
    app, g = program.app, program.guidance
    gen = weights.generator(0, "parts", dev)
    B = work["batch_size"]
    h = cfg["latent_size"]
    params = list(program.params.values())
    views = _views(program, gen)
    out: Dict[str, Callable] = {}

    from tpunerf_torch.guidance import sds as sds_lib
    latents = torch.randn((B, h, h, 4), generator=gen, device=dev)
    t = torch.full((), 500, dtype=torch.int64, device=dev)
    text = app._select_text(views) if hasattr(app, "_select_text") else \
        _nerf_text(app, views)

    def unet_cfg():
        with torch.no_grad():
            return sds_lib.cfg_eps(g.unet_apply, latents, t, text,
                                   work["guidance_scale"])

    out["unet_cfg"] = unet_cfg
    out["attention"] = _attention(cfg, B, gen, dev)

    if work["app"] == "latent_nerf":
        scene = app.scene
        H, S = work["train_grid_size"], work["num_samples"]
        u = torch.rand((B, H * H, S), generator=gen, device=dev)

        def nerf_render():
            r = scene.render_train(views, u=u)
            loss = r["image"].sum() + r["sparsity_loss"]
            return torch.autograd.grad(loss, params)

        out["nerf_render"] = nerf_render
        out["hashgrid"] = _hashgrid(scene, work, gen, dev)
        if work["nerf_type"] == "rgb":
            from tpunerf_torch.kernels import texture as texk
            img = torch.rand((B, H, H, 3), generator=gen, device=dev,
                             requires_grad=True)
            noise = torch.randn((B, h, h, 4), generator=gen, device=dev)
            size = cfg["image_size"]

            def vae_encode():
                rgb = texk.resize_bilinear(img, size, size)
                lat = g.encode_imgs(rgb, noise=noise)
                return torch.autograd.grad(lat.sum(), img)

            out["vae_encode"] = vae_encode
    else:
        scene = app.scene

        def mesh_render():
            r = scene.render_train(views)
            loss = (r["image"].sum() + r["laplacian_loss"]
                    + r["displacement_norm"])
            return torch.autograd.grad(loss, params, allow_unused=True)

        out["mesh_render"] = mesh_render
        out["raster"] = _raster(scene, views)
    return out


def _views(program, gen):
    from tpunerf_torch.core.views import rand_poses
    return rand_poses(program.work["batch_size"], program.trainer.view_cfg,
                      program.device, generator=gen)


def _nerf_text(app, views):
    from tpunerf_torch.training.latent_nerf_app import select_text_embeddings
    return select_text_embeddings(app.text_z, views.dirs)


def attention_shape(cfg: dict, batch: int):
    """(B·2, heads, tokens, head width) of the UNet's long self-attention:
    the CFG pass doubles the batch; the 64² level's tokens."""
    u = cfg["unet"]
    width = u["block_out_channels"][0]
    return (2 * batch, u["attention_num_heads"], cfg["latent_size"] ** 2,
            width // u["attention_num_heads"])


def _attention(cfg: dict, B: int, gen, dev) -> Callable:
    from tpunerf_torch.kernels.attention import attention
    shape = attention_shape(cfg, B)
    dtype = getattr(torch, cfg["dtypes"]["unet"])
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    scale = shape[-1] ** -0.5

    def run():
        with torch.no_grad():
            return attention(q, k, v, scale)

    return run


def _hashgrid(scene, work: dict, gen, dev) -> Callable:
    """The encode and the table's gradient at the step's points: every
    ray's K compacted samples."""
    from tpunerf_torch.kernels.hashgrid import hash_encode_auto
    field = scene.field
    n = (work["batch_size"] * work["train_grid_size"] ** 2
         * scene.march.num_compacted)
    x = torch.rand((n, 3), generator=gen, device=dev)
    gout = torch.randn((n, field.config.grid.out_dim), generator=gen,
                       device=dev)

    def run():
        out = hash_encode_auto(x, field.hash_table, field.config.grid)
        return torch.autograd.grad(out, field.hash_table, gout)

    return run


def raster_inputs(scene, views):
    """The step's body-camera face rows: (face z, face image xy, face
    features) as the render hands them to the rasterizer, and the size."""
    from tpunerf_torch.meshrep import render as mrender
    spec = scene.camera
    verts = scene.mesh.vertices + scene.displacement
    fv_cam, fv_img, B = mrender._project(verts, scene.mesh.faces,
                                         views.theta, views.phi,
                                         views.radius, spec)
    feats = torch.cat([scene.face_uv_attr.expand(B, -1, -1, -1),
                       -fv_cam[..., 2:3]], dim=-1)
    return fv_cam[..., 2].detach(), fv_img.detach(), feats.detach(), \
        scene.render_grid_size


def _raster(scene, views) -> Callable:
    from tpunerf_torch.kernels import rasterize as rast
    fz, fimg, feats, H = raster_inputs(scene, views)
    sigma = scene.soft_mask_sigma

    def run():
        with torch.no_grad():
            f, idx = rast.rasterize(H, H, fz, fimg, feats)
            return f, idx, rast.soft_silhouette(H, H, fimg, sigma=sigma)

    return run


def counts(program) -> Dict[str, Dict[str, int]]:
    """What the rooflines count on the step's own inputs: for a mesh cell,
    the body camera's face rows (B, F, features C, pixels P) and their
    inside (pixel, face) pairs."""
    if program.work["app"] != "paint_mesh":
        return {}
    from portbench.arith import raster
    scene = program.app.scene
    views = _views(program, weights.generator(0, "parts", program.device))
    _, fimg, feats, H = raster_inputs(scene, views)
    B, F = fimg.shape[:2]
    return {"raster_counts": {"B": B, "F": F, "C": feats.shape[-1],
                              "P": H * H,
                              "pairs": raster.inside_pairs(fimg, H, H)}}
