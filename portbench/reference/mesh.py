"""Plain PyTorch latent-paint-mesh, mode 0: a latitude-longitude sphere with
its own UVs, a learnable latent texture and per-vertex displacement under
the uniform-Laplacian term, the body and the head camera, the hard z-buffer
rasterizer with barycentric interpolation, bilinear texture sampling, the
DIB-R soft silhouette as the (detached) compositing mask over the hard
rendered background dome, and SDS from the SD-v1 UNet.

A frozen copy of the equations the configuration runs (Latent-Paint,
arXiv 2211.07600; DIB-R's silhouette), in float32. A pixel takes the
inside face (all three edge functions ≥ 0, either winding) of the largest
camera z, the lowest face id among equals.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference import nerf, sd
from portbench.reference.precision import round_to, set_kind
from portbench.reference.train import adam, guidance

EPS = 1e-10
BODY = (math.pi / 4, -0.3)        # fovy, look-at height
HEAD = (math.pi / 12, 0.4)


def uv_sphere(n_lat: int, n_lon: int, radius: float):
    """(vertices (V, 3), faces (F, 3), face UVs (F, 3, 2)) of the
    latitude-longitude sphere, poles without slivers."""
    lats = np.linspace(0, np.pi, n_lat + 1)
    lons = np.linspace(0, 2 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(lats, lons, indexing="ij")
    verts = np.stack([radius * np.sin(th) * np.sin(ph), radius * np.cos(th),
                      radius * np.sin(th) * np.cos(ph)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_lat + 1), np.arange(n_lon + 1),
                       indexing="ij")
    uvs = np.stack([j / n_lon, 1.0 - i / n_lat], -1).reshape(-1, 2)
    faces = []
    for a in range(n_lat):
        for b in range(n_lon):
            v00, v01 = a * (n_lon + 1) + b, a * (n_lon + 1) + b + 1
            v10, v11 = v00 + n_lon + 1, v01 + n_lon + 1
            if a > 0:
                faces.append([v00, v10, v01])
            if a < n_lat - 1:
                faces.append([v01, v10, v11])
    faces = np.asarray(faces, np.int64)
    return (torch.tensor(verts, dtype=torch.float32),
            torch.from_numpy(faces),
            torch.tensor(uvs, dtype=torch.float32)[faces])


def normalized(verts: torch.Tensor, scale: float, dy: float) -> torch.Tensor:
    v = verts - verts.mean(0)
    v = v / torch.linalg.norm(v, dim=1).max() * scale
    return v + torch.tensor([0.0, dy, 0.0])


def laplacian(faces: torch.Tensor, n: int):
    """(neighbour pairs (E, 2), 1/degree (V,)) of the uniform Laplacian."""
    f = faces.numpy()
    pairs = np.unique(np.concatenate([f[:, [0, 1]], f[:, [1, 0]],
                                      f[:, [1, 2]], f[:, [2, 1]],
                                      f[:, [2, 0]], f[:, [0, 2]]]), axis=0)
    deg = np.bincount(pairs[:, 0], minlength=n).astype(np.float32)
    return torch.from_numpy(pairs), torch.from_numpy(
        np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0).astype(np.float32))


def lap(v: torch.Tensor, pairs: torch.Tensor, inv_deg: torch.Tensor):
    """Neighbour mean minus self, (V, 3)."""
    s = torch.zeros_like(v).index_add(0, pairs[:, 0], v[pairs[:, 1]])
    return s * inv_deg[:, None] - v


def project(verts, faces, pose, fovy: float, height: float):
    """Camera-space z (B, F, 3) and image xy (B, F, 3, 2) of each face
    vertex: world → camera by the look-at transform, then x, y scaled by
    1/tan(fovy/2) over the depth −z."""
    pos = nerf.camera_position(pose["theta"], pose["phi"], pose["radius"])
    M = nerf.look_at(pos, height)
    ones = torch.ones((*verts.shape[:-1], 1), device=verts.device)
    cam = torch.cat([verts, ones], -1) @ M                 # (B, V, 3)
    f = 1.0 / math.tan(fovy / 2)
    img = cam[..., :2] * f / (-cam[..., 2:3])
    return cam[:, faces, 2], img[:, faces]


def _edges(fv_img):
    """The three edge functions' (a, b, c) of each face, signed so that the
    inside is ≥ 0, and |twice the area|."""
    v0, v1, v2 = fv_img[..., 0, :], fv_img[..., 1, :], fv_img[..., 2, :]

    def edge(a, b):
        return (-(b[..., 1] - a[..., 1]), b[..., 0] - a[..., 0],
                (b[..., 1] - a[..., 1]) * a[..., 0]
                - (b[..., 0] - a[..., 0]) * a[..., 1])

    den = ((v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1])
           - (v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0]))
    s = torch.sign(den)
    es = [tuple(c * s for c in edge(a, b))
          for a, b in ((v1, v2), (v2, v0), (v0, v1))]
    return es, den.abs()


def pixels(H: int, W: int, device) -> torch.Tensor:
    ys = 1.0 - (torch.arange(H, dtype=torch.float32, device=device)
                + 0.5) / H * 2
    xs = (torch.arange(W, dtype=torch.float32, device=device)
          + 0.5) / W * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def select(fv_z, fv_img, pix, block: int = 256) -> torch.Tensor:
    """(B, P) id of the face each pixel shows, −1 for none."""
    with torch.no_grad():
        es, area = _edges(fv_img)
        ok = area > EPS
        B, Fn = area.shape
        px, py = pix[None, :, 0, None], pix[None, :, 1, None]
        best_z = torch.full((B, pix.shape[0]), -math.inf, device=pix.device)
        best_i = torch.full((B, pix.shape[0]), -1, dtype=torch.int64,
                            device=pix.device)
        for f0 in range(0, Fn, block):
            sl = slice(f0, f0 + block)
            inside = ok[:, None, sl]
            for a, b, c in es:
                inside = inside & ((a[:, None, sl] * px + b[:, None, sl] * py
                                    + c[:, None, sl]) >= 0)
            z = sum((a[:, None, sl] * px + b[:, None, sl] * py
                     + c[:, None, sl]) * fv_z[:, None, sl, k]
                    for k, (a, b, c) in enumerate(es)) \
                / torch.where(ok, area, torch.ones_like(area))[:, None, sl]
            z = torch.where(inside, z, torch.full_like(z, -math.inf))
            zb, ib = z.max(-1)          # the first of equals: lowest id
            take = zb > best_z
            best_z = torch.where(take, zb, best_z)
            best_i = torch.where(take, ib + f0, best_i)
        return best_i


def interpolate(pix, fid, fv_img, feats) -> torch.Tensor:
    """Barycentric interpolation (B, P, C) of the shown faces' features,
    differentiable to the image positions and the features; 0 where no
    face shows."""
    B = fid.shape[0]
    safe = fid.clamp(min=0)
    b = torch.arange(B, device=fid.device)[:, None]
    tri, f = fv_img[b, safe], feats[b, safe]
    v0, v1, v2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]

    def cross(a, c):
        return a[..., 0] * c[..., 1] - a[..., 1] * c[..., 0]

    w = torch.stack([cross(v2 - v1, pix - v1), cross(v0 - v2, pix - v2),
                     cross(v1 - v0, pix - v0)], -1)
    den = w.sum(-1, keepdim=True)
    den = torch.where(den.abs() > EPS, den, torch.ones_like(den))
    out = torch.einsum("bpk,bpkc->bpc", w / den, f)
    return torch.where((fid >= 0)[..., None], out, torch.zeros_like(out))


def silhouette(fv_img, pix, sigma: float, block: int = 256) -> torch.Tensor:
    """DIB-R soft coverage 1 − ∏_f (1 − p_f), p_f = 1 inside the face, else
    exp(−d²/σ) of the squared distance d² to its nearest edge (B, P)."""
    with torch.no_grad():
        es, area = _edges(fv_img)
        B, Fn = area.shape
        px, py = pix[None, :, 0, None], pix[None, :, 1, None]
        prod = torch.ones((B, pix.shape[0]), device=pix.device)
        for f0 in range(0, Fn, block):
            sl = slice(f0, f0 + block)
            inside = (area > EPS)[:, None, sl]
            for a, b, c in es:
                inside = inside & ((a[:, None, sl] * px + b[:, None, sl] * py
                                    + c[:, None, sl]) >= 0)
            v = fv_img[:, sl]
            d2 = None
            for k in range(3):
                ax, ay = v[:, None, :, k, 0], v[:, None, :, k, 1]
                bx, by = (v[:, None, :, (k + 1) % 3, 0],
                          v[:, None, :, (k + 1) % 3, 1])
                wx, wy = bx - ax, by - ay
                ux, uy = px - ax, py - ay
                s = ((ux * wx + uy * wy)
                     / (wx * wx + wy * wy).clamp(min=EPS)).clamp(0.0, 1.0)
                dk = (ux - s * wx) ** 2 + (uy - s * wy) ** 2
                d2 = dk if d2 is None else torch.minimum(d2, dk)
            p = torch.where(inside, torch.ones_like(d2),
                            torch.exp(-d2 / sigma))
            prod = prod * torch.prod(1.0 - p, dim=-1)
        return 1.0 - prod


def texture_sample(uv: torch.Tensor, tex: torch.Tensor) -> torch.Tensor:
    """Bilinear samples (B, P, C) of the (B, R, R, C) texture at uv in
    [0, 1] (v = 1 is the first row), zero outside."""
    B = uv.shape[0]
    grid = torch.stack([uv[..., 0] * 2 - 1, 1 - uv[..., 1] * 2],
                       -1).reshape(B, 1, -1, 2)
    out = F.grid_sample(tex.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.reshape(B, tex.shape[-1], -1).transpose(1, 2)


def mesh_steps(cfg: dict, work: dict, seed: int, device, steps: int = 3,
               kinds: Optional[Dict[str, Optional[str]]] = None,
               probe=None) -> dict:
    """The first `steps` steps of a latent-paint-mesh mode-0 cell; as
    `train.nerf_steps`; `kinds["mesh"]` rounds the render's positions,
    coordinates, texels and images."""
    kinds = kinds or {}

    def rnd(x):
        return round_to(x, kinds.get("mesh"))

    scene, view = cfg["scene"], work["view"]
    unet, clip, _, abar = guidance(cfg, seed, device, rgb=False)
    set_kind(unet, kinds.get("unet"))
    set_kind(clip, kinds.get("clip"))
    body_bank = sd.direction_embeddings(clip, cfg["clip"], work["text"])
    head_bank = sd.direction_embeddings(
        clip, cfg["clip"], f"a close up face of {work['text']}")
    del clip
    verts, faces, face_uv = uv_sphere(32, 64, 1.0)
    verts = normalized(verts, scene["shape_scale"], scene["dy"])
    dome_v, dome_f, _ = uv_sphere(16, 32, 5.0)
    pairs, inv_deg = laplacian(faces, verts.shape[0])
    verts, faces, face_uv, dome_v, dome_f, pairs, inv_deg = (
        t.to(device) for t in (verts, faces, face_uv, dome_v, dome_f, pairs,
                               inv_deg))
    lap0 = lap(verts, pairs, inv_deg)
    R = scene["texture_resolution"]
    shapes = {"background_sphere_colors": (1, dome_f.shape[0], 3, 4),
              "texture_img": (1, R, R, 4), "displacement": tuple(verts.shape),
              "lights": (1, 9)}
    init = weights.mesh_init(sorted(shapes.items()), seed, device)
    params = {n: init[n].clone().requires_grad_(True) for n in shapes}
    start = {n: p.detach().clone() for n, p in params.items()}
    lr = {"background_sphere_colors": work["lr"], "texture_img": work["lr"],
          "displacement": work["disp_lr"], "lights": work["disp_lr"]}
    H = work["train_grid_size"]
    pix = pixels(H, H, device)
    gen = weights.generator(seed, "draws", device)
    B, h = work["batch_size"], cfg["latent_size"]
    probe = probe or (lambda name, t: t)
    losses, scales, first, state = [], [], None, {}
    for step in range(1, steps + 1):
        pose = nerf.poses(torch.rand((4, B), generator=gen, device=device),
                          view)
        t = torch.randint(cfg["min_step"], cfg["max_step"] + 1, (),
                          generator=gen, device=device)
        noise = torch.randn((B, h, h, 4), generator=gen, device=device)
        disp = params["displacement"]
        v = verts + disp
        tex = rnd(params["texture_img"]).expand(B, -1, -1, -1)
        fg, soft = [], []
        for fovy, height in (BODY, HEAD):
            fz, fimg = project(v[None].expand(B, -1, -1), faces, pose, fovy,
                               height)
            fimg = rnd(fimg)
            fid = select(fz, fimg, pix)
            uv = rnd(interpolate(pix, fid, fimg, face_uv[None].expand(
                B, -1, -1, -1)))
            fg.append(rnd(texture_sample(uv, tex)) * (fid >= 0)[..., None])
            soft.append(silhouette(fimg, pix, scene["soft_mask_sigma"]))
        sel = pose["is_body"].float()[:, None, None]
        image = fg[0] * sel + fg[1] * (1 - sel)
        mask = (soft[0] * sel[..., 0] + soft[1] * (1 - sel[..., 0]))[..., None]
        bz, bimg = project(dome_v[None].expand(B, -1, -1), dome_f, pose,
                           BODY[0], scene["dy"])
        bid = select(bz, bimg, pix)
        bg = rnd(interpolate(pix, bid, bimg, params[
            "background_sphere_colors"].expand(B, -1, -1, -1)))
        latents = rnd(bg * (1 - mask) + image * mask).reshape(B, H, H, 4)
        latents = probe("latents", latents)
        body = sd.select_text(body_bank, pose["dirs"])
        head = sd.select_text(head_bank, pose["dirs"])
        s2 = torch.cat([sel, sel])
        grad = sd.sds_grad(unet, abar, latents, body * s2 + head * (1 - s2),
                           t, noise, work["guidance_scale"])
        reg = (work["lambda_laplacian"] * torch.mean(torch.sum(
            (lap(verts + disp, pairs, inv_deg) - lap0) ** 2, -1))
            + work["lambda_displacement"] * torch.mean(disp ** 2))
        loss = torch.sum(latents * grad) + reg
        scales.append(float(torch.sum(torch.abs(latents.detach() * grad))
                            + reg.detach()))
        gs = torch.autograd.grad(loss, list(params.values()),
                                 allow_unused=True)
        grads = {n: probe("grad", torch.zeros_like(p) if g is None else g)
                 for (n, p), g in zip(params.items(), gs)}
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        adam(params, grads, state, lr, step)
        losses.append(float(loss.detach()))
    return {"losses": losses, "scales": scales, "first_grad": first,
            "start": start,
            "end": {n: p.detach().clone() for n, p in params.items()}}
