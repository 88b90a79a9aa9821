"""Mesh renderer: camera → rasterize → texture. Batched over views.

The hard path of the JAX package's `meshrep/render.py`. Vertex normals, SH
lighting, per-vertex displacement and the soft (DIB-R) mask belong to the
latent-paint-mesh slice of the port and are refused here.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from tpunerf_torch.core import camera as cam
from tpunerf_torch.kernels import rasterize as rast
from tpunerf_torch.kernels import texture as texk



class RenderOutput(NamedTuple):
    image: torch.Tensor                 # (B, H, W, C)
    mask: torch.Tensor                  # (B, H, W, 1) hard coverage
    face_idx: torch.Tensor              # (B, H, W) int32
    normals: Optional[torch.Tensor] = None
    lighting: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None    # (B, H, W, 1) camera −z, 0 = bg


@functools.lru_cache(maxsize=16)
def _projection(fovy: float, device: torch.device) -> torch.Tensor:
    return cam.perspective_projection(fovy, device=device)


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Projection + look-at height for one camera family (the paint camera
    has FOV π/3)."""
    fovy: float = math.pi / 3
    look_at_height: float = 0.0

    def projection(self, device: torch.device = torch.device("cpu")
                   ) -> torch.Tensor:
        """The (3,) projection vector, made once per device and kept
        there."""
        return _projection(self.fovy, torch.device(device))


def _project(vertices: torch.Tensor, faces: torch.Tensor, theta, phi, radius,
             spec: CameraSpec) -> Tuple[torch.Tensor, torch.Tensor, int]:
    dev = vertices.device
    theta = torch.atleast_1d(torch.as_tensor(theta, dtype=torch.float32,
                                             device=dev))
    phi = torch.atleast_1d(torch.as_tensor(phi, dtype=torch.float32,
                                           device=dev))
    radius = torch.as_tensor(radius, dtype=torch.float32,
                             device=dev).expand(theta.shape)
    transform = cam.camera_transform_from_view(
        theta, phi, radius, look_at_height=spec.look_at_height)
    fv_cam, fv_img, _ = cam.prepare_vertices(
        vertices, faces, spec.projection(dev), transform)
    return fv_cam, fv_img, theta.shape[0]


def render_single_view(mesh_vertices: torch.Tensor, faces: torch.Tensor,
                       face_attributes: torch.Tensor, theta, phi, radius,
                       spec: CameraSpec = CameraSpec(), dims=(64, 64)
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard rasterization of per-face attributes (the background dome).
    Returns the (B, H, W, C) image and the (B, H, W, 1) mask."""
    fv_cam, fv_img, B = _project(mesh_vertices, faces, theta, phi, radius,
                                 spec)
    attrs = face_attributes.expand(B, *face_attributes.shape[-3:])
    feats, face_idx = rast.rasterize(dims[0], dims[1], fv_cam[..., 2],
                                     fv_img, attrs)
    return feats, (face_idx > -1).float()[..., None]


def render_single_view_texture(
        verts: torch.Tensor, faces: torch.Tensor, uv_face_attr: torch.Tensor,
        texture_map: torch.Tensor, theta, phi, radius,
        spec: CameraSpec = CameraSpec(), dims=(64, 64),
        interpolation_mode: str = "bilinear", white_background: bool = False,
        detach_uv: bool = True, displacement: Optional[torch.Tensor] = None,
        compute_normals: bool = False, lights: Optional[torch.Tensor] = None,
        soft_mask_sigma: Optional[float] = None) -> RenderOutput:
    """Textured render with a hard mask: rasterize interpolated UVs and
    depth, sample the texture, composite on black or white.
    `detach_uv=True` stops geometry gradients at the UV map, so the
    texture's gradient comes only through the sampling."""
    for name, asked in (("displacement", displacement is not None),
                        ("compute_normals", compute_normals),
                        ("lights", lights is not None),
                        ("soft_mask_sigma", soft_mask_sigma is not None)):
        if asked:
            raise NotImplementedError(f"{name} {rast.MESH_SLICE}")
    H, W = dims
    fv_cam, fv_img, B = _project(verts, faces, theta, phi, radius, spec)

    # per-face-vertex features: uv (2) + camera depth −z (1)
    features = torch.cat([uv_face_attr.expand(B, *uv_face_attr.shape[-3:]),
                          -fv_cam[..., 2:3]], dim=-1)
    feats, face_idx = rast.rasterize(H, W, fv_cam[..., 2], fv_img, features)
    uv_px = feats[..., :2]
    if detach_uv:
        uv_px = uv_px.detach()

    image = texk.texture_mapping(uv_px, texture_map, mode=interpolation_mode)
    hard_mask = (face_idx > -1).float()[..., None]
    depth = feats[..., 2:3] * hard_mask
    image = image * hard_mask
    if white_background:
        image = image + (1.0 - hard_mask)
    return RenderOutput(image=image, mask=hard_mask, face_idx=face_idx,
                        depth=depth)
