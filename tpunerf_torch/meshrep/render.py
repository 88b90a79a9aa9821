"""Mesh renderer: camera → rasterize → texture and shade. Batched over views.

One functional API for both renderers: the hard path of latent-paint, and
the DIB-R soft path of latent-paint-mesh with per-vertex displacement,
area-weighted vertex normals, 9-coefficient SH lighting and the body and
head cameras.
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
    mask: torch.Tensor                  # (B, H, W, 1) hard or soft coverage
    face_idx: torch.Tensor              # (B, H, W) int32
    normals: Optional[torch.Tensor] = None   # (B, H, W, 3) world normals
    lighting: Optional[torch.Tensor] = None  # (B, H, W, 1) SH shading
    depth: Optional[torch.Tensor] = None    # (B, H, W, 1) camera −z, 0 = bg


@functools.lru_cache(maxsize=16)
def _projection(fovy: float, device: torch.device) -> torch.Tensor:
    return cam.perspective_projection(fovy, device=device)


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Projection + look-at height for one camera family: the paint camera
    has FOV π/3; paint-mesh's body camera FOV π/4 looking at −0.3, its head
    camera FOV π/12 looking at +0.4."""
    fovy: float = math.pi / 3
    look_at_height: float = 0.0

    def projection(self, device: torch.device) -> torch.Tensor:
        """The (3,) projection vector, made once per device and kept
        there."""
        return _projection(self.fovy, torch.device(device))


BODY_CAMERA = CameraSpec(fovy=math.pi / 4, look_at_height=-0.3)
HEAD_CAMERA = CameraSpec(fovy=math.pi / 12, look_at_height=0.4)


def compute_vertex_normals(vertices: torch.Tensor, faces: torch.Tensor
                           ) -> torch.Tensor:
    """Area-weighted unit vertex normals (V, 3): each face's unnormalised
    normal is added to its three vertices. The scatter-add (`index_add`)
    sums in an order that varies from run to run on the card."""
    fv = cam.index_vertices_by_faces(vertices, faces)      # (F, 3, 3)
    fn = cam.face_normals(fv, unit=False)
    vn = torch.zeros_like(vertices).index_add(
        0, faces.reshape(-1).long(), fn.repeat_interleave(3, dim=0))
    return vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp(min=1e-12)


# Real SH basis constants, bands 0-2, in the order
# [1, y, z, x, xy, yz, 3z²−1, xz, x²−y²]
_SH_C = (0.282095, 0.488603, 0.488603, 0.488603,
         1.092548, 1.092548, 0.315392, 1.092548, 0.546274)


def spherical_harmonic_lighting(normals: torch.Tensor, lights: torch.Tensor
                                ) -> torch.Tensor:
    """9-coefficient SH shading from unit normals: normals (..., 3), lights
    (B, 9) or broadcastable (..., 9) → scalar irradiance (B, ...)."""
    x, y, z = normals[..., 0], normals[..., 1], normals[..., 2]
    basis = torch.stack([
        _SH_C[0] * torch.ones_like(x),
        _SH_C[1] * y, _SH_C[2] * z, _SH_C[3] * x,
        _SH_C[4] * x * y, _SH_C[5] * y * z,
        _SH_C[6] * (3 * z * z - 1.0), _SH_C[7] * x * z,
        _SH_C[8] * (x * x - y * y),
    ], dim=-1)                                             # (..., 9)
    if lights.dim() == 2:
        # (B, 9) → broadcast over the spatial dims of (B, ..., 9)
        lights = lights.reshape(lights.shape[0],
                                *([1] * (basis.dim() - 2)), 9)
    return torch.sum(basis * lights, dim=-1)


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
    """Textured render with a hard or a DIB-R soft mask: rasterize
    interpolated UVs and depth, sample the texture, composite on black or
    white. `displacement` (V, 3) moves the vertices before projection;
    `compute_normals` adds the world-normal map and, with `lights` (B, 9),
    the SH shading; `soft_mask_sigma` makes the mask the soft silhouette,
    differentiable to the vertices. `detach_uv=True` stops geometry
    gradients at the UV map, so the texture's gradient comes only through
    the sampling."""
    H, W = dims
    if displacement is not None:
        verts = verts + displacement
    fv_cam, fv_img, B = _project(verts, faces, theta, phi, radius, spec)

    # per-face-vertex features: uv (2) + camera depth −z (1) [+ normal (3)]
    feat_list = [uv_face_attr.expand(B, *uv_face_attr.shape[-3:]),
                 -fv_cam[..., 2:3]]
    if compute_normals:
        fn_attr = cam.index_vertices_by_faces(
            compute_vertex_normals(verts, faces), faces)   # (F, 3, 3) world
        feat_list.append(fn_attr.expand(B, *fn_attr.shape))
    features = torch.cat(feat_list, dim=-1)
    feats, face_idx = rast.rasterize(H, W, fv_cam[..., 2], fv_img, features)
    uv_px = feats[..., :2]
    if detach_uv:
        uv_px = uv_px.detach()

    image = texk.texture_mapping(uv_px, texture_map, mode=interpolation_mode)
    hard_mask = (face_idx > -1).float()[..., None]
    if soft_mask_sigma is not None:
        mask = rast.soft_silhouette(H, W, fv_img,
                                    sigma=soft_mask_sigma)[..., None]
    else:
        mask = hard_mask
    depth = feats[..., 2:3] * hard_mask

    normals_img = lighting = None
    if compute_normals:
        normals_img = feats[..., 3:6]
        nrm = torch.linalg.norm(normals_img, dim=-1,
                                keepdim=True).clamp(min=1e-12)
        normals_img = normals_img / nrm * hard_mask
        if lights is not None:
            lighting = spherical_harmonic_lighting(normals_img, lights)
            lighting = lighting.clamp(1e-8, 1.0)[..., None]

    image = image * hard_mask
    if white_background:
        image = image + (1.0 - hard_mask)
    return RenderOutput(image=image, mask=mask, face_idx=face_idx,
                        normals=normals_img, lighting=lighting, depth=depth)
