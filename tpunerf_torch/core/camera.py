"""Camera math: spherical poses, look-at transforms, perspective projection
of meshes, prompt-direction buckets.

Conventions are those of the JAX package's `core/camera.py`:

* world: +Y up; the camera orbits the origin at spherical (theta, phi, r)
  with position (r·sinθ·sinφ, r·cosθ, r·sinθ·cosφ);
* camera space: right-handed, camera looks down −z;
* image/NDC: x right, y up, both in [−1, 1]; perspective divide by −z.
  There is no near-plane clip: a vertex behind the camera goes through the
  same divide and its face is z-tested like any other.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def spherical_camera_position(theta: torch.Tensor, phi: torch.Tensor,
                              radius: torch.Tensor) -> torch.Tensor:
    """theta: polar angle from +Y, phi: azimuth. Broadcasts; (..., 3)."""
    theta, phi, radius = torch.broadcast_tensors(theta, phi, radius)
    x = radius * torch.sin(theta) * torch.sin(phi)
    y = radius * torch.cos(theta)
    z = radius * torch.sin(theta) * torch.cos(phi)
    return torch.stack([x, y, z], dim=-1)


def _cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)


def look_at_transform(camera_position: torch.Tensor, look_at: torch.Tensor,
                      up: torch.Tensor) -> torch.Tensor:
    """World→camera transform as a (..., 4, 3) matrix, applied as
    ``[p, 1] @ M``. The camera z-axis points from `look_at` toward the
    camera. Poses with `up` parallel to the view axis switch to a z-world
    up so the rotation stays orthonormal."""
    look_at = look_at.expand_as(camera_position)
    up = up.expand_as(camera_position)
    z_axis = _normalize(camera_position - look_at)
    x_raw = _cross3(up, z_axis)
    alt_up = torch.zeros_like(up)
    alt_up[..., 2] = 1.0
    degenerate = torch.sum(x_raw * x_raw, dim=-1, keepdim=True) < 1e-8
    x_raw = torch.where(degenerate, _cross3(alt_up, z_axis), x_raw)
    x_axis = _normalize(x_raw)
    y_axis = _cross3(z_axis, x_axis)
    rot = torch.stack([x_axis, y_axis, z_axis], dim=-1)          # (..., 3, 3)
    trans = -torch.einsum("...i,...ij->...j", camera_position, rot)
    return torch.cat([rot, trans[..., None, :]], dim=-2)         # (..., 4, 3)


def camera_transform_from_view(theta: torch.Tensor, phi: torch.Tensor,
                               radius: torch.Tensor,
                               look_at_height: float = 0.0) -> torch.Tensor:
    """Spherical view → world→camera (..., 4, 3) transform: look-at target
    (0, look_at_height, 0), up (0, 1, 0)."""
    pos = spherical_camera_position(theta, phi, radius)
    look_at = torch.zeros_like(pos)
    look_at[..., 1] = look_at_height
    up = torch.zeros_like(pos)
    up[..., 1] = 1.0
    return look_at_transform(pos, look_at, up)


def perspective_projection(fovy: float = math.pi / 3, ratio: float = 1.0,
                           device: torch.device = torch.device("cpu")
                           ) -> torch.Tensor:
    """Projection coefficients (3,): NDC x = px·c0/−pz, y = py·c1/−pz."""
    tanfov = math.tan(fovy / 2.0)
    proj = torch.full((3,), -1.0, dtype=torch.float32, device=device)
    proj[0] = 1.0 / (ratio * tanfov)
    proj[1] = 1.0 / tanfov
    return proj


def transform_vertices(vertices: torch.Tensor,
                       camera_transform: torch.Tensor) -> torch.Tensor:
    """World (..., V, 3) → camera space via a (..., 4, 3) transform."""
    ones = torch.ones((*vertices.shape[:-1], 1), dtype=vertices.dtype,
                      device=vertices.device)
    return torch.cat([vertices, ones], dim=-1) @ camera_transform


def perspective_project(vertices_camera: torch.Tensor,
                        camera_proj: torch.Tensor) -> torch.Tensor:
    """Camera-space (..., V, 3) → NDC image coords (..., V, 2): scale by the
    projection coefficients, then divide x, y by the third component."""
    scaled = vertices_camera * camera_proj
    return scaled[..., :2] / scaled[..., 2:3]


def face_normals(face_vertices: torch.Tensor, unit: bool = True
                 ) -> torch.Tensor:
    """Normals of (..., F, 3, 3) face vertices → (..., F, 3)."""
    e1 = face_vertices[..., 1, :] - face_vertices[..., 0, :]
    e2 = face_vertices[..., 2, :] - face_vertices[..., 0, :]
    n = _cross3(e1, e2)
    if unit:
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                            min=1e-12)
    return n


def index_vertices_by_faces(vertex_attr: torch.Tensor,
                            faces: torch.Tensor) -> torch.Tensor:
    """Gather per-vertex attributes (..., V, C) into per-face
    (..., F, 3, C)."""
    return vertex_attr[..., faces.long(), :]


def prepare_vertices(vertices: torch.Tensor, faces: torch.Tensor,
                     camera_proj: torch.Tensor,
                     camera_transform: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World mesh + camera → (face_vertices_camera, face_vertices_image,
    face_normals). Batched over the camera's leading dims."""
    verts_cam = transform_vertices(vertices, camera_transform)
    verts_img = perspective_project(verts_cam, camera_proj)
    fv_cam = index_vertices_by_faces(verts_cam, faces)
    fv_img = index_vertices_by_faces(verts_img, faces)
    return fv_cam, fv_img, face_normals(fv_cam)


def get_view_direction(thetas: torch.Tensor, phis: torch.Tensor,
                       overhead: float, front: float) -> torch.Tensor:
    """Bucket (theta, phi) [radians] into prompt-direction ids:
    0 front · 1 left · 2 back · 3 right · 4 overhead · 5 bottom."""
    phis = torch.remainder(phis, 2 * math.pi)
    half = front / 2.0
    res = torch.full(thetas.shape, 3, dtype=torch.int64, device=thetas.device)
    res = torch.where((phis >= 2 * math.pi - half) | (phis < half), 0, res)
    res = torch.where((phis >= half) & (phis < math.pi - half), 1, res)
    res = torch.where((phis >= math.pi - half) & (phis < math.pi + half), 2,
                      res)
    res = torch.where(thetas <= overhead, 4, res)
    res = torch.where(thetas >= math.pi - overhead, 5, res)
    return res


VIEW_DIRECTION_SUFFIXES = (
    "front view", "side view", "back view", "side view", "overhead view",
    "bottom view",
)
