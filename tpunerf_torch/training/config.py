"""Train configuration schema — one typed superset for all apps.

Mirrors the reference's pyrallis dataclasses
(src/latent_paint/configs/train_config.py:1-98 and
src/latent_paint_mesh/configs/train_config.py:1-156) with every field a real
typed dataclass field (the reference leaves `texture_resolution`,
`diffusion_name` etc. un-annotated and silently non-configurable —
SURVEY.md §2.1). Parsed by core/config.py (YAML + dotted CLI).

A field-for-field copy of the JAX package's schema (a test holds the two
equal); port-only settings such as the device stay out of it.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple


@dataclasses.dataclass
class RenderConfig:
    """Rendering / view-sampling (reference RenderConfig, train_config.py:5-30
    + mesh variant :9-33)."""
    train_grid_size: int = 64
    eval_grid_size: int = 512
    radius_range: Tuple[float, float] = (1.0, 1.5)
    angle_overhead: float = 30.0
    angle_front: float = 60.0
    theta_range: Tuple[float, float] = (0.0, 150.0)
    phi_range: Tuple[float, float] = (0.0, 360.0)
    backbone: str = "texture-mesh"          # or 'latent-nerf'
    nerf_type: str = "latent"               # 'latent' | 'rgb'
    batch_size: int = 1
    body_prob: float = 1.0                  # dual-camera body/head coin flip
    # volumetric renderer
    num_samples_per_ray: int = 128
    bound: float = 1.0                      # scene AABB half-extent
    # Field-MLP compute dtype: "auto" = bf16 on an accelerator / f32 on CPU,
    # or "float32"/"bfloat16" explicitly. Params stay f32 either way.
    # Pin "float32" for the reference allclose parity gate (PARITY.md).
    mlp_dtype: str = "auto"
    # NeRF→mesh extraction stage (scripts/train_latent_nerf_mesh.py)
    mc_resolution: int = 128                # marching-tets grid resolution
    iso_level: float = 10.0                 # density iso-surface threshold


@dataclasses.dataclass
class GuideConfig:
    """Guidance (reference GuideConfig, train_config.py:33-48, mesh :36-74)."""
    text: str = ""
    append_direction: bool = True
    shape_path: Optional[str] = None
    concept_name: Optional[str] = None
    diffusion_name: str = "sd-v1-4"
    model_dir: Optional[Path] = None        # converted SD weights dir
    tiny_diffusion: bool = False            # test/offline mode (mocked UNet)
    shape_scale: float = 0.6
    dy: float = 0.25
    proximal_surface: float = 0.3           # sketch-shape band (README:140-142)
    texture_resolution: int = 128
    texture_interpolation_mode: str = "bilinear"
    guidance_scale: float = 100.0
    num_inference_steps: int = 50
    image: Optional[Path] = None            # reference image (paint-mesh)
    # pretrained CLIP vision tower for the semantic CLIP losses (a
    # transformers CLIPVisionModelWithProjection checkpoint dir); without
    # it the use_clip tower is random-init (smoke-test only)
    clip_model_dir: Optional[Path] = None
    sampled_texture: Optional[Path] = None  # init texture (paint-mesh)
    use_sd: bool = True                     # StableDiffusion vs PaintByExample
    append_neg_text: bool = False
    negative_text: str = ""                 # CFG negative prompt
    # UNet weight/compute dtype policy: "auto" = bf16 on an accelerator / f32
    # elsewhere, or "float32"/"bfloat16" explicitly. The UNet is frozen
    # under SDS, so bf16 halves its weight traffic with no f32 master
    # needed. Pin
    # "float32" for the reference allclose parity gate (PARITY.md).
    unet_dtype: str = "auto"


@dataclasses.dataclass
class OptimConfig:
    """Optimization (reference OptimConfig, train_config.py:51-63,
    mesh :77-117)."""
    seed: int = 0
    iters: int = 5000
    lr: float = 1e-2
    disp_lr: float = 1e-4
    resume: bool = False
    ckpt: Optional[Path] = None
    min_step: float = 0.02
    max_step: float = 0.98
    lambda_shape: float = 5e-6
    lambda_laplacian: float = 100.0
    lambda_displacement: float = 10.0
    mode: int = 0                           # 0 Latent-Paint | 1 TADA | 2 SDEdit
    use_opt_txt: bool = False
    # PbE low-t CLIP branch (reference paint_by_example.py:658-664 via
    # trainer use_clip, latent_paint_mesh/training/trainer.py:384)
    use_clip: bool = False
    # volumetric extras
    lambda_sparsity: float = 5e-4
    lambda_opacity: float = 0.0
    start_shading_iter: Optional[int] = None
    check_nan: bool = False                 # per-step finite-loss guard
    # steps per device dispatch: >1 chains train steps in one program (the
    # JAX package's lax.scan trainer; the port replays one step captured in
    # a CUDA graph, Trainer.run_chunk and GraphedStep)
    train_chunk: int = 1


@dataclasses.dataclass
class LogConfig:
    """Logging / experiment layout (reference LogConfig,
    train_config.py:66-83)."""
    exp_name: str = "default"
    exp_root: Path = Path("experiments")
    save_interval: int = 100
    eval_size: int = 10
    full_eval_size: int = 100
    # poses per eval dispatch; bounds eval memory
    eval_batch: int = 5
    # write checkpoints on a background thread
    async_ckpt: bool = True
    save_mesh: bool = True
    max_keep_ckpts: int = 2
    eval_only: bool = False
    vis_train_prob: float = 0.05            # 5% train-render dumps
    log_images: bool = True
    # capture a profiler trace of steps [a, b) into <exp_dir>/trace
    # (SURVEY.md §5.1 — view in TensorBoard/XProf)
    trace_steps: Optional[Tuple[int, int]] = None

    @property
    def exp_dir(self) -> Path:
        return self.exp_root / self.exp_name


@dataclasses.dataclass
class DistConfig:
    """Device-mesh layout (new capability, SURVEY.md §2.7)."""
    data_axis: int = -1     # −1 = all devices on data; else explicit size
    rays_axis: int = 1


@dataclasses.dataclass
class TrainConfig:
    log: LogConfig = dataclasses.field(default_factory=LogConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    guide: GuideConfig = dataclasses.field(default_factory=GuideConfig)
    dist: DistConfig = dataclasses.field(default_factory=DistConfig)

    def __post_init__(self):
        # eval-only requires a checkpoint (reference train_config.py:94-97)
        if self.log.eval_only and not (self.optim.resume or self.optim.ckpt):
            self.optim.resume = True
