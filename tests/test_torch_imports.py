"""Rules the PyTorch port (tpunerf_torch) keeps: it loads neither JAX nor
the JAX package, its entry points run on the card unless told otherwise,
its trainer refuses what it cannot do yet, and its TrainConfig stays field
for field the JAX package's."""
import dataclasses
import pkgutil
import re
import subprocess
import sys
import typing
from pathlib import Path

import pytest
import torch

import tpunerf.training.config as jconfig
import tpunerf_torch
import tpunerf_torch.training.config as tconfig
from tpunerf_torch.fields.scene import LatentNeRFScene
from tpunerf_torch.guidance.schedulers import NoiseSchedule, ddim_timesteps
from tpunerf_torch.guidance.stable_diffusion import StableDiffusionGuidance
from tpunerf_torch.meshrep.textured_mesh import TexturedMeshScene
from tpunerf_torch.scripts.exp_hash_bwd import main as exp_hash_bwd_main
from tpunerf_torch.train_latent_nerf import main, split_device
from tpunerf_torch.train_latent_paint import main as paint_main
from tpunerf_torch.train_latent_nerf_mesh import main as bridge_main
from tpunerf_torch.train_latent_paint_mesh import main as mesh_main
from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
from tpunerf_torch.training.latent_paint import LatentPaintApp
from tpunerf_torch.training.trainer import Trainer, unported_settings

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "tpunerf_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        tpunerf_torch.__path__, "tpunerf_torch."))


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    mods = _modules()
    for m in ("train_latent_nerf", "train_latent_paint", "core.obj_io",
              "meshrep.uv_unwrap", "meshrep.textured_mesh", "guidance.vae",
              "kernels.rasterize", "kernels.texture",
              "training.latent_paint", "train_latent_paint_mesh",
              "training.latent_paint_mesh", "meshrep.laplacian",
              "meshrep.displacement_mlp", "scripts.exp_hash_bwd",
              "profiling", "training.trainer", "train_latent_nerf_mesh",
              "fields.sketch_shape", "fields.marching", "native"):
        assert f"tpunerf_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'tpunerf' or "
            "m.startswith('tpunerf.'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_no_module_names_jax_or_the_jax_package():
    pat = re.compile(r"\bimport jax\b|\bfrom jax\b|\btpunerf\.|"
                     r"\bimport tpunerf\b|\bfrom tpunerf\b")
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pat.search(p.read_text())]
    assert not offenders


def test_kernels_are_cuda_sources_of_the_package():
    names = sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    assert names == ["attention.cu", "attention_bwd.cu", "hashgrid.cu",
                     "occgrid.cu", "rasterize.cu"]
    bwd = (PKG / "csrc" / "attention_bwd.cu").read_text()
    for symbol in ("attention_bwd_dkv", "attention_bwd_dq", "mma.sync",
                   "wgmma_rs", "attention_bwd_dkv_mma", "attention_bwd_dq_mma",
                   "cp_async_arrive"):
        assert symbol in bwd, symbol
    # #12 and #13 in one wgmma kernel (bf16 at padded head dims 48 and 64),
    # on mma.sync (bf16 at 128, and the earlier design, timed only) and on
    # the CUDA cores (f32); no float atomics
    assert bwd.count("__global__") == 5 and "atomicAdd" not in bwd
    raster = (PKG / "csrc" / "rasterize.cu").read_text()
    for symbol in ("select_faces_dense", "select_faces_binned",
                   "soft_fwd_dense", "soft_fwd_binned", "soft_bwd_dense",
                   "soft_bwd_binned", "expf(", "__fmul_rn", "__fadd_rn",
                   "soft_fwd_dense_sweep", "soft_fwd_binned_sweep",
                   "soft_fwd_dense_tile_kernel", "select_faces_dense_sweep",
                   "select_faces_binned_sweep", "face_out",
                   "soft_bwd_binned_sweep", "soft_bwd_faces", "warp_sum8",
                   "soft_bwd_dense_sweep", "soft_bwd_dense_tiles_kernel"):
        assert symbol in raster, symbol
    # 3 culled selection, 2 all-pairs selection (timed only), 3 culled soft
    # forward, 2 all-pairs soft forward (timed only), the culled dense soft
    # backward and its first pass, the first dense one (timed only), the
    # culled binned one and its face sum, the first binned one (timed only)
    assert raster.count("__global__") == 16 and "__expf" not in raster
    occ = (PKG / "csrc" / "occgrid.cu").read_text()
    for symbol in ("occgrid_lookup", "occgrid_lookup_scalar", "float4",
                   "__fmul_rn", "__fdiv_rn", "kPow2"):
        assert symbol in occ, symbol
    # the 4-wide lookup (one template), the first design (timed only)
    assert occ.count("__global__") == 2
    assert "use_fast_math" not in " ".join(
        __import__("tpunerf_torch.kernels._build",
                   fromlist=["NVCC_FLAGS"]).NVCC_FLAGS)
    for p in (PKG / "csrc").glob("*.cu"):
        text = p.read_text()
        assert "Replaces" in text and "bound" in text, p.name
    # no library kernel stands in for a hand-written one
    pat = re.compile(r"scaled_dot_product_attention|torch\.compile|"
                     r"flash_attn|import triton")
    assert not [p.name for p in PKG.rglob("*.py") if pat.search(p.read_text())]


def _cfg(tmp_path, **log):
    base = dict(exp_root=tmp_path, eval_size=0, full_eval_size=0,
                save_mesh=False, log_images=False, save_interval=10 ** 6)
    base.update(log)
    return tconfig.TrainConfig(log=tconfig.LogConfig(**base),
                               guide=tconfig.GuideConfig(tiny_diffusion=True))


def test_entry_points_need_a_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LatentNeRFApp.create(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, app=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--guide.tiny_diffusion", "true"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LatentPaintApp.create(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paint_main(["--guide.tiny_diffusion", "true", "--guide.shape_path",
                    "sphere"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LatentPaintMeshApp.create(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_main(["--guide.tiny_diffusion", "true", "--guide.shape_path",
                   "sphere"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge_main(["--guide.tiny_diffusion", "true"])
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            exp_hash_bwd_main(argv + ["--n", "64"])


@pytest.mark.parametrize("create", [
    lambda: StableDiffusionGuidance.create(tiny=True),
    lambda: LatentNeRFScene.create(tiny=True),
    lambda: NoiseSchedule.scaled_linear(),
    lambda: TexturedMeshScene.create("sphere"),
    lambda: ddim_timesteps(50),
], ids=["guidance", "nerf_scene", "noise_schedule", "mesh_scene",
        "ddim_timesteps"])
def test_constructors_resolve_no_device_to_the_card(monkeypatch, create):
    """`device=None` means CUDA: here, without a card, each raises the
    `resolve_device` error instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create()


def test_constructors_build_on_a_named_device():
    assert NoiseSchedule.scaled_linear(device="cpu").betas.device.type == "cpu"
    scene = LatentNeRFScene.create(tiny=True, device="cpu")
    assert scene.occ_grid.device.type == "cpu"


@pytest.mark.parametrize("setting, item", [
    (dict(log=dict(eval_size=10)), None),
    (dict(log=dict(full_eval_size=100)), None),
    (dict(log=dict(save_mesh=True)), None),
    (dict(log=dict(log_images=True)), None),
    (dict(log=dict(save_interval=100)), None),
    (dict(log=dict(eval_only=True)), None),
    (dict(log=dict(trace_steps=(2, 4))), "A.4"),
    (dict(optim=dict(resume=True)), None),
    (dict(optim=dict(check_nan=True)), None),
    (dict(optim=dict(train_chunk=8)), "A.4"),
])
def test_trainer_refuses_what_slice_1_lacks(tmp_path, setting, item):
    """What slice 1 lacked is refused, naming the ROADMAP.md item that
    brings it, until that item lands; then it is accepted (for an app with
    an eval render)."""
    cfg = _cfg(tmp_path, **setting.get("log", {}))
    for k, v in setting.get("optim", {}).items():
        setattr(cfg.optim, k, v)
    if item is None or item in LANDED:
        assert not unported_settings(cfg, _EvalApp())
        return
    assert unported_settings(cfg, _EvalApp())
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md item {item}"):
        Trainer(cfg, app=_EvalApp(), device="cpu")


# the ROADMAP.md items of the parametrisation above that have landed
LANDED = {"A.4"}


class _EvalApp:
    def eval_render(self, views, dims):
        raise AssertionError("not called")


@pytest.mark.parametrize("setting,refused,without_eval", [
    (dict(eval_size=10), False, True), (dict(full_eval_size=100), False, True),
    (dict(save_mesh=True), False, True), (dict(log_images=True), False, False),
    (dict(save_interval=100), False, False),
    (dict(trace_steps=(2, 4)), False, False),
])
def test_apps_with_an_eval_render_get_the_eval_settings(tmp_path, setting,
                                                        refused,
                                                        without_eval):
    cfg = _cfg(tmp_path, **setting)
    assert bool(unported_settings(cfg, _EvalApp())) is refused
    # an app without one: the eval settings are refused too
    assert bool(unported_settings(cfg, None)) is without_eval


def test_paint_cli_trains_evaluates_and_exports_on_the_cpu(tmp_path):
    paint_main(["--device", "cpu", "--guide.tiny_diffusion", "true",
                "--guide.text", "a red fish", "--guide.shape_path",
                "icosphere", "--guide.texture_resolution", "16",
                "--optim.iters", "2", "--render.train_grid_size", "16",
                "--render.eval_grid_size", "16", "--log.exp_root",
                str(tmp_path), "--log.exp_name", "cli", "--log.eval_size",
                "1", "--log.full_eval_size", "2", "--log.log_images",
                "false", "--log.save_interval", "100"])
    exp = tmp_path / "cli"
    assert (exp / "vis" / "eval" / "step_000000_000_rgb.png").exists()
    assert (exp / "mesh" / "mesh.obj").exists()
    assert (exp / "vt.npy").exists()


def _schema(cls):
    hints = typing.get_type_hints(cls)
    out = {}
    for f in dataclasses.fields(cls):
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        tp = hints[f.name]
        out[f.name] = (_schema(tp) if dataclasses.is_dataclass(tp)
                       else (repr(tp), default))
    return out


def test_train_config_equals_the_jax_one_field_for_field():
    assert _schema(tconfig.TrainConfig) == _schema(jconfig.TrainConfig)
    assert tconfig.TrainConfig() == tconfig.TrainConfig()
    assert dataclasses.asdict(tconfig.TrainConfig()) == \
        dataclasses.asdict(jconfig.TrainConfig())


def test_cli_device_flag_stays_out_of_the_config():
    assert split_device(["--device", "cpu", "--optim.iters", "3"]) == \
        ("cpu", ["--optim.iters", "3"])
    assert split_device(["--device=cuda:1"]) == ("cuda:1", [])
    assert split_device(["--log.exp_name", "x"]) == (None,
                                                     ["--log.exp_name", "x"])


def test_cli_trains_the_tiny_app_on_the_cpu(tmp_path):
    main(["--config_path",
          str(ROOT / "demo_configs" / "latent_nerf" / "sand_castle.yaml"),
          "--device", "cpu", "--guide.tiny_diffusion", "true",
          "--optim.iters", "2", "--render.train_grid_size", "8",
          "--render.num_samples_per_ray", "16", "--log.exp_root",
          str(tmp_path), "--log.eval_size", "0", "--log.full_eval_size",
          "0", "--log.save_mesh", "false", "--log.log_images", "false",
          "--log.save_interval", "100"])
    assert (tmp_path / "sand_castle" / "config.yaml").exists()
    assert (tmp_path / "sand_castle" / "log.txt").exists()


def test_cli_trains_the_tiny_app_with_the_default_log_settings(tmp_path):
    """sand_castle.yaml with no log override but sizes: checkpoints, eval
    and result frames, train images, the mesh export logged as skipped
    (the tiny random field has no surface at iso 10)."""
    main(["--config_path",
          str(ROOT / "demo_configs" / "latent_nerf" / "sand_castle.yaml"),
          "--device", "cpu", "--guide.tiny_diffusion", "true",
          "--optim.iters", "6", "--render.train_grid_size", "8",
          "--render.num_samples_per_ray", "16", "--render.eval_grid_size",
          "16", "--log.exp_root", str(tmp_path), "--log.save_interval", "2",
          "--log.eval_size", "2", "--log.full_eval_size", "3",
          "--log.eval_batch", "2", "--log.vis_train_prob", "0.5"])
    exp = tmp_path / "sand_castle"
    assert sorted(p.name for p in (exp / "checkpoints").iterdir()) == [
        "step_000004.ckpt", "step_000006.ckpt"]
    evals = sorted(p.name for p in (exp / "vis" / "eval").iterdir())
    assert evals == [f"step_{s:06d}_{i:03d}_rgb.png" for s in (0, 2, 4, 6)
                     for i in range(2)]
    assert list((exp / "results").iterdir())
    assert list((exp / "vis" / "train").glob("step_*.png"))
    assert "mesh export skipped: no surface at isolevel" in (
        exp / "log.txt").read_text()
    assert not (exp / "mesh").exists() or not any((exp / "mesh").iterdir())
