"""The port's trainer around the step, with tiny apps on the CPU: a
latent-NeRF run with the default log settings (scaled down) writes the
artifacts a JAX Trainer run of the same config writes; a resumed run
restores scene, Adam state and step bit for bit and then steps as the
unbroken run does; a model-only load keeps Adam fresh; the NaN guard saves
the last good parameters and keeps the original error; a failing image
write fails the run only after every write is joined; `--log.eval_only`
through each CLI writes frames and takes no step; latent-paint and mode 0
of latent-paint-mesh save and resume through the same trainer."""
import threading
import time

import numpy as np
import pytest
import torch

from tpunerf.core.config import parse as jparse
from tpunerf.training import config as jconfig
from tpunerf.training.latent_nerf_app import LatentNeRFApp as JApp
from tpunerf.training.trainer import Trainer as JTrainer
from tpunerf_torch import (train_latent_nerf, train_latent_paint,
                           train_latent_paint_mesh)
from tpunerf_torch.core.config import parse
from tpunerf_torch.core.views import rand_poses
from tpunerf_torch.guidance.stable_diffusion import StableDiffusionGuidance
from tpunerf_torch.training import checkpoints as tck
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
from tpunerf_torch.training.latent_paint import LatentPaintApp
from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
from tpunerf_torch.training.trainer import Trainer

CPU = torch.device("cpu")
SAND_CASTLE = "demo_configs/latent_nerf/sand_castle.yaml"
# sand_castle.yaml's log settings are the defaults; only sizes are cut
TINY_NERF = ["--config_path", SAND_CASTLE, "--guide.tiny_diffusion", "true",
             "--render.train_grid_size", "8",
             "--render.num_samples_per_ray", "16",
             "--render.eval_grid_size", "16"]
SCALED_LOG = ["--optim.iters", "6", "--log.save_interval", "2",
              "--log.eval_size", "2", "--log.full_eval_size", "3",
              "--log.eval_batch", "2", "--log.vis_train_prob", "0.5"]
QUIET = ["--log.eval_size", "0", "--log.full_eval_size", "0",
         "--log.save_mesh", "false", "--log.log_images", "false"]
TINY_PAINT = ["--guide.tiny_diffusion", "true", "--guide.text", "a red fish",
              "--guide.shape_path", "icosphere",
              "--guide.texture_resolution", "16",
              "--render.train_grid_size", "16",
              "--render.eval_grid_size", "16"]


@pytest.fixture(scope="module")
def guidance():
    return StableDiffusionGuidance.create(tiny=True, unet_dtype="float32",
                                          device=CPU)


def _artifacts(exp):
    """Files under an experiment, JPEG named as PNG, without the mesh
    export (ROADMAP.md item A.7) and the metric rows (none in 6 steps)."""
    return sorted(str(p.relative_to(exp)).replace(".jpg", ".png")
                  for p in exp.rglob("*") if p.is_file()
                  and p.relative_to(exp).parts[0] != "mesh"
                  and p.name != "metrics.jsonl")


def test_default_log_settings_write_what_jax_writes(tmp_path,
                                                    tiny_sd_guidance):
    args = TINY_NERF + SCALED_LOG + ["--log.exp_root", str(tmp_path)]
    train_latent_nerf.main(args + ["--device", "cpu", "--log.exp_name",
                                   "torch"])
    jcfg = jparse(jconfig.TrainConfig, args + ["--log.exp_name", "jax"])
    jcfg.render.backbone = "latent-nerf"
    JTrainer(jcfg, JApp.create(jcfg, guidance=tiny_sd_guidance)).train()
    got, want = _artifacts(tmp_path / "torch"), _artifacts(tmp_path / "jax")
    assert got == want
    # kept checkpoints, eval frames before step 1 and after each save, and
    # train images on the steps JAX picks (the same draws)
    assert [a for a in got if a.startswith("checkpoints")] == [
        "checkpoints/step_000004.ckpt", "checkpoints/step_000006.ckpt"]
    assert sum(a.startswith("vis/eval") for a in got) == 8
    assert any(a.startswith("vis/train") for a in got)
    assert any(a.startswith("results/step_000006") for a in got)
    assert "mesh export skipped" in (tmp_path / "torch" / "log.txt"
                                     ).read_text()


def _nerf_cfg(tmp_path, *extra):
    return parse(TrainConfig, TINY_NERF + QUIET + [
        "--render.mlp_dtype", "float32", "--guide.unet_dtype", "float32",
        "--log.exp_root", str(tmp_path), "--log.exp_name", "run",
        "--optim.iters", "4", "--log.save_interval", "2", *extra])


def _opt_tensors(opt):
    return [(i, k, v) for i, st in sorted(opt.state_dict()["state"].items())
            for k, v in sorted(st.items())]


def _assert_same_state(a: Trainer, b: Trainer):
    sa, sb = a.app.state_dict(), b.app.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = _opt_tensors(a.optimizer), _opt_tensors(b.optimizer)
    assert [x[:2] for x in oa] == [x[:2] for x in ob] and oa
    assert all(torch.equal(x[2], y[2]) for x, y in zip(oa, ob))


def _injected_step(trainer, seed):
    """One Adam step with the draws made here, not by the generator."""
    gen = torch.Generator().manual_seed(seed)
    views = rand_poses(1, trainer.view_cfg, CPU, generator=gen)
    u = torch.rand((1, 64, 16), generator=gen)          # 8² rays, S = 16
    noise = torch.randn((1, 8, 8, 4), generator=gen)
    trainer.optimizer.zero_grad(set_to_none=True)
    loss, _ = trainer.app.loss_fn(views, u=u, t=torch.tensor(500),
                                  noise=noise)
    loss.backward()
    trainer.optimizer.step()


def test_resume_restores_everything_bit_for_bit(tmp_path, guidance):
    cfg = _nerf_cfg(tmp_path)
    unbroken = Trainer(cfg, LatentNeRFApp.create(cfg, guidance, CPU), CPU)
    unbroken.train()
    assert [p.name for p in unbroken.ckpts.existing()] == [
        "step_000002.ckpt", "step_000004.ckpt"]
    saved, _, _ = unbroken.ckpts.load()
    live = unbroken.app.state_dict()
    assert all(torch.equal(saved[k], live[k]) for k in live)

    rcfg = _nerf_cfg(tmp_path, "--optim.resume", "true")
    resumed = Trainer(rcfg, LatentNeRFApp.create(rcfg, guidance, CPU), CPU)
    assert resumed.train_step_idx == 4
    _assert_same_state(unbroken, resumed)
    for tr in (unbroken, resumed):
        _injected_step(tr, 7)
    _assert_same_state(unbroken, resumed)


def test_a_model_only_load_keeps_adam_fresh(tmp_path, guidance):
    cfg = _nerf_cfg(tmp_path)
    Trainer(cfg, LatentNeRFApp.create(cfg, guidance, CPU), CPU).train()
    path = tmp_path / "run" / "checkpoints" / "step_000002.ckpt"
    mcfg = _nerf_cfg(tmp_path, "--log.exp_name", "model_only",
                     "--optim.ckpt", str(path))
    tr = Trainer(mcfg, LatentNeRFApp.create(mcfg, guidance, CPU), CPU)
    assert tr.train_step_idx == 0 and not tr.optimizer.state
    params, _, _ = tck.CheckpointManager(path.parent).load(path)
    live = tr.app.state_dict()
    assert all(torch.equal(params[k], live[k]) for k in live)


class _SmallApp:
    """Two parameters under SGD(lr = 1) on Σw² + 1 (each step negates w);
    the loss is NaN from call `nan_at` on."""

    def __init__(self, nan_at=None):
        self.w = torch.nn.Parameter(torch.zeros(2))
        self.nan_at, self.calls = nan_at, 0

    def init_params(self, generator=None):
        with torch.no_grad():
            self.w.copy_(torch.tensor([0.5, -1.0]))

    def make_optimizer(self):
        return torch.optim.SGD([self.w], lr=1.0)

    def loss_fn(self, views, generator=None):
        self.calls += 1
        loss = (self.w ** 2).sum() + 1.0
        if self.nan_at is not None and self.calls >= self.nan_at:
            loss = loss * float("nan")
        return loss, {}

    def eval_render(self, views, dims):
        return {"image": torch.full((views.batch_size, *dims, 3), 0.5)}

    def export(self, path):
        raise NotImplementedError("no mesh")

    def state_dict(self):
        return {"w": self.w.detach()}

    def load_state_dict(self, state):
        with torch.no_grad():
            self.w.copy_(state["w"])

    def migrate_params(self, params):
        return params


def _small_cfg(tmp_path, **log):
    cfg = parse(TrainConfig, QUIET + ["--log.exp_root", str(tmp_path),
                                      "--optim.iters", "10",
                                      "--log.save_interval", "2"])
    for k, v in log.items():
        setattr(cfg.log, k, v)
    return cfg


@pytest.mark.parametrize("writer", ["ok", "failed"])
def test_nan_guard_saves_the_last_good_params(tmp_path, monkeypatch, writer):
    cfg = _small_cfg(tmp_path)
    cfg.optim.check_nan = True
    failure = OSError("checkpoint disk full")
    if writer == "failed":
        real = tck._write_atomic

        def broken_steps(path, state):
            if path.name.startswith("step_"):
                raise failure
            real(path, state)

        monkeypatch.setattr(tck, "_write_atomic", broken_steps)
    tr = Trainer(cfg, _SmallApp(nan_at=3), CPU)
    with pytest.raises(FloatingPointError, match="step 3") as info:
        tr.train()
    # the asynchronous save of step 2 failed first: kept as the cause
    assert info.value.__cause__ is (failure if writer == "failed" else None)
    params, _, nxt = tr.ckpts.load(tr.ckpt_dir / "nan_debug.ckpt")
    assert nxt == 3 and params["w"].tolist() == [0.5, -1.0]   # step 2's
    assert [p.name for p in tr.ckpts.existing()] == (
        ["step_000002.ckpt"] if writer == "ok" else [])


def test_a_failing_image_write_fails_the_run_after_every_write(
        tmp_path, monkeypatch):
    def save(path, img):
        if path.name.endswith("_000_rgb.png"):
            raise OSError("bad png")
        time.sleep(0.3)
        path.write_bytes(b"png")

    monkeypatch.setattr(Trainer, "_save_image", staticmethod(save))
    cfg = _small_cfg(tmp_path, eval_size=4, eval_batch=4, save_interval=100)
    cfg.optim.iters = 2
    cfg.render.eval_grid_size = 8
    tr = Trainer(cfg, _SmallApp(), CPU)
    # another trainer's pool (the JAX package's is never shut down) may live
    before = set(threading.enumerate())
    with pytest.raises(OSError, match="bad png"):
        tr.train()
    written = sorted(p.name for p in tr.eval_vis_dir.iterdir())
    assert written == [f"step_000000_{i:03d}_rgb.png" for i in (1, 2, 3)]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("imgio") and t not in before]


CLIS = {
    "latent_nerf": (train_latent_nerf, TINY_NERF),
    "latent_paint": (train_latent_paint, TINY_PAINT),
    "latent_paint_mesh": (train_latent_paint_mesh,
                          TINY_PAINT + ["--optim.mode", "0"]),
}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_eval_only_writes_frames_and_takes_no_step(tmp_path, monkeypatch,
                                                   name):
    cli, args = CLIS[name]
    base = args + ["--device", "cpu", "--log.exp_root", str(tmp_path),
                   "--log.exp_name", name]
    cli.main(base + QUIET + ["--optim.iters", "2",
                             "--log.save_interval", "2"])
    ckpts = sorted((tmp_path / name / "checkpoints").iterdir())
    assert [p.name for p in ckpts] == ["step_000002.ckpt"]

    def no_step(self):
        raise AssertionError("eval_only took a step")

    monkeypatch.setattr(Trainer, "train_step", no_step)
    cli.main(base + ["--log.eval_only", "true", "--log.full_eval_size", "2",
                     "--log.eval_batch", "2", "--log.save_mesh", "false"])
    assert sorted((tmp_path / name / "checkpoints").iterdir()) == ckpts
    results = [p.name for p in (tmp_path / name / "results").iterdir()]
    assert results and all(r.startswith("step_000002") for r in results)


@pytest.mark.parametrize("app_cls", [LatentPaintApp, LatentPaintMeshApp],
                         ids=["latent_paint", "latent_paint_mesh_mode0"])
def test_paint_apps_save_and_resume(tmp_path, guidance, app_cls):
    extra = ["--render.body_prob", "0.7"] if app_cls is LatentPaintMeshApp \
        else []
    argv = TINY_PAINT + QUIET + extra + [
        "--log.exp_root", str(tmp_path), "--optim.iters", "2",
        "--log.save_interval", "2", "--log.async_ckpt", "false"]
    cfg = parse(TrainConfig, argv)
    first = Trainer(cfg, app_cls.create(cfg, guidance, device=CPU), CPU)
    first.train()
    rcfg = parse(TrainConfig, argv + ["--optim.resume", "true"])
    app = app_cls.create(rcfg, guidance, device=CPU)
    state = app.state_dict()
    assert app.migrate_params(state) is state       # latent mode: as is
    resumed = Trainer(rcfg, app, CPU)
    assert resumed.train_step_idx == 2
    _assert_same_state(first, resumed)
    assert len(resumed.optimizer.param_groups) == len(
        first.optimizer.param_groups)
    assert np.isfinite(resumed.app.state_dict()["texture_img"].numpy()).all()
