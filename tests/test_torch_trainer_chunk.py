"""The port's chunked trainer (`optim.train_chunk > 1`) and profiler traces
(`log.trace_steps`) on the CPU, with tiny apps: a chunk runs the eager step
k times there, so chunked and eager runs end in the same state bit for bit
(latent-NeRF over occupancy refreshes, latent-paint); chunks are clipped at
`log.save_interval` and `optim.iters`, and checkpoints, evals, train
images and metric rows land on the steps (and under the names) that the JAX
package's chunked trainer writes; the NaN guard reads a chunk's losses and
saves its start; a trace is written in eager and chunked runs and stopped on
an out-of-range bound and on a raised step; latent-paint-mesh refuses
chunks by name; and the step that a card captures (loss and backward) reads
nothing back to the host."""
import collections
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpunerf.training import config as jconfig
from tpunerf.training.latent_paint import LatentPaintApp as JPaint
from tpunerf.training.trainer import Trainer as JTrainer
from tpunerf_torch.guidance.stable_diffusion import StableDiffusionGuidance
from tpunerf_torch import profiling
from tpunerf_torch.profiling import TRACE_FILE
from tpunerf_torch.training import config as tconfig
from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
from tpunerf_torch.training.latent_paint import LatentPaintApp
from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
from tpunerf_torch.training import trainer as trainer_mod
from tpunerf_torch.training.trainer import Trainer, unported_settings

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def guidance():
    return StableDiffusionGuidance.create(tiny=True, unet_dtype="float32",
                                          device=CPU)


def _log(mod, tmp_path, name, **over):
    base = dict(exp_name=name, exp_root=tmp_path, save_interval=4,
                eval_size=0, full_eval_size=0, vis_train_prob=0.0,
                save_mesh=False)
    base.update(over)
    return mod.LogConfig(**base)


def _nerf_cfg(tmp_path, name, log=None, **optim):
    base = dict(iters=6, seed=0, lr=1e-2)
    base.update(optim)
    return tconfig.TrainConfig(
        log=_log(tconfig, tmp_path, name, **(log or {})),
        render=tconfig.RenderConfig(train_grid_size=8, eval_grid_size=16,
                                    num_samples_per_ray=16,
                                    mlp_dtype="float32"),
        optim=tconfig.OptimConfig(**base),
        guide=tconfig.GuideConfig(text="a sand castle", tiny_diffusion=True,
                                  unet_dtype="float32"))


def _paint_cfg(mod, tmp_path, name, log=None, **optim):
    base = dict(iters=6, seed=0, lr=1e-2)
    base.update(optim)
    return mod.TrainConfig(
        log=_log(mod, tmp_path, name, **(log or {})),
        render=mod.RenderConfig(train_grid_size=16, eval_grid_size=16),
        optim=mod.OptimConfig(**base),
        guide=mod.GuideConfig(text="a red fish", shape_path="icosphere",
                              tiny_diffusion=True, texture_resolution=16,
                              unet_dtype="float32"))


def _nerf(cfg, guidance, refresh_every=None):
    app = LatentNeRFApp.create(cfg, guidance=guidance, device="cpu")
    if refresh_every:
        app.scene.occ_update_interval = refresh_every
    return Trainer(cfg, app, device="cpu")


def _assert_same_run(a: Trainer, b: Trainer):
    """Scene state, Adam state and the generator equal bit for bit."""
    sa, sb = a.app.state_dict(), b.app.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()[
        "state"]
    assert oa.keys() == ob.keys() and oa
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.train_step_idx == b.train_step_idx


def test_chunked_equals_eager_bit_for_bit_nerf(tmp_path, guidance):
    """train_chunk 4 against eager, refreshes every 2 steps (at 1, 2, 4,
    6: inside and at the end of chunks); chunks of 4 then 2."""
    eager = _nerf(_nerf_cfg(tmp_path, "eager"), guidance, 2)
    chunked = _nerf(_nerf_cfg(tmp_path, "chunk", train_chunk=4), guidance, 2)
    seen = []
    eager.train()
    chunked.train(on_step=lambda step, loss: seen.append(step))
    _assert_same_run(eager, chunked)
    assert seen == [1, 2, 3, 4, 5, 6] and chunked.train_step_idx == 6


def test_chunked_equals_eager_bit_for_bit_paint(tmp_path, guidance):
    def run(name, **optim):
        cfg = _paint_cfg(tconfig, tmp_path, name, **optim)
        app = LatentPaintApp.create(cfg, guidance=guidance, device="cpu")
        trainer = Trainer(cfg, app, device="cpu")
        trainer.train()
        return trainer
    _assert_same_run(run("eager"), run("chunk", train_chunk=3))


@pytest.mark.parametrize("train_chunk, lengths", [
    (32, [4, 4, 2]), (3, [3, 1, 3, 1, 2]), (1, [1] * 10)],
    ids=["chunk32", "chunk3", "eager"])
def test_chunk_lengths_clip_at_save_interval_and_iters(tmp_path, guidance,
                                                       train_chunk, lengths):
    """The loop's chunks and checkpoints (the steps themselves stood in
    for: the tests above run them)."""
    trainer = _nerf(_nerf_cfg(tmp_path, f"c{train_chunk}", iters=10,
                              train_chunk=train_chunk), guidance)
    ran = []

    def run_chunk(k):
        ran.append(k)
        trainer.train_step_idx += k
        return torch.zeros(k), {}

    trainer.run_chunk = run_chunk
    trainer.train()
    assert ran == lengths and trainer.train_step_idx == 10
    ckpts = sorted(p.name for p in trainer.ckpt_dir.glob("step_*.ckpt"))
    assert ckpts == ["step_000004.ckpt", "step_000008.ckpt"]


def _artifacts(exp):
    """Files of a run, JPEG named as PNG, without the mesh export."""
    return sorted(str(p.relative_to(exp)).replace(".jpg", ".png")
                  for p in exp.rglob("*") if p.is_file()
                  and p.relative_to(exp).parts[0] != "mesh"
                  and p.name not in ("metrics.jsonl", "log.txt"))


def _rows(exp):
    return [json.loads(line)["step"]
            for line in (exp / "metrics.jsonl").read_text().splitlines()]


def test_chunked_cadence_writes_what_the_jax_chunked_trainer_writes(
        tmp_path, tiny_sd_guidance, guidance):
    """Both packages' chunked trainers over 120 steps, train_chunk 32
    clipped at save_interval 40 (chunks 32, 8, 32, 8, 32, 8), with the
    steps stood in for on both sides (the tests above hold the steps; this
    one holds the loop around them): the same checkpoint files (80 and 120
    kept), evals on the same steps, train images on the same steps (p =
    0.5, one draw a chunk, the same generator) and metric rows after the
    chunks that cross 50 and 100 (at 72 and 112)."""
    log = dict(save_interval=40, vis_train_prob=0.5)
    image = np.zeros((1, 16, 16, 3), np.float32)
    evals = {}

    def stub_evaluate(name):
        def evaluate(step, size, *args, **kwargs):
            evals.setdefault(name, []).append(step)
        return evaluate

    jcfg = _paint_cfg(jconfig, tmp_path, "jax", log, iters=120,
                      train_chunk=32)
    jtrainer = JTrainer(jcfg, JPaint.create(jcfg, guidance=tiny_sd_guidance))

    def jax_chunk(k):
        def run(params, opt_state, key, step0):
            zeros = np.zeros(k, np.float32)
            return params, opt_state, key, zeros, zeros, {"image": image}
        return run

    jtrainer._build_train_chunk = jax_chunk
    jtrainer.evaluate = stub_evaluate("jax")
    jtrainer.train()

    cfg = _paint_cfg(tconfig, tmp_path, "torch", log, iters=120,
                     train_chunk=32)
    trainer = Trainer(cfg, LatentPaintApp.create(cfg, guidance=guidance,
                                                 device="cpu"), device="cpu")
    ran = []

    def run_chunk(k):
        ran.append(k)
        trainer.train_step_idx += k
        return torch.zeros(k), {"image": torch.from_numpy(image)}

    trainer.run_chunk = run_chunk
    trainer.evaluate = stub_evaluate("torch")
    trainer.train()
    got, want = _artifacts(tmp_path / "torch"), _artifacts(tmp_path / "jax")
    assert got == want
    assert ran == [32, 8, 32, 8, 32, 8]
    assert [a for a in got if a.startswith("checkpoints")] == [
        "checkpoints/step_000080.ckpt", "checkpoints/step_000120.ckpt"]
    assert any(a.startswith("vis/train/") for a in got)
    assert evals["torch"] == evals["jax"] == [0, 40, 80, 120, 120]
    assert _rows(tmp_path / "torch") == _rows(tmp_path / "jax") == [72, 112]


def test_metric_row_grad_norm_is_the_last_steps(tmp_path, guidance,
                                                monkeypatch):
    """A metric row every 2 steps: the eager run's rows (steps 2 and 4) and
    the chunked run's (step 4, after its chunk of 4) carry the gradient
    norm of their last step, computed only for the row: equal bit for bit
    at step 4, and the norm of the gradients that step left."""
    monkeypatch.setattr(trainer_mod, "METRIC_INTERVAL", 2)
    runs = {}
    for name, chunk in (("eager", 1), ("chunk", 4)):
        trainer = _nerf(_nerf_cfg(tmp_path, f"rows_{name}", iters=4,
                                  train_chunk=chunk), guidance)
        trainer.train()
        runs[name] = (trainer, [json.loads(line) for line in (
            trainer.exp_dir / "metrics.jsonl").read_text().splitlines()])
    eager, chunk = runs["eager"][1], runs["chunk"][1]
    assert [r["step"] for r in eager] == [2, 4]
    assert [r["step"] for r in chunk] == [4]
    assert eager[-1]["grad_norm"] == chunk[-1]["grad_norm"] > 0
    assert chunk[-1]["grad_norm"] == runs["chunk"][0].grad_norm().item()


def test_chunked_nan_guard_saves_the_chunk_start(tmp_path, guidance):
    """lr 1e30 poisons the second step: the guard reads the chunk's four
    losses, saves the parameters of the chunk's start (step 0) as
    nan_debug and names the step and the way to localise it."""
    trainer = _nerf(_nerf_cfg(tmp_path, "nan", train_chunk=4,
                              check_nan=True, lr=1e30), guidance)
    start = {k: v.clone() for k, v in trainer.app.state_dict().items()}
    with pytest.raises(FloatingPointError,
                       match=r"non-finite loss at step 2 \(chunk-start "
                             r"params saved to .*nan_debug.*train_chunk 1"):
        trainer.train()
    saved = torch.load(trainer.ckpt_dir / "nan_debug.ckpt",
                       weights_only=True)
    assert saved["train_step"] == 0
    assert all(torch.equal(saved["params"][k], v) for k, v in start.items())
    assert trainer.train_step_idx == 4


@pytest.mark.parametrize("train_chunk", [1, 4], ids=["eager", "chunked"])
def test_trace_steps_writes_a_trace_and_stops_past_the_run(
        tmp_path, guidance, train_chunk):
    """trace_steps [2, 100) past iters 6: the trace is opened before step
    2 (before the chunk holding it), closed at the end of the run, and
    holds the steps' operations."""
    trainer = _nerf(_nerf_cfg(tmp_path, f"t{train_chunk}", iters=6,
                              train_chunk=train_chunk,
                              log=dict(trace_steps=(2, 100))), guidance)
    opened = []
    real = trainer.run_chunk
    trainer.run_chunk = lambda k: (opened.append(
        (trainer.train_step_idx, trainer._trace is not None)), real(k))[1]
    trainer.train()
    first = 1 if train_chunk == 1 else 0
    assert [s for s, on in opened if on][0] == first
    assert trainer._trace is None
    events = json.loads((trainer.exp_dir / "trace" / TRACE_FILE
                         ).read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name")) for e in events)
    assert "profiler trace written" in (trainer.exp_dir / "log.txt"
                                        ).read_text()


def test_trace_steps_window_closes_at_its_bound(tmp_path, guidance):
    """Eager: [3, 5) traces steps 3 and 4 and closes before step 5."""
    trainer = _nerf(_nerf_cfg(tmp_path, "w", iters=6,
                              log=dict(trace_steps=(3, 5))), guidance)
    on = []
    real = trainer.run_chunk
    trainer.run_chunk = lambda k: (on.append(trainer._trace is not None),
                                   real(k))[1]
    trainer.train()
    assert on == [False, False, True, True, False, False]
    assert (trainer.exp_dir / "trace" / TRACE_FILE).exists()


def test_trace_stops_when_a_step_raises(tmp_path, guidance):
    trainer = _nerf(_nerf_cfg(tmp_path, "nan_trace", train_chunk=2,
                              check_nan=True, lr=1e30,
                              log=dict(trace_steps=(1, 100))), guidance)
    with pytest.raises(FloatingPointError):
        trainer.train()
    assert trainer._trace is None
    assert (trainer.exp_dir / "trace" / TRACE_FILE).exists()


def test_profiling_helpers_trace_annotate_and_time(tmp_path):
    """`trace` writes a Chrome trace holding an `annotate` range; the
    phase timer keeps a mean a phase."""
    timer = profiling.PhaseTimer()
    with profiling.trace(tmp_path):
        with profiling.annotate("phase under test"):
            for _ in range(2):
                with timer.phase("matmul"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name") == "phase under test" for e in events)
    assert timer.counts["matmul"] == 2
    assert 0 < timer.summary()["matmul"] <= timer.totals["matmul"]


def test_paint_mesh_refuses_chunks_by_name(tmp_path, guidance):
    cfg = _paint_cfg(tconfig, tmp_path, "mesh", train_chunk=2)
    cfg.log.eval_size = cfg.log.full_eval_size = 0
    app = LatentPaintMeshApp.create(cfg, guidance=guidance, device="cpu")
    missing = unported_settings(cfg, app)
    assert len(missing) == 1 and "latent-paint-mesh" in missing[0] \
        and "ROADMAP.md item A.12" in missing[0]
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A.12"):
        Trainer(cfg, app, device="cpu")
    cfg.optim.train_chunk = 1
    assert not unported_settings(cfg, app)


# what a CUDA graph's capture refuses: reading a device value on the host
_HOST_READS = {"_local_scalar_dense", "item", "is_nonzero", "nonzero",
               "masked_select", "unique", "_unique2", "unique_dim",
               "equal", "allclose"}


class _HostReads(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _HOST_READS:
            self.seen[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("app_kind, nerf_type", [
    ("nerf", "latent"), ("nerf", "rgb"), ("paint", "latent"),
    ("paint", "rgb"), ("nerf+shape", "latent")])
def test_captured_step_reads_nothing_back(tmp_path, guidance, app_kind,
                                          nerf_type):
    """The loss and backward of the step that the trainer captures, as the
    CPU runs them: no value goes back to the host (the card's Adam is
    capturable; the CPU's reads its step count, so it is left out).
    "nerf+shape" adds the sketch-shape loss (eval config #3's step)."""
    g = dataclasses.replace(guidance, latent_mode=nerf_type == "latent")
    if app_kind.startswith("nerf"):
        cfg = _nerf_cfg(tmp_path, app_kind + nerf_type)
        cfg.render.nerf_type = nerf_type
        if app_kind == "nerf+shape":
            cfg.guide.shape_path = "icosphere"
            cfg.optim.lambda_shape = 1.0
        app = LatentNeRFApp.create(cfg, guidance=g, device="cpu")
        assert (app.scene.sdf is not None) == (app_kind == "nerf+shape")
    else:
        cfg = _paint_cfg(tconfig, tmp_path, app_kind + nerf_type)
        cfg.render.nerf_type = nerf_type
        app = LatentPaintApp.create(cfg, guidance=g, device="cpu")
    trainer = Trainer(cfg, app, device="cpu")
    trainer.optimizer.step = lambda: None
    trainer.step_body()                  # lazy set-up outside the probe
    trainer.optimizer.zero_grad(set_to_none=True)
    with _HostReads() as probe:
        loss, aux = trainer.step_body()
        gnorm = trainer.grad_norm()
    assert not probe.seen, dict(probe.seen)
    assert np.isfinite(loss.item()) and gnorm.item() > 0
    if app_kind == "nerf+shape":
        assert aux["shape_loss"].item() > 0
