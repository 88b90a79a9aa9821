"""The port's chunked trainer (`optim.train_chunk > 1`) and profiler traces
(`log.trace_steps`) on the CPU, with tiny apps: a chunk runs the eager step
k times there, so chunked and eager runs end in the same state bit for bit
(latent-NeRF over occupancy refreshes, latent-paint, latent-paint-mesh in
each mode and with each backend); chunks are clipped at
`log.save_interval` and `optim.iters`, and checkpoints, evals, train
images and metric rows land on the steps (and under the names) that the JAX
package's chunked trainer writes (latent-paint's and latent-paint-mesh's);
the NaN guard reads a chunk's losses and saves its start; a trace is
written in eager and chunked runs and stopped on an out-of-range bound and
on a raised step; and the step that a card captures (loss and backward)
reads nothing back to the host and uploads nothing from it."""
import collections
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_port import one_torch_thread  # noqa: F401
from tpunerf.training import config as jconfig
from tpunerf.training.latent_paint import LatentPaintApp as JPaint
from tpunerf.training.latent_paint_mesh import LatentPaintMeshApp as JMesh
from tpunerf.training.trainer import Trainer as JTrainer
from tpunerf_torch.guidance.depth import StableDiffusionDepthGuidance
from tpunerf_torch.guidance.paint_by_example import PaintByExampleGuidance
from tpunerf_torch.guidance.stable_diffusion import StableDiffusionGuidance
from tpunerf_torch import profiling
from tpunerf_torch.kernels import rasterize as TR
from tpunerf_torch.scripts.pbe_step import exemplar_png
from tpunerf_torch.profiling import TRACE_FILE
from tpunerf_torch.training import config as tconfig
from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
from tpunerf_torch.training.latent_paint import LatentPaintApp
from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
from tpunerf_torch.training import trainer as trainer_mod
from tpunerf_torch.training.trainer import Trainer

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


def _mesh_cfg(mod, tmp_path, name, backend="text", mode=0, log=None,
              **optim):
    """A tiny latent-paint-mesh config (the sphere, 16² train grid, 16²
    texture): `backend` "text" (SD), "depth" (B = 2), "pbe" or
    "pbe-clip" (Paint-by-Example on a 64² exemplar, with optim.use_clip)."""
    base = dict(iters=4, seed=0, lr=1e-2, mode=mode, lambda_laplacian=10.0,
                lambda_displacement=1.0, use_clip=backend == "pbe-clip")
    base.update(optim)
    guide = dict(text="a red car", shape_path="sphere", tiny_diffusion=True,
                 texture_resolution=16, unet_dtype="float32")
    render = dict(train_grid_size=16, eval_grid_size=16, body_prob=0.7)
    if backend == "depth":
        guide["diffusion_name"] = "sd-depth"
        render["batch_size"] = 2
    if backend.startswith("pbe"):
        image = tmp_path / "exemplar.png"
        if not image.exists():
            exemplar_png(image, 0, size=64)
        guide.update(use_sd=False, image=image)
    return mod.TrainConfig(
        log=_log(mod, tmp_path, name, **(log or {})),
        render=mod.RenderConfig(**render), optim=mod.OptimConfig(**base),
        guide=mod.GuideConfig(**guide))


@pytest.fixture(scope="module")
def mesh_stacks(guidance):
    """The port's tiny guidance stacks of latent-paint-mesh's backends
    (random from seed 0; the depth one without its inpainting UNet)."""
    def gen():
        return torch.Generator().manual_seed(0)
    return {"text": guidance,
            "depth": StableDiffusionDepthGuidance.create(
                tiny=True, unet_dtype="float32", device=CPU, generator=gen()),
            "pbe": PaintByExampleGuidance.create(
                tiny=True, unet_dtype="float32", device=CPU, generator=gen())}


def _mesh_app(cfg, stacks, backend):
    """The app of `_mesh_cfg`'s config on the CPU; with Paint-by-Example
    its render at 16² latents, which the tiny UNet and VAE take at a
    sixteenth of the cost of the scene's 64²."""
    if backend == "depth":
        return LatentPaintMeshApp.create(cfg, depth_guidance=stacks["depth"],
                                         device="cpu")
    if backend.startswith("pbe"):
        app = LatentPaintMeshApp.create(cfg, pbe=stacks["pbe"], device="cpu")
        app.scene.latent_size = 16
        return app
    g = dataclasses.replace(stacks["text"], latent_mode=cfg.optim.mode == 0)
    return LatentPaintMeshApp.create(cfg, guidance=g, device="cpu")


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


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("case", [
    "mode0", "mode1", "mode2", "depth", "pbe", "pbe-clip"])
def test_chunked_equals_eager_bit_for_bit_paint_mesh(tmp_path, mesh_stacks,
                                                     case):
    """Latent-paint-mesh, train_chunk 3 against eager over 4 steps (chunks
    of 3 then 1), in each mode with text SD, and in mode 0 with depth SD
    (B = 2) and Paint-by-Example without and with `optim.use_clip` (whose
    t is drawn through the trainer's hook: both branches are taken). On one
    torch thread, as the other latent-paint-mesh tests run: on a pool of
    threads the mesh step's CPU gradient differs in its last bits from run
    to run, eager against eager as well."""
    backend = case if not case.startswith("mode") else "text"
    mode = int(case[4]) if case.startswith("mode") else 0
    flags = []

    def run(name, **optim):
        cfg = _mesh_cfg(tconfig, tmp_path, name, backend, mode, **optim)
        app = _mesh_app(cfg, mesh_stacks, backend)
        if backend == "pbe-clip":
            draw = app.draw_branch

            def recorded(generator=None):
                lead, flag = draw(generator)
                flags.append(bool(flag))
                return lead, flag
            app.draw_branch = recorded
        trainer = Trainer(cfg, app, device="cpu")
        trainer.train()
        return trainer
    _assert_same_run(run(case + "-eager"), run(case + "-chunk",
                                               train_chunk=3))
    if backend == "pbe-clip":
        assert len(flags) == 8 and flags[:4] == flags[4:] \
            and set(flags) == {False, True}, flags


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


def test_chunked_cadence_of_paint_mesh_is_the_jax_chunked_trainers(
        tmp_path, tiny_sd_guidance, guidance):
    """As the test above, for latent-paint-mesh: both packages' chunked
    trainers over 120 steps, train_chunk 32 clipped at save_interval 40,
    the steps stood in for on both sides, write the same checkpoints, evals,
    train images and metric rows."""
    log = dict(save_interval=40, vis_train_prob=0.5)
    image = np.zeros((1, 16, 16, 3), np.float32)
    evals = {}

    def stub_evaluate(name):
        def evaluate(step, size, *args, **kwargs):
            evals.setdefault(name, []).append(step)
        return evaluate

    jcfg = _mesh_cfg(jconfig, tmp_path, "jax", log=log, iters=120,
                     train_chunk=32)
    jtrainer = JTrainer(jcfg, JMesh.create(jcfg, guidance=tiny_sd_guidance))

    def jax_chunk(k):
        def run(params, opt_state, key, step0):
            zeros = np.zeros(k, np.float32)
            return params, opt_state, key, zeros, zeros, {"image": image}
        return run

    jtrainer._build_train_chunk = jax_chunk
    jtrainer.evaluate = stub_evaluate("jax")
    jtrainer.train()

    cfg = _mesh_cfg(tconfig, tmp_path, "torch", log=log, iters=120,
                    train_chunk=32)
    trainer = Trainer(cfg, LatentPaintMeshApp.create(
        cfg, guidance=guidance, device="cpu"), device="cpu")
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


# what a CUDA graph's capture refuses: reading a device value on the host,
# and a tensor made from host data inside the step (`torch.tensor(...)`, an
# element set from a Python number), an upload
_HOST_READS = {"_local_scalar_dense", "item", "is_nonzero", "nonzero",
               "masked_select", "unique", "_unique2", "unique_dim",
               "equal", "allclose", "lift_fresh"}


class _HostReads(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _HOST_READS:
            self.seen[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("app_kind, nerf_type", [
    ("nerf", "latent"), ("nerf", "rgb"), ("paint", "latent"),
    ("paint", "rgb"), ("nerf+shape", "latent"),
    ("mesh0", "text"), ("mesh0", "depth"), ("mesh0", "pbe"),
    ("mesh0", "pbe-clip-sds"), ("mesh0", "pbe-clip-clip"),
    ("mesh1", "bins"), ("mesh1", "overflow"), ("mesh2", "text")])
def test_captured_step_reads_nothing_back(tmp_path, request, guidance,
                                          monkeypatch, app_kind, nerf_type):
    """The loss and backward of the step that the trainer captures, as the
    CPU runs them: no value goes back to the host and none comes from it
    (the card's Adam is capturable; the CPU's reads its step count, so it
    is left out). "nerf+shape" adds the sketch-shape loss (eval config #3's
    step). "meshM" is latent-paint-mesh in mode M: mode 0 with text SD,
    depth SD (B = 2) and Paint-by-Example, with `optim.use_clip` on each
    branch (t injected into the trainer's draws, the branch passed as a
    replay of that branch's graph passes it); mode 1 at a 128² grid (the
    wide camera), where the band bins are built, once with bins that hold (the selection's K
    512) and once with bins that overflow (the soft silhouette's K 256
    too), each choice made on the device; mode 2."""
    g = dataclasses.replace(guidance, latent_mode=nerf_type == "latent")
    drawn = branch = None
    bins = []
    if app_kind.startswith("nerf"):
        cfg = _nerf_cfg(tmp_path, app_kind + nerf_type)
        cfg.render.nerf_type = nerf_type
        if app_kind == "nerf+shape":
            cfg.guide.shape_path = "icosphere"
            cfg.optim.lambda_shape = 1.0
        app = LatentNeRFApp.create(cfg, guidance=g, device="cpu")
        assert (app.scene.sdf is not None) == (app_kind == "nerf+shape")
    elif app_kind.startswith("mesh"):
        backend = ("text" if nerf_type in ("bins", "overflow")
                   else nerf_type.replace("-sds", "").replace("-clip-clip",
                                                               "-clip"))
        cfg = _mesh_cfg(tconfig, tmp_path, app_kind + nerf_type, backend,
                        int(app_kind[4]))
        if nerf_type in ("bins", "overflow"):
            # one camera (the wide one) at the least grid that builds bins
            cfg.render.train_grid_size, cfg.render.body_prob = 128, 1.0
            select = TR._select_faces_batched
            K = 512 if nerf_type == "bins" else TR._BIN_K
            monkeypatch.setattr(TR, "_select_faces_batched",
                                functools.partial(select, K=K))
            if nerf_type == "overflow":
                monkeypatch.setattr(TR, "soft_silhouette", functools.partial(
                    TR.soft_silhouette, bin_k=256))
            bin_faces = TR._bin_faces

            def recorded(*args, **kwargs):
                ids, maxc = bin_faces(*args, **kwargs)
                bins.append((args[4], maxc, "margin" in kwargs))
                return ids, maxc
            monkeypatch.setattr(TR, "_bin_faces", recorded)
        app = _mesh_app(cfg, request.getfixturevalue("mesh_stacks"),
                        backend)
    else:
        cfg = _paint_cfg(tconfig, tmp_path, app_kind + nerf_type)
        cfg.render.nerf_type = nerf_type
        app = LatentPaintApp.create(cfg, guidance=g, device="cpu")
    trainer = Trainer(cfg, app, device="cpu")
    trainer.optimizer.step = lambda: None
    trainer.step_body()                  # lazy set-up outside the probe
    trainer.optimizer.zero_grad(set_to_none=True)
    if nerf_type.startswith("pbe-clip"):
        branch = nerf_type.endswith("clip-clip")
        t = torch.tensor(250 if branch else 500)
        drawn = (trainer.draw()[0], {"t": t},
                 app.guidance.clip_branch_flag(t))
    bins.clear()
    with _HostReads() as probe:
        loss, aux = trainer.step_body(drawn, branch)
        gnorm = trainer.grad_norm()
    assert not probe.seen, dict(probe.seen)
    assert np.isfinite(loss.item()) and gnorm.item() > 0
    assert all(torch.is_tensor(v) for v in aux.values()), aux.keys()
    if app_kind == "nerf+shape":
        assert aux["shape_loss"].item() > 0
    if nerf_type.startswith("pbe-clip"):
        assert bool(aux["clip_branch"]) == branch
    if nerf_type == "bins":
        assert bins and all(int(m) <= k for k, m, _ in bins)
    if nerf_type == "overflow":
        for soft in (False, True):
            assert any(int(m) > k for k, m, sft in bins if sft == soft)


class _EagerGraph:
    """A stand-in for `GraphedStep` on the CPU: a replay is the eager step
    body, with its loss, aux and gradients as the static outputs;
    `tamper`, where given, runs after it (a fault in the captured
    update)."""

    def __init__(self, trainer, tamper=None):
        self.trainer, self.tamper, self.branch = trainer, tamper, None

    def replay(self):
        self.trainer.optimizer.zero_grad(set_to_none=True)
        self.loss, self.aux = self.trainer.step_body()
        self.grads = [p.grad for p in self.trainer.params]
        if self.tamper is not None:
            self.tamper()


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("fault", [False, True], ids=["exact", "tampered"])
def test_graphed_against_eager_judges_the_update_exactly(tmp_path, guidance,
                                                         fault):
    """`graph_check.graphed_against_eager` and `graph_agreement` on a
    latent-paint-mesh trainer whose replay is the eager step (a CUDA
    graph's stand-in on the CPU): everything agrees and the update check
    reads 0; a replay whose update is off by one ulp in one parameter
    fails the "app" group through the update check, though its gradients
    and loss are the eager ones."""
    from tpunerf_torch.scripts.graph_check import (graph_agreement,
                                                   graphed_against_eager)
    cfg = _mesh_cfg(tconfig, tmp_path, f"g{fault}", "text", 0)
    app = _mesh_app(cfg, {"text": guidance}, "text")
    trainer = Trainer(cfg, app, device="cpu")
    trainer.train_step()                 # Adam's state exists

    def tamper():
        with torch.no_grad():
            d = app.scene.displacement
            d.view(-1)[7] = torch.nextafter(d.view(-1)[7],
                                            torch.tensor(1.0))
    trainer.graph = _EagerGraph(trainer, tamper if fault else None)
    d = graphed_against_eager(trainer)
    verdict = graph_agreement(d)
    assert d["replay"]["loss"] == d["eager"]["loss"] == 0.0
    assert max(d["replay"][k] for k in d["replay"]
               if k.startswith("grad")) == 0.0
    assert verdict["app"]["ok"] != fault and verdict["adam"]["ok"]
    assert (verdict["app"]["update"] > 0) == fault
    assert {k.split(" ")[0] for k in d["update"]} == {"app", "adam"}
    assert trainer.train_step_idx == 2
