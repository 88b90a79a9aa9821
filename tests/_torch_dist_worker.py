"""One rank of the multi-process tests of the port's distribution layer
(tests/test_torch_dist.py). Imports no JAX: the test process computes the
JAX package's references and hands this script the weights and draws.

    python tests/_torch_dist_worker.py TASK SPEC OUT_DIR INIT_METHOD

with RANK and WORLD_SIZE in the environment (`dist.launch.run_ranks`).
TASK is `mesh` (the layout, its groups and collectives), `apps` (each app's
step on the (2, 2) mesh, and on rank 0 the one-rank step first) or
`trainer` (the Trainer's scenarios of SPEC, a JSON file). Each rank writes
`<OUT_DIR>/<TASK>_rank<r>.pt`.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tpunerf_torch.dist import mesh as dist_mesh  # noqa: E402

TERMS = ("guidance_loss", "sparsity_loss", "opacity_loss", "shape_loss",
         "laplacian_loss", "displacement_norm")


def app_cfg(mod, kind: str, exp_root: Path, batch_size: int = 2):
    """The tiny configuration of an app case (`mod`: either package's
    training.config): latent-NeRF (`nerf`, `nerf_sketch`) as
    tests/test_torch_train_step.py, latent-paint (`paint`) as
    tests/test_torch_latent_paint.py, latent-paint-mesh mode 0 and 1
    (`mesh0`, `mesh1`) as tests/test_torch_latent_paint_mesh.py."""
    log = mod.LogConfig(exp_name=kind, exp_root=Path(exp_root), eval_size=0,
                        full_eval_size=0, save_mesh=False, log_images=False,
                        save_interval=1000)
    if kind.startswith("nerf"):
        cfg = mod.TrainConfig(
            log=log,
            render=mod.RenderConfig(train_grid_size=16,
                                    num_samples_per_ray=32,
                                    mlp_dtype="float32",
                                    batch_size=batch_size),
            optim=mod.OptimConfig(seed=0, lr=1e-2, iters=17),
            guide=mod.GuideConfig(text="a sand castle", tiny_diffusion=True,
                                  unet_dtype="float32"))
        if kind == "nerf_sketch":
            cfg.optim.lambda_shape = 1.0
            cfg.guide.shape_path = "sphere"
            cfg.guide.proximal_surface = 0.3
        return cfg
    if kind == "paint":
        return mod.TrainConfig(
            log=log,
            render=mod.RenderConfig(train_grid_size=24, eval_grid_size=32,
                                    batch_size=batch_size),
            optim=mod.OptimConfig(iters=6, seed=0, lr=1e-2),
            guide=mod.GuideConfig(text="a red fish", shape_path="sphere",
                                  tiny_diffusion=True, texture_resolution=32,
                                  unet_dtype="float32"))
    mode = int(kind[-1])
    return mod.TrainConfig(
        log=log,
        render=mod.RenderConfig(train_grid_size=24, eval_grid_size=32,
                                body_prob=0.5 if mode == 0 else 1.0,
                                batch_size=batch_size),
        optim=mod.OptimConfig(iters=6, seed=0, lr=1e-2, mode=mode,
                              lambda_laplacian=10.0,
                              lambda_displacement=1.0),
        guide=mod.GuideConfig(text="a red car", shape_path="sphere",
                              tiny_diffusion=True, texture_resolution=32,
                              unet_dtype="float32"))


def make_app(kind: str, cfg, guidance):
    if kind.startswith("nerf"):
        from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
        return LatentNeRFApp.create(cfg, guidance=guidance, device="cpu")
    if kind == "paint":
        from tpunerf_torch.training.latent_paint import LatentPaintApp
        return LatentPaintApp.create(cfg, guidance=guidance, device="cpu")
    from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
    return LatentPaintMeshApp.create(cfg, guidance=guidance, device="cpu")


def step(app, kind: str, views, draws, layout):
    """One step: loss, backward, the world's sums (with a layout), Adam.
    Returns the loss and terms (the world's), the gradients and the
    parameters after Adam, by parameter name."""
    opt = app.make_optimizer()
    opt.zero_grad(set_to_none=True)
    if kind.startswith("mesh"):
        loss, aux = app.loss_fn(views, draws=dict(draws))
    else:
        loss, aux = app.loss_fn(views, **draws)
    loss.backward()
    params = [p for g in opt.param_groups for p in g["params"]]
    names = [k for k in TERMS if k in aux]
    values = [loss.detach()] + [aux[k] for k in names]
    if layout is not None:
        values = dist_mesh.all_reduce_grads(params, *values)
    named = dict(app.scene.named_parameters())
    grads = {n: p.grad.clone() for n, p in named.items()
             if p.grad is not None}
    opt.step()
    return {"terms": dict(zip(("loss",) + tuple(names),
                              [float(v) for v in values])),
            "grads": grads,
            "params": {n: p.detach().clone() for n, p in named.items()}}


def split_grads(app, kind: str, views, draws):
    """The one-rank gradients with the guidance term taken one view at a
    time and summed, and the displacement's regularisers (which see no
    view) once: what splitting the batch alone does to the sums. For the
    apps whose terms are sums over the views (latent-paint, and
    latent-paint-mesh modes 0 and 1)."""
    optim = app.cfg.optim
    lam = optim.lambda_laplacian, optim.lambda_displacement
    optim.lambda_laplacian = optim.lambda_displacement = 0.0
    total = {}

    def add():
        for n, p in app.scene.named_parameters():
            if p.grad is not None:
                total[n] = total.get(n, 0) + p.grad
        app.scene.zero_grad(set_to_none=True)

    app.scene.zero_grad(set_to_none=True)
    for i in range(views.batch_size):
        one = {k: v if k.startswith("t") else v[i:i + 1]
               for k, v in draws.items()}
        if kind.startswith("mesh"):
            loss, _ = app.loss_fn(views[i:i + 1], draws=one)
        else:
            loss, _ = app.loss_fn(views[i:i + 1], **one)
        loss.backward()
        add()
    optim.lambda_laplacian, optim.lambda_displacement = lam
    if kind.startswith("mesh"):
        render = app.scene.render_train(views[:1])
        (lam[0] * render["laplacian_loss"]
         + lam[1] * render["displacement_norm"]).backward()
        add()
    return total


def run_apps(spec_path: Path, out: Path, rank: int) -> None:
    from tpunerf_torch.core.views import ViewBatch
    from tpunerf_torch.fields.sketch_shape import SDFGrid
    from tpunerf_torch.guidance.stable_diffusion import \
        StableDiffusionGuidance
    from tpunerf_torch.training import config as tconfig
    spec = torch.load(spec_path, weights_only=False)
    g = StableDiffusionGuidance.create(tiny=True, unet_dtype="float32",
                                       device=torch.device("cpu"))
    for name in ("unet", "text_encoder", "vae"):
        getattr(g, name).load_state_dict(spec["guidance"][name])
    g.min_step, g.max_step = spec["guidance"]["steps"]
    layout = dist_mesh.make_mesh(n_data=2, n_rays=2)
    results = {}
    for case in spec["cases"]:
        kind = case["kind"]
        cfg = app_cfg(tconfig, kind, Path(spec["exp_root"]))
        if "sdf" in case:        # the test's grid of the guide shape
            cfg.guide.shape_path = None
        app = make_app(kind, cfg, g)
        if "sdf" in case:
            app.scene.sdf = SDFGrid(*case["sdf"])
        app.scene.load_state_dict(case["scene"])
        state0 = {k: v.clone() for k, v in app.scene.state_dict().items()}
        views = ViewBatch(**case["views"])
        res = {}
        if rank == 0:                    # the one-rank step first
            if not kind.startswith("nerf"):
                res["split"] = split_grads(app, kind, views, case["draws"])
            res["one_rank"] = step(app, kind, views, case["draws"], None)
            app.scene.load_state_dict(state0)
        app.set_layout(layout)
        res["mesh"] = step(app, kind, views, case["draws"], layout)
        results[kind] = res
    torch.save(results, out / f"apps_rank{rank}.pt")


def run_mesh(out: Path, rank: int) -> None:
    """The (2, 2) layout of 4 ranks: axes, bands, the gather and its
    gradient, the band's gradient of a whole frame, the gradient sum and
    the broadcast."""
    layout = dist_mesh.make_mesh(n_data=2, n_rays=2)
    x = torch.full((1, 3, 2), float(rank + 1), requires_grad=True)
    frame = layout.gather_rows(x)
    (frame * torch.arange(6.0)[None, :, None]).sum().backward()
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.full((3,), float(rank))
    loss = torch.tensor(float(rank + 1))
    (summed,) = dist_mesh.all_reduce_grads([p], loss)
    whole = torch.ones((1, 4, 2), requires_grad=True)
    kept = layout.band_grad(whole)
    (kept * torch.arange(4.0)[None, :, None]).sum().backward()
    t = torch.tensor([float(rank), 7.0])
    b = torch.tensor([rank == 0, rank != 0])
    dist_mesh.replicate_([t, b])
    refused = []
    for name, fn, n in (("row_band", layout.row_band, 7),
                        ("data_rows", layout.data_rows, 3)):
        try:
            fn(n)
        except ValueError:
            refused.append(name)
    torch.save({"rank": layout.rank, "data": layout.data_index,
                "rays": layout.rays_index, "row_band": layout.row_band(8),
                "data_rows": layout.data_rows(4), "refused": refused,
                "frame": frame.detach(), "frame_grad": x.grad,
                "band_grad": (kept.detach(), whole.grad),
                "grad": p.grad, "loss": summed, "broadcast": t, "bool": b},
               out / f"mesh_rank{rank}.pt")


class _Writes:
    """The files this process opens for writing under a directory (an
    audit hook on `open` and `os.mkdir`)."""

    def __init__(self, root: Path):
        self.root, self.paths = str(root), []
        sys.addaudithook(self)

    def __call__(self, event, args):
        if event == "open" and isinstance(args[0], (str, Path)):
            path, mode, flags = str(args[0]), args[1], args[2]
            if isinstance(mode, str):
                writing = any(c in mode for c in "wax+")
            else:
                writing = bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
            if writing and path.startswith(self.root):
                self.paths.append(path)
        elif event == "os.mkdir" and str(args[0]).startswith(self.root):
            self.paths.append(str(args[0]))


def run_trainer(spec_path: Path, out: Path, rank: int) -> None:
    """Each scenario of the spec through the Trainer: its layout, the
    warning it logged, its step, the state of each rank at the end, and
    what this rank wrote under the runs' root."""
    from tpunerf_torch.training import config as tconfig
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
    from tpunerf_torch.training.trainer import Trainer
    spec = json.loads(Path(spec_path).read_text())
    root = Path(spec["exp_root"])
    writes = _Writes(root)
    results = {}
    for sc in spec["scenarios"]:
        cfg = app_cfg(tconfig, "nerf", root, batch_size=sc["batch_size"])
        cfg.log.exp_name = sc["name"]
        cfg.dist.rays_axis = sc.get("rays_axis", 1)
        cfg.optim.iters = sc["iters"]
        cfg.optim.train_chunk = sc.get("train_chunk", 1)
        cfg.optim.resume = sc.get("resume", False)
        cfg.log.save_interval = sc.get("save_interval", 1000)
        cfg.log.eval_size = sc.get("eval_size", 0)
        cfg.log.full_eval_size = sc.get("eval_size", 0)
        cfg.log.log_images = sc.get("log_images", False)
        cfg.log.vis_train_prob = 1.0
        cfg.render.eval_grid_size = 16
        app = LatentNeRFApp.create(cfg, device="cpu")
        trainer = Trainer(cfg, app, device="cpu")
        start = trainer.train_step_idx
        losses = []
        trainer.train(on_step=lambda s, loss: losses.append(float(loss)))
        layout = trainer.layout
        results[sc.get("key", sc["name"])] = {
            "mesh": None if layout is None else (layout.n_data,
                                                 layout.n_rays),
            "wired": layout is not None and app.layout is layout
            and app.scene.layout is layout, "start": start,
            "end": trainer.train_step_idx, "losses": losses,
            "state": {k: v.clone() for k, v in app.state_dict().items()},
            "adam": [t.clone() for t in dist_mesh.state_tensors(
                {}, trainer.optimizer)]}
    results["writes"] = writes.paths
    torch.save(results, out / f"trainer_rank{rank}.pt")


def main() -> None:
    task, spec, out, init = sys.argv[1:5]
    torch.set_num_threads(1)
    dist_mesh.initialize("gloo", init, device="cpu", timeout_s=120)
    rank = dist_mesh.rank()
    out = Path(out)
    if task == "mesh":
        run_mesh(out, rank)
    elif task == "apps":
        run_apps(Path(spec), out, rank)
    else:
        run_trainer(Path(spec), out, rank)
    dist_mesh.barrier()
    dist_mesh.dist.destroy_process_group()


if __name__ == "__main__":
    main()
