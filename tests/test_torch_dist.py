"""The port's distribution layer (tpunerf_torch/dist/) on CPU ranks over
gloo, against the JAX package's single-device step: the (data, rays) mesh
of 4 ranks at (2, 2), the view stream, each app's step on the mesh (per
loss term, every gradient, Adam), the Trainer on the mesh (the rays axis
wired, the fall-back to the whole batch, resume, chunks, files written by
rank 0 alone), the NaN/Inf guards and the scaling harness.

Each multi-process case spawns its ranks (tests/_torch_dist_worker.py, no
JAX, one torch thread each), which rendezvous through a file under the
test's temporary directory and are joined under a time limit of their own
(`dist.launch.run_ranks`), so that a hung rank fails the test instead of
hanging it. The JAX package's tests show its sharded step equals its
single-device one (tests/test_dist.py), so the single-device step is the
reference here."""
import dataclasses
import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from _torch_port import assert_close_to_max, np_tree, port_guidance
from tpunerf.core import views as jviews
from tpunerf.fields import occupancy as jocc
from tpunerf.guidance import sds as jsds
from tpunerf.training import config as jconfig
from tpunerf_torch.core import views as tviews
from tpunerf_torch.dist import launch
from tpunerf_torch.dist import mesh as dist_mesh
from tpunerf_torch.training import config as tconfig
from tpunerf_torch.weights import load_flax_params

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(W.__file__)
RANKS_TIMEOUT_S = 120
KINDS = ("nerf", "nerf_sketch", "paint", "mesh0", "mesh1")
# the tolerances of each app's parity file (test_torch_train_step.py,
# test_torch_latent_paint.py, test_torch_latent_paint_mesh.py): the loss,
# the gradients (of their largest value), a regulariser's term
LOSS_RTOL = {"nerf": 1e-4, "nerf_sketch": 1e-4, "paint": 1e-4,
             "mesh0": 1e-4, "mesh1": 5e-4}
TERM_RTOL = {"sparsity_loss": 1e-5, "opacity_loss": 1e-5,
             "shape_loss": 1e-5, "laplacian_loss": 2e-5,
             "displacement_norm": 2e-5}


def spawn(task: str, spec, tmp: Path, world: int = 4):
    """Run `world` ranks of the worker's `task`; each rank's results."""
    launch.run_ranks(
        [sys.executable, str(WORKER), task, str(spec), str(tmp),
         launch.rendezvous_file(tmp)], world, timeout=RANKS_TIMEOUT_S,
        cwd=ROOT, log_dir=tmp / f"{task}_logs")
    return [torch.load(tmp / f"{task}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_views(jv):
    return {"theta": _t(jv.theta), "phi": _t(jv.phi),
            "radius": _t(jv.radius), "dirs": _t(jv.dirs).long(),
            "is_body": _t(jv.is_body)}


def _sds(key, g, shape):
    k_t, k_n = jax.random.split(key)
    return (torch.tensor(int(jsds.sample_timestep(k_t, g.min_step,
                                                  g.max_step))),
            _t(jax.random.normal(k_n, shape)))


# --------------------------------------------------------------------------
# each app's step at (data 2, rays 2) against the JAX package's
# --------------------------------------------------------------------------

def _nerf_case(kind, jg, tg, tmp):
    from tpunerf.fields.sketch_shape import SDFGrid as JSDFGrid
    from tpunerf.training.latent_nerf_app import LatentNeRFApp as JApp
    from tpunerf_torch.fields.sketch_shape import SDFGrid as TSDFGrid
    from tpunerf_torch.meshrep import shapes as tshapes
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp as TApp
    cfg_t, cfg_j = W.app_cfg(tconfig, kind, tmp), W.app_cfg(jconfig, kind,
                                                             tmp)
    shape = cfg_j.guide.shape_path
    cfg_t.guide.shape_path = cfg_j.guide.shape_path = None
    tapp = TApp.create(cfg_t, guidance=tg, device="cpu")
    japp = JApp.create(cfg_j, guidance=jg)
    if shape is not None:
        # the port's grid (the C++ library's, equal to the JAX package's
        # within 1e-6: test_torch_train_step.py), not JAX's 40 s numpy
        # build, at 24³ (the app's 48³ takes 25 s here): how the mesh
        # splits the shape term does not depend on the grid's size
        mesh = tshapes.load_shape(shape).normalize(
            target_scale=cfg_t.guide.shape_scale, dy=cfg_t.guide.dy)
        sdf = tapp.scene.sdf = TSDFGrid.from_mesh(
            mesh.vertices.numpy(), mesh.faces.numpy(), resolution=24,
            bound=cfg_t.render.bound, device="cpu")
        japp = dataclasses.replace(japp, scene=dataclasses.replace(
            japp.scene, sdf=JSDFGrid(values=jnp.asarray(
                sdf.values.numpy()), bound=sdf.bound,
                resolution=sdf.resolution)))
    params = jax.jit(japp.init_params)(jax.random.key(1))
    # a blob of occupied cells, so that compaction drops samples
    centers = np.asarray(jocc.cell_centers(japp.scene.occ_cfg))
    params["occ_grid"] = jnp.asarray(
        np.where(np.linalg.norm(centers, axis=-1) < 0.45, 1.0, 0.0),
        jnp.float32)
    load_flax_params(tapp.scene, np_tree(params), "scene")
    key_view, key = jax.random.split(jax.random.key(11))
    jv = jviews.rand_poses(key_view, 2, jviews.ViewSamplerConfig())
    k_render, k_sds = jax.random.split(key)
    P, S = japp.scene.train_grid_size ** 2, japp.scene.march.num_samples
    H = japp.scene.train_grid_size
    t, noise = _sds(k_sds, japp.guidance, (2, H, H, 4))
    draws = {"u": _t(jax.random.uniform(k_render, (2, P, S))), "t": t,
             "noise": noise}

    def with_terms(p):
        # the loss, and its regularisers from the same render (one jit)
        loss, _ = japp.loss_fn(p, jv, key, jnp.asarray(1))
        out = japp.scene.render_train(p, jv, k_render, jnp.asarray(1))
        return loss, {k: out[k] for k in ("sparsity_loss", "opacity_loss",
                                          "shape_loss") if k in out}

    def reference():
        (loss, out), grads = jax.jit(jax.value_and_grad(
            with_terms, has_aux=True))(params)
        optim = japp.cfg.optim
        terms = {"sparsity_loss": float(out["sparsity_loss"]),
                 "opacity_loss": float(out["opacity_loss"])}
        regs = optim.lambda_sparsity * terms["sparsity_loss"] + (
            optim.lambda_opacity * terms["opacity_loss"])
        if "shape_loss" in out:
            terms["shape_loss"] = float(out["shape_loss"])
            regs += optim.lambda_shape * terms["shape_loss"]
        terms["loss"] = float(loss)
        terms["guidance_loss"] = float(loss) - regs
        from tpunerf_torch.weights import state_dict_from_flax
        g = state_dict_from_flax(np_tree(grads["field"]), "field")
        return terms, {f"field.{k}": v.numpy() for k, v in g.items()}
    return tapp, jv, draws, reference


def _paint_case(kind, jg, tg, tmp, rng):
    from tpunerf.training.latent_paint import LatentPaintApp as JPaint
    from tpunerf.training.latent_paint_mesh import LatentPaintMeshApp as JMesh
    from tpunerf_torch.training.latent_paint import LatentPaintApp as TPaint
    from tpunerf_torch.training.latent_paint_mesh import \
        LatentPaintMeshApp as TMesh
    mode = 0 if kind == "paint" else int(kind[-1])
    cfg_j = W.app_cfg(jconfig, kind, tmp)
    if kind == "paint":
        japp = JPaint.create(cfg_j, guidance=jg)
        params = japp.init_params(jax.random.key(1))
        tapp = TPaint.create(W.app_cfg(tconfig, kind, tmp), guidance=tg,
                             device="cpu")
        load_flax_params(tapp.scene, np_tree(params), "paint_scene")
    else:
        japp = JMesh.create(cfg_j, guidance=dataclasses.replace(
            jg, latent_mode=mode == 0))
        params = dict(japp.init_params(jax.random.key(1)))
        V = japp.scene.mesh.num_vertices
        params["displacement"] = jnp.asarray(
            0.01 * rng.normal(size=(V, 3)), jnp.float32)
        params["lights"] = params["lights"] + jnp.asarray(
            0.2 * rng.normal(size=(1, 9)), jnp.float32)
        params["texture_img_rgb_finetune"] = jnp.asarray(
            rng.uniform(size=(1, 32, 32, 3)), jnp.float32)
        tapp = TMesh.create(W.app_cfg(tconfig, kind, tmp), guidance=tg,
                            device="cpu")
        load_flax_params(tapp.scene, np_tree(params), "paint_mesh_scene")
    jv = jviews.ViewBatch(
        theta=jnp.asarray([1.2, 0.9]), phi=jnp.asarray([0.4, 2.5]),
        radius=jnp.asarray([1.4, 1.3]), dirs=jnp.asarray([0, 2], jnp.int32),
        is_body=jnp.asarray([True, False]))
    key = jax.random.key(13)
    g = japp.guidance
    lat = (2, 16, 16, 4)
    if kind == "paint":
        t, noise = _sds(key, g, lat)
        draws = {"t": t, "noise": noise}
    elif mode == 0:
        t, noise = _sds(jax.random.split(key)[0], g, lat)
        draws = {"t": t, "noise": noise}
    else:
        k1, k2, k3 = jax.random.split(jax.random.split(key)[0], 3)
        enc = (2,) + tuple(g.encode_imgs_mode(
            jnp.zeros((1, g.image_size, g.image_size, 3))).shape[1:])
        t1, n1 = _sds(k3, g, enc)
        t2, n2 = _sds(jax.random.fold_in(k3, 1), g, enc)
        draws = {"vae_noise_img": _t(jax.random.normal(k1, enc)),
                 "vae_noise_nrm": _t(jax.random.normal(k2, enc)),
                 "t_img": t1, "noise_img": n1, "t_nrm": t2,
                 "noise_nrm": n2}

    def with_terms(p):
        # the loss, and the mesh's regularisers from a render (one jit)
        loss, _ = japp.loss_fn(p, jv, key, jnp.asarray(1))
        if kind == "paint":
            return loss, {}
        out = japp.scene.render_train(p, jv, with_lighting=mode != 0)
        return loss, {k: out[k] for k in ("laplacian_loss",
                                          "displacement_norm")}

    def reference():
        (loss, out), grads = jax.jit(jax.value_and_grad(
            with_terms, has_aux=True))(params)
        terms = {"loss": float(loss)}
        if kind == "paint":
            terms["guidance_loss"] = float(loss)
        else:
            optim = japp.cfg.optim
            terms["laplacian_loss"] = float(out["laplacian_loss"])
            terms["displacement_norm"] = float(out["displacement_norm"])
            terms["guidance_loss"] = float(loss) - (
                optim.lambda_laplacian * terms["laplacian_loss"]
                + optim.lambda_displacement * terms["displacement_norm"])
        return terms, {k: np.asarray(v) for k, v in grads.items()}
    return tapp, jv, draws, reference


@pytest.fixture(scope="module")
def app_runs(tiny_sd_guidance, tmp_path_factory):
    """The five cases handed to one spawn of 4 ranks (started first), the
    JAX references computed while they run; {kind: (JAX terms, JAX
    gradients, each rank's results)}."""
    tmp = tmp_path_factory.mktemp("dist_apps")
    rng = np.random.default_rng(0)
    torch.set_num_threads(1)
    tg = port_guidance(tiny_sd_guidance)
    load_flax_params(tg.vae, np_tree(tiny_sd_guidance.vae_params), "vae")
    cases, refs = [], {}
    for kind in KINDS:
        if kind.startswith("nerf"):
            tapp, jv, draws, ref = _nerf_case(kind, tiny_sd_guidance, tg, tmp)
        else:
            tapp, jv, draws, ref = _paint_case(kind, tiny_sd_guidance, tg,
                                               tmp, rng)
        case = {"kind": kind, "scene": tapp.scene.state_dict(),
                "views": _port_views(jv), "draws": draws}
        sdf = getattr(tapp.scene, "sdf", None)
        if sdf is not None:         # built here, not on every rank
            case["sdf"] = (sdf.values, sdf.bound)
        cases.append(case)
        refs[kind] = ref
    guidance = {"unet": tg.unet.state_dict(),
                "text_encoder": tg.text_encoder.state_dict(),
                "vae": tg.vae.state_dict(),
                "steps": (tg.min_step, tg.max_step)}
    torch.save({"guidance": guidance, "cases": cases,
                "exp_root": str(tmp / "exp")}, tmp / "spec.pt")
    got = {}

    def run():
        try:
            got["ranks"] = spawn("apps", tmp / "spec.pt", tmp)
        except BaseException as e:        # re-raised by the fixture
            got["error"] = e

    ranks = threading.Thread(target=run)
    ranks.start()
    try:
        jax_refs = {kind: ref() for kind, ref in refs.items()}
    finally:
        ranks.join()
    if "error" in got:
        raise got["error"]
    return {kind: (*jax_refs[kind], [r[kind] for r in got["ranks"]])
            for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_step_equals_the_jax_single_device_step(app_runs, kind):
    """Per loss term (the world's sum of the ranks' shares) and every
    gradient (summed over the world), within the app's parity
    tolerances."""
    terms_j, grads_j, ranks = app_runs[kind]
    got = ranks[0]["mesh"]
    assert set(got["terms"]) == set(terms_j)
    for name, ref in terms_j.items():
        rtol = TERM_RTOL.get(name, LOSS_RTOL[kind])
        np.testing.assert_allclose(got["terms"][name], ref, rtol=rtol,
                                   err_msg=name)
    assert set(got["grads"]) == set(grads_j) or kind != "nerf"
    for name, g in got["grads"].items():
        assert_close_to_max(g.numpy(), grads_j[name], LOSS_RTOL[kind], name)


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_step_equals_the_ports_one_rank_step(app_runs, kind):
    """The loss and each term within 1e-6 of the one-rank value; every
    gradient within 1e-6 of its largest value or, for the paint apps,
    within twice what splitting the one-rank batch into single views does
    to it (the same sums in another order), whichever is larger."""
    _, _, ranks = app_runs[kind]
    one, got = ranks[0]["one_rank"], ranks[0]["mesh"]
    for name, ref in one["terms"].items():
        assert abs(got["terms"][name] - ref) <= 1e-6 * abs(ref), name
    split = ranks[0].get("split")
    for name, ref in one["grads"].items():
        scale = float(ref.abs().max())
        err = float((got["grads"][name] - ref).abs().max())
        allowed = 1e-6 * scale
        if split is not None:
            allowed = max(allowed,
                          2 * float((split[name] - ref).abs().max()))
        assert err <= allowed, f"{name}: {err:.3e} > {allowed:.3e}"


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_step_keeps_the_ranks_bit_equal(app_runs, kind):
    """After the gradient sum and Adam every rank holds the same
    parameters, bit for bit, and the same gradients and terms."""
    _, _, ranks = app_runs[kind]
    first = ranks[0]["mesh"]
    for r in ranks[1:]:
        assert r["mesh"]["terms"] == first["terms"]
        for part in ("grads", "params"):
            for name, v in first[part].items():
                assert torch.equal(r["mesh"][part][name], v), (part, name)


# --------------------------------------------------------------------------
# the layout, the view stream
# --------------------------------------------------------------------------

def test_mesh_axes_groups_and_collectives(tmp_path):
    """4 ranks at (2, 2), row-major as np.reshape(devices, (2, 2)): each
    rank's indices, bands and views (an axis that does not divide them is
    refused); the gather within a rays row and its gradient; a whole
    frame's gradient kept to the band; the gradient sum; rank 0's values
    broadcast (a bool too)."""
    ranks = spawn("mesh", "-", tmp_path)
    for r, got in enumerate(ranks):
        d, j = divmod(r, 2)
        assert (got["rank"], got["data"], got["rays"]) == (r, d, j)
        assert got["row_band"] == slice(4 * j, 4 * j + 4)
        assert got["data_rows"] == slice(2 * d, 2 * d + 2)
        assert got["refused"] == ["row_band", "data_rows"]   # 7 rows, 3 views
        # the identity forward; n_rays x the gradient on this rank's rows
        kept, kept_grad = got["band_grad"]
        assert torch.equal(kept, torch.ones((1, 4, 2)))
        rows = torch.zeros(4)
        rows[2 * j:2 * j + 2] = 2 * torch.arange(4.0)[2 * j:2 * j + 2]
        assert torch.equal(kept_grad, rows[None, :, None].expand(1, 4, 2))
        # the rays row (ranks 2d, 2d + 1) stacked in order
        row = torch.cat([torch.full((1, 3, 2), float(2 * d + 1)),
                         torch.full((1, 3, 2), float(2 * d + 2))], dim=1)
        assert torch.equal(got["frame"], row)
        # n_rays x this rank's band of the frame's gradient
        band = torch.arange(6.0)[3 * j:3 * j + 3]
        assert torch.equal(got["frame_grad"],
                           2 * band[None, :, None].expand(1, 3, 2))
        assert torch.equal(got["grad"], torch.full((3,), 6.0))
        assert float(got["loss"]) == 10.0
        assert torch.equal(got["broadcast"], torch.tensor([0.0, 7.0]))
        assert torch.equal(got["bool"], torch.tensor([True, False]))


def test_a_mesh_that_does_not_tile_is_refused():
    with pytest.raises(AssertionError):
        dist_mesh.make_mesh(n_data=2, n_rays=1)       # one process
    layout = dist_mesh.make_mesh()
    assert (layout.n_data, layout.n_rays, layout.world_size) == (1, 1, 1)
    assert not layout.splits


def test_view_stream_hosts_draw_disjoint_views():
    """As tests/test_dist.py's: two hosts draw other views; one host draws
    the same views twice; the draws can be passed in."""
    cfg, cpu = tviews.ViewSamplerConfig(), torch.device("cpu")
    s0 = tviews.train_view_stream(0, 2, cfg, cpu, host_id=0)
    s1 = tviews.train_view_stream(0, 2, cfg, cpu, host_id=1)
    a, b = next(s0), next(s1)
    assert (a.theta - b.theta).abs().max() > 1e-6
    again = next(tviews.train_view_stream(0, 2, cfg, cpu, host_id=0))
    assert torch.equal(a.theta, again.theta)
    assert not torch.equal(next(s0).theta, a.theta)   # the stream moves on
    u = torch.rand((4, 2), generator=torch.Generator().manual_seed(3))
    given = next(tviews.train_view_stream(0, 2, cfg, cpu, draws=[u]))
    assert torch.equal(given.theta,
                       tviews.rand_poses(2, cfg, cpu, u=u).theta)


# --------------------------------------------------------------------------
# the Trainer on 4 ranks
# --------------------------------------------------------------------------

SCENARIOS = [
    dict(key="rays2", name="rays2", batch_size=2, rays_axis=2, iters=2,
         save_interval=2, eval_size=1, log_images=True),
    dict(key="notile", name="notile", batch_size=2, rays_axis=3, iters=4),
    dict(key="nodiv", name="nodiv", batch_size=2, rays_axis=1, iters=1),
    dict(key="resume", name="rays2", batch_size=2, rays_axis=2, iters=3,
         save_interval=2, resume=True),
    dict(key="eager", name="eager", batch_size=2, rays_axis=2, iters=6,
         save_interval=4),
    dict(key="chunked", name="chunked", batch_size=2, rays_axis=2, iters=6,
         save_interval=4, train_chunk=3),
]


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_trainer")
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"exp_root": str(tmp / "exp"),
                                "scenarios": SCENARIOS}))
    return tmp / "exp", spawn("trainer", spec, tmp)


def _equal_states(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        for name, v in first["state"].items():
            assert torch.equal(r[key]["state"][name], v), (key, name)
        assert all(torch.equal(a, b) for a, b in
                   zip(first["adam"], r[key]["adam"]))


def test_trainer_wires_the_rays_axis(trainer_runs):
    """dist.rays_axis 2 on 4 ranks: the (2, 2) mesh, set_layout called,
    two finite steps, the same state on every rank."""
    _, ranks = trainer_runs
    for r in ranks:
        got = r["rays2"]
        assert got["mesh"] == (2, 2) and got["wired"]
        assert got["end"] == 2 and np.isfinite(got["losses"]).all()
        assert got["losses"] == ranks[0]["rays2"]["losses"]
    _equal_states(ranks, "rays2")


@pytest.mark.parametrize("key,words,iters", [
    ("notile", "dist mesh (1×3) does not tile the 4 ranks", 4),
    ("nodiv", "batch_size 2 not divisible by the data axis (4)", 1)])
def test_trainer_warns_and_runs_the_whole_batch(trainer_runs, key, words,
                                                iters):
    """A mesh that does not tile the ranks, or a data axis that does not
    divide the batch: the JAX package's warning, no mesh, and every rank
    runs the whole batch (each the same step, here bit for bit)."""
    exp, ranks = trainer_runs
    log = (exp / key / "log.txt").read_text()
    assert words in log and "running SINGLE-device" in log
    for r in ranks:
        assert r[key]["mesh"] is None and r[key]["end"] == iters
    _equal_states(ranks, key)
    # the whole batch's losses are the (2, 2) mesh's (the same draws, step
    # after step: a draw out of step would change a loss entirely), up to
    # the order of the sums
    np.testing.assert_allclose(ranks[0][key]["losses"],
                               ranks[0]["eager"]["losses"][:iters],
                               rtol=1e-5)


def test_trainer_resume_restores_replicated_state(trainer_runs):
    """optim.resume on the mesh: every rank continues after the saved step
    2, from the same state, and stays equal after step 3."""
    _, ranks = trainer_runs
    for r in ranks:
        assert (r["resume"]["start"], r["resume"]["end"]) == (2, 3)
        assert r["resume"]["mesh"] == (2, 2)
    _equal_states(ranks, "resume")


def test_trainer_chunked_on_the_mesh_equals_eager(trainer_runs):
    """optim.train_chunk 3 on the (2, 2) mesh: the same losses and the same
    parameters as eager steps (← tests/test_dist.py:157-275); on the CPU a
    chunk is eager steps, so bit for bit."""
    _, ranks = trainer_runs
    for r in ranks:
        assert r["chunked"]["losses"] == r["eager"]["losses"]
        for name, v in r["eager"]["state"].items():
            assert torch.equal(r["chunked"]["state"][name], v), name
    _equal_states(ranks, "chunked")


def test_trainer_writes_files_from_rank_0_only(trainer_runs):
    """Ranks 1-3 open nothing for writing under the runs' root (an audit
    hook on open and mkdir); rank 0 writes the config, log, checkpoint,
    eval frames, train images and orbit."""
    exp, ranks = trainer_runs
    for r in ranks[1:]:
        assert r["writes"] == []
    written = set(ranks[0]["writes"])
    run = exp / "rays2"
    for rel in ("config.yaml", "log.txt", "checkpoints/step_000002.ckpt.tmp",
                "vis/eval/step_000002_000_rgb.png",
                "vis/train/step_000001.png"):
        assert str(run / rel) in written, rel
    assert (run / "checkpoints" / "step_000002.ckpt").exists()
    assert list((run / "results").iterdir())


# --------------------------------------------------------------------------
# the NaN/Inf guards, the scaling harness
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["log_negative", "divide_by_zero",
                                  "overflow_to_inf", "finite", "nan_in",
                                  "inf_minus_inf"])
def test_checked_raises_where_checkify_does(case):
    """`debug.checked` against `tpunerf.utils.debug.checked` on the same
    arrays: both raise, or both return the same values."""
    from tpunerf.utils import debug as jdebug
    from tpunerf_torch import debug as tdebug
    nan, inf = float("nan"), float("inf")
    cases = {
        "log_negative": ("log", [1.0, -1.0, 2.0]),
        "divide_by_zero": ("div", [1.0, -1.0, 2.0], [1.0, 0.0, 1.0]),
        "overflow_to_inf": ("exp", [1000.0]),
        "finite": ("affine", [1.0, -1.0, 2.0]),
        "nan_in": ("double", [nan, 1.0]),
        "inf_minus_inf": ("sub", [inf]),
    }[case]
    op, arrays = cases[0], cases[1:]
    jfns = {"log": jnp.log, "div": lambda a, b: a / b, "exp": jnp.exp,
            "affine": lambda a: a * 2 + 1, "double": lambda a: a * 2,
            "sub": lambda a: a - a}
    tfns = {"log": torch.log, "div": lambda a, b: a / b, "exp": torch.exp,
            "affine": lambda a: a * 2 + 1, "double": lambda a: a * 2,
            "sub": lambda a: a - a}
    try:
        ref = np.asarray(jdebug.checked(jfns[op])(
            *(jnp.asarray(a, jnp.float32) for a in arrays)))
    except Exception:
        ref = None
    if ref is None:
        with pytest.raises(FloatingPointError):
            tdebug.checked(tfns[op])(*(torch.tensor(a) for a in arrays))
    else:
        got = tdebug.checked(tfns[op])(*(torch.tensor(a) for a in arrays))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_assert_all_finite_and_nan_to_num_tree_as_jax():
    from jax.experimental import checkify

    from tpunerf.utils import debug as jdebug
    from tpunerf_torch import debug as tdebug
    nan, inf = float("nan"), float("inf")
    tree = {"b": [1.0, nan], "a": [1.0, 2.0], "c": [inf, -inf, 3.0]}
    jtree = {k: jnp.asarray(v, jnp.float32) for k, v in tree.items()}
    ttree = {k: torch.tensor(v) for k, v in tree.items()}
    err, _ = checkify.checkify(
        lambda t: jdebug.assert_all_finite(t, "grads"))(jtree)
    message = err.get().split(" (")[0]           # "... leaf 1"
    with pytest.raises(FloatingPointError, match=f"^{message}$"):
        tdebug.assert_all_finite(ttree, "grads")
    tdebug.assert_all_finite({"a": ttree["a"], "i": torch.tensor([1])})
    clean_j = jdebug.nan_to_num_tree(jtree)
    clean_t = tdebug.nan_to_num_tree({**ttree, "i": torch.tensor([5])})
    for k in tree:
        np.testing.assert_array_equal(clean_t[k].numpy(),
                                      np.asarray(clean_j[k]))
    assert torch.equal(clean_t["i"], torch.tensor([5]))


def test_bench_scaling_prints_its_json_line_on_two_cpu_ranks():
    res = subprocess.run(
        [sys.executable, "-m", "tpunerf_torch.scripts.bench_scaling",
         "--device", "cpu", "--ranks", "2", "--grid", "16", "--samples",
         "16", "--iters", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=3 * RANKS_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["devices"] == [1, 2] and out["rays2_mesh"] == [1, 2]
    assert all(v > 0 for v in out["steps_per_s"] + [out["rays2_steps_per_s"]])
    assert out["views_per_s"][1] == pytest.approx(2 * out["steps_per_s"][1],
                                                  abs=2e-3)
    assert out["efficiency"] > 0
