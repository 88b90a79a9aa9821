"""The port's NeRF→mesh bridge against the JAX package's: marching
tetrahedra (numpy, bit for bit; C++, equal up to order and the same over
calls and thread counts, watertight, wound outward), the scene's density
grid and iso-surface on the same weights, and `train_latent_nerf_mesh`
from a port checkpoint: the mesh JAX extracts from the same parameters,
then a latent-paint step on it."""
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port import (assert_close_to_max, np_tree,  # noqa: F401
                         one_torch_thread)
from tpunerf import native as jnative
from tpunerf.fields import marching as jmarching
from tpunerf.fields.scene import LatentNeRFScene as JScene
from tpunerf_torch import native as tnative
from tpunerf_torch import train_latent_nerf_mesh as bridge
from tpunerf_torch.fields import marching as tmarching
from tpunerf_torch.fields.scene import LatentNeRFScene as TScene
from tpunerf_torch.guidance.stable_diffusion import StableDiffusionGuidance
from tpunerf_torch.training import config as tconfig
from tpunerf_torch.training.checkpoints import CheckpointManager
from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
from tpunerf_torch.training.latent_paint import LatentPaintApp
from tpunerf_torch.training.trainer import Trainer
from tpunerf_torch.weights import flax_entries, load_flax_params

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.usefixtures("one_torch_thread")
needs_jax_native = pytest.mark.skipif(
    not jnative.native_available(),
    reason="the JAX package's native library is not built")


def _field(G: int, seed: int, kind: str = "noisy") -> np.ndarray:
    """A blob at iso 10 on [−1, 1]³ (the grid's corners, as extraction
    takes them): noisy, or a smooth off-centre ellipsoid."""
    ax = np.linspace(-1, 1, G)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    if kind == "ellipsoid":
        return 10 + 30 * (0.5 - np.sqrt((X - 0.1) ** 2 / 0.8
                                        + (Y + 0.05) ** 2 / 1.3 + Z ** 2))
    rng = np.random.default_rng(seed)
    return ((0.55 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)) * 30 + 10
            + rng.normal(0, 0.5, X.shape))


def _sorted(verts, faces):
    """Vertex coordinates and triangle soups, each column sorted: equal for
    two meshes that differ only in vertex and face order."""
    return (np.sort(verts, axis=0),
            np.sort(verts[faces].reshape(len(faces), -1), axis=0))


@pytest.mark.parametrize("G, seed, dtype", [(16, 0, np.float32),
                                            (20, 1, np.float32),
                                            (18, 2, np.float64)])
def test_numpy_marching_equals_jax(G, seed, dtype):
    vals = _field(G, seed).astype(dtype)
    got = tmarching.marching_tetrahedra(vals, 10.0, bound=0.9,
                                        use_native=False)
    ref = jmarching.marching_tetrahedra(vals, 10.0, bound=0.9,
                                        use_native=False)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(got[1]) > 100


@needs_jax_native
@pytest.mark.parametrize("G, seed", [(24, 3), (31, 4)])
def test_native_marching_matches_jax_native(G, seed):
    vals = _field(G, seed)
    vn, fn = tmarching.marching_tetrahedra(vals, 10.0)
    vj, fj = jmarching.marching_tetrahedra(vals, 10.0)
    assert vn.shape == vj.shape and fn.shape == fj.shape
    for a, b in zip(_sorted(vn, fn), _sorted(vj, fj)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_native_marching_matches_numpy():
    """The two weld differently (edge identity, rounded position) and clip
    t differently on flat edges: on a field with no corner at the iso
    value they give the same soup."""
    vals = _field(24, 3)
    vn, fn = tmarching.marching_tetrahedra(vals, 10.0)
    vp, fp = tmarching.marching_tetrahedra(vals, 10.0, use_native=False)
    assert vn.shape == vp.shape and fn.shape == fp.shape
    for a, b in zip(_sorted(vn, fn), _sorted(vp, fp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


_EXTRACT = (
    "import sys, numpy as np; from tpunerf_torch import native; "
    "v, f = native.marching_tets(np.load(sys.argv[1]), 10.0, 1.0); "
    "np.save(sys.argv[2], v); np.save(sys.argv[3], f)")


def test_native_marching_is_the_same_over_calls_and_threads(tmp_path):
    """Two calls here (OpenMP's default threads), then a process each with
    OMP_NUM_THREADS 1 and 4: the same arrays bit for bit."""
    vals = _field(40, 5).astype(np.float32)
    runs = [tnative.marching_tets(vals, 10.0, 1.0) for _ in range(2)]
    np.save(tmp_path / "vals.npy", vals)
    for n in (1, 4):
        out = [tmp_path / f"{k}{n}.npy" for k in "vf"]
        subprocess.run([sys.executable, "-c", _EXTRACT, tmp_path / "vals.npy",
                        *out], cwd=ROOT, check=True,
                       env={**os.environ, "OMP_NUM_THREADS": str(n)})
        runs.append(tuple(np.load(p) for p in out))
    assert len(runs[0][1]) > 1000
    for v, f in runs[1:]:
        assert np.array_equal(v, runs[0][0]) and np.array_equal(f, runs[0][1])


@pytest.mark.parametrize("use_native", [True, False])
def test_marching_is_wound_outward(use_native):
    vals = _field(32, 0, "ellipsoid")
    V, F = tmarching.marching_tetrahedra(vals, 10.0, use_native=use_native)
    nrm = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])
    ctr = V[F].mean(axis=1) - np.array([0.1, -0.05, 0.0])
    assert len(F) > 100 and (np.sum(nrm * ctr, axis=1) > 0).all()


def test_native_marching_is_watertight():
    V, F = tmarching.marching_tetrahedra(_field(20, 6), 10.0)
    cnt = Counter()
    for f in F:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            cnt[(min(a, b), max(a, b))] += 1
    assert set(cnt.values()) == {2}


def test_empty_and_full_fields_give_no_surface():
    for vals in (np.zeros((8, 8, 8)), np.full((8, 8, 8), 20.0)):
        for use_native in (True, False):
            V, F = tmarching.marching_tetrahedra(vals, 10.0,
                                                 use_native=use_native)
            assert V.shape == (0, 3) and F.shape == (0, 3)


# --------------------------------------------------------------------------
# the scene: density grid and iso-surface on the same weights


@pytest.fixture(scope="module")
def scenes():
    js = JScene.create(tiny=True, mlp_dtype="float32")
    params = jax.jit(js.init_params)(jax.random.key(3))
    ts = TScene.create(tiny=True, mlp_dtype="float32", device=CPU)
    load_flax_params(ts, np_tree(params), "scene")
    return js, params, ts


@pytest.mark.parametrize("G", [16, 24])
def test_density_grid_matches_jax(scenes, G):
    js, params, ts = scenes
    ref = js.density_grid(params, G)
    got = ts.density_grid(G)
    assert got.dtype == np.float32 and got.shape == (G, G, G)
    assert_close_to_max(got, ref, 1e-5, "sigma grid")


@needs_jax_native
def test_extract_mesh_matches_jax(scenes):
    js, params, ts = scenes
    vj, fj = js.extract_mesh(params, resolution=24, iso=1.0)
    vt, ft = ts.extract_mesh(resolution=24, iso=1.0)
    assert len(fj) > 10 and vt.shape == vj.shape and ft.shape == fj.shape
    for a, b in zip(_sorted(vt, ft), _sorted(vj, fj)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_export_writes_the_iso_surface(scenes, tmp_path, monkeypatch):
    """`LatentNeRFApp.export` (the trainer's `mesh/`): the 64³ surface as
    an OBJ with its MTL and albedo, the vertices JAX extracts (iso 1 here:
    the tiny random field has none at the default 10)."""
    js, params, ts = scenes
    extract = ts.extract_mesh
    monkeypatch.setattr(ts, "extract_mesh",
                        lambda resolution, iso=10.0: extract(resolution, 1.0))
    LatentNeRFApp(cfg=None, guidance=None, scene=ts, text_z=None
                  ).export(tmp_path)
    lines = (tmp_path / "mesh.obj").read_text().splitlines()
    verts = np.array([ln.split()[1:] for ln in lines if ln.startswith("v ")],
                     np.float32)
    n_faces = sum(ln.startswith("f ") for ln in lines)
    vj, fj = js.extract_mesh(params, resolution=64, iso=1.0)
    assert n_faces == len(fj) > 100
    np.testing.assert_allclose(np.sort(verts, axis=0), np.sort(vj, axis=0),
                               rtol=0, atol=1e-5)
    assert (tmp_path / "mesh.mtl").exists()
    assert (tmp_path / "albedo.png").exists()


# --------------------------------------------------------------------------
# the bridge, train_latent_nerf_mesh


def _flax_tree(template, state, kind: str):
    """The port's state dict as a JAX parameter tree shaped as `template`
    (the inverse of weights.state_dict_from_flax: Dense kernels
    transposed back)."""
    inner = template["params"] if set(template) == {"params"} else template
    names = iter(name for name, _ in flax_entries(template, kind))

    def fill(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            else:
                value = state[next(names)].numpy()
                out[k] = value.T if k == "kernel" else value
                assert out[k].shape == v.shape, k
        return out

    tree = fill(inner)
    return {"params": tree} if inner is not template else tree


def _nerf_cfg(tmp_path):
    return tconfig.TrainConfig(
        log=tconfig.LogConfig(exp_root=tmp_path, exp_name="nm",
                              save_interval=2, eval_size=0, full_eval_size=0,
                              save_mesh=False, log_images=False),
        render=tconfig.RenderConfig(train_grid_size=16, eval_grid_size=16,
                                    num_samples_per_ray=32,
                                    mlp_dtype="float32"),
        optim=tconfig.OptimConfig(iters=2, seed=0),
        guide=tconfig.GuideConfig(text="a castle", tiny_diffusion=True,
                                  unet_dtype="float32",
                                  texture_resolution=32))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two tiny port steps written to a checkpoint."""
    tmp = tmp_path_factory.mktemp("bridge")
    cfg = _nerf_cfg(tmp)
    guidance = StableDiffusionGuidance.create(
        tiny=True, unet_dtype="float32", device=CPU,
        generator=torch.Generator().manual_seed(0))
    app = LatentNeRFApp.create(cfg, guidance=guidance, device=CPU)
    Trainer(cfg, app, device=CPU).train()
    return cfg, guidance


@needs_jax_native
def test_bridge_mesh_equals_jax_from_the_same_checkpoint(trained):
    cfg, _ = trained
    mesh = bridge.extract_mesh_from_checkpoint(cfg, 24, 1.0, device=CPU)
    assert mesh.num_vertices > 10 and mesh.num_faces > 10
    assert mesh.vertices.dtype == torch.float32
    assert mesh.faces.dtype == torch.int32
    params, _, _ = CheckpointManager(cfg.log.exp_dir / "checkpoints").load()
    js = JScene.create(tiny=True, num_samples=32, num_compacted=16,
                       train_grid_size=16, mlp_dtype="float32")
    template = jax.jit(js.init_params)(jax.random.key(0))
    field = {k[len("field."):]: v for k, v in params.items()
             if k.startswith("field.")}
    jparams = {"field": _flax_tree(template["field"], field, "field"),
               "occ_grid": params["occ_grid"].numpy()}
    vj, fj = js.extract_mesh(jparams, resolution=24, iso=1.0)
    assert fj.shape == tuple(mesh.faces.shape)
    for a, b in zip(_sorted(mesh.vertices.numpy(), mesh.faces.numpy()),
                    _sorted(vj, fj)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_bridge_paints_the_extracted_mesh(trained):
    cfg, guidance = trained
    mesh = bridge.extract_mesh_from_checkpoint(cfg, 24, 1.0, device=CPU)
    paint_cfg = bridge.paint_config(cfg)
    paint_cfg.optim.iters = 1
    assert paint_cfg.log.exp_name == "nm_mesh"
    assert paint_cfg.optim.ckpt is None and not paint_cfg.optim.resume
    app = LatentPaintApp.create(paint_cfg, guidance=guidance, mesh=mesh,
                                device=CPU)
    texture = app.scene.texture_img.detach().clone()
    trainer = Trainer(paint_cfg, app, device=CPU)
    losses = []
    trainer.train(on_step=lambda step, loss: losses.append(float(loss)))
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert torch.isfinite(app.scene.texture_img).all()
    assert not torch.equal(texture, app.scene.texture_img.detach())


def test_bridge_cli_trains_on_the_checkpoints_mesh(trained):
    """`python -m tpunerf_torch.train_latent_nerf_mesh`: the newest
    checkpoint of the run, extracted at the configured grid and iso level,
    painted as the `_mesh` experiment."""
    cfg, _ = trained
    bridge.main(["--device", "cpu", "--log.exp_root",
                 str(cfg.log.exp_root), "--log.exp_name", "nm",
                 "--guide.tiny_diffusion", "true", "--guide.text", "a castle",
                 "--guide.texture_resolution", "32",
                 "--render.train_grid_size", "16", "--render.mlp_dtype",
                 "float32", "--render.mc_resolution", "24",
                 "--render.iso_level", "1.0", "--optim.iters", "1",
                 "--log.save_interval", "1", "--log.eval_size", "0",
                 "--log.full_eval_size", "0", "--log.log_images", "false"])
    exp = cfg.log.exp_root / "nm_mesh"
    assert (exp / "checkpoints" / "step_000001.ckpt").exists()
    assert (exp / "mesh" / "mesh.obj").exists()
    with pytest.raises(FileNotFoundError, match="optim.ckpt"):
        bridge.main(["--device", "cpu", "--log.exp_root",
                     str(cfg.log.exp_root), "--log.exp_name", "none",
                     "--guide.tiny_diffusion", "true"])
