"""The entry points that read pretrained weights, against the JAX package
on the same tiny directories: the three guidance backends'
`create(model_dir=...)` (the depth backend with its inpainting UNet's
`inpaint_model_dir`) give the JAX package's weights bit for bit and its SDS
loss and gradient within the guidance tests' tolerances; the apps'
`guide.model_dir` and `guide.clip_model_dir` read the same; the CLIP BPE
tokenizer of a directory's `tokenizer/` gives the JAX package's ids; a
textual-inversion concept with that tokenizer is refused by name; and the
port's `convert_sd_weights` writes the JAX script's `.npz` members, name for
name and byte for byte."""
import dataclasses
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close_to_max, one_torch_thread  # noqa: F401
from _torch_weights import assert_same, pbe_sd, save, text_sd, vae_sd, \
    vision_sd
from test_weights_converter import _make_unet_sd
from tpunerf.guidance import sds as jsds
from tpunerf.guidance.clip_text import BPETokenizer as JBPE
from tpunerf.guidance.depth import StableDiffusionDepthGuidance as JDepth
from tpunerf.guidance.paint_by_example import PaintByExampleGuidance as JPbE
from tpunerf.guidance.stable_diffusion import StableDiffusionGuidance as JSD
from tpunerf.guidance.unet import UNetConfig as JUNetConfig
from tpunerf.training import config as jconfig
from tpunerf_torch.guidance.clip_text import BPETokenizer
from tpunerf_torch.guidance.depth import StableDiffusionDepthGuidance
from tpunerf_torch.guidance.paint_by_example import PaintByExampleGuidance
from tpunerf_torch.guidance.stable_diffusion import StableDiffusionGuidance
from tpunerf_torch.scripts import convert_sd_weights as tconvert
from tpunerf_torch.training import config as tconfig

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
# the guidance tests' tolerances: ε̂'s agreement ×100 (CFG) in the SDS
# gradient, relative to its largest value, and the loss on its scale
SDS_REL = 1e-4

# a small CLIP BPE vocabulary: the specials, letters, their word ends and
# the merges of a few words
_LETTERS = "abcdefghijklmnopqrstuvwxyz"
_MERGES = ["c a", "ca t</w>", "s a", "n d</w>", "sa nd</w>", "l e", "g o</w>",
           "le go</w>", "m a", "n</w>"]


def write_tokenizer(directory):
    vocab = ["<|startoftext|>", "<|endoftext|>", "</w>"]
    vocab += list(_LETTERS) + [c + "</w>" for c in _LETTERS] + list("!,.-'")
    vocab += ["".join(m.split()) for m in _MERGES]
    (directory / "tokenizer").mkdir(parents=True, exist_ok=True)
    (directory / "tokenizer" / "vocab.json").write_text(
        json.dumps({t: i for i, t in enumerate(dict.fromkeys(vocab))}))
    (directory / "tokenizer" / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(_MERGES) + "\n")


def _unet_sd(cin):
    return _make_unet_sd(JUNetConfig.tiny(in_channels=cin))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Tiny directories in mixed file forms: SD v1 (F16 UNet, the VAE in
    the older attention naming as BF16, `text_encoder/pytorch_model.bin`
    with the prefix, and a tokenizer), SD2-depth (F32 5-channel UNet, .bin
    VAE, bare `text_encoder/model.safetensors`), an inpainting UNet (.bin),
    Paint-by-Example (BF16 UNet, F32 VAE, `image_encoder/pytorch_model` as
    F16 with the bare tower) and a CLIP tower (`model.safetensors`)."""
    root = tmp_path_factory.mktemp("weights")
    d = {name: root / name for name in ("sd", "depth", "inpaint", "pbe",
                                        "clip")}
    unet = "unet/diffusion_pytorch_model"
    vae = "vae/diffusion_pytorch_model"
    save(d["sd"] / unet, _unet_sd(4), "F16")
    save(d["sd"] / vae, vae_sd(old_names=True), "BF16")
    save(d["sd"] / "text_encoder" / "pytorch_model", text_sd(), "bin")
    write_tokenizer(d["sd"])
    save(d["depth"] / unet, _unet_sd(5), "F32")
    save(d["depth"] / vae, vae_sd(), "bin")
    save(d["depth"] / "text_encoder" / "model", text_sd(prefixed=False),
         "F32")
    save(d["inpaint"] / unet, _unet_sd(9), "bin")
    save(d["pbe"] / unet, _unet_sd(9), "BF16")
    save(d["pbe"] / vae, vae_sd(), "F32")
    save(d["pbe"] / "image_encoder" / "pytorch_model", pbe_sd(prefix=""),
         "F16")
    save(d["clip"] / "model", vision_sd(), "F32")
    return d


@pytest.fixture(scope="module")
def sd_pair(dirs):
    return (JSD.create(jax.random.key(0), tiny=True, model_dir=dirs["sd"]),
            StableDiffusionGuidance.create(tiny=True, model_dir=dirs["sd"],
                                           device=CPU))


@pytest.fixture(scope="module")
def depth_pair(dirs):
    kw = dict(tiny=True, model_dir=dirs["depth"], use_inpaint=True,
              inpaint_model_dir=dirs["inpaint"])
    return (JDepth.create(jax.random.key(0), **kw),
            StableDiffusionDepthGuidance.create(device=CPU, **kw))


@pytest.fixture(scope="module")
def pbe_pair(dirs):
    return (JPbE.create(jax.random.key(0), tiny=True, model_dir=dirs["pbe"]),
            PaintByExampleGuidance.create(tiny=True, model_dir=dirs["pbe"],
                                          device=CPU))


def assert_sd_stack(jg, tg):
    assert_same(tg.unet, jg.unet_params, "unet")
    assert_same(tg.vae, jg.vae_params, "vae")
    assert_same(tg.text_encoder, jg.text_params, "clip_text")


def _lat(seed, n=16):
    return np.random.default_rng(seed).normal(size=(1, n, n, 4)).astype(
        np.float32)


def test_sd_create_reads_the_directory_as_jax(sd_pair):
    jg, tg = sd_pair
    assert_sd_stack(jg, tg)
    assert isinstance(tg.tokenizer, BPETokenizer)
    emb_j = np.asarray(jg.get_text_embeds(["a cat on sand"]))
    emb_t = tg.get_text_embeds(["a cat on sand"])
    np.testing.assert_allclose(emb_t.numpy(), emb_j, atol=2e-5)
    # one SDS loss and its gradient, the draws replayed from the JAX key
    lat, key = _lat(1), jax.random.key(7)
    loss_j, grad_j = jax.jit(jax.value_and_grad(
        lambda x: jg.train_step_loss(key, jnp.asarray(emb_j), x)))(
        jnp.asarray(lat))
    k_t, k_n = jax.random.split(key)
    t = int(jsds.sample_timestep(k_t, jg.min_step, jg.max_step))
    noise = torch.from_numpy(np.asarray(jax.random.normal(k_n, lat.shape)))
    x = torch.from_numpy(lat).requires_grad_(True)
    loss_t = tg.train_step_loss(torch.from_numpy(emb_j), x, 100.0,
                                t=torch.tensor(t), noise=noise)
    loss_t.backward()
    assert_close_to_max(x.grad.numpy(), np.asarray(grad_j), SDS_REL,
                        "SDS gradient")
    scale = float(np.sum(np.abs(lat * np.asarray(grad_j))))
    assert abs(loss_t.item() - float(loss_j)) <= SDS_REL * scale


def test_depth_create_reads_both_directories_as_jax(depth_pair):
    jg, tg = depth_pair
    assert_sd_stack(jg, tg)
    assert_same(tg.inpaint_unet, jg.inpaint_unet_params, "unet")
    assert tg.inpaint_unet.conv_in.weight.shape[1] == 9
    lat = _lat(2)
    depth = np.random.default_rng(3).uniform(
        -1, 1, size=(1, 64, 64, 1)).astype(np.float32)
    emb_j = jg.get_text_embeds(["a nascar"])
    emb_t = tg.get_text_embeds(["a nascar"])
    key = jax.random.key(8)
    loss_j, grad_j = jax.jit(jax.value_and_grad(
        lambda x: jg.train_step_loss(key, emb_j, x, jnp.asarray(depth))))(
        jnp.asarray(lat))
    k_t, k_n = jax.random.split(key)
    t = int(jsds.sample_timestep(k_t, jg.min_step, jg.max_step))
    noise = torch.from_numpy(np.asarray(jax.random.normal(k_n, lat.shape)))
    x = torch.from_numpy(lat).requires_grad_(True)
    loss_t = tg.train_step_loss(emb_t, x, torch.from_numpy(depth),
                                t=torch.tensor(t), noise=noise)
    loss_t.backward()
    assert_close_to_max(x.grad.numpy(), np.asarray(grad_j), SDS_REL, "grad")
    scale = float(np.sum(np.abs(lat * np.asarray(grad_j))))
    assert abs(loss_t.item() - float(loss_j)) <= SDS_REL * scale


def test_depth_inpainting_unet_stays_random_without_its_directory(dirs):
    g = StableDiffusionDepthGuidance.create(
        tiny=True, model_dir=dirs["depth"], use_inpaint=True, device=CPU,
        generator=torch.Generator().manual_seed(0))
    w = g.inpaint_unet.conv_in.weight
    assert w.shape[1] == 9 and torch.isfinite(w).all() and w.std() > 0
    # drawn from the generator: the loaded stack took no draw before it
    again = StableDiffusionDepthGuidance.create(
        tiny=True, model_dir=dirs["depth"], use_inpaint=True, device=CPU,
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, again.inpaint_unet.conv_in.weight)


def test_pbe_create_reads_the_directory_as_jax(pbe_pair):
    jg, tg = pbe_pair
    assert_same(tg.unet, jg.unet_params, "unet")
    assert_same(tg.vae, jg.vae_params, "vae")
    assert_same(tg.image_encoder, jg.image_encoder_params,
                "pbe_image_encoder")
    rng = np.random.default_rng(4)
    lat = _lat(5)
    mask = np.zeros((1, 16, 16, 1), np.float32)
    mask[:, 4:12, 4:12] = 1.0
    img = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    emb = jg.encode_exemplar(jnp.asarray(img))
    np.testing.assert_allclose(
        tg.encode_exemplar(torch.from_numpy(img)).numpy(), np.asarray(emb),
        rtol=1e-5, atol=1e-5)
    key, t = jax.random.key(9), 500
    loss_j, grad_j = jax.jit(jax.value_and_grad(
        lambda x: dataclasses.replace(jg, min_step=t, max_step=t)
        .train_step_loss(key, x, jnp.asarray(mask), emb)))(jnp.asarray(lat))
    _, k_n = jax.random.split(key)
    noise = torch.from_numpy(np.asarray(jax.random.normal(k_n, lat.shape)))
    x = torch.from_numpy(lat).requires_grad_(True)
    loss_t = tg.train_step_loss(x, torch.from_numpy(mask),
                                torch.from_numpy(np.asarray(emb)),
                                t=torch.tensor(t), noise=noise)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=SDS_REL)
    assert_close_to_max(x.grad.numpy(), np.asarray(grad_j), SDS_REL,
                        "d loss / d latents")


def _cfg(mod, tmp_path, **guide):
    return mod.TrainConfig(
        log=mod.LogConfig(exp_name="w", exp_root=tmp_path, eval_size=0,
                          full_eval_size=0, save_mesh=False,
                          log_images=False, save_interval=1000),
        render=mod.RenderConfig(train_grid_size=24, eval_grid_size=32),
        optim=mod.OptimConfig(iters=1, seed=0),
        guide=mod.GuideConfig(text="a red car", shape_path="sphere",
                              tiny_diffusion=True, texture_resolution=32,
                              unet_dtype="float32", **guide))


@pytest.mark.parametrize("app", ["latent_nerf", "latent_paint",
                                 "latent_paint_mesh", "latent_paint_mesh_depth",
                                 "latent_paint_mesh_pbe"])
def test_apps_read_guide_model_dir_as_jax(dirs, sd_pair, depth_pair,
                                          pbe_pair, tmp_path, app):
    """Each app builds its backend from `guide.model_dir`: the SD-v1 stack
    (latent-NeRF, whose NeRF→mesh bridge builds latent-paint's, and the
    paint apps), SD2-depth and Paint-by-Example in latent-paint-mesh."""
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
    from tpunerf_torch.training.latent_paint import LatentPaintApp
    from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
    from tpunerf_torch.utils import write_png
    guide = {"latent_paint_mesh_depth": dict(model_dir=dirs["depth"],
                                             diffusion_name="sd-depth"),
             "latent_paint_mesh_pbe": dict(model_dir=dirs["pbe"],
                                           use_sd=False, image=tmp_path
                                           / "e.png")}.get(
        app, dict(model_dir=dirs["sd"]))
    if "image" in guide:
        write_png(guide["image"], np.full((64, 64, 3), 90, np.uint8))
    cfg = _cfg(tconfig, tmp_path, **guide)
    cls = {"latent_nerf": LatentNeRFApp,
           "latent_paint": LatentPaintApp}.get(app, LatentPaintMeshApp)
    built = cls.create(cfg, device=CPU)
    g = built.guidance
    if app == "latent_paint_mesh_pbe":
        jg = pbe_pair[0]
        assert_same(g.unet, jg.unet_params, "unet")
        assert_same(g.image_encoder, jg.image_encoder_params,
                    "pbe_image_encoder")
    else:
        assert_sd_stack((depth_pair if "depth" in app else sd_pair)[0], g)


def test_clip_model_dir_reads_the_tower_as_jax(dirs, sd_pair, tmp_path):
    """`guide.clip_model_dir`: the tower of the CLIP losses, read as the
    JAX package's `_make_clip_embedder` reads it, and through the app."""
    from tpunerf.training.latent_paint_mesh import _make_clip_embedder
    from tpunerf_torch.training.latent_paint_mesh import (LatentPaintMeshApp,
                                                          make_clip_embedder)
    from tpunerf_torch.utils import write_png
    jcfg = _cfg(jconfig, tmp_path, clip_model_dir=dirs["clip"])
    _, jparams = _make_clip_embedder(jcfg)
    tcfg = _cfg(tconfig, tmp_path, clip_model_dir=dirs["clip"])
    assert_same(make_clip_embedder(tcfg, CPU), jparams, "clip_vision")
    tcfg.guide.image = tmp_path / "ref.png"
    write_png(tcfg.guide.image, np.full((64, 64, 3), 40, np.uint8))
    app = LatentPaintMeshApp.create(tcfg, guidance=sd_pair[1], device=CPU)
    assert_same(app.clip, jparams, "clip_vision")


def test_cli_trains_from_guide_model_dir(dirs, tmp_path):
    from tpunerf_torch.train_latent_nerf import main
    main(["--device", "cpu", "--guide.tiny_diffusion", "true",
          "--guide.model_dir", str(dirs["sd"]), "--optim.iters", "2",
          "--render.train_grid_size", "8", "--render.num_samples_per_ray",
          "16", "--log.exp_root", str(tmp_path), "--log.eval_size", "0",
          "--log.full_eval_size", "0", "--log.save_mesh", "false",
          "--log.log_images", "false", "--log.save_interval", "100",
          "--log.exp_name", "w"])
    exp = tmp_path / "w"
    assert str(dirs["sd"]) in (exp / "config.yaml").read_text()
    assert "Finished Training" in (exp / "log.txt").read_text()


PROMPTS = ["a cat", "A Sand-castle!", "lego man, side view", "", "catsand",
           "mango's go-kart 42"]


def test_bpe_tokenizer_gives_the_jax_ids(tmp_path):
    write_tokenizer(tmp_path)
    files = (tmp_path / "tokenizer" / "vocab.json",
             tmp_path / "tokenizer" / "merges.txt")
    ids = BPETokenizer(*files, max_length=16)(PROMPTS)
    np.testing.assert_array_equal(ids, JBPE(*files, max_length=16)(PROMPTS))
    # merged words take one id each; every row ends on the end token
    vocab = json.loads(files[0].read_text())
    assert list(ids[0, :4]) == [vocab[t] for t in (
        "<|startoftext|>", "a</w>", "cat</w>", "<|endoftext|>")]


def test_a_concept_with_the_bpe_tokenizer_is_refused_by_name(
        dirs, sd_pair, tmp_path):
    """The JAX package ends such a pair in an AttributeError (its BPE
    tokenizer has no `add_token`); the port refuses it by name."""
    concept = tmp_path / "cat-toy"
    concept.mkdir()
    (concept / "token_identifier.txt").write_text("<cat-toy>")
    torch.save({"<cat-toy>": torch.zeros(32)},
               concept / "learned_embeds.bin")
    jg, tg = sd_pair
    with pytest.raises(AttributeError):
        jg.maybe_load_concept(str(concept))
    with pytest.raises(NotImplementedError, match="tokenizer"):
        tg.maybe_load_concept(str(concept))
    assert tg.text_encoder.embeddings.token_embedding.weight.shape[0] == \
        jg.text_encoder.config.vocab_size


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return [(i.filename, zf.read(i.filename)) for i in zf.infolist()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_writes_the_jax_scripts_members(sd_pair, tmp_path, dtype):
    """The port's writer on the tiny stack, against the JAX script's own
    flattening, cast and `np.savez` on the JAX trees of the same
    directory."""
    from scripts.convert_sd_weights import flatten_tree
    jg, tg = sd_pair
    np_dtype = np.float32 if dtype == "float32" else jnp.bfloat16

    def cast(t):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np_dtype), t)

    flat = {}
    flat.update(flatten_tree(cast(jg.unet_params), "unet"))
    flat.update(flatten_tree(cast(jg.vae_params), "vae"))
    flat.update(flatten_tree(cast(jg.text_params), "text"))
    np.savez(tmp_path / "jax.npz", **flat)
    tconvert.write_npz(tmp_path / "port.npz", tconvert.flat_params(
        tg.unet, tg.vae, tg.text_encoder, dtype))
    ref, got = _members(tmp_path / "jax.npz"), _members(tmp_path / "port.npz")
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (name, a), (_, b) in zip(got, ref):
        assert a == b, name
    assert ref[0][0] == "unet['params']['conv_in']['bias'].npy"
