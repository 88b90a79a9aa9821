"""The port's pretrained-weight loaders (tpunerf_torch/guidance/weights.py)
and its safetensors reader against the JAX package's loaders
(tpunerf/guidance/weights.py) and the `safetensors` package, on tiny
diffusers- and transformers-layout files written here.

Every loaded module equals the JAX package's loaded tree bit for bit (the
tree through the flax bridge, `state_dict_from_flax`), for every variant of
the layout (UNets of 4, 5 and 9 input channels, both VAE attention
namings, text and vision towers with and without their prefix,
`pre_layrnorm` or `pre_layernorm`, the Paint-by-Example encoder) in every
file form (.bin, F32, F16 and BF16 safetensors); the same faults raise the
same exception class in both packages. The JAX side runs its own reader
and converters and `_check_tree` against `jax.eval_shape` of its module's
init, computed once a module here (what its `load_*` functions do, less
the repeated trace)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch

from _torch_port import one_torch_thread  # noqa: F401
from _torch_weights import (FORMS, assert_same, pbe_sd, save, text_sd,
                            vae_sd, vision_sd)
from test_weights_converter import _make_unet_sd
from tpunerf.guidance import weights as jw
from tpunerf.guidance.clip_text import CLIPTextConfig as JTextConfig
from tpunerf.guidance.clip_text import CLIPTextModel as JText
from tpunerf.guidance.clip_vision import CLIPImageEmbedder as JEmbedder
from tpunerf.guidance.clip_vision import CLIPVisionConfig as JVisionConfig
from tpunerf.guidance.paint_by_example import \
    PaintByExampleImageEncoder as JEncoder
from tpunerf.guidance.unet import UNet2DCondition as JUNet
from tpunerf.guidance.unet import UNetConfig as JUNetConfig
from tpunerf.guidance.unet import apply_unet_dtype
from tpunerf.guidance.vae import AutoencoderKL as JVAE
from tpunerf.guidance.vae import VAEConfig as JVAEConfig
from tpunerf_torch.guidance import weights as tw
from tpunerf_torch.guidance.clip_text import CLIPTextConfig, CLIPTextModel
from tpunerf_torch.guidance.clip_vision import (CLIPImageEmbedder,
                                                CLIPVisionConfig)
from tpunerf_torch.guidance.paint_by_example import (
    PaintByExampleImageEncoder, pbe_num_mapper_blocks)
from tpunerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from tpunerf_torch.guidance.vae import AutoencoderKL, VAEConfig
from tpunerf_torch.safetensors_io import read_safetensors

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_KEY = jax.random.key(0)

# (JAX module, its init's inputs), by the kind of tiny module
def _jax_modules():
    tiny = JVisionConfig.tiny()
    return {
        "unet4": (JUNet(JUNetConfig.tiny()), 4),
        "unet5": (JUNet(JUNetConfig.tiny(in_channels=5)), 5),
        "unet9": (JUNet(JUNetConfig.tiny(in_channels=9)), 9),
        "vae": (JVAE(JVAEConfig.tiny()), None),
        "text": (JText(JTextConfig.tiny()), None),
        "vision": (JEmbedder(tiny), None),
        "pbe": (JEncoder(tiny, proj_dim=32), None),
    }


@functools.lru_cache(maxsize=None)
def jax_shapes(what):
    module, cin = _jax_modules()[what]
    if cin is not None:
        return jax.eval_shape(module.init, _KEY, jnp.zeros((1, 8, 8, cin)),
                              jnp.zeros((1,), jnp.int32),
                              jnp.zeros((1, 77, 32)))
    if what == "vae":
        return jax.eval_shape(module.init, _KEY, jnp.zeros((1, 32, 32, 3)),
                              _KEY)
    if what == "text":
        return jax.eval_shape(module.init, _KEY, jnp.zeros(
            (1, JTextConfig.tiny().max_length), jnp.int32))
    return jax.eval_shape(module.init, _KEY, jnp.zeros((1, 32, 32, 3)))


def jax_load(what, base):
    """The JAX package's loader of one tiny module from `base`: its reader,
    its converter and `_check_tree`."""
    sd = jw._load_state_dict(base)
    vis = JVisionConfig.tiny()
    if what.startswith("unet"):
        tree = jw.convert_unet(sd, _jax_modules()[what][0].config)
    elif what == "vae":
        tree = jw.convert_vae(sd, JVAEConfig.tiny())
    elif what == "text":
        tree = jw.convert_clip_text(sd, JTextConfig.tiny())
    elif what == "vision":
        tree = jw.convert_clip_vision(sd, vis)
    else:
        tree = jw.convert_pbe_image_encoder(sd, vis,
                                            pbe_num_mapper_blocks(vis))
    return jw._check_tree(tree, jax_shapes(what), what)


PORT = {
    "unet4": ("unet", lambda: UNet2DCondition(UNetConfig.tiny())),
    "unet5": ("unet", lambda: UNet2DCondition(UNetConfig.tiny(in_channels=5))),
    "unet9": ("unet", lambda: UNet2DCondition(UNetConfig.tiny(in_channels=9))),
    "vae": ("vae", lambda: AutoencoderKL(VAEConfig.tiny())),
    "text": ("clip_text", lambda: CLIPTextModel(CLIPTextConfig.tiny())),
    "vision": ("clip_vision",
               lambda: CLIPImageEmbedder(CLIPVisionConfig.tiny())),
    "pbe": ("pbe_image_encoder", lambda: PaintByExampleImageEncoder(
        CLIPVisionConfig.tiny(), 32)),
}


def port_load(what, base):
    """The port's loader of one tiny module from `base`: a module on the
    meta device given storage on the CPU and filled."""
    kind, make = PORT[what]
    with torch.device("meta"):
        module = make()
    return tw.fill_(module, tw.convert(module, tw._load_state_dict(base),
                                       kind, what), torch.device("cpu"))


VARIANTS = {
    "unet4": ("unet4", lambda: _make_unet_sd(JUNetConfig.tiny())),
    "unet5": ("unet5", lambda: _make_unet_sd(JUNetConfig.tiny(
        in_channels=5))),
    "unet9": ("unet9", lambda: _make_unet_sd(JUNetConfig.tiny(
        in_channels=9))),
    "vae": ("vae", vae_sd),
    "vae_old_names": ("vae", lambda: vae_sd(old_names=True)),
    "text_prefixed": ("text", text_sd),
    "text_bare": ("text", lambda: text_sd(prefixed=False)),
    "vision_prefixed": ("vision", vision_sd),
    "vision_bare_pre_layernorm": ("vision", lambda: vision_sd(
        prefix="", pre_ln="pre_layernorm")),
    "pbe_encoder": ("pbe", pbe_sd),
    "pbe_encoder_bare_tower": ("pbe", lambda: pbe_sd(prefix="")),
}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loaded_module_equals_the_jax_tree(tmp_path, variant, form):
    what, make_sd = VARIANTS[variant]
    written = save(tmp_path / "m", make_sd(), form)
    module = port_load(what, tmp_path / "m")
    assert_same(module, jax_load(what, tmp_path / "m"), PORT[what][0])
    # and the file's values themselves, widened, where a leaf is not
    # transposed on the JAX side (the tower's names differ: see assert_same)
    for name, value in module.state_dict().items():
        if name in written:
            assert torch.equal(value, written[name].float()), name


def test_f32_into_the_bf16_unet_rounds_as_apply_unet_dtype(tmp_path):
    """An F32 file into a bf16 UNet: nearest-even rounding on the copy, as
    the JAX package's `apply_unet_dtype` casts its loaded tree."""
    save(tmp_path / "unet" / "diffusion_pytorch_model",
         _make_unet_sd(JUNetConfig.tiny()), "F32")
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.tiny()).to(torch.bfloat16)
    tw.load_unet_params(tmp_path, unet, torch.device("cpu"))
    assert all(p.dtype == torch.bfloat16 for p in unet.parameters())
    jnet = JUNet(JUNetConfig.tiny())
    tree = jax.jit(lambda p: apply_unet_dtype(jnet, p, "bfloat16")[1])(
        jax_load("unet4", tmp_path / "unet" / "diffusion_pytorch_model"))
    assert all(a.dtype == jnp.bfloat16 for a in jax.tree_util.tree_leaves(
        tree))
    assert_same(unet, tree, "unet")


def test_safetensors_is_read_before_bin(tmp_path):
    sd = _make_unet_sd(JUNetConfig.tiny())
    base = tmp_path / "unet" / "diffusion_pytorch_model"
    save(base, {k: v + 1 for k, v in sd.items()}, "bin")
    save(base, sd, "F32")
    jnet = JUNet(JUNetConfig.tiny())
    unet = UNet2DCondition(UNetConfig.tiny())
    tw.load_unet_params(tmp_path, unet)
    assert_same(unet, jw.load_unet_params(tmp_path, jnet), "unet")
    assert torch.equal(unet.conv_in.bias, torch.from_numpy(
        sd["conv_in.bias"]))


@pytest.mark.parametrize("files", [("model", "pytorch_model"),
                                   ("pytorch_model",)])
def test_model_is_probed_before_pytorch_model(tmp_path, files):
    """transformers' two names for a CLIP tower's file, `model` first."""
    sd = vision_sd()
    for i, name in enumerate(reversed(files)):
        save(tmp_path / name, {k: v + i for k, v in sd.items()},
             "F32" if name == "model" else "bin")
    embedder = CLIPImageEmbedder(CLIPVisionConfig.tiny())
    tw.load_clip_vision_params(tmp_path, embedder)
    tree = jw.load_clip_vision_params(tmp_path, _jax_modules()["vision"][0])
    assert_same(embedder, tree, "clip_vision")
    shift = len(files) - 1
    assert torch.equal(embedder.vision_model.post_layernorm.bias,
                       torch.from_numpy(sd["vision_model.post_layernorm.bias"]
                                        + shift))


def _drop(key):
    return lambda sd: {k: v for k, v in sd.items() if k != key}


def _reshape(key, shape):
    return lambda sd: {**sd, key: np.zeros(shape, np.float32)}


_PROJ_IN = "down_blocks.0.attentions.0.proj_in.weight"
_SHORTCUT = "up_blocks.1.resnets.0.conv_shortcut"
FAULTS = {
    # a key the converter reads and the file lacks
    "missing_key": ("unet4", _drop("conv_in.bias"), KeyError),
    "missing_mapper_block": ("pbe", _drop("mapper.blocks.0.norm1.bias"),
                             KeyError),
    # a leaf of another shape
    "wrong_shape": ("unet4", _reshape("conv_in.weight", (33, 4, 3, 3)),
                    ValueError),
    # an SD-2 snapshot's linear projections, 2-D where SD v1 has 1×1 convs
    "sd2_linear_proj_in": ("unet4", _reshape(_PROJ_IN, (32, 32)),
                           ValueError),
    "wrong_text_width": ("text", _reshape(
        "text_model.final_layer_norm.weight", (33,)), ValueError),
    # a shortcut on one side only
    "shortcut_the_module_lacks": ("unet4", lambda sd: {
        **sd, "down_blocks.0.resnets.0.conv_shortcut.weight":
        np.zeros((32, 32, 1, 1), np.float32),
        "down_blocks.0.resnets.0.conv_shortcut.bias":
        np.zeros(32, np.float32)}, ValueError),
    "shortcut_the_file_lacks": ("unet4", lambda sd: {
        k: v for k, v in sd.items() if not k.startswith(_SHORTCUT)},
        ValueError),
    # the embedder's projection absent from the file
    "no_visual_projection": ("vision", _drop("visual_projection.weight"),
                             ValueError),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_the_same_fault_raises_the_same_class(tmp_path, fault):
    what, edit, exc = FAULTS[fault]
    make_sd = {"unet4": VARIANTS["unet4"][1], "pbe": pbe_sd,
               "text": text_sd, "vision": vision_sd}[what]
    save(tmp_path / "m", edit(dict(make_sd())), "F32")
    with pytest.raises(exc) as err_jax:
        jax_load(what, tmp_path / "m")
    with pytest.raises(exc) as err_port:
        port_load(what, tmp_path / "m")
    if exc is ValueError:
        words = "param-tree mismatch" if "param-tree" in str(
            err_jax.value) else "shape mismatch"
        assert words in str(err_port.value), (err_jax.value, err_port.value)


def test_a_missing_file_raises_file_not_found_in_both(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        jw.load_unet_params(tmp_path, JUNet(JUNetConfig.tiny()))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tw.load_unet_params(tmp_path, UNet2DCondition(UNetConfig.tiny()))
    with pytest.raises(FileNotFoundError, match="no model"):
        jw.load_clip_vision_params(tmp_path, _jax_modules()["vision"][0])
    with pytest.raises(FileNotFoundError, match="no model"):
        tw.load_clip_vision_params(
            tmp_path, CLIPImageEmbedder(CLIPVisionConfig.tiny()))


# --------------------------------------------------------------------------
# the reader against the safetensors package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64, torch.uint8,
                                   torch.float64])
def test_reader_matches_the_safetensors_package(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn((3, 5, 7), generator=g).to(dtype),
               "b.weight": torch.randn((1,), generator=g).to(dtype),
               "empty": torch.zeros((0, 4), dtype=dtype),
               "scalar": torch.tensor(2.5).to(dtype)}
    path = tmp_path / "t.safetensors"
    safetensors.torch.save_file(tensors, path,
                                metadata={"format": "pt", "note": "x"})
    ref = safetensors.torch.load_file(path)
    got = read_safetensors(path)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and \
            got[k].shape == ref[k].shape, k
        assert torch.equal(got[k], ref[k]), k


def _raw_file(path, header: dict, data: bytes, pad: bool = True):
    import json
    text = json.dumps(header).encode()
    if pad:
        text += b" " * (-len(text) % 8)
    path.write_bytes(len(text).to_bytes(8, "little") + text + data)


def test_reader_takes_an_unaligned_header(tmp_path):
    """A header whose length is no multiple of 8 (the format does not ask
    for padding): the tensors are copied into aligned storage."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    path = tmp_path / "u.safetensors"
    _raw_file(path, {"x": {"dtype": "F32", "shape": [2, 3],
                           "data_offsets": [0, 24]},
                     "__metadata__": {"k": "v"}},
              x.numpy().tobytes(), pad=False)
    got = read_safetensors(path)
    assert torch.equal(got["x"], x)


@pytest.mark.parametrize("case", ["truncated_data", "header_past_end",
                                  "unknown_dtype", "offsets_not_shape"])
def test_reader_refuses_a_bad_file(tmp_path, case):
    path = tmp_path / "bad.safetensors"
    if case == "truncated_data":
        safetensors.torch.save_file({"x": torch.ones(100)}, path)
        path.write_bytes(path.read_bytes()[:-40])
    elif case == "header_past_end":
        path.write_bytes((1000).to_bytes(8, "little") + b"{}")
    elif case == "unknown_dtype":
        safetensors.torch.save_file(
            {"x": torch.ones(4).to(torch.float8_e4m3fn)}, path)
    else:
        _raw_file(path, {"x": {"dtype": "F32", "shape": [2, 3],
                               "data_offsets": [0, 20]}}, bytes(24))
    with pytest.raises(ValueError):
        read_safetensors(path)
