"""Helpers shared by the JAX-vs-port tests of the PyTorch port
(tests/test_torch_*.py other than test_torch_parity.py): JAX trees as
numpy, a tolerance check, the tiny guidance stacks rebuilt in the port from
the JAX ones' weights."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch


def np_tree(tree):
    """A JAX parameter tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close_to_max(actual, expected, rel: float, what: str = ""):
    """|actual − expected| ≤ rel · max|expected|, elementwise."""
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape, (what, actual.shape,
                                            expected.shape)
    tol = rel * max(float(np.abs(expected).max()), 1e-30)
    err = float(np.abs(actual - expected).max())
    assert err <= tol, f"{what}: max error {err:.3e} > {tol:.3e}"


def port_guidance(jax_guidance):
    """The port's tiny StableDiffusionGuidance (f32, CPU) holding the JAX
    guidance's UNet and text-tower weights."""
    from tpunerf_torch.guidance.stable_diffusion import \
        StableDiffusionGuidance
    from tpunerf_torch.weights import load_flax_params
    g = StableDiffusionGuidance.create(tiny=True, unet_dtype="float32",
                                       device=torch.device("cpu"))
    load_flax_params(g.unet, np_tree(jax_guidance.unet_params), "unet")
    load_flax_params(g.text_encoder, np_tree(jax_guidance.text_params),
                     "clip_text")
    g.min_step, g.max_step = jax_guidance.min_step, jax_guidance.max_step
    return g


def port_depth_guidance(jax_depth):
    """The port's tiny StableDiffusionDepthGuidance (f32, CPU, with the
    inpainting UNet) holding the JAX depth stack's weights: both UNets, the
    text tower and the VAE."""
    from tpunerf_torch.guidance.depth import StableDiffusionDepthGuidance
    from tpunerf_torch.weights import load_flax_params
    g = StableDiffusionDepthGuidance.create(
        tiny=True, use_inpaint=jax_depth.inpaint_unet is not None,
        unet_dtype="float32", device=torch.device("cpu"))
    load_flax_params(g.unet, np_tree(jax_depth.unet_params), "unet")
    if g.inpaint_unet is not None:
        load_flax_params(g.inpaint_unet,
                         np_tree(jax_depth.inpaint_unet_params), "unet")
    load_flax_params(g.text_encoder, np_tree(jax_depth.text_params),
                     "clip_text")
    load_flax_params(g.vae, np_tree(jax_depth.vae_params), "vae")
    g.min_step, g.max_step = jax_depth.min_step, jax_depth.max_step
    return g


def pbe_stacks(directory):
    """The tiny Paint-by-Example stack of the port (f32, CPU, random from
    seed 0) and the JAX package's holding the same weights: the port's
    state dicts, saved in diffusers' layout under `directory`, loaded by the
    JAX package's own checkpoint loader (`create(model_dir=...)`), which
    checks every key and shape. Far cheaper than flax's init of the tiny
    stack, and the port's names proven to be diffusers'."""
    from pathlib import Path

    from tpunerf.guidance.paint_by_example import \
        PaintByExampleGuidance as JPbE
    from tpunerf_torch.guidance.paint_by_example import \
        PaintByExampleGuidance
    g = PaintByExampleGuidance.create(
        tiny=True, unet_dtype="float32", device=torch.device("cpu"),
        generator=torch.Generator().manual_seed(0))
    for sub, module, name in (
            ("unet", g.unet, "diffusion_pytorch_model"),
            ("vae", g.vae, "diffusion_pytorch_model"),
            ("image_encoder", g.image_encoder, "pytorch_model")):
        (Path(directory) / sub).mkdir(parents=True, exist_ok=True)
        torch.save(module.state_dict(), Path(directory) / sub / f"{name}.bin")
    jg = JPbE.create(jax.random.key(0), tiny=True, model_dir=directory)
    assert (jg.min_step, jg.max_step) == (g.min_step, g.max_step)
    return jg, g


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch thread for a module: the test workers share the host's
    cores, and a pool of a thread a core in each worker oversubscribes
    them (a case of 1 s alone then takes 100 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
