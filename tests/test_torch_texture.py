"""The port's texture sampling and resizes against the JAX package's, f32,
inputs made with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunerf.kernels import texture as JT
from tpunerf_torch.kernels import texture as TT


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_texture_mapping_matches_jax(mode, rng):
    tex = rng.normal(size=(2, 9, 13, 4)).astype(np.float32)
    # inside, on the border, and out of range (zero padding)
    uv = rng.uniform(-0.2, 1.2, size=(2, 7, 11, 2)).astype(np.float32)
    uv[0, 0, :4] = [[0.0, 0.0], [1.0, 1.0], [0.5, 0.5], [1.0, 0.0]]
    ref = np.asarray(JT.texture_mapping(jnp.asarray(uv), jnp.asarray(tex),
                                        mode=mode))
    got = TT.texture_mapping(_t(uv), _t(tex), mode=mode).numpy()
    assert got.shape == (2, 7, 11, 4)
    # the same taps and f32 weights, summed in another order
    np.testing.assert_allclose(got, ref, atol=2e-6)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_out_of_range_samples_are_zero(mode):
    tex = torch.ones((1, 4, 4, 3))
    uv = torch.tensor([[[3.0, 3.0], [-2.0, 0.5], [0.5, -2.0]]])
    assert TT.texture_mapping(uv, tex, mode=mode).abs().max() == 0


def test_v_is_flipped_and_rows_start_at_the_top():
    tex = torch.zeros((1, 2, 2, 1))
    tex[0, 0, 1] = 1.0                       # texture row 0 (v = 1), column 1
    uv = torch.tensor([[[0.75, 0.75], [0.75, 0.25], [0.25, 0.75]]])
    got = TT.texture_mapping(uv, tex, mode="nearest")[0, :, 0]
    assert got.tolist() == [1.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="no interpolation mode"):
        TT.texture_mapping(uv, tex, mode="cubic")


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_texture_gradient_matches_jax(mode, rng):
    tex = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    uv = rng.uniform(0.0, 1.0, size=(1, 6, 6, 2)).astype(np.float32)
    g = rng.normal(size=(1, 6, 6, 4)).astype(np.float32)
    ref = jax.grad(lambda t: jnp.sum(JT.texture_mapping(
        jnp.asarray(uv), t, mode=mode) * g))(jnp.asarray(tex))
    t = _t(tex).requires_grad_()
    (TT.texture_mapping(_t(uv), t, mode=mode) * _t(g)).sum().backward()
    # scatter-adds of the same weights in another order
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=1e-5)
    assert t.grad.abs().sum() > 0


@pytest.mark.parametrize("out", [(16, 16), (7, 5), (24, 40), (64, 64)])
def test_resize_bicubic_matches_jax(out, rng):
    img = rng.normal(size=(2, 24, 24, 4)).astype(np.float32)
    ref = np.asarray(JT.resize_bicubic(jnp.asarray(img), *out))
    got = TT.resize_bicubic(_t(img), *out).numpy()
    assert got.shape == (2, *out, 4)
    # the same Keys a = −0.75 taps; the source coordinate comes from a
    # rounded scale factor and the cubic is evaluated in another form:
    # 3e-6 of the largest value (≈ 4.5)
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_resize_bicubic_carries_the_gradient(rng):
    img = _t(rng.normal(size=(1, 12, 12, 2)).astype(np.float32))
    img.requires_grad_()
    TT.resize_bicubic(img, 8, 8).square().sum().backward()
    assert img.grad is not None and (img.grad != 0).all()


@pytest.mark.parametrize("out", [(16, 16), (48, 40), (128, 128)])
def test_resize_bilinear_matches_jax(out, rng):
    img = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(JT.resize_bilinear(jnp.asarray(img), *out))
    got = TT.resize_bilinear(_t(img), *out).numpy()
    # both antialias with a triangle filter when shrinking
    np.testing.assert_allclose(got, ref, atol=1e-5)
