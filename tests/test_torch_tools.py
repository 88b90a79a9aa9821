"""The port's four measuring tools (tpunerf_torch/scripts/profile_render.py,
profile_unet.py, exp_unet_ablate.py, occ_rate_curve.py) against the JAX
package's scripts, with the functions they brought into the port
(`occupancy.mean_density`, `encoding.frequency_encode`): the stage bodies,
grids, UNet variants and FLOP counts on the same inputs, and each tool's
run on the CPU (`--device cpu --tiny`: plain versions, no times). The card
runs them in test_torch_kernels_cuda.py and chip_smoke.py."""
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close_to_max, one_torch_thread  # noqa: F401
from scripts import occ_rate_curve as jcurve
from tpunerf.fields import encoding as jenc
from tpunerf.fields import occupancy as jocc
from tpunerf.guidance.unet import UNet2DCondition as JUNet
from tpunerf.guidance.unet import UNetConfig as JUNetConfig
from tpunerf_torch.core.views import ViewSamplerConfig, rand_poses
from tpunerf_torch.fields import encoding as tenc
from tpunerf_torch.fields import occupancy as tocc
from tpunerf_torch.fields import volume_render as vr
from tpunerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from tpunerf_torch.scripts import card
from tpunerf_torch.scripts import exp_unet_ablate as ablate
from tpunerf_torch.scripts import occ_rate_curve as curve
from tpunerf_torch.scripts import profile_render as prender
from tpunerf_torch.scripts import profile_unet as punet
from tpunerf_torch.weights import load_flax_params

ROOT = Path(__file__).resolve().parents[1]
TOOLS = {"profile_render": prender, "profile_unet": punet,
         "exp_unet_ablate": ablate, "occ_rate_curve": curve}
BLOBS = [0.02, 0.05, 0.1, 0.185, 0.3, 0.5, 1.0]


def _report(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_mean_density_matches_jax():
    grid = np.random.default_rng(0).uniform(size=(32 ** 3,)).astype(
        np.float32)
    np.testing.assert_allclose(
        tocc.mean_density(torch.from_numpy(grid)).item(),
        float(jocc.mean_density(jnp.asarray(grid))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_freqs", [1, 6])
def test_frequency_encode_matches_jax(n_freqs):
    x = np.random.default_rng(n_freqs).uniform(
        -1, 1, size=(5, 7, 3)).astype(np.float32)
    ref = np.asarray(jenc.frequency_encode(jnp.asarray(x), n_freqs))
    out = tenc.frequency_encode(torch.from_numpy(x), n_freqs).numpy()
    assert out.shape == ref.shape == (5, 7, 3 * (1 + 2 * n_freqs))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("frac", BLOBS)
@pytest.mark.parametrize("G", [16, 128])
def test_blob_grid_equals_jax_bit_for_bit(G, frac):
    np.testing.assert_array_equal(curve.blob_grid(G, frac),
                                  jcurve.blob_grid(G, frac))


def test_stratified_samples_equal_the_jax_expression():
    """profile_render's sample body against scripts/profile_render.py's
    `make_xyz`, written out in jnp, on the same uniform draw."""
    B, Hs, S = 2, 8, 16
    gen = torch.Generator().manual_seed(0)
    views = rand_poses(B, ViewSamplerConfig(), torch.device("cpu"),
                       generator=gen)
    rays = vr.generate_rays(views.theta, views.phi, views.radius, Hs, Hs,
                            fovy=np.pi / 3)
    u = np.random.default_rng(1).uniform(size=(B, Hs * Hs, S)).astype(
        np.float32)
    t, xyz = prender.stratified_xyz(rays, torch.from_numpy(u), S)
    near, far, o, d = (jnp.asarray(a.numpy()) for a in
                       (rays.near, rays.far, rays.origins, rays.dirs))
    uj = (jnp.arange(S, dtype=jnp.float32) + 0.5) / S
    uj = jnp.broadcast_to(uj, (B, Hs * Hs, S))
    uj = uj + (jnp.asarray(u) - 0.5) / S
    tj = near[..., None] + (far - near)[..., None] * uj
    xyzj = jnp.clip(o[..., None, :] + d[..., None, :] * tj[..., None],
                    -1.0, 1.0)
    # the same float operations in the same order: 1 ulp at most
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=2e-7,
                               atol=0)
    np.testing.assert_allclose(xyz.numpy(), np.asarray(xyzj), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["no-downup-attn", "layers1"])
def test_unet_variants_match_jax(name):
    """Each ablation variant of the tiny UNet, built in both packages from
    the same `dataclasses.replace`, the same random weights in both (drawn
    with numpy onto the JAX tree's shapes, carried across by
    `load_flax_params`): one forward within the UNet parity tolerance (1e-4
    of the max)."""
    jcfg = ablate.variant(JUNetConfig.tiny(), name)
    tcfg = ablate.variant(UNetConfig.tiny(), name)
    assert tcfg.down_block_has_attn == jcfg.down_block_has_attn
    assert tcfg.layers_per_block == jcfg.layers_per_block
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    junet = JUNet(jcfg)
    shapes = jax.eval_shape(junet.init, jax.random.key(0), jnp.asarray(x),
                            jnp.asarray(t), jnp.asarray(ctx))
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
        shapes)
    ref = np.asarray(jax.jit(junet.apply)(params, x, t, ctx))
    tunet = UNet2DCondition(tcfg)
    load_flax_params(tunet, params, "unet")
    with torch.no_grad():
        out = tunet(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(ctx)).numpy()
    assert_close_to_max(out, ref, 1e-4, f"{name} UNet eps")


def test_family_flops_equal_the_jax_expressions():
    """scripts/profile_unet.py's counts (`fl = ...` at :123, :148-156,
    :203) at its shapes, written out; and the families of SD v1 at 64²
    are its lists."""
    B = 2
    resnets, transformers = punet.families(UNetConfig.sd_v1(), 64)
    assert resnets == [(64, 320, 320, 4 + 1), (32, 640, 640, 4 + 1),
                       (16, 1280, 1280, 4 + 1), (8, 1280, 1280, 2 + 2 + 3)]
    assert transformers == [(64, 320, 2 + 3), (32, 640, 2 + 3),
                            (16, 1280, 2 + 3), (8, 1280, 1)]
    for H, ci, co, _ in resnets:
        assert punet.resnet_flops(B, H, ci, co) == \
            2 * 2 * B * H * H * 9 * ci * co
    for H, ch, _ in transformers:
        N = H * H
        assert punet.transformer_flops(B, H, ch) == (
            2 * 2 * B * N * N * ch
            + 2 * B * N * ch * ch * 4
            + 2 * B * N * ch * ch * 2
            + 2 * B * 77 * 768 * ch * 2
            + 2 * 2 * B * N * 77 * ch
            + 2 * B * N * ch * (8 * ch + 4 * ch))
    assert punet.conv_flops(B, 64, 320, 320) == 2 * B * 64 * 64 * 9 * 320 * 320
    assert ablate.downup_transformers(UNetConfig.sd_v1()) == 15


def test_gemm_issuers_reads_a_profiler_trace():
    """A kernel is put under the host operations around its launch on the
    launching thread, outermost first; kernels of other names are left."""
    trace = {"traceEvents": [
        {"cat": "cpu_op", "name": "aten::einsum", "tid": 1, "ts": 0,
         "dur": 100},
        {"cat": "cpu_op", "name": "aten::bmm", "tid": 1, "ts": 10, "dur": 50},
        {"cat": "cpu_op", "name": "aten::linear", "tid": 1, "ts": 200,
         "dur": 50},
        {"cat": "cpu_op", "name": "aten::other", "tid": 2, "ts": 0,
         "dur": 1000},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1,
         "ts": 20, "dur": 5, "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1,
         "ts": 210, "dur": 5, "args": {"correlation": 8}},
        {"cat": "kernel", "name": "cutlass_80_simt_sgemm_128x64",
         "ts": 300, "dur": 9, "args": {"correlation": 7}},
        {"cat": "kernel", "name": "sm90_xmma_gemm_bf16", "ts": 400,
         "dur": 9, "args": {"correlation": 8}},
    ]}
    assert dict(punet.gemm_issuers(trace)) == {"aten::einsum > aten::bmm": 1}


ROWS = {
    # scripts/profile_render.py's rows, read from its source
    "profile_render": re.findall(
        r'_scan_time\("([^"]+)"',
        (ROOT / "scripts" / "profile_render.py").read_text()),
    # scripts/profile_unet.py's rows at the tiny UNet's shapes
    "profile_unet": ["UNet fwd (B=2, 16x16x4)", "UNet fwd+bwd",
                     "resnet 16x16 c32->32  (x3 in UNet)",
                     "resnet 8x8 c64->64  (x5 in UNet)",
                     "transformer2d 16x16 c32  (x3 in UNet)",
                     "transformer2d 8x8 c64  (x1 in UNet)",
                     "sum of family times x counts (approx)",
                     "self-attn 256 tokens c32 (naive path: plain)",
                     "self-attn 64 tokens c64 (naive path: plain)",
                     "conv3x3 16x16 c32->32 f32",
                     "conv3x3 16x16 c32->32 bf16"],
    "exp_unet_ablate": [f"{v} {d}" for v in ablate.VARIANTS
                        for d in ("f32", "bf16")],
    "occ_rate_curve": ["0.02", "0.5", "1.0"],
}
ARGV = {"profile_render": ["--occ-warm", "4"], "profile_unet": [],
        "exp_unet_ablate": [], "occ_rate_curve": ["--points", "0.02,0.5,1"]}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_runs_its_rows_on_the_cpu(tool, capsys, one_torch_thread):
    assert TOOLS[tool].main(["--device", "cpu", "--tiny"] + ARGV[tool]) == 0
    report = _report(capsys)
    names = [r["name"] for r in report.get("rows", [])] or [
        p["tag"] for p in report["points"]]
    assert names == ROWS[tool]
    assert card.report_times(report) == []       # no time on the CPU


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tools_need_a_card_unless_told(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TOOLS[tool].main(argv + ["--tiny"])


def test_teddy_point_names_its_file_when_absent(capsys):
    try:
        curve.teddy_grid(8, 1.0, torch.device("cpu"))
    except FileNotFoundError as exc:
        assert "teddy" in str(exc) and "shapes/teddy.obj" in str(exc)
        return
    # where the mesh exists the point is its SDF band: some cells, not all
    grid = curve.teddy_grid(8, 1.0, torch.device("cpu"))
    assert 0 < grid.sum() < grid.size


def test_blob_points_hit_their_fraction_at_the_full_grid():
    """What chip_smoke.py holds each blob point to: within 0.01 of its
    target at 128³."""
    for frac in BLOBS:
        occ = float((curve.point_grid(frac, 128, 1.0, "cpu") > 0.01)
                    .float().mean())
        assert abs(occ - frac) <= 0.01, (frac, occ)
