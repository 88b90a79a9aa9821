"""The port's cost-split experiment of the hash-grid table gradient
(tpunerf_torch/kernels/hashgrid.py `hash_bwd_variant`, tpunerf_torch/scripts/
exp_hash_bwd.py) against the JAX package's (scripts/exp_hash_bwd.py), whose
Pallas variants run in interpret mode. The CUDA variants are held against
these plain versions on the card (test_torch_kernels_cuda.py)."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_port import assert_close_to_max
from scripts import exp_hash_bwd as jexp
from tpunerf.fields import encoding as jenc
from tpunerf_torch.fields import encoding as tenc
from tpunerf_torch.kernels import _build
from tpunerf_torch.kernels import hashgrid as thg
from tpunerf_torch.scripts import exp_hash_bwd as texp

ROOT = Path(__file__).resolve().parents[1]
N = 777
# the small grid of tests/test_hashgrid_kernel.py (level 0 dense, 1-3
# hashed) and the default full-width grid (every level hashed)
CONFIGS = {
    "small": dict(n_levels=4, log2_hashmap_size=9, base_resolution=4,
                  desired_resolution=32),
    "default": {},
}


def _inputs(name, seed=3):
    jcfg = jenc.HashGridConfig(**CONFIGS[name])
    tcfg = tenc.HashGridConfig(**CONFIGS[name])
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(N, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1e-7, 1 - 1e-7, 0.5]]
    g = rng.standard_normal((N, tcfg.out_dim)).astype(np.float32)
    return jcfg, tcfg, x, g


@pytest.mark.parametrize("tile", [256, 512])
@pytest.mark.parametrize("jmode", ["full", "dot_swap", "dot_tp", "dot_toh"])
def test_full_and_global_match_the_jax_variants(jmode, tile):
    jcfg, tcfg, x, g = _inputs("small")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jexp.hash_bwd_variant(jnp.asarray(x), jnp.asarray(g),
                                               jcfg, jmode, tile))
    for mode in ("full", "global"):
        out = thg.hash_bwd_variant(torch.from_numpy(x), torch.from_numpy(g),
                                   tcfg, mode, tile)
        # the Pallas kernel rounds the payload w·g to bf16: 2e-2 of max
        assert_close_to_max(out.numpy(), ref, 2e-2, f"{mode} vs {jmode}")


@pytest.mark.parametrize("name", ["small", "default"])
def test_addr_matches_jax_corner_sums(name):
    jcfg, tcfg, x, g = _inputs(name, seed=5)
    idx, w = (np.asarray(a) for a in
              jenc.corner_indices_and_weights(jnp.asarray(x), jcfg))
    L, F = tcfg.n_levels, tcfg.n_features_per_level
    g_lnf = g.reshape(N, L, F).transpose(1, 0, 2)
    ref_idx = (idx.astype(np.int64).sum(axis=(1, 2)) % 2 ** 32).astype(
        np.uint32).view(np.int32)
    ref_wg = (w[..., None].astype(np.float64)
              * g_lnf[:, :, None, :]).sum(axis=(1, 2))
    out_idx, out_wg = thg.hash_bwd_variant(
        torch.from_numpy(x), torch.from_numpy(g), tcfg, "addr", 2048)
    # Σ idx: exact, modulo 2³² as the kernel's uint32 sum
    np.testing.assert_array_equal(out_idx.numpy(), ref_idx)
    # Σ w·g: f32 against an f64 sum of the same products, 1e-5 of max
    assert_close_to_max(out_wg.numpy(), ref_wg, 1e-5, "Σ w·g")
    # the same sum is the table gradient's, summed over slots
    dtable = thg.hash_bwd_variant(torch.from_numpy(x), torch.from_numpy(g),
                                  tcfg, "full", 2048)
    assert_close_to_max(dtable.sum(dim=1).numpy(), ref_wg, 1e-5,
                        "Σ dtable")


@pytest.mark.parametrize("name", ["small", "default"])
def test_accum_matches_add_at_on_stand_in_slots(name):
    _, tcfg, x, g = _inputs(name, seed=7)
    L, T, F = (tcfg.n_levels, tcfg.table_size, tcfg.n_features_per_level)
    # MurmurHash3's fmix32 of p·8 + c, in wrapping uint32 arithmetic
    h = np.arange(N * 8, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h ^= h >> 16
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> 13
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> 16
    slots = h & np.uint32(T - 1)
    # the payload: the f32 with bits 0x3F800000 | (h >> 9), in [1, 2)
    payload = ((h >> 9) | np.uint32(0x3F800000)).view(np.float32)
    assert payload.min() >= 1 and payload.max() < 2
    ref = np.zeros((L, T, F), np.float64)
    for level in range(L):
        for f in range(F):
            np.add.at(ref[level, :, f], slots.astype(np.int64), payload)
    # neither x nor g is read: other inputs give the same sums
    out = thg.hash_bwd_variant(torch.from_numpy(x), torch.from_numpy(g),
                               tcfg, "accum", 4096)
    other = thg.hash_bwd_variant(torch.from_numpy(x[::-1].copy()),
                                 torch.from_numpy(-g), tcfg, "accum", 4096)
    assert torch.equal(out, other)
    # f32 sums in another order than f64 np.add.at: 1e-5 of max
    assert_close_to_max(out.numpy(), ref, 1e-5, "accum")


def test_cpu_tensors_launch_nothing():
    _, tcfg, x, g = _inputs("small")
    _build.reset_launches()
    for mode in thg.VARIANT_MODES:
        thg.hash_bwd_variant(torch.from_numpy(x), torch.from_numpy(g), tcfg,
                             mode, 256)
    assert _build.LAUNCHES.get(thg.VARIANT, 0) == 0


@pytest.mark.parametrize("mode,ppb", [
    ("vpu", 8192), ("mxu", 8192), ("dot_swap", 8192),
    ("full", 0), ("full", -256), ("full", 100), ("full", 8192.0),
])
def test_bad_mode_or_points_per_block_raises(mode, ppb):
    _, tcfg, x, g = _inputs("small")
    for fn in (thg.hash_bwd_variant, thg.hash_bwd_variant_plain):
        with pytest.raises(ValueError):
            fn(torch.from_numpy(x), torch.from_numpy(g), tcfg, mode, ppb)


def test_launches_under_graph_capture_count_at_replay(monkeypatch):
    # a launch enqueued in a CUDA graph's capture runs at each replay, so
    # it goes to CAPTURED, not LAUNCHES; graph_ms counts it per replay
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    _build.CAPTURED.clear()
    _build.reset_launches()
    _build.count_launch(thg.VARIANT)
    assert _build.CAPTURED == {thg.VARIANT: 1}
    assert _build.LAUNCHES.get(thg.VARIANT, 0) == 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    _build.count_launch(thg.VARIANT, 20)
    assert _build.LAUNCHES[thg.VARIANT] == 20
    _build.CAPTURED.clear()


def test_run_on_the_cpu_holds_every_variant():
    rows = texp.run("cpu", n=N, seed=1)
    assert [(r["mode"], r["points_per_block"]) for r in rows] == [
        (m, p) for m in thg.VARIANT_MODES for p in texp.SWEEP]
    assert all(r["ok"] and r["ms"] is None for r in rows)


def test_cli_runs_the_plain_versions_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "tpunerf_torch.scripts.exp_hash_bwd",
         "--device", "cpu", "--n", str(N)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert lines[0] == f"L=12 T=2048 F=2 N={N}"
    variants = [ln for ln in lines if ln.startswith("variant ")]
    assert len(variants) == len(thg.VARIANT_MODES) * len(texp.SWEEP)
    assert not any(" ms" in ln or "FAIL" in ln for ln in variants)
