"""The counts of `portbench/arith/` equal counts made by hand at small
widths."""
import json

import pytest
import torch

from portbench.arith import attention, hashgrid, raster, step

from conftest import DATA


def test_attention_counts():
    # q·kᵀ and p·v: 2·N·N·D each a head
    assert attention.flops((1, 2, 4, 3)) == 2 * (2 * 4 * 4 * 3) * 2
    assert attention.nbytes((1, 2, 4, 3), 2) == 4 * (2 * 4 * 3) * 2


def test_hashgrid_counts():
    n, L, T, F = 5, 2, 8, 2
    # x, table, incoming gradient read; features and table gradient written
    assert hashgrid.nbytes(n, L, T, F) == 4 * (n * 3 + L * T * F
                                               + n * L * F + n * L * F
                                               + L * T * F)
    assert hashgrid.flops(n, L, F) == 2 * n * L * 8 * (3 + 2 * F)


def test_raster_inside_pairs():
    # pixel centres of a 4 × 4 image at ±0.25, ±0.75; the triangle holds
    # x ≤ −(y + 1)/2 above y = −1: (−0.75, −0.75), (−0.25, −0.75),
    # (−0.75, −0.25), (−0.75, 0.25)
    tri = torch.tensor([[[[-1.0, -1.0], [0.0, -1.0], [-1.0, 1.0]]]])
    assert raster.inside_pairs(tri, 4, 4) == 4
    assert raster.nbytes(1, 1, 3, 16) == 4 * (1 * 3 * (1 + 2 + 3)
                                              + 16 * (3 + 2))
    assert raster.flops(4) == 4 * (25 + 80)


def test_flop_counter_counts_products_as_twice_their_macs():
    with torch.device("meta"):
        conv = torch.nn.Conv2d(3, 5, 3, padding=1)
        x = torch.empty(2, 3, 8, 8)
    counts = step._counted(lambda: conv(x))
    assert sum(counts.values()) == 2 * 2 * 5 * 3 * 9 * 8 * 8


def test_field_mlps_by_hand():
    cfg = json.loads((DATA / "tiny_nerf.json").read_text())
    cfg["field"]["out_channels"] = 4
    cfg["scene"].update(train_grid_size=4, num_compacted=2)
    f = cfg["field"]
    rays, pts = 16, 32
    enc = f["grid"]["n_levels"] * f["grid"]["n_features_per_level"]
    sigma = [(enc, 16), (16, 8)]
    color = [(16 + 7, 16), (16, 4)]
    bg = [(16, 32), (32, 4)]
    want = (sum(3 * 2 * pts * a * b for a, b in sigma + color)
            + 2 * 2 * rays * 16 * 32 + 3 * 2 * rays * 32 * 4)
    assert step.field_mlps(cfg, 1) == want


@pytest.mark.parametrize("batch", [1, 2])
def test_unet_counts_scale_with_the_batch(batch):
    cfg = json.loads((DATA / "tiny_nerf.json").read_text())
    one = sum(step.unet_cfg(cfg, 1).values())
    assert sum(step.unet_cfg(cfg, batch).values()) == batch * one
