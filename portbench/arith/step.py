"""Operations of one training step's matrix products and convolutions,
counted from the shapes at which the cell runs them, each with the peak of
the precision the port lets it use on the card: the UNet's CFG pass
(bfloat16), the field's MLPs forward and backward (bfloat16), the VAE
encoder forward and its backward to the image (convolutions under cuDNN's
TF32, its mid-block attention in float32). The counts are PyTorch's
`FlopCounterMode` over the plain reference's modules on the meta device:
no storage, no kernel."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.arith.peaks import FLOPS as PEAK
from portbench.reference import sd
CONV_OPS = ("convolution", "convolution_backward")


def _counted(fn) -> Dict[str, int]:
    with FlopCounterMode(display=False) as counter:
        fn()
    return {str(op).split(".")[1]: n
            for op, n in counter.get_flop_counts()["Global"].items()}


def unet_cfg(cfg: dict, batch: int) -> Dict[str, int]:
    """The CFG pass: the UNet at batch 2B on the latent grid."""
    with torch.device("meta"):
        unet = sd.unet_from(cfg["unet"])
        h, ctx = cfg["latent_size"], cfg["unet"]["cross_attention_dim"]
        x = torch.empty(2 * batch, h, h, cfg["unet"]["in_channels"])
        t = torch.zeros(2 * batch, dtype=torch.int64)
        c = torch.empty(2 * batch, cfg["clip"]["max_length"], ctx)
    return _counted(lambda: unet(x, t, c))


def vae_encode(cfg: dict, batch: int) -> Dict[str, int]:
    """The encoder at the image size, forward and backward to the image."""
    with torch.device("meta"):
        vae = sd.vae_from(cfg["vae"]).requires_grad_(False)
        s, h = cfg["image_size"], cfg["latent_size"]
        img = torch.empty(batch, s, s, 3, requires_grad=True)
        noise = torch.empty(batch, h, h, 4)

    def run():
        vae.encode(img, noise).sum().backward()

    return _counted(run)


def field_mlps(cfg: dict, batch: int) -> int:
    """The three MLPs forward and backward: 2·in·out a point a layer
    forward, twice that backward (the weight's gradient and the input's;
    the background's first layer takes no input gradient), on every ray's
    K samples (density and colour) and on every ray (background)."""
    f, s = cfg["field"], cfg["scene"]
    rays = batch * s["train_grid_size"] ** 2
    pts = rays * s["num_compacted"]
    enc = f["grid"]["n_levels"] * f["grid"]["n_features_per_level"]
    n_sh, geo = f["sh_degree"] ** 2, f["geo_feat_dim"]

    def dims(first, hidden, layers, last):
        d = [first] + [hidden] * (layers - 1) + [last]
        return list(zip(d[:-1], d[1:]))

    total = 0
    for n, layers, skip_first in (
            (pts, dims(enc, f["hidden_dim"], f["num_layers"], 1 + geo), False),
            (pts, dims(n_sh + geo, f["hidden_dim_color"],
                       f["num_layers_color"], f["out_channels"]), False),
            (rays, dims(n_sh, f["bg_hidden_dim"], 2, f["out_channels"]),
             True)):
        for i, (a, b) in enumerate(layers):
            times = 2 if (skip_first and i == 0) else 3
            total += times * 2 * n * a * b
    return total


def parts(cfg: dict, work: dict) -> List[Tuple[str, float, float]]:
    """[(part, operations, peak operations a second)] of one step."""
    B = work["batch_size"]
    out = [("unet_cfg", float(sum(unet_cfg(cfg, B).values())), PEAK["bf16"])]
    if work["app"] == "latent_nerf":
        out.append(("field_mlps", float(field_mlps(cfg, B)), PEAK["bf16"]))
        if work["nerf_type"] == "rgb":
            counts = vae_encode(cfg, B)
            conv = sum(n for op, n in counts.items() if op in CONV_OPS)
            other = sum(n for op, n in counts.items() if op not in CONV_OPS)
            out += [("vae_convs", float(conv), PEAK["tf32"]),
                    ("vae_attention", float(other), PEAK["f32"])]
    return out


def seconds_at_peak(cfg: dict, work: dict) -> float:
    return sum(ops / peak for _, ops, peak in parts(cfg, work))
