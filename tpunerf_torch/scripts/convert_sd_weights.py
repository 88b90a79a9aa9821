"""CLI: convert a diffusers-layout Stable-Diffusion directory into one
`.npz` of the JAX package's parameter trees.

    python -m tpunerf_torch.scripts.convert_sd_weights \\
        --model_dir /path/to/stable-diffusion-v1-4 \\
        --out weights/sd_v1_4.npz [--dtype bfloat16] [--variant sd_v1]

`model_dir` holds unet/, vae/ and text_encoder/ with *.safetensors or *.bin
(guidance/weights.py reads them, with every name and shape checked against
the full-width modules of `--variant`: the SD-v1 UNet with 4, 9 or 5 input
channels, a 768-wide context, the SD-v1 VAE and the CLIP ViT-L/14 text
tower). The file is the JAX package's `scripts/convert_sd_weights.py`'s,
member for member: each member is named by its flax path
(`unet['params']['conv_in']['kernel']`, under "unet", "vae" and "text"), in
flax's layouts (HWIO convolutions, (in, out) dense kernels), float32 or
bfloat16 (stored as `<V2`, two bytes a value, as numpy stores an
`ml_dtypes.bfloat16` array). Runs on the CPU; loads neither JAX nor numpy's
bfloat16.
"""
from __future__ import annotations

import argparse
import zipfile
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpunerf_torch.guidance import vae as vae_lib
from tpunerf_torch.guidance import weights
from tpunerf_torch.guidance.clip_text import CLIPTextConfig, CLIPTextModel
from tpunerf_torch.guidance.stable_diffusion import _on_meta
from tpunerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from tpunerf_torch.weights import flax_leaves

VARIANTS = {"sd_v1": 4, "sd_v1_9ch": 9, "sd2_depth": 5}

# a member's value: its numpy descr and its array in C order
Member = Tuple[str, np.ndarray]


def flat_params(unet: torch.nn.Module, vae: torch.nn.Module,
                text: torch.nn.Module, dtype: str) -> Dict[str, Member]:
    """{flax path: member} of the three modules, in the order the JAX
    script writes them: "unet", "vae", "text", each tree flattened with its
    keys sorted at every level (jax.tree_util's order)."""
    flat: Dict[str, Member] = {}
    for prefix, module, kind in (("unet", unet, "unet"), ("vae", vae, "vae"),
                                 ("text", text, "clip_text")):
        leaves = sorted(flax_leaves(module, kind), key=lambda kv: kv[0])
        for path, value in leaves:
            key = prefix + "".join(f"[{k!r}]" for k in path)
            value = value.to("cpu", torch.float32).contiguous()
            if dtype == "bfloat16":
                bits = value.to(torch.bfloat16).view(torch.int16).numpy()
                flat[key] = ("<V2", bits.view("V2"))
            else:
                arr = value.numpy()
                flat[key] = (np.lib.format.dtype_to_descr(arr.dtype), arr)
    return flat


def write_npz(path: Path, flat: Dict[str, Member]) -> None:
    """Write `flat` as `np.savez` writes it: a stored (uncompressed) zip of
    `<key>.npy` members with version-1.0 headers."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (descr, arr) in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(fid, {
                    "descr": descr, "fortran_order": False,
                    "shape": arr.shape})
                fid.write(np.ascontiguousarray(arr).tobytes())


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_dir", type=Path, required=True,
                    help="diffusers snapshot dir (unet/, vae/, text_encoder/)")
    ap.add_argument("--out", type=Path, required=True, help="output .npz")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--variant", default="sd_v1", choices=sorted(VARIANTS),
                    help="UNet input layout: 4-ch text SD, 9-ch inpaint/PbE, "
                         "5-ch depth-conditioned")
    args = ap.parse_args(argv)

    cpu = torch.device("cpu")
    unet, vae, text = weights.load_sd_params(
        args.model_dir,
        _on_meta(UNet2DCondition,
                 UNetConfig.sd_v1(in_channels=VARIANTS[args.variant])),
        _on_meta(vae_lib.AutoencoderKL, vae_lib.VAEConfig.sd_v1()),
        _on_meta(CLIPTextModel, CLIPTextConfig.vit_l_14()), cpu)
    flat = flat_params(unet, vae, text, args.dtype)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    write_npz(args.out, flat)
    n_params = sum(int(np.prod(arr.shape)) for _, arr in flat.values())
    print(f"wrote {args.out}: {len(flat)} tensors, {n_params/1e6:.1f}M params,"
          f" dtype={args.dtype}")


if __name__ == "__main__":
    main()
