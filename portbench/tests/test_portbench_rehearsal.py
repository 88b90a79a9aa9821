"""The harness drives each tiny cell end to end on the CPU with the port's
plain kernels: the reference agrees with the program, each planted fault
and the control make `correct` false, and a measuring run that finds no
card fails instead of falling back."""
import json

import pytest
import torch

from portbench import harness, judge
from portbench.drivers import sds_train
from portbench.reference import train as reference

from conftest import TINY_CELLS

SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_rehearsal_is_correct(tiny_root, cell):
    out = harness.run(tiny_root, cell, SEED, 1.0, trace=True, device="cpu")
    assert out["correct"], out["compared"]
    assert list(out)[-1] == "compared"
    traffic = json.loads((tiny_root / "portbench" / "workloads"
                          / f"{cell}.json").read_text())
    assert out["attempted"] == 3 + traffic["chunk"]


@pytest.mark.parametrize("fault", sds_train.FAULTS)
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    out = harness.run(tiny_root, cell, SEED, 1.0, trace=False, device="cpu",
                      fault=fault)
    assert not out["correct"], (fault, out["compared"])


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_the_control_is_not_correct(tiny_root, cell):
    spec = harness.load(tiny_root, cell)
    traffic = spec["traffic"]
    cfg = spec["driver"].resolve(spec["config"], traffic)
    ref = harness._reference(reference, traffic, cfg, SEED, "cpu")
    ctl = harness._reference(reference, traffic, cfg, SEED, "cpu",
                             kinds=traffic["control"])
    assert not judge.verdict(judge.readings(ctl, ref), traffic["limits"])


def test_a_measuring_run_without_a_card_fails(tiny_root, monkeypatch,
                                              capsys):
    monkeypatch.chdir(tiny_root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        harness.main(["--workload", "tiny_stage1", "--seed", "1",
                      "--seconds", "1", "--trace", "0"])
    assert err.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_program_and_reference_weights_match_by_name():
    """The weights the benchmark draws by name fit the program's modules
    and the reference's alike."""
    from portbench import weights
    from portbench.reference import nerf, sd
    from tpunerf_torch.fields.latent_nerf import (LatentNeRFConfig,
                                                  LatentNeRFField)
    from tpunerf_torch.guidance.clip_text import (CLIPTextConfig,
                                                  CLIPTextModel)
    from tpunerf_torch.guidance.unet import UNet2DCondition, UNetConfig
    from tpunerf_torch.guidance.vae import AutoencoderKL, VAEConfig
    import dataclasses
    with torch.device("meta"):
        pairs = [(UNet2DCondition(UNetConfig.sd_v1()),
                  sd.unet_from(json.loads(json.dumps(dataclasses.asdict(
                      UNetConfig.sd_v1()))))),
                 (CLIPTextModel(CLIPTextConfig.vit_l_14()),
                  sd.clip_from(dataclasses.asdict(CLIPTextConfig()))),
                 (AutoencoderKL(VAEConfig.sd_v1()),
                  sd.vae_from(dataclasses.asdict(VAEConfig())))]
    field_cfg = dataclasses.asdict(LatentNeRFConfig())
    field_cfg["grid"] = dataclasses.asdict(LatentNeRFConfig().grid)
    pairs.append((LatentNeRFField(LatentNeRFConfig(), torch.device("cpu")),
                  nerf.Field(field_cfg)))
    for prog, ref in pairs:
        assert weights.named_shapes(prog) == weights.named_shapes(ref)
