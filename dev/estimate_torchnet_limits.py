"""The basis of chip_smoke.py's phase 25(g) and 25(h) limits, on the CPU.

    python3 dev/estimate_torchnet_limits.py [--seeds 3] [--resnet]

(g) A BERT-Base-wide ``nn.TransformerEncoder`` (12 layers of d 768, 12
heads, FFN 3072, gelu, batch_first), seeded, at 2 x 128 tokens: run by
torch itself, through ``TorchNet`` (its attentions swapped for the
port's core, the einsum chain on the CPU), and through ``TorchNet`` with
an error of FLASH_ATOL (the flash kernel's fp32 limit against its plain
version, phase 3) and a random sign added to every element of every
layer's attention output. Prints the largest distance of each from
torch's own run; the phase's limit is twice the perturbed reading, its
gain (the reading over FLASH_ATOL) is P25_ENCODER_GAIN.

(h) With ``--resnet``: ResNet-50's torch twin as phase 25 seeds it, at 2
x 3 x 224 x 224, fp32 against float64: the largest distance relative to
the largest float64 logit (P25_IMPORT_F64 leaves room for cuDNN's
algorithms over this reading).
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from analytics_zoo_tpu_torch.net import TorchNet  # noqa: E402
from analytics_zoo_tpu_torch.net import torch_net  # noqa: E402


def encoder_readings(seed: int, batch: int, seq: int):
    cs.SEED = seed
    module = cs.p25_encoder(torch)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, seq, cs.P25_ENCODER["d_model"]), dtype=np.float32))
    with torch.inference_mode():
        want = module(x).numpy()
    net = TorchNet(module, device="cpu")
    plain = float(np.abs(net.predict(x.numpy()) - want).max())
    real = torch_net.FlashMultiheadAttention.forward
    gen = torch.Generator().manual_seed(seed + 1)

    def perturbed(self, *a, **k):
        out, w = real(self, *a, **k)
        sign = torch.randint(0, 2, out.shape, generator=gen) * 2 - 1
        return out + cs.FLASH_ATOL * sign.to(out.dtype), w

    torch_net.FlashMultiheadAttention.forward = perturbed
    try:
        moved = float(np.abs(net.predict(x.numpy()) - want).max())
    finally:
        torch_net.FlashMultiheadAttention.forward = real
    return plain, moved


def resnet_reading(seed: int, batch: int):
    cs.SEED = seed
    cs.P25_RESNET_BATCH = batch
    rec = cs.p25_resnet(torch, np, "cpu")
    module, x = rec["module"], rec["x"]
    with torch.inference_mode():
        ref = module.double()(torch.from_numpy(x).double()).numpy()
    return float(np.abs(rec["want"] - ref).max() / np.abs(ref).max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--resnet", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    worst = 0.0
    for seed in range(args.seeds):
        plain, moved = encoder_readings(seed, args.batch, args.seq)
        worst = max(worst, moved)
        print(f"(g) seed {seed}: TorchNet's einsum route {plain:.3g} from "
              f"torch's own run; with FLASH_ATOL ({cs.FLASH_ATOL}) in every "
              f"attention output {moved:.3g} (gain "
              f"{moved / cs.FLASH_ATOL:.3g})", flush=True)
    print(f"(g) worst {worst:.3g}: gain {worst / cs.FLASH_ATOL:.3g}, limit "
          f"2 x {worst:.3g} = {2 * worst:.3g} (chip_smoke "
          f"P25_ENCODER_ATOL {cs.P25_ENCODER_ATOL:.3g})")
    if args.resnet:
        for seed in range(args.seeds):
            print(f"(h) seed {seed}: fp32 ResNet-50 twin "
                  f"{resnet_reading(seed, args.batch):.3g} of the largest "
                  f"logit from float64 (chip_smoke P25_IMPORT_F64 "
                  f"{cs.P25_IMPORT_F64:.3g})", flush=True)


if __name__ == "__main__":
    main()
