"""Learning rates of the full-width training run, on the card: for each
``--lrs`` value, ``repro_torch.launch.train`` trains Qwen2-1.5B (full
width and depth, bf16, remat, AdamW) from the same seeded weights on the
same synthetic batches, and the loss of two batches it never trains on
(pipeline steps 1000 and 1001) is taken before and after. Writes
``benchmarks/artifacts/train_lr_sweep_torch.json`` with the card's name
and power limit.

  PYTHONPATH=src python -m benchmarks.train_lr_sweep_torch \\
      --lrs 1e-3 3e-5 1e-5 3e-6

It is how ``chip_smoke.py`` phase 6a's learning rate was chosen: at this
width Adam's first steps move every weight by about lr whatever its
gradient's size, and from 1e-4 up the loss rises over 30 steps.
"""
import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as tfm
from repro_torch.train.trainer import loss_fn

OUT = Path(__file__).resolve().parent / "artifacts" / \
    "train_lr_sweep_torch.json"
HELD_OUT_STEPS = (1000, 1001)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def held_out_losses(model, cfg, batches):
    with torch.no_grad():
        return [float(loss_fn(model, b, cfg)[0]) for b in batches]


def run(lrs, arch="qwen2-1.5b", steps=30, batch=4, seq=512,
        microbatches=2, device="cuda"):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, batch, seq)
    held = [{k: torch.as_tensor(v, device=device)
             for k, v in pipe.batch_at(s).items()} for s in HELD_OUT_STEPS]
    fresh = tfm.init_model(cfg, torch.Generator(device).manual_seed(0),
                           device)
    before = held_out_losses(fresh, cfg, held)
    del fresh
    rows = []
    for lr in lrs:
        res = train_mod.train([
            "--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--microbatches", str(microbatches),
            "--lr", str(lr), "--ckpt", "", "--device", device])
        losses = res.losses
        rows.append(dict(lr=lr, losses=losses,
                         first5_mean=statistics.mean(losses[:5]),
                         last5_mean=statistics.mean(losses[-5:]),
                         held_out_before=before,
                         held_out_after=held_out_losses(res.model, cfg,
                                                        held)))
        print(json.dumps(rows[-1]), flush=True)
        del res
        if device != "cpu":
            torch.cuda.empty_cache()
    return dict(arch=arch, steps=steps, batch=batch, seq=seq,
                microbatches=microbatches, held_out_steps=HELD_OUT_STEPS,
                rows=rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", type=float, nargs="+",
                    default=[1e-3, 3e-5, 1e-5, 3e-6])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.lrs, device=args.device)
    out["device"] = card() if args.device != "cpu" else "cpu"
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
