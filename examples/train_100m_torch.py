"""End-to-end training on the PyTorch port: a qwen2-family model on the
deterministic synthetic pipeline, with checkpointing and auto-resume, on
the card unless ``--device cpu`` is given. Counterpart of
``examples/train_100m.py``.

Full run (~100M parameters: 10 layers x d 640 x ff 2560, 32k vocab):
  PYTHONPATH=src python examples/train_100m_torch.py --preset 100m \\
      --steps 300

CI-sized run (~3M parameters, the same loss-curve shape in seconds):
  PYTHONPATH=src python examples/train_100m_torch.py --preset quick \\
      --device cpu
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import register
from repro_torch.launch import train as train_mod


def preset_cfg(name: str):
    base = get_config("qwen2-1.5b")
    if name == "100m":
        return dataclasses.replace(
            base, name="qwen2-100m", n_layers=10, d_model=640, n_heads=10,
            n_kv_heads=2, head_dim=64, d_ff=2560, vocab_size=32_000,
            dtype="float32", param_dtype="float32", remat=False,
            attn_sharding="replicated")
    return dataclasses.replace(
        base, name="qwen2-3m", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=2048,
        dtype="float32", param_dtype="float32", remat=False,
        attn_sharding="replicated")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="quick", choices=["quick", "100m"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train100m"))
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: cuda)")
    args = ap.parse_args(argv)

    cfg = register(preset_cfg(args.preset))
    n = cfg.param_counts()["total"]
    print(f"[example] {cfg.name}: {n/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")
    losses = train_mod.main([
        "--arch", cfg.name, "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--ckpt", args.ckpt, "--lr", "1e-3", "--device", args.device,
    ])
    assert losses[-1] < losses[0], "loss did not decrease"
    print(f"[example] ok: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
