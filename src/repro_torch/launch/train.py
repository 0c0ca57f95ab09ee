"""End-to-end training driver. Counterpart of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --device cpu --steps 40 --batch 8 --seq 32 --lr 3e-3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 30 --batch 4 --seq 512 --microbatches 2 --lr 1e-5 --ckpt ""
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --steps 10 --batch 4 --seq 512 --microbatches 2 --lr 1e-4 --ckpt ""

On the card (the default device) it trains the configuration at full
width and depth in its own dtype (Qwen2-1.5B's 1.54 B bf16 parameters,
RecurrentGemma-2B's 2.67 B, RWKV6-3B's 3.07 B), with remat as
configured, through the forward and backward kernels of
``flash_attention``, ``rglru_scan`` and ``rwkv6_scan``. Features, as the reference's: the deterministic
synthetic pipeline, AdamW with float32 moments, checkpoints every
``--ckpt-every`` steps and on the crash or SIGTERM path, auto-resume,
optional int8 error-feedback gradient compression. Added:
``--device``, ``--microbatches`` (gradient accumulation, as
``make_train_step``'s ``num_microbatches``) and ``--ckpt ""`` (no
checkpoints: a full-size state is 15.4 GB on disk). The weights are
random, drawn under the reference's init rules from a ``torch.Generator``
seeded with 0. ``--production-mesh`` needs the mesh tooling,
which the port does not have yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import (compress_gradients,
                                                 init_error_state)
from repro_torch.distributed.fault_tolerance import TrainController
from repro_torch.models import transformer as tfm
from repro_torch.train.optimizer import adamw, cosine_schedule
from repro_torch.train.trainer import (make_train_step, trainable_params,
                                       value_and_grad)


class NoCheckpoints:
    """The manager's interface, saving nothing (``--ckpt ""``)."""

    def maybe_save(self, step, tree, metadata=None, force=False):
        return False

    def wait(self):
        pass

    def restore_latest(self, template, device="cuda"):
        return None, None


def build(cfg, model, compress: bool = False, lr: float = 3e-4,
          total_steps: int = 10_000, num_microbatches: int = 1):
    """(opt, step_fn): ``step_fn((params, opt_state, err), batch) ->
    (state, metrics)`` trains ``model`` in place; ``params`` is the
    model's parameters by name, the tree the optimizer walks."""
    if compress and num_microbatches > 1:
        raise ValueError("--compress-grads takes the whole batch at once, "
                         "as the reference's; it has no microbatches")
    opt = adamw(cosine_schedule(lr, 20, total_steps))
    base_step = make_train_step(cfg, None, opt, num_microbatches)

    def step_fn(state, batch):
        params, opt_state, err = state
        if compress:
            # compress at the grad level (wire-format int8 + error feedback)
            (loss, _), grads = value_and_grad(model, batch, cfg)
            grads, err = compress_gradients(grads, err)
            _, opt_state, om = opt.update(grads, opt_state, params)
            metrics = dict(loss=loss, **om)
        else:
            _, opt_state, metrics = base_step(model, opt_state, batch)
        return (params, opt_state, err), metrics

    return opt, step_fn


def copy_state(state, loaded) -> None:
    """Write a restored state into the live one, leaf by leaf, in place
    (the parameters are the model's)."""
    if isinstance(state, dict):
        for k in state:
            copy_state(state[k], loaded[k])
    elif isinstance(state, (list, tuple)):
        for a, b in zip(state, loaded):
            copy_state(a, b)
    else:
        with torch.no_grad():
            state.copy_(loaded)


@dataclasses.dataclass
class TrainRun:
    """What ``train`` leaves: the losses of the steps it ran, the state,
    the step it reached, the model, and each step's seconds on the
    host's clock (the loss read back, so the device has finished)."""
    losses: list
    state: tuple
    step: int
    model: object
    step_seconds: list


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--microbatches", type=int, default=1)
    return ap.parse_args(argv)


def train(argv=None) -> TrainRun:
    args = parse(argv)
    if args.production_mesh:
        raise NotImplementedError("--production-mesh needs the mesh "
                                  "tooling, which the port does not have "
                                  "yet")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    model = tfm.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt, step_fn = build(cfg, model, compress=args.compress_grads,
                         lr=args.lr, total_steps=args.steps,
                         num_microbatches=args.microbatches)
    params = trainable_params(model)
    opt_state = opt.init(params)
    err = init_error_state(params) if args.compress_grads else ()
    state = (params, opt_state, err)

    pipe = SyntheticTokenPipeline(cfg.vocab_size, args.batch, args.seq)
    mgr = (CheckpointManager(args.ckpt, save_interval=args.ckpt_every)
           if args.ckpt else NoCheckpoints())

    # auto-resume
    start = 0
    found = mgr.restore_latest(state, dev)
    if found[0] is not None:
        start = found[0]
        copy_state(state, found[1])
        print(f"[train] resumed from step {start}")

    losses, seconds = [], []

    def wrapped_step(st, batch):
        t0 = time.time()
        st, m = step_fn(st, batch)
        loss = float(m["loss"])
        seconds.append(time.time() - t0)
        losses.append(loss)
        if len(losses) % 10 == 1:
            print(f"[train] step={len(losses)+start} loss={loss:.4f} "
                  f"({seconds[-1]:.2f}s)", flush=True)
        return st, m

    def batch_at(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in pipe.batch_at(step).items()}

    ctl = TrainController(wrapped_step, batch_at, mgr, max_steps=args.steps)
    state, step, _ = ctl.run(state, start_step=start)
    if losses:
        print(f"[train] done at step {step}; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")
    else:
        print(f"[train] checkpoint already at step {start} >= "
              f"--steps {args.steps}; nothing to do")
    return TrainRun(losses, state, step, model, seconds)


def main(argv=None):
    return train(argv).losses


if __name__ == "__main__":
    main()
