"""Fault-tolerance example on the PyTorch port, training half: train,
stop mid-run (a preemption), auto-resume from the checkpoint and finish.
Each run is a fresh process of ``repro_torch.launch.train``, on the card
unless ``--device cpu`` is given. Counterpart of the training half of
``examples/elastic_restart.py``; its serving half has its counterpart in
``tests/test_torch_chaos.py``'s kill-and-resume cases.

  PYTHONPATH=src python examples/elastic_restart_torch.py [--device cpu]
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def run(ckpt, steps, device):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-1.5b", "--reduced", "--steps", str(steps), "--batch", "4",
         "--seq", "32", "--ckpt", ckpt, "--ckpt-every", "5", "--device",
         device], capture_output=True, text=True, env=env)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    print(r.stdout.strip().splitlines()[-1])
    return r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: cuda)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_elastic"))
    args = ap.parse_args(argv)
    shutil.rmtree(args.ckpt, ignore_errors=True)

    print("[example] phase 1: train 12 steps (checkpoints every 5)")
    run(args.ckpt, 12, args.device)

    print("[example] phase 2: 'preempted' — resume and continue to 25")
    r = run(args.ckpt, 25, args.device)
    assert "resumed from step 12" in r.stdout, "did not resume"
    print("[example] ok: resumed training completed")
    return r.stdout


if __name__ == "__main__":
    main()
