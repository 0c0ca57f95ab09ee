"""Split-serving example on the PyTorch port: Bayes-Split-Edge places the
split point for an LM from the assigned pool and serves batched requests
with the chosen partition. Every BO evaluation executes the real
partitioned forward (device half -> boundary payload -> server half), on
the card unless ``--device cpu`` is given. Counterpart of
``examples/serve_split.py``: the reduced form of the architecture, with
random weights from a seeded ``torch.Generator``.

  PYTHONPATH=src python examples/serve_split_torch.py \\
      --arch recurrentgemma-2b [--device cpu]
"""
import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--budget", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="where the model and the BO run (default: cuda)")
    args = ap.parse_args(argv)
    res = serve_mod.main(["--arch", args.arch, "--reduced",
                          "--budget", str(args.budget),
                          "--device", args.device])
    if res.n_evals > args.budget:
        raise SystemExit(f"{res.n_evals} evaluations over the budget "
                         f"{args.budget}")
    print("[example] ok")
    return res


if __name__ == "__main__":
    main()
