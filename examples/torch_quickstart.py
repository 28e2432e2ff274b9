"""Quickstart on the PyTorch/CUDA port: train a reduced smollm-360m for a
few steps, then serve a few greedy tokens from a reduced qwen3-0.6b, both
on the port's kernels.  Runs on the CUDA card; ``--device cpu`` runs the
kernels' plain versions instead (without a card and without it, it
raises).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import serve_loop
from repro_torch.launch.train import train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    print("== training (reduced smollm-360m, synthetic stream) ==")
    out = train_loop("smollm-360m", steps=15, batch=8, seq=48, lr=3e-3,
                     device=device)
    print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")

    print("== serving (reduced qwen3-0.6b, batched greedy decode) ==")
    served = serve_loop("qwen3-0.6b", batch=4, prompt_len=12, gen=8,
                        device=device)
    print("generated token ids:\n", served["generated"])


if __name__ == "__main__":
    main()
