"""Fault tolerance on the PyTorch/CUDA port: train with checkpointing,
simulate a preemption mid-run, restart, and verify the resumed run
continues the exact same trajectory (deterministic data pipeline +
restored optimizer state).  Runs on the CUDA card; ``--device cpu`` runs
the kernels' plain versions instead (without a card and without it, it
raises).

  PYTHONPATH=src python examples/torch_train_resume.py [--device cpu]
"""
import argparse
import tempfile

import numpy as np

from repro_torch.launch.train import train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    with tempfile.TemporaryDirectory() as d:
        print("== uninterrupted 12-step run ==")
        full = train_loop("granite-moe-1b-a400m", steps=12, batch=4, seq=32,
                          ckpt_dir=f"{d}/ref", ckpt_every=4,
                          log=lambda *a: None, device=device)
        print("losses:", [f"{x:.3f}" for x in full["losses"]])

        print("== run killed after 6 steps (simulated preemption) ==")
        train_loop("granite-moe-1b-a400m", steps=12, batch=4, seq=32,
                   ckpt_dir=f"{d}/job", ckpt_every=4, stop_after=6,
                   log=lambda *a: None, device=device)

        print("== restarted: resumes from latest checkpoint ==")
        resumed = train_loop("granite-moe-1b-a400m", steps=12, batch=4,
                             seq=32, ckpt_dir=f"{d}/job", ckpt_every=4,
                             resume=True, device=device)
        drift = np.abs(np.array(full["losses"][6:])
                       - np.array(resumed["losses"])).max()
        print(f"max loss drift vs uninterrupted run: {drift:.2e}")
        assert drift < 1e-3, "resume must continue the same trajectory"
        print("OK — resumed trajectory matches")


if __name__ == "__main__":
    main()
