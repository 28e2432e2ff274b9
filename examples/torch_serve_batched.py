"""Batched serving on the PyTorch/CUDA port: prefill a batch of prompts
for an enc-dec model (whisper-tiny backbone with the stubbed audio
frontend), an SSM (mamba2) and a hybrid (recurrentgemma), then decode
tokens — exercising the KV-cache, cross-attention cache and
recurrent-state serving paths.  Runs on the CUDA card; ``--device cpu``
runs the kernels' plain versions instead (without a card and without it,
it raises).

  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import serve_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    for arch in ("whisper-tiny", "mamba2-130m", "recurrentgemma-9b"):
        print(f"== {arch} ==")
        out = serve_loop(arch, batch=3, prompt_len=10, gen=8, device=device)
        print("tokens:\n", out["generated"])


if __name__ == "__main__":
    main()
