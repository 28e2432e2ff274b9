"""Serving: prefill + batched autoregressive decode.

The port of the JAX package's ``launch/serve.py``.  ``make_prefill_step``
/ ``make_serve_step`` build the step functions; ``serve_loop`` is a
runnable single-device batched-request demo (greedy decoding) on the
port's kernels (``kernels.ops``), on the card unless ``device`` says
otherwise.  The prompts come from a ``torch.Generator`` seeded with
``seed + 1``, so they differ from the JAX demo's.

Run (reduced, on a CUDA card; ``--device cpu`` runs the kernels' plain
versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --batch 4 --prompt-len 16 --gen 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Tuple

import torch

from ..configs import get_config, reduced
from ..models.common import Rules
from ..models.frontends import synth_frontend_inputs
from ..models.transformer import Model


def make_prefill_step(model: Model, rules: Optional[Rules], max_len: int):
    def prefill_step(params: Dict, batch: Dict
                     ) -> Tuple[torch.Tensor, Dict]:
        return model.prefill(params, batch["tokens"], max_len, rules,
                             frames=batch.get("frames"),
                             patches=batch.get("patches"))
    return prefill_step


def make_serve_step(model: Model, rules: Optional[Rules]):
    def serve_step(params: Dict, cache: Dict, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict]:
        """The next token of each row (int32) and the cache, updated in
        place."""
        logits, cache = model.decode_step(params, tokens, cache, rules)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, cache
    return serve_step


def serve_loop(arch: str, batch: int = 4, prompt_len: int = 16,
               gen: int = 16, use_reduced: bool = True, seed: int = 0,
               log=print, device="cuda") -> Dict:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve_loop: no CUDA card; pass device='cpu' "
                           "to run the kernels' plain versions")
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    cfg = cfg.replace(dtype=torch.float32, remat=False)
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    # the cache holds a VLM's stub patches ahead of the prompt (the JAX
    # demo's prompt_len + gen + 8 leaves pixtral-12b's 64 patches no room:
    # its cache writes are clamped there, out of bounds here)
    max_len = cfg.n_patches + prompt_len + gen + 8

    prompts = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), device=device,
        generator=torch.Generator(device=device).manual_seed(seed + 1))
    extras = synth_frontend_inputs(cfg, batch, device=device)

    prefill = make_prefill_step(model, None, max_len)
    step = make_serve_step(model, None)

    t0 = time.perf_counter()
    last_logits, cache = prefill(params, {"tokens": prompts, **extras})
    tok = torch.argmax(last_logits, dim=-1).to(torch.int32)[:, None]
    out_tokens = [tok]
    for _ in range(gen - 1):
        nxt, cache = step(params, cache, tok)
        tok = nxt[:, None]
        out_tokens.append(tok)
    gen_tokens = torch.cat(out_tokens, dim=1).cpu()
    elapsed = time.perf_counter() - t0
    log(f"served {batch} requests x {gen} tokens in {elapsed:.2f}s "
        f"({batch * gen / elapsed:.1f} tok/s) on {device}")
    return {"generated": gen_tokens.numpy(), "elapsed_s": elapsed}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    serve_loop(args.arch, args.batch, args.prompt_len, args.gen,
               args.reduced, device=args.device)


if __name__ == "__main__":
    main()
