"""Serving: prefill + batched autoregressive decode.

The port of the JAX package's ``launch/serve.py``.  ``make_prefill_step``
/ ``make_serve_step`` build the step functions (on the partitioned route,
``Model(cfg, impl=kernels.ops.partitioned(...))`` with the parameters
placed by ``launch.train.make_state_shardings``, over a cache placed by
``cache_pspecs``: ``placed_cache``); ``serve_loop`` is a
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
from ..kernels import ops
from ..models.common import P, Rules, placed_zeros, placements, spec
from ..models.frontends import synth_frontend_inputs
from ..models.layers import greedy
from ..models.transformer import Model


# the logical axes of each cache leaf, less the leading layer-stack axes
CACHE_AXES = {
    "k": ("batch", "cache_seq", "cache_heads", None),
    "v": ("batch", "cache_seq", "cache_heads", None),
    "k_scale": ("batch", "cache_seq", "cache_heads"),
    "v_scale": ("batch", "cache_seq", "cache_heads"),
    "ssm": ("batch", "ssm_heads", None, None),
    "h": ("batch", "rnn"),
    "conv": ("batch", None, None),
}


def cache_pspecs(model: Model, cache_abs, rules) -> Dict:
    """PartitionSpecs for the decode cache: KV seq/heads per rules; leading
    layer-stack dim unsharded; batch per rules.  Divisibility fallback is
    applied through ``spec`` (e.g. 5 KV heads on a 16-way axis -> None)."""
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        nd = len(tree.shape)
        axes = CACHE_AXES.get(name)
        if axes is None or nd < len(axes):
            return P()
        lead = nd - len(axes)        # leading layer-stack dims (unsharded)
        return spec(rules, *((None,) * lead + axes), shape=tree.shape)
    return walk(cache_abs)


def placed_cache(model: Model, batch: int, max_len: int, mesh,
                 rules: Rules, device) -> Dict:
    """A zero cache laid out on ``mesh`` by ``cache_pspecs``, each leaf
    made from its local shard alone (``models.common.placed_zeros``) on
    ``device``."""
    abstract = model.make_cache(batch, max_len, abstract=True)
    specs = cache_pspecs(model, abstract, rules)

    def make(s, ps):
        if isinstance(s, dict):
            return {k: make(s[k], ps[k]) for k in s}
        return placed_zeros(s.shape, s.dtype, mesh, placements(ps, mesh),
                            device)
    return make(abstract, specs)


def _partitioned(model: Model):
    impl = model.impl
    return impl if isinstance(impl, ops.Partitioned) else None


def make_prefill_step(model: Model, rules: Optional[Rules], max_len: int):
    """The prefill ``(params, batch) -> (last logits, cache)``; on the
    partitioned route (``Model(cfg, impl=kernels.ops.partitioned(...))``)
    its cache is placed by ``cache_pspecs``."""
    part = _partitioned(model)

    def prefill_step(params: Dict, batch: Dict
                     ) -> Tuple[torch.Tensor, Dict]:
        tokens = batch["tokens"]
        cache = None
        if part is not None:
            cache = placed_cache(model, tokens.shape[0], max_len, part.mesh,
                                 part.rules, tokens.device)
        return model.prefill(params, tokens, max_len, rules,
                             frames=batch.get("frames"),
                             patches=batch.get("patches"), cache=cache)
    return prefill_step


def make_serve_step(model: Model, rules: Optional[Rules]):
    def serve_step(params: Dict, cache: Dict, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict]:
        """The next token of each row (int32) and the cache, updated in
        place."""
        logits, cache = model.decode_step(params, tokens, cache, rules)
        return greedy(logits), cache
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
