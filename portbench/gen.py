"""The one generator of the benchmark's traffic: every input a cell uses is
made here from its mix file's parameters and the run's ``--seed``.

Streams are independent: ``generator(seed, "weights")`` and
``generator(seed, "inputs")`` draw from seeds hashed from the run's seed
and the stream's name, so any whole number is a seed (negative or past 64
bits too).  Every draw is made on the device in one call a stream.

Mixes by ``input``:

* ``images``: ``distinct_batches`` batches of ``batch`` N(0, 1) images
  (``image_size`` square, ``channels``, NHWC, float32) and uniform labels
  below ``num_classes`` (from the configuration).
* ``tokens``: ``distinct_batches`` batches of ``batch`` x ``seq`` uniform
  token ids below the vocabulary.
* ``prompts``: an open loop of single requests at ``rate_per_s``: the
  window's ``round(rate * seconds)`` arrivals (rounded to a multiple the
  kind asks for), their gaps the quantiles of an exponential distribution
  and their prompt lengths ``lengths`` in equal shares, both shuffled by
  a schedule seed that the kind fixes, so that every run offers the same
  work at the same times; the run's seed draws each prompt's tokens.
"""
from __future__ import annotations

import hashlib
import math
from typing import List, Tuple

import torch


def sub_seed(seed: int, stream: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def image_pool(cfg: dict, mix: dict, seed: int, device
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``(images, labels)`` of each distinct batch."""
    g = generator(seed, "inputs", device)
    k, b, s = mix["distinct_batches"], mix["batch"], cfg["image_size"]
    images = torch.randn((k, b, s, s, cfg["in_channels"]), generator=g,
                         device=device, dtype=torch.float32)
    labels = torch.randint(0, cfg["num_classes"], (k, b), generator=g,
                           device=device)
    return list(zip(images.unbind(0), labels.unbind(0)))


def token_pool(cfg: dict, mix: dict, seed: int, device) -> List[torch.Tensor]:
    g = generator(seed, "inputs", device)
    tokens = torch.randint(0, cfg["vocab_size"], (
        mix["distinct_batches"], mix["batch"], mix["seq"]), generator=g,
        device=device)
    return list(tokens.unbind(0))


def pool(cfg: dict, mix: dict, seed: int, device) -> list:
    if mix["input"] == "images":
        return image_pool(cfg, mix, seed, device)
    if mix["input"] == "tokens":
        return token_pool(cfg, mix, seed, device)
    raise ValueError(f"no pool of {mix['input']!r} inputs")


def arrivals(mix: dict, seconds: float, schedule_seed: int,
             multiple: int = 1) -> Tuple[List[float], List[int]]:
    """Each request's due time (s from the window's start, the first at
    0, the last before ``seconds``) and prompt length; as many requests
    as the nearest multiple of ``multiple`` to ``rate * seconds``."""
    rate = mix["rate_per_s"]
    n = multiple * max(1, round(rate * seconds / multiple))
    g = torch.Generator().manual_seed(sub_seed(schedule_seed, "arrivals"))
    gaps = [-math.log(1 - (i + 0.5) / n) / rate for i in range(n)]
    order = torch.randperm(n, generator=g).tolist()
    gaps = [gaps[i] for i in order]
    # scaled so that the n arrivals fill the window: the last is due
    # one mean gap before its end
    scale = seconds * (n - 1) / n / max(sum(gaps[:-1]), 1e-12)
    due, t = [], 0.0
    for gap in gaps:
        due.append(t)
        t += gap * scale
    lengths = [mix["lengths"][i % len(mix["lengths"])] for i in range(n)]
    order = torch.randperm(n, generator=g).tolist()
    return due, [lengths[i] for i in order]


def prompts(cfg: dict, mix: dict, seed: int, n: int, device) -> torch.Tensor:
    """Token ids (n, longest length); request i reads its first
    ``length`` of row i."""
    g = generator(seed, "inputs", device)
    return torch.randint(0, cfg["vocab_size"], (n, max(mix["lengths"])),
                         generator=g, device=device)


def sample(seed: int, stream: str, population: int, k: int) -> List[int]:
    """``k`` distinct indices below ``population`` (all if fewer), sorted."""
    g = torch.Generator().manual_seed(sub_seed(seed, stream))
    return sorted(torch.randperm(population, generator=g)[:k].tolist())
