"""Prefill and serve step builders (counterpart of the inference half of
``repro.train.step``): ``make_prefill_step`` is the forward-only prefill,
``make_serve_step`` one KV-cached decode iteration.  Both run without
autograd, on the device of the parameters they are given.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decode_step, forward


def make_prefill_step(cfg: ArchConfig, *, sliding_window: int = 0):
    """Forward-only prefill (the prefill_32k shape): batch -> logits."""
    def prefill(params, batch):
        with torch.no_grad():
            logits, _ = forward(cfg, params, batch, remat=False,
                                sliding_window=sliding_window)
        return logits
    return prefill


def make_serve_step(cfg: ArchConfig, *, sliding_window: int = 0,
                    temperature: float = 0.0):
    """One decode iteration: (params, cache, tokens (B,1)) ->
    (next_tokens (B,1), cache), the cache written in place
    (:func:`repro_torch.models.decode.decode_step`).

    Greedy at ``temperature`` 0 (the first of equal logits, as JAX's
    argmax).  Above it, a draw from softmax(logits / temperature) by a
    torch generator seeded with the cache's length before the step: the
    same skip-ahead keying as JAX's ``fold_in(PRNGKey(0), length)``, not
    its stream.
    """
    def serve_step(params, cache, tokens):
        length = int(cache["length"])
        logits, new_cache = decode_step(cfg, params, cache, tokens,
                                        sliding_window=sliding_window)
        last = logits[:, -1]
        if temperature > 0.0:
            gen = torch.Generator(device=last.device).manual_seed(length)
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)
        else:
            nxt = torch.argmax(last, dim=-1)[:, None]
        return nxt.to(tokens.dtype), new_cache
    return serve_step
