"""Deterministic synthetic data pipeline with restart-exact skip-ahead.

Counterpart of ``repro.data.pipeline``.  Batches are pure functions of
(seed, step) via counter-based Philox: a restarted job passes the
checkpointed step and receives the same batch with no state replay.
Tokens are JAX's bit for bit (the port's ``core.rng.philox4x32`` at the
same counters and key).  The stub frontends' ``frames`` and
``patch_emb`` come from ``jax.random.normal`` there and from a torch
generator keyed on (seed, step) here, so they are not JAX's values;
tests hand both packages the same arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.api.session import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import rng as crng


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # synthetic stream: tokens ~ philox(step, position) % vocab


def _tokens(seed: int, step: int, shape, vocab: int, device):
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    bits = crng.philox4x32(step, 0, idx, 1, int(seed) & crng.MASK32, 0)[0]
    return (bits % max(vocab - 1, 1)).to(torch.int32).reshape(shape)


def _normal(seed: int, step: int, shape, device):
    """bf16 normal draws of (seed, step) from a torch generator."""
    gen = torch.Generator(device=device).manual_seed(
            ((int(seed) & crng.MASK32) << 32) | (int(step) & crng.MASK32))
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).to(torch.bfloat16)


def make_batch(cfg: ArchConfig, shape: ShapeConfig, *, step: int = 0,
               seed: int = 0, abstract: bool = False,
               batch_override: int = 0, seq_override: int = 0,
               device=None) -> Dict:
    """One training/prefill batch for (arch, shape) at ``step``, on
    ``device`` (default the CUDA card; raises without one).
    ``abstract=True``: tensors on the meta device (shapes and dtypes
    only, JAX's ``ShapeDtypeStruct``s)."""
    device = torch.device("meta") if abstract else resolve_device(device)
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    out: Dict = {}

    if abstract:
        def empty(shape_, dtype):
            return torch.empty(shape_, dtype=dtype, device=device)
        if cfg.family == "audio":
            out["frames"] = empty((b, cfg.enc_seq, cfg.d_model),
                                  torch.bfloat16)
            out["tokens"] = empty((b, s), torch.int32)
            out["labels"] = empty((b, s), torch.int32)
            return out
        text_len = s - cfg.prefix_len if cfg.family == "vlm" else s
        out["tokens"] = empty((b, text_len), torch.int32)
        out["labels"] = empty((b, s), torch.int32)
        if cfg.family == "vlm":
            out["patch_emb"] = empty((b, cfg.prefix_len, cfg.d_model),
                                     torch.bfloat16)
        return out

    if cfg.family == "audio":
        out["frames"] = _normal(seed, step, (b, cfg.enc_seq, cfg.d_model),
                                device)
        out["tokens"] = _tokens(seed, 2 * step, (b, s), cfg.vocab, device)
        out["labels"] = _tokens(seed, 2 * step + 1, (b, s), cfg.vocab,
                                device)
        return out

    text_len = s - cfg.prefix_len if cfg.family == "vlm" else s
    out["tokens"] = _tokens(seed, 2 * step, (b, text_len), cfg.vocab, device)
    out["labels"] = _tokens(seed, 2 * step + 1, (b, s), cfg.vocab, device)
    if cfg.family == "vlm":
        out["patch_emb"] = _normal(seed, step,
                                   (b, cfg.prefix_len, cfg.d_model), device)
    return out


class DataIterator:
    """Stateful wrapper: next() yields (step, batch); skip_to(step)
    restores."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                 batch_override: int = 0, seq_override: int = 0, *,
                 device=None):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = resolve_device(device)
        self.step = 0
        self._b, self._s = batch_override, seq_override

    def skip_to(self, step: int) -> None:
        self.step = step

    def __next__(self):
        batch = make_batch(self.cfg, self.shape, step=self.step,
                           seed=self.seed, batch_override=self._b,
                           seq_override=self._s, device=self.device)
        out = (self.step, batch)
        self.step += 1
        return out
