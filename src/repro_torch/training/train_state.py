"""Serve-side step functions.

Counterpart of the serving half of `repro.training.train_state`:
`make_prefill_step` and `make_decode_step` return functions of
``(params, batch, caches)`` that give ``(next_tok, new_caches)`` exactly as
the reference's do, with the greedy next token as int32.  The train step
comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch, caches):
        last_logits, new_caches = M.prefill(cfg, params, batch, caches)
        next_tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
        return next_tok, new_caches
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(params, batch, caches):
        last_logits, new_caches = M.decode_step(cfg, params, batch, caches)
        next_tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
        return next_tok, new_caches
    return decode_step
