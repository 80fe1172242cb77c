"""Model API of the port: init / forward / decode (dense and paged) for
the dense family."""

from __future__ import annotations

from . import lm
from .config import ModelConfig


def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    return lm.init_lm(cfg, seed, device=device)


def forward_fn(cfg: ModelConfig):
    return lm.forward_lm


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *, device="cuda"):
    return lm.init_decode_caches(cfg, batch, seq_len, device=device)


def decode_fn(cfg: ModelConfig):
    return lm.decode_step


def init_paged_caches(cfg: ModelConfig, batch: int, n_pages: int,
                      page_size: int, max_len: int, *, device="cuda"):
    """Page-pool decode caches for continuous batching (dense family)."""
    return lm.init_paged_caches(cfg, batch, n_pages, page_size, max_len,
                                device=device)


def decode_paged_fn(cfg: ModelConfig):
    """Per-slot-position decode step over paged caches (dense family)."""
    return lm.decode_step_paged


__all__ = ["ModelConfig", "init_model", "forward_fn", "init_caches",
           "decode_fn", "init_paged_caches", "decode_paged_fn"]
