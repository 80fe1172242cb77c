"""Model API of the port: init / forward / loss / decode, dispatched by
family: :mod:`.encdec` for the encoder–decoder family (``audio``,
whisper-tiny), :mod:`.lm` for every decoder-only one.  The paged entry
points refuse ``audio``, as the reference's do."""

from __future__ import annotations

from . import encdec, lm
from .config import ModelConfig


def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    if cfg.family == "audio":
        return encdec.init_encdec(cfg, seed, device=device)
    return lm.init_lm(cfg, seed, device=device)


def loss_fn(cfg: ModelConfig):
    return encdec.encdec_loss if cfg.family == "audio" else lm.lm_loss


def forward_fn(cfg: ModelConfig):
    return encdec.forward_encdec if cfg.family == "audio" else lm.forward_lm


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *, device="cuda"):
    if cfg.family == "audio":
        return encdec.init_encdec_caches(cfg, batch, seq_len, device=device)
    return lm.init_decode_caches(cfg, batch, seq_len, device=device)


def decode_fn(cfg: ModelConfig):
    return encdec.decode_step_encdec if cfg.family == "audio" else lm.decode_step


def init_paged_caches(cfg: ModelConfig, batch: int, n_pages: int,
                      page_size: int, max_len: int, *, device="cuda"):
    """Page-pool decode caches for continuous batching (LM families; the
    recurrent ones are refused by :func:`lm.init_paged_caches`)."""
    if cfg.family == "audio":
        raise ValueError("continuous batching serves LM families only")
    return lm.init_paged_caches(cfg, batch, n_pages, page_size, max_len,
                                device=device)


def decode_paged_fn(cfg: ModelConfig):
    """Per-slot-position decode step over paged caches (LM families)."""
    if cfg.family == "audio":
        raise ValueError("continuous batching serves LM families only")
    return lm.decode_step_paged


__all__ = ["ModelConfig", "init_model", "loss_fn", "forward_fn", "init_caches",
           "decode_fn", "init_paged_caches", "decode_paged_fn"]
