"""Deterministic synthetic data with checkpointable state.

Batches are a pure function of ``(seed, step)``: restarts reproduce them
exactly, and the pipeline state a checkpoint keeps is one integer.  The
numpy generator and draws are the reference's, so both packages train on
the same tokens, frames and patches bit for bit: Zipf-distributed tokens
clipped into the vocabulary, unit-Gaussian frames and patches.  The host
draws them and copies them to the requested device once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig


@dataclass
class DataState:
    seed: int
    step: int

    def as_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d: dict) -> "DataState":
        return cls(seed=int(d["seed"]), step=int(d["step"]))


def synth_batch(cfg: ModelConfig, batch: int, seq: int, state: DataState, *,
                device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """The batch for ``state.step``: ``tokens`` (batch, seq) int32, and
    ``frames`` (audio) or ``patches`` (VLM) float32, on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng((state.seed, state.step))
    ranks = rng.zipf(1.2, size=(batch, seq)).astype(np.int64)
    tokens = np.minimum(ranks - 1, cfg.vocab_size - 1).astype(np.int32)
    out = {"tokens": torch.from_numpy(tokens).to(dev)}
    if cfg.family == "audio":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.encoder.n_frames, cfg.d_model), dtype=np.float32)).to(dev)
    if cfg.family == "vlm":
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.vision.n_patches, cfg.vision.d_vision),
            dtype=np.float32)).to(dev)
    return out


def next_batch(cfg: ModelConfig, batch: int, seq: int, state: DataState, *,
               device: str | torch.device = "cuda"):
    out = synth_batch(cfg, batch, seq, state, device=device)
    return out, DataState(state.seed, state.step + 1)
