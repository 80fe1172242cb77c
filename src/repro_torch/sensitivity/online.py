"""Online per-layer sensitivity estimation from shadow-step samples.

Own copy of ``repro.sensitivity.online``.

The serving engine already measures real logit drift every
``shadow_every`` batches (live stack vs exact stack on cache copies).
That sample is a *total* over all layers; this estimator folds it back
into per-layer sensitivities by attributing the measured drift to layers
in proportion to the drift the current estimates predict for the plan
that produced it — layer ``l`` carrying operator mae ``m_l`` gets share
``s_l·m_l / Σ_j s_j·m_j`` of the total, and its implied sensitivity
``share·drift / m_l`` updates an EWMA.

Identifiability mirrors the physics: one fixed plan only pins the
weighted sum ``Σ s_l·m_l`` (each update rescales the estimate vector to
match the measured total, preserving ratios), but an adaptive serve never
holds one plan — the controller walks the ladder and per-class traffic
decodes on different levels, so successive samples carry *different* mae
vectors and the per-layer components separate.  The convergence test
drives exactly that: synthetic drift from varied plans pulls the
estimates to the offline profile.

Exact layers (``m_l = 0``) are silent in a sample and keep their current
estimate — attribution never divides by an exact layer's zero mae.
"""

from __future__ import annotations

import numpy as np

__all__ = ["OnlineSensitivity"]


class OnlineSensitivity:
    """Per-layer EWMA sensitivities (drift per unit operator mae)."""

    def __init__(self, n_layers: int, *, alpha: float = 0.25,
                 init=None) -> None:
        assert 0 < alpha <= 1
        self.alpha = float(alpha)
        if init is None:
            self.sens = np.ones(n_layers, dtype=np.float64)
        else:
            self.sens = np.asarray(init, dtype=np.float64).copy()
            assert self.sens.shape == (n_layers,)
        assert (self.sens >= 0).all()
        self.n_updates = 0

    @classmethod
    def from_profile(cls, profile, bits, *, alpha: float = 0.25,
                     width_map=None) -> "OnlineSensitivity":
        """Seed from an offline :class:`~repro_torch.sensitivity.profile.SensitivityProfile`
        -- per-width, or per-layer-width under a mixed ``width_map``."""
        if width_map is not None:
            init = np.array([profile.sensitivities(b)[l]
                             for l, b in enumerate(width_map)])
            return cls(len(width_map), alpha=alpha, init=init)
        return cls(profile.n_layers, alpha=alpha,
                   init=profile.sensitivities(bits))

    def update(self, maes, drift: float) -> None:
        """Fold one shadow sample in.  ``maes[l]`` is the compiled-table
        mae of the operator layer ``l`` ran in the sampled batch (0 for
        exact layers); ``drift`` is the measured total mean |Δlogit|."""
        m = np.asarray(maes, dtype=np.float64)
        assert m.shape == self.sens.shape
        active = m > 0
        if not active.any():
            return      # all-exact plan: the sample carries no signal
        d = max(0.0, float(drift))
        pred = self.sens * m
        total = float(pred[active].sum())
        if total > 0:
            shares = np.where(active, pred / total, 0.0)
        else:       # estimates collapsed to 0: split evenly over active
            shares = active / active.sum()
        obs = np.zeros_like(self.sens)
        obs[active] = d * shares[active] / m[active]
        a = self.alpha
        self.sens = np.where(active, (1 - a) * self.sens + a * obs,
                             self.sens)
        self.n_updates += 1

    def sensitivities(self) -> np.ndarray:
        return self.sens.copy()
