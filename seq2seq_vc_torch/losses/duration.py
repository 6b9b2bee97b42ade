"""Duration predictor loss names (mirrors seq2seq_vc_tpu/losses/duration.py).

The port's AAS-VC has the stochastic predictor only, which returns its own
NLL from the model's forward pass; the deterministic predictor's
``DurationPredictorLoss`` comes with that predictor.
"""

from __future__ import annotations


class StochasticDurationPredictorLoss:
    """Placeholder for the config name (the NLL comes from the model)."""

    def __call__(self, *args, **kwargs):
        return None
