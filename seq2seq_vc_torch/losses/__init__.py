"""Losses of the AAS-VC, VTN, FastSpeech-VC and Transformer-TTS training
steps, resolved by name from the YAML ``criterions`` block (mirrors
seq2seq_vc_tpu/losses/__init__.py)."""

from .duration import DurationPredictorLoss, StochasticDurationPredictorLoss
from .forward_sum import ForwardSumLoss
from .guided_attention import GuidedAttentionLoss, GuidedMultiHeadAttentionLoss
from .l1 import L1Loss
from .seq2seq import Seq2SeqLoss

_CRITERIONS = {
    "L1Loss": L1Loss,
    "Seq2SeqLoss": Seq2SeqLoss,
    "ForwardSumLoss": ForwardSumLoss,
    "DurationPredictorLoss": DurationPredictorLoss,
    "StochasticDurationPredictorLoss": StochasticDurationPredictorLoss,
    "GuidedAttentionLoss": GuidedAttentionLoss,
    "GuidedMultiHeadAttentionLoss": GuidedMultiHeadAttentionLoss,
}


def get_criterion(name: str, **params):
    if name not in _CRITERIONS:
        raise NotImplementedError(f"criterion {name!r} is not ported yet")
    return _CRITERIONS[name](**params)
