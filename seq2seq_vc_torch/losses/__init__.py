"""Losses of the AAS-VC (the diffusion decoders' included), VTN,
FastSpeech-VC and Transformer-TTS training steps and the flow NLL, resolved
by name from the YAML ``criterions`` block (mirrors
seq2seq_vc_tpu/losses/__init__.py)."""

from .diffsinger_l2 import DiffSingerL2Loss
from .duration import DurationPredictorLoss, StochasticDurationPredictorLoss
from .forward_sum import ForwardSumLoss
from .guided_attention import GuidedAttentionLoss, GuidedMultiHeadAttentionLoss
from .l1 import L1Loss
from .mle import MLELoss
from .seq2seq import Seq2SeqLoss

_CRITERIONS = {
    "L1Loss": L1Loss,
    "Seq2SeqLoss": Seq2SeqLoss,
    "ForwardSumLoss": ForwardSumLoss,
    "DurationPredictorLoss": DurationPredictorLoss,
    "StochasticDurationPredictorLoss": StochasticDurationPredictorLoss,
    "GuidedAttentionLoss": GuidedAttentionLoss,
    "GuidedMultiHeadAttentionLoss": GuidedMultiHeadAttentionLoss,
    "MLELoss": MLELoss,
    "DiffSingerL2Loss": DiffSingerL2Loss,
}


def get_criterion(name: str, **params):
    if name not in _CRITERIONS:
        raise ValueError(f"unknown criterion: {name}")
    return _CRITERIONS[name](**params)
