"""Training (mirrors seq2seq_vc_tpu/train): the AAS-VC, VTN and
FastSpeech-VC trainers, their optimizer, schedule, state and data
pipeline, and the trainer registry."""

from .aas_vc import AASVCTrainer
from .ar_vc import ARVCTrainer
from .nar_vc import NARVCTrainer

TRAINERS = {"ARVCTrainer": ARVCTrainer, "AASVCTrainer": AASVCTrainer,
            "NARVCTrainer": NARVCTrainer}
# trainer types of the JAX package that the port does not have yet, and the
# ROADMAP.md item (queue 1) that ports each
_NOT_PORTED = {"ARTTSTrainer": "queue 1 item 3 (TransformerTTS)"}


def get_trainer_class(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"trainer_type {name!r} is not ported yet: ROADMAP.md "
                                  f"{_NOT_PORTED[name]}")
    if name not in TRAINERS:
        raise ValueError(f"unknown trainer_type: {name}")
    return TRAINERS[name]
