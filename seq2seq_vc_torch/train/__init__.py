"""Training (mirrors seq2seq_vc_tpu/train): the AAS-VC, VTN,
FastSpeech-VC and Transformer-TTS trainers, their optimizer, schedule,
state and data pipelines, and the trainer registry."""

from .aas_vc import AASVCTrainer
from .ar_tts import ARTTSTrainer
from .ar_vc import ARVCTrainer
from .nar_vc import NARVCTrainer

TRAINERS = {"ARVCTrainer": ARVCTrainer, "AASVCTrainer": AASVCTrainer,
            "NARVCTrainer": NARVCTrainer, "ARTTSTrainer": ARTTSTrainer}


def get_trainer_class(name: str):
    if name not in TRAINERS:
        raise ValueError(f"unknown trainer_type: {name}")
    return TRAINERS[name]
