"""models of the PyTorch port (mirrors seq2seq_vc_tpu/models) and their
registry: the decode entry point picks the AR or the NAR path by
membership of ``AR_VC_MODELS`` or ``NAR_VC_MODELS``."""

from .aas_vc import AASVC
from .fastspeech_vc import FastSpeechVC
from .vtn import VTN

AR_VC_MODELS = ["VTN"]
NAR_VC_MODELS = ["FastSpeechVC", "AASVC"]

_MODELS = {"VTN": VTN, "AASVC": AASVC, "FastSpeechVC": FastSpeechVC}
# model types of the JAX package that the port does not have yet, and the
# ROADMAP.md item (queue 1) that ports each
_NOT_PORTED = {"TransformerTTS": "queue 1 item 3 (TransformerTTS)"}


def get_model_class(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"model_type {name!r} is not ported yet: ROADMAP.md "
                                  f"{_NOT_PORTED[name]}")
    if name not in _MODELS:
        raise ValueError(f"unknown model_type: {name}")
    return _MODELS[name]
