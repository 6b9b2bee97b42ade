"""models of the PyTorch port (mirrors seq2seq_vc_tpu/models) and their
registry: the decode entry point picks the AR or the NAR path by
membership of ``AR_VC_MODELS`` or ``NAR_VC_MODELS``; ``TransformerTTS``
is the text-to-mel model of ``tts_train`` and ``tts_decode``."""

from .aas_vc import AASVC
from .fastspeech_vc import FastSpeechVC
from .transformer_tts import TransformerTTS
from .vtn import VTN

AR_VC_MODELS = ["VTN"]
NAR_VC_MODELS = ["FastSpeechVC", "AASVC"]

_MODELS = {"VTN": VTN, "AASVC": AASVC, "FastSpeechVC": FastSpeechVC,
           "TransformerTTS": TransformerTTS}


def get_model_class(name: str):
    if name not in _MODELS:
        raise ValueError(f"unknown model_type: {name}")
    return _MODELS[name]
