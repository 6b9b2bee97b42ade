"""Urhythmic on the port (mirrors seq2seq_vc_tpu/urhythmic): HuBERT-soft
units (``hubert``), segmentation (``segmenter``, ``cluster``), rhythm
models, time stretchers, the HiFi-GAN fine-tune (``vocoder_train``,
``dataset``) and the recipe's command line (``cli``)."""

from .utils import SoundType, SONORANT, OBSTRUENT, SILENCE, Metric  # noqa: F401
from .segmenter import Segmenter, segment  # noqa: F401
from .rhythm_model import RhythmModelFineGrained, RhythmModelGlobal  # noqa: F401
from .stretcher import TimeStretcherFineGrained, TimeStretcherGlobal  # noqa: F401
from .model import UrhythmicFine, UrhythmicGlobal  # noqa: F401
