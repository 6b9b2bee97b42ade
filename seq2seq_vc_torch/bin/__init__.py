"""Command-line entry points of the PyTorch port (mirror seq2seq_vc_tpu/bin):
``preprocess``, ``compute_statistics``, ``normalize``, ``vc_train``,
``vc_decode``, ``vc_serve``, ``tokenize_text``, ``tts_train``,
``tts_decode``, ``vocoder_anasyn_debug``, ``evaluate`` and
``convert_checkpoint`` (a reference checkpoint to a port one, on the
CPU). Each has ``main(argv=None)``, so a script can drive it in-process,
and each that computes on a device a ``--device`` flag (default: the
card; without one it raises)."""

from __future__ import annotations

import logging
import sys

import torch


def setup(verbose: int) -> None:
    """Logging to stderr, and float32 matmuls and convolutions in full
    float32: TF32 off for cuBLAS and cuDNN (PyTorch's default leaves it on
    for cuDNN), the mode in which the port's card checks run."""
    logging.basicConfig(
        level=logging.INFO if verbose else logging.WARNING, stream=sys.stderr,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.info("tf32 off: torch.backends.cuda.matmul.allow_tf32=%s, "
                 "torch.backends.cudnn.allow_tf32=%s", torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
