"""Shared set-up of the port's parity tests (tests/test_torch_*.py).

Builds the same tiny model in the JAX package and in the PyTorch port with
the weights carried across. The tests that need an NVIDIA card are in
tests/test_torch_kernels_cuda.py, which imports no JAX.

Every other port test file imports ``release_jax_executables``, an autouse
fixture that drops JAX's compiled executables before and after the file.
"""

import gc

import jax
import numpy as np
import pytest
import torch

from seq2seq_vc_tpu.convert.reference import convert_aasvc, convert_transformer_tts, convert_vtn
from seq2seq_vc_tpu.models import AASVC as JaxAASVC
from seq2seq_vc_tpu.models import VTN as JaxVTN
from seq2seq_vc_tpu.models import TransformerTTS as JaxTransformerTTS
from seq2seq_vc_torch.convert import aasvc_state_dict
from seq2seq_vc_torch.models.aas_vc import AASVC
from seq2seq_vc_torch.models.transformer_tts import TransformerTTS
from seq2seq_vc_torch.models.vtn import VTN

@pytest.fixture(autouse=True, scope="module")
def release_jax_executables():
    """Drop every executable JAX has compiled in this process, before the
    file that imports this fixture and after it. Each executable the XLA
    CPU compiler makes holds memory mappings of its own until it is freed:
    an eager ``jax.vjp`` of a Pallas kernel in interpret mode adds
    2,500-3,200, so a test worker that ran several such files reached the
    kernel's limit of 65,530 mappings a process (``vm.max_map_count``), and
    the next compile segfaulted. ``jax.clear_caches()`` and a collection
    free them (back to ~1,100)."""
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()


# the AAS-VC test configuration: the flagship's structure at toy widths
TINY_AASVC = dict(
    idim=80, odim=80, adim=32, aheads=2, elayers=1, eunits=64, dlayers=1, dunits=64,
    postnet_layers=2, postnet_chans=16, post_encoder_reduction_factor=4,
    duration_predictor_type="stochastic", stochastic_duration_predictor_flows=2,
    positionwise_layer_type="linear", conformer_enc_kernel_size=7,
    conformer_dec_kernel_size=7, duration_predictor_use_encoder_outputs=False,
    encoder_normalize_before=True, decoder_normalize_before=True,
    stochastic_duration_predictor_noise_scale=0.0,
)


# the VTN test configuration: vtn.v1.yaml's structure (post-LN decoder,
# reduction factor 4, group-norm postnet) at toy widths, prenet dropout off
# (its always-on bits cannot be reproduced across frameworks)
TINY_VTN = dict(
    idim=80, odim=80, adim=32, aheads=2, elayers=2, eunits=64, dlayers=2, dunits=64,
    dprenet_units=24, postnet_layers=2, postnet_chans=16, decoder_reduction_factor=4,
    encoder_normalize_before=True, decoder_normalize_before=False,
    dprenet_dropout_rate=0.0,
)


# the Transformer-TTS test configuration: transformer_tts.v1.yaml's structure
# (pre-LN encoder, post-LN decoder, r 1, guided attention on 2 layers x 2
# heads) at toy widths, a vocabulary of 20 tokens, prenet dropout off; its
# decoder side has TINY_VTN's widths, so that modules carry over to a VTN
TINY_TTS = dict(
    idim=20, odim=80, adim=32, aheads=2, elayers=2, eunits=64, dlayers=2, dunits=64,
    dprenet_units=24, postnet_layers=2, postnet_chans=16, decoder_reduction_factor=1,
    encoder_normalize_before=True, decoder_normalize_before=False,
    num_heads_applied_guided_attn=2, num_layers_applied_guided_attn=2,
    dprenet_dropout_rate=0.0,
)
NO_DROPOUT = dict(
    transformer_enc_dropout_rate=0.0, transformer_enc_positional_dropout_rate=0.0,
    transformer_enc_attn_dropout_rate=0.0, transformer_dec_dropout_rate=0.0,
    transformer_dec_positional_dropout_rate=0.0, transformer_dec_attn_dropout_rate=0.0,
)


def perturb_(module: torch.nn.Module, seed: int, scale: float = 0.1) -> torch.nn.Module:
    """Add seeded noise to every parameter, so that zero-initialised ones
    (flow projections, affine flows, norms) take part in the comparison."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=g, dtype=p.dtype))
    return module


def aasvc_pair(seed: int = 0, port_kw=None, **over):
    """(port AASVC, JAX AASVC, flax params), weights from the port's init
    carried to flax by the JAX package's converter."""
    cfg = dict(TINY_AASVC, **over)
    torch.manual_seed(seed)
    port = perturb_(AASVC(**cfg, **(port_kw or {})).eval(), seed)
    jax_model = JaxAASVC(**cfg, alignment_dist_form="direct")
    flax = convert_aasvc(port.state_dict(), jax_model)
    return port, jax_model, flax


def carried_back(flax, port: torch.nn.Module) -> None:
    """Load ``flax`` into ``port`` through the port's own converter."""
    port.load_state_dict(aasvc_state_dict(flax, port))


def assert_state_dicts_equal(a, b) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def np_inputs(rng: np.random.Generator, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def vtn_pair(seed: int = 0, port_kw=None, **over):
    """(port VTN, JAX VTN, flax params), weights from the port's init
    carried to flax by the JAX package's converter."""
    cfg = dict(TINY_VTN, **over)
    torch.manual_seed(seed)
    port = perturb_(VTN(**cfg, **(port_kw or {})).eval(), seed)
    jax_model = JaxVTN(**cfg)
    return port, jax_model, convert_vtn(port.state_dict(), jax_model)


def tts_pair(seed: int = 0, **over):
    """(port TransformerTTS, JAX TransformerTTS, flax params), weights from
    the port's init carried to flax by the JAX package's converter."""
    cfg = dict(TINY_TTS, **over)
    torch.manual_seed(seed)
    port = perturb_(TransformerTTS(**cfg).eval(), seed)
    jax_model = JaxTransformerTTS(**cfg)
    return port, jax_model, convert_transformer_tts(port.state_dict(), jax_model)
