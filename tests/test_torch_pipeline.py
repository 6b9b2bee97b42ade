"""Port: wav->wav serving path (seq2seq_vc_torch/pipeline.py, dsp/, vocoder/).

At the tiny sizes of tests/test_pipeline.py (AAS-VC adim 32 with a
stochastic duration predictor, HiFi-GAN with 32 upsample channels), weights
built in the port from a seed are carried to the JAX package by its
converters and back by the port's, and the same numpy audio goes through
both. The duration predictor's noise scale is 0 on both sides and both
vocoders compute in float32, so the comparison is of the algorithm.

Tolerances, float32: log-mel atol 1e-4 (log10 of an FFT, summed in another
order); generator and chunked synthesis atol 1e-5 on a tanh waveform;
whole conversions atol 1e-4 with exactly equal lengths (the model's float32
reordering carried through the vocoder).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (release_jax_executables: autouse fixture)
    aasvc_pair,
    assert_state_dicts_equal,
    release_jax_executables,
)
from seq2seq_vc_tpu.dsp.features import _logmel as jax_logmel
from seq2seq_vc_tpu.dsp.mel import mel_filterbank as jax_mel_filterbank
from seq2seq_vc_tpu.dsp.stft import hann_window as jax_hann_window
from seq2seq_vc_tpu.pipeline import Wav2WavConverter as JaxWav2Wav
from seq2seq_vc_tpu.vocoder.convert_torch import torch_hifigan_to_flax
from seq2seq_vc_tpu.vocoder.hifigan import HifiganGenerator as JaxHifigan
from seq2seq_vc_tpu.vocoder.hifigan import chunked_generate as jax_chunked_generate
from seq2seq_vc_torch.convert import hifigan_state_dict
from seq2seq_vc_torch.dsp.features import _logmel
from seq2seq_vc_torch.dsp.mel import mel_filterbank
from seq2seq_vc_torch.dsp.stft import hann_window
from seq2seq_vc_torch.pipeline import Wav2WavConverter, _synth_ladder
from seq2seq_vc_torch.vocoder.hifigan import HifiganGenerator, chunked_generate

SR = 16000
CONFIG = {"sampling_rate": SR, "fft_size": 1024, "hop_size": 256,
          "num_mels": 80, "fmin": 80, "fmax": 7600}
VOC = dict(in_channels=80, upsample_channels=32, upsample_kernel_sizes=(16, 16, 4, 4),
           upsample_factors=(8, 8, 2, 2), resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))


def _audio(seconds, f0, seed):
    t = np.arange(int(SR * seconds)) / SR
    noise = np.random.default_rng(seed).standard_normal(t.shape)
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * noise).astype(np.float32)


def _stats(seed):
    rng = np.random.default_rng(seed)
    return {"mean": (-5 + rng.standard_normal(80)).astype(np.float32),
            "scale": (1 + 0.5 * rng.random(80)).astype(np.float32)}


@pytest.fixture(scope="module")
def vocoders():
    """(port generator, JAX generator, flax params), float32 both."""
    torch.manual_seed(0)
    port = HifiganGenerator(**VOC, compute_dtype=torch.float32).eval()
    jax_voc = JaxHifigan(**VOC, dtype=jnp.float32)
    template = jax_voc.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    flax = torch_hifigan_to_flax(sd, jax.tree_util.tree_map(np.asarray, template), num_kernels=1)
    return port, jax_voc, flax


@pytest.fixture(scope="module")
def converters(vocoders):
    port_voc, jax_voc, voc_flax = vocoders
    port, jax_model, flax = aasvc_pair(
        seed=3, post_encoder_reduction_factor=2, postnet_layers=0,
        duration_predictor_use_encoder_outputs=True,
    )
    src, trg = _stats(1), _stats(2)
    jax_conv = JaxWav2Wav(jax_model, flax, jax_voc, voc_flax, src, trg, CONFIG, bucket_frames=32)
    port_conv = Wav2WavConverter(port, port_voc, src, trg, CONFIG, bucket_frames=32, device="cpu")
    return port_conv, jax_conv


def test_logmel_matches_jax():
    pad = 512
    x = np.pad(_audio(0.5, 220, 0), (pad, pad), mode="reflect")
    window = jax_hann_window(1024)
    mel_t = jax_mel_filterbank(SR, 1024, 80, 80, 7600).T
    np.testing.assert_array_equal(hann_window(1024), window)
    np.testing.assert_array_equal(mel_filterbank(SR, 1024, 80, 80, 7600).T, mel_t)
    ref = np.asarray(jax_logmel(jnp.asarray(x), window, mel_t, 1024, 256, 10.0))
    got = _logmel(torch.from_numpy(x), torch.from_numpy(window), torch.from_numpy(mel_t),
                  1024, 256, 10.0)
    assert got.shape == ref.shape == (1 + (len(x) - 1024) // 256, 80)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_hifigan_weights_round_trip_and_match_jax(vocoders):
    port, jax_voc, flax = vocoders
    assert_state_dicts_equal(hifigan_state_dict(flax, port), port.state_dict())
    mel = np.random.default_rng(0).standard_normal((2, 24, 80)).astype(np.float32)
    ref = np.asarray(jax_voc.apply(flax, jnp.asarray(mel)))
    with torch.no_grad():
        got = port(torch.from_numpy(mel))
    assert got.shape == (2, 24 * 256) and ref.shape[:2] == (2, 24 * 256)
    np.testing.assert_allclose(got.numpy(), ref.reshape(got.shape), atol=1e-5)


def test_chunked_generate_matches_jax(vocoders):
    port, jax_voc, flax = vocoders
    mel = np.random.default_rng(1).standard_normal((200, 80)).astype(np.float32)
    ref = np.asarray(jax_chunked_generate(jax_voc, flax, jnp.asarray(mel)))
    with torch.no_grad():
        got = chunked_generate(port, torch.from_numpy(mel))
    assert got.shape == ref.shape == (200 * 256,)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_call_matches_jax_converter(converters):
    port_conv, jax_conv = converters
    audio = _audio(1.0, 220, 4)
    ref = jax_conv(audio)
    got = port_conv(audio)
    assert port_conv.last_out_frames == jax_conv.last_out_frames
    assert port_conv.last_synth_cap == jax_conv.last_synth_cap
    assert got.shape == ref.shape and len(got) % 256 == 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_convert_batch_matches_jax_converter(converters):
    port_conv, jax_conv = converters
    audios = [_audio(s, f, 5 + i) for i, (s, f) in enumerate([(0.5, 220), (0.33, 330), (0.45, 440)])]
    ref = jax_conv.convert_batch(audios)
    got = port_conv.convert_batch(audios)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.shape == r.shape and len(g) % 256 == 0
        np.testing.assert_allclose(g, r, atol=1e-4)
    assert port_conv.warmup_synth() == jax_conv.warmup_synth()


@pytest.mark.parametrize("speculate", [True, False])
def test_streamed_vocoder_equals_the_serial_path(vocoders, speculate):
    """The VTN's ``Wav2WavARConverter``: the streamed vocoder (the default)
    gives the serial path's waveform on every sample within each item's
    valid length, with the kept speculation supplying it. Three sources of
    different lengths stop at their own budgets over several geometric
    chunks (threshold 1.1 never stops early). Both paths synthesise the
    same windows; the streamed path runs every item's windows in one
    vocoder call, and oneDNN's convolutions sum the same products in an
    order that depends on the batch (seen: up to 4 float32 ulps), so the
    waveforms agree to atol 1e-6 (a tanh output, |x| <= 1)."""
    from _torch_port import vtn_pair
    from seq2seq_vc_torch.pipeline import Wav2WavARConverter

    port_voc = vocoders[0]
    port, _, _ = vtn_pair(seed=4)
    config = dict(CONFIG, inference={"threshold": 1.1, "maxlenratio": 6.0,
                                     "decode_chunk_steps": 4, "decode_max_chunk_steps": 8,
                                     "decode_est_len_ratio": 0.0})
    conv = Wav2WavARConverter(port, port_voc, _stats(1), _stats(2), config, device="cpu")
    conv.ar_decode.speculate = speculate
    audios = [_audio(s, f, 9 + i) for i, (s, f) in enumerate([(0.7, 220), (0.42, 330),
                                                               (0.55, 440)])]
    serial = conv.convert_batch(audios, stream_vocoder=False)
    assert not conv.last_stream_kept
    synth, prefixes = conv._stream_synth, []
    conv._stream_synth = lambda outs, st: prefixes.append(len(outs)) or synth(outs, st)
    streamed = conv.convert_batch(audios)
    assert conv.last_stream_kept
    assert len(prefixes) > 2  # several chunks, so several speculations
    # the streamed ladder: the budget's synthesis ladder at each batch size
    ladder = _synth_ladder(conv.last_stream_budget, conv.bucket_frames)
    assert conv.warmup_stream([1, 3]) == 2 * len(ladder)
    for s, w in zip(streamed, serial):
        assert s.shape == w.shape and len(s) % 256 == 0 and np.isfinite(s).all()
        np.testing.assert_allclose(s, w, atol=1e-6, rtol=0)
