"""Port: AAS-VC non-autoregressive inference (seq2seq_vc_torch/models/aas_vc.py).

A tiny AAS-VC with the flagship's structure (idim 80, adim 32, 2 heads, 1+1
conformer layers, post-encoder reduction 4, stochastic duration predictor
with 2 flows, postnet 2 x 16, conv kernel 7, the conv2d duration-predictor
projection) is built in the port from a seed, its weights carried to the
JAX package by its converter and back by the port's. The stochastic
predictor's noise scale is 0 on both sides, so it draws no noise;
``test_duration_predictor_with_given_noise`` feeds both the same noise.

Durations are ``ceil(exp(logw))``, so ``d_outs`` must match exactly; the
tests assert that no ``exp(logw)`` lies within 1e-4 of an integer, so a
rounding flip cannot make them flaky. ``outs`` are compared over each
item's ``out_lens`` in float32 at atol 1e-4 and rtol 1e-4: two conformer
stacks, the flows and the postnet compound the reordering of float32 sums.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (release_jax_executables: autouse fixture)
    aasvc_pair,
    assert_state_dicts_equal,
    carried_back,
    release_jax_executables,
)
from seq2seq_vc_tpu.models import AASVC as JaxAASVC
from seq2seq_vc_tpu.models.common import conv2d_subsampled_lengths as jax_subsampled_lengths
from seq2seq_vc_torch.convert import aasvc_state_dict
from seq2seq_vc_torch.models.aas_vc import AASVC
from seq2seq_vc_torch.models.common import conv2d_subsampled_lengths
from seq2seq_vc_torch.nn.transformer import Conv2dSubsampling
from seq2seq_vc_torch.ops.masks import make_non_pad_mask

TOL = dict(atol=1e-4, rtol=1e-4)
B, T = 2, 48
LENS = np.array([48, 36])
MAX_OUT = 64


def _src(seed=0):
    return np.random.default_rng(seed).standard_normal((B, T, 80)).astype(np.float32)


def _log_durations(port, x, noise=None, noise_scale=0.0):
    """The port's log-durations for source ``x``: the first half of
    ``AASVC.inference``."""
    xt = torch.from_numpy(x)
    with torch.no_grad():
        hs, ilens = port._encode(xt, torch.from_numpy(LENS))
        dp_in = port._dp_features(hs, xt)
        mask = make_non_pad_mask(ilens, hs.shape[1])
        logw = port.duration_predictor.log_durations(dp_in, mask, noise_scale, noise)
    return logw[mask].numpy(), dp_in, mask


def _assert_off_integers(logw):
    w = np.exp(logw.astype(np.float64))
    assert np.abs(w - np.round(w)).min() > 1e-4, "a duration sits on a rounding edge"


def test_weights_round_trip_exactly():
    port, jax_model, flax = aasvc_pair(seed=0)
    back = aasvc_state_dict(flax, port)
    assert_state_dicts_equal(back, port.state_dict())
    # every flax leaf the JAX model declares is filled
    shapes = jax.eval_shape(
        lambda: jax_model.init(
            {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
            _src(), LENS, _src(), LENS, _src(), LENS, deterministic=True,
        )
    )
    flat_ref = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(flax["params"])[0])
    assert len(flat_ref) == len(flat_got)
    for path, leaf in flat_ref:
        assert flat_got[path].shape == leaf.shape, path


def test_converter_fails_loudly_on_leftover_and_missing_keys():
    port, _, flax = aasvc_pair(seed=0)
    extra = {"params": dict(flax["params"], stray={"kernel": np.zeros(3)})}
    with pytest.raises(ValueError, match="stray"):
        aasvc_state_dict(extra, port)
    missing = {"params": {k: v for k, v in flax["params"].items() if k != "feat_out"}}
    with pytest.raises(KeyError, match="feat_out"):
        aasvc_state_dict(missing, port)


@pytest.mark.parametrize("backend", ["xla", "fused", "flash"])
def test_inference_matches_jax(backend):
    # flash gate 40: the encoder (12 stacked frames) takes the fused path,
    # the decoder (64 frames) the flash path
    port, jax_model, flax = aasvc_pair(
        seed=0, port_kw=dict(attention_backend=backend, flash_min_len=40)
    )
    carried_back(flax, port)
    x = _src()
    _assert_off_integers(_log_durations(port, x)[0])

    ref = jax_model.apply(
        flax, x, LENS, x, max_output_frames=MAX_OUT, method=JaxAASVC.inference,
        rngs={"noise": jax.random.PRNGKey(0)},
    )
    xt = torch.from_numpy(x)
    got = port.inference(xt, torch.from_numpy(LENS), xt, max_output_frames=MAX_OUT)

    np.testing.assert_array_equal(got["d_outs"].numpy(), np.asarray(ref["d_outs"]))
    np.testing.assert_array_equal(got["out_lens"].numpy(), np.asarray(ref["out_lens"]))
    np.testing.assert_array_equal(got["d_lens"].numpy(), np.asarray(ref["d_lens"]))
    assert got["outs"].shape == ref["outs"].shape
    for b, n in enumerate(np.asarray(ref["out_lens"])):
        np.testing.assert_allclose(got["outs"][b, :n].numpy(), np.asarray(ref["outs"])[b, :n], **TOL)


def test_duration_predictor_with_given_noise():
    port, jax_model, flax = aasvc_pair(seed=1)
    x = _src(seed=1)
    noise = np.random.default_rng(5).standard_normal((B, T // 4, 2)).astype(np.float32)
    logw, dp_in, mask = _log_durations(port, x, torch.from_numpy(noise), noise_scale=0.8)
    _assert_off_integers(logw)

    with torch.no_grad():
        got = port.duration_predictor(dp_in, mask, noise_scale=0.8, noise=torch.from_numpy(noise))
    ref = jax_model.apply(
        flax, dp_in.numpy(), mask.numpy(), noise,
        method=lambda m, x_, mk, z: m.duration_predictor(
            x_, mk, inverse=True, noise_scale=0.8, noise=z
        ),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy()[mask.numpy()] >= 1).all()


def test_debug_alignment_branch_matches_jax():
    port, jax_model, flax = aasvc_pair(seed=2)
    x, y = _src(seed=2), _src(seed=3)
    ylens = np.array([48, 40])
    ref = jax_model.apply(
        flax, x, LENS, x, max_output_frames=MAX_OUT, tgt_speech=y,
        tgt_speech_lengths=ylens, method=JaxAASVC.inference,
        rngs={"noise": jax.random.PRNGKey(0)},
    )
    xt = torch.from_numpy(x)
    got = port.inference(
        xt, torch.from_numpy(LENS), xt, max_output_frames=MAX_OUT,
        tgt_speech=torch.from_numpy(y), tgt_speech_lengths=torch.from_numpy(ylens),
    )
    np.testing.assert_array_equal(got["ds"].numpy(), np.asarray(ref["ds"]))
    lp_ref = np.asarray(ref["log_p_attn"])
    finite = np.isfinite(lp_ref)
    np.testing.assert_array_equal(np.isfinite(got["log_p_attn"].numpy()), finite)
    np.testing.assert_allclose(got["log_p_attn"].numpy()[finite], lp_ref[finite], **TOL)


def test_unported_options_raise():
    # the diffusion decoders are ROADMAP.md queue 1 item 5
    with pytest.raises(NotImplementedError, match="item 5"):
        AASVC(idim=80, odim=80, adim=32, aheads=2, decoder_type="diffsinger",
              duration_predictor_type="stochastic")


def test_conv2d_subsampled_lengths_match_jax_and_the_layer():
    lens = np.arange(7, 60)
    got = conv2d_subsampled_lengths(torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_subsampled_lengths(lens)))
    layer = Conv2dSubsampling(16, 8)
    for t in (7, 8, 33):
        out, _ = layer(torch.zeros(1, t, 16))
        assert out.shape[1] == conv2d_subsampled_lengths(torch.tensor(t)).item()
