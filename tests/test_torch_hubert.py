"""Port: the HuBERT-soft encoder (seq2seq_vc_torch/urhythmic/hubert.py), the
``urhythmic.cli encode`` batches and ``preprocess``'s ``hubert`` feature,
against the JAX package on the CPU, at hubert-base widths (95 M
parameters) with seeded random weights.

One module-scoped pair serves every case: the port's ``HubertSoft``
(seeded, its norms perturbed) and the flax params that the JAX package's
``convert_torch_hubert`` makes of its ``state_dict``. Both run float32.

- Units and log-probs agree to 2e-4 absolute (rtol 1e-3), the tolerance
  at which tests/test_hubert.py holds the JAX encoder against HF's
  (float32 sums in another order through 12 layers).
- The masked bucket forward (tail-padded, ``lengths``) equals the
  exact-length one on the valid prefix to 2e-5 (rtol 1e-4), as
  tests/test_hubert.py holds the JAX one.
- ``convert.hubert_soft_state_dict`` of the flax params gives the port's
  ``state_dict`` back bit for bit; ``load_hubert_soft`` of an HF
  ``HubertModel`` file gives the weights that JAX's converter gives of it
  (1e-6: the positional conv's weight norm is folded on each side), and
  the port's encoder and layer tap agree with HF's to 2e-4.
- ``preprocess``'s ``hubert`` features (``layer: 6`` and ``feature:
  units``) agree with the JAX CLI's to 2e-4.
"""

import sys

import numpy as np
import pytest
import torch
import yaml

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.bin import preprocess as jax_preprocess
from seq2seq_vc_tpu.urhythmic.hubert import HubertSoft as JaxHubertSoft
from seq2seq_vc_tpu.urhythmic.hubert import convert_torch_hubert
from seq2seq_vc_tpu.utils.io import read_hdf5
from seq2seq_vc_torch.bin import preprocess
from seq2seq_vc_torch.convert import hubert_soft_state_dict
from seq2seq_vc_torch.urhythmic import cli
from seq2seq_vc_torch.urhythmic.hubert import (HubertSoft, conv_stack_frames, encode_batch,
                                               load_hubert_soft)
from seq2seq_vc_torch.utils.audio import read_wav, write_wav

ATOL, RTOL = 2e-4, 1e-3  # port vs JAX, float32
MASK_ATOL, MASK_RTOL = 2e-5, 1e-4  # masked bucket vs exact length, one side


def _wav(n, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(port HubertSoft, flax params of its state_dict, its checkpoint file)."""
    torch.manual_seed(0)
    port = HubertSoft().eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    path = tmp_path_factory.mktemp("hubert") / "hubert_soft.pt"
    torch.save({"hubert": {f"module.{k}": v for k, v in port.state_dict().items()}}, path)
    return port, convert_torch_hubert(port.state_dict()), str(path)


def test_units_and_log_probs_match_jax(pair):
    port, params, _ = pair
    wav = _wav(4000, 0)[None]
    want_u, want_lp = (np.asarray(t) for t in JaxHubertSoft().apply(params, wav))
    with torch.no_grad():
        got_u, got_lp = (t.numpy() for t in port(torch.from_numpy(wav)))
    assert got_u.shape == want_u.shape == (1, conv_stack_frames(4080), 256)
    np.testing.assert_allclose(got_u, want_u, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_lp, want_lp, atol=ATOL, rtol=RTOL)
    # the masked bucket forward: a 6400-sample bucket, and a batch of two
    # rows of other lengths
    units, log_probs, n = encode_batch(port, np.stack([wav[0], np.zeros(4000, np.float32)]),
                                       bucket_samples=6400, lengths=[4000, 2500])
    assert n.tolist() == [conv_stack_frames(4080), conv_stack_frames(2580)]
    np.testing.assert_allclose(units[0, : n[0]].numpy(), got_u[0], atol=MASK_ATOL, rtol=MASK_RTOL)
    np.testing.assert_allclose(log_probs[0, : n[0]].numpy(), got_lp[0], atol=MASK_ATOL,
                               rtol=MASK_RTOL)
    with torch.no_grad():
        short = port.units(torch.zeros(1, 2500))[0].numpy()
    np.testing.assert_allclose(units[1, : n[1]].numpy(), short, atol=MASK_ATOL, rtol=MASK_RTOL)
    # the unmasked padded forward differs: the mask is what keeps it exact
    with torch.no_grad():
        unmasked = port.units(torch.from_numpy(np.pad(wav, ((0, 0), (0, 2400)))))[0]
    assert np.abs(unmasked[: n[0]].numpy() - got_u[0]).max() > 1e-3


def test_state_dict_carried_from_jax(pair):
    port, params, path = pair
    fresh = HubertSoft()
    fresh.load_state_dict(hubert_soft_state_dict(params, fresh))
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # the bshall file (a "hubert" entry, "module." prefixes) loads as it is
    loaded = load_hubert_soft(path, device="cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_loader_reads_hf_naming():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(2)
    hf = transformers.HubertModel(transformers.HubertConfig()).eval()
    sd = dict(hf.state_dict())
    g = torch.Generator().manual_seed(3)
    sd["proj.weight"] = 0.02 * torch.randn(256, 768, generator=g)
    sd["proj.bias"] = 0.1 * torch.randn(256, generator=g)
    sd["label_embedding.weight"] = torch.randn(100, 256, generator=g)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(sd, f"{tmp}/hf.pt")
        port = load_hubert_soft(f"{tmp}/hf.pt", device="cpu")
    want = hubert_soft_state_dict(convert_torch_hubert(sd), HubertSoft())
    for k, v in want.items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=0, atol=1e-6, msg=k)
    wav = torch.from_numpy(_wav(4000, 4)[None])
    with torch.no_grad():
        hs = hf(wav, output_hidden_states=True).hidden_states
        np.testing.assert_allclose(port.encode(wav).numpy(), hs[-1].numpy(), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(port.encode(wav, 3).numpy(), hs[3].numpy(), atol=ATOL,
                                   rtol=RTOL)
    # an HF base model has no soft head: it loads zero-filled, as in JAX
    base = {k: v for k, v in sd.items() if not k.startswith(("proj.", "label_embedding."))}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(base, f"{tmp}/base.pt")
        zero = load_hubert_soft(f"{tmp}/base.pt", device="cpu")
    assert not zero.proj.weight.any() and not zero.label_embedding.weight.any()


def test_encode_cli_batches_write_exact_length_units(pair, tmp_path):
    """``urhythmic.cli encode`` batches same-bucket utterances (two share a
    1 s bucket, one is longer) and writes each row's exact-length units."""
    port, _, path = pair
    lens = [4000, 4480, 17000]
    for i, n in enumerate(lens):
        write_wav(str(tmp_path / f"u{i}.wav"), _wav(n, 10 + i), 16000)
    cli.main(["encode", "--in-dir", str(tmp_path), "--out-dir", str(tmp_path / "enc"),
              "--hubert-checkpoint", path, "--batch-size", "2", "--device", "cpu"])
    for i in range(len(lens)):
        wav, _ = read_wav(str(tmp_path / f"u{i}.wav"))
        with torch.no_grad():
            u, lp = (t[0].numpy() for t in port(torch.from_numpy(wav[None])))
        got_u = np.load(tmp_path / "enc" / "soft" / f"u{i}.npy")
        got_lp = np.load(tmp_path / "enc" / "logprobs" / f"u{i}.npy")
        assert got_u.shape == u.shape and got_lp.shape == lp.shape
        np.testing.assert_allclose(got_u, u, atol=MASK_ATOL, rtol=MASK_RTOL)
        np.testing.assert_allclose(got_lp, lp, atol=MASK_ATOL, rtol=MASK_RTOL)


@pytest.mark.parametrize("hubert", [{"layer": 6}, {"feature": "units"}],
                         ids=["layer6", "units"])
def test_preprocess_hubert_matches_jax(pair, tmp_path, hubert):
    _, _, path = pair
    sr = 16000
    t = np.arange(sr // 2) / sr
    write_wav(str(tmp_path / "utt1.wav"), (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32),
              sr)
    (tmp_path / "wav.scp").write_text(f"utt1 {tmp_path}/utt1.wav\n")
    conf = {"sampling_rate": sr, "fft_size": 1024, "hop_size": 256, "win_length": None,
            "window": "hann", "num_mels": 80, "fmin": 80, "fmax": 7600,
            "global_gain_scale": 1.0, "trim_silence": False, "format": "hdf5",
            "feat_list": {"mel": {}, "hubert": dict(hubert, checkpoint=path)}}
    (tmp_path / "conf.yaml").write_text(yaml.safe_dump(conf))
    (tmp_path / "npy.yaml").write_text(yaml.safe_dump(dict(conf, format="npy")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("S2S_JAX_CACHE_DIR", "")  # no persistent compilation cache
        mp.setattr(sys, "argv", ["preprocess", "--wav-scp", str(tmp_path / "wav.scp"),
                                 "--dumpdir", str(tmp_path / "jax"),
                                 "--config", str(tmp_path / "conf.yaml")])
        jax_preprocess.main()
    preprocess.main(["--wav-scp", str(tmp_path / "wav.scp"), "--dumpdir", str(tmp_path / "port"),
                     "--config", str(tmp_path / "npy.yaml"), "--device", "cpu"])
    want = read_hdf5(str(tmp_path / "jax" / "utt1.h5"), "hubert")
    got = np.load(tmp_path / "port" / "hubert" / "utt1.npy")
    assert got.shape == want.shape
    assert got.shape[1] == (256 if "feature" in hubert else 768)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
