"""Port: ``bin/convert_checkpoint.py`` against the JAX package's CLI of the
same name.

A reference-format checkpoint (``{"model": state_dict, "steps",
"epochs"}`` pickled by ``torch.save``; BatchNorm statistics and counters
included) is written from a port model built from a seed, with the
running statistics drawn too. It goes through the JAX CLI (flax variables
with ``batch_stats``, msgpack) and through the port's CLI (a port
checkpoint); the port's ``vc_decode`` of the converted checkpoint must
give the features that the JAX model gives on its own conversion, to the
AR decode tolerance of tests/test_torch_cli.py (atol 1e-4), and the NAR
model's inference the same. Both CLIs refuse BatchNorm statistics that the
config's group norm cannot hold, with the same instruction.
"""

import sys
from pathlib import Path

import flax
import jax
import numpy as np
import pytest
import torch
import yaml

from _torch_port import perturb_, release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.bin import convert_checkpoint as jax_cli
from seq2seq_vc_tpu.models import AASVC as JaxAASVC
from seq2seq_vc_tpu.models import VTN as JaxVTN
from seq2seq_vc_tpu.models import ar_driver as jax_ar_driver
from seq2seq_vc_torch.bin import convert_checkpoint, vc_decode
from seq2seq_vc_torch.core.config import load_config
from seq2seq_vc_torch.models import get_model_class
from seq2seq_vc_torch.nn.conformer import ConvBatchNorm

REPO = Path(__file__).resolve().parents[1]
VTN_CONF = REPO / "egs/arctic/vc1/conf/vtn.v1.yaml"
AAS_CONF = REPO / "egs/synth/vc1/conf/aas_vc.synth.yaml"
AR_TOL = dict(atol=1e-4, rtol=0)
TOL = dict(atol=1e-4, rtol=1e-4)
# vtn.v1.yaml at toy widths with the options a reference checkpoint may
# carry: a conformer encoder (new-style rel-pos, batch-norm conv module,
# conv1d positionwise layers of 3 taps, concat_after) and the batch-norm
# postnet; the prenet's dropout 0 (its bits differ across frameworks)
VTN_OPTIONS = dict(adim=32, aheads=2, elayers=2, eunits=64, dlayers=2, dunits=64,
                   dprenet_units=24, postnet_layers=2, postnet_chans=16,
                   dprenet_dropout_rate=0.0, encoder_type="conformer",
                   conformer_rel_pos_type="latest", conformer_conv_norm_type="batch_norm",
                   conformer_enc_kernel_size=5, positionwise_layer_type="conv1d",
                   positionwise_conv_kernel_size=3, encoder_concat_after=True,
                   postnet_norm_type="batch_norm")
AAS_OPTIONS = dict(compute_dtype="float32", stochastic_duration_predictor_noise_scale=0.0,
                   conformer_conv_norm_type="batch_norm", postnet_norm_type="batch_norm",
                   adim=32, aheads=2, elayers=1, eunits=64, dlayers=1, dunits=64,
                   postnet_chans=16, duration_predictor_type="deterministic")
LENS = (37, 52, 44)


def _config(path: Path, **model_params):
    config = load_config(str(path))
    config["model_params"] = dict(config["model_params"], **model_params)
    return config


def _reference(tmp_path: Path, config, seed: int, bare: bool = False) -> str:
    """A reference checkpoint of the config's model (seeded weights and
    running statistics, counters set) and its config.yml; returns the
    checkpoint's path."""
    torch.manual_seed(seed)
    model = perturb_(get_model_class(config["model_type"])(**config["model_params"]), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvBatchNorm):
                m.running_mean.copy_(0.3 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
                m.num_batches_tracked.fill_(1234)
    sd = model.state_dict()
    (tmp_path / "config.yml").write_text(yaml.safe_dump(config))
    path = tmp_path / "checkpoint-7steps.pkl"
    torch.save(sd if bare else {"model": sd, "steps": 7, "epochs": 2, "config": config}, path)
    return str(path)


def _jax_convert(monkeypatch, ckpt: str, conf: str, out: str):
    """The JAX CLI, in-process; returns its flax variables (raw tree)."""
    monkeypatch.setenv("S2S_JAX_CACHE_DIR", "")
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint", "--torch-checkpoint", ckpt,
                                      "--config", conf, "--outpath", out])
    jax_cli.main()
    with open(out, "rb") as f:
        state = flax.serialization.msgpack_restore(f.read())
    return state, flax.serialization.msgpack_restore(state["model"])


def _port_convert(ckpt: str, conf: str, out: str):
    convert_checkpoint.main(["--torch-checkpoint", ckpt, "--config", conf, "--outpath", out])
    return torch.load(out, map_location="cpu", weights_only=True)


def _write_feats(root: Path, lens, seed: int) -> str:
    rng = np.random.default_rng(seed)
    lines = []
    for i, n in enumerate(lens):
        path = root / f"src_{i}.npy"
        np.save(path, (-4 + rng.standard_normal((n, 80))).astype(np.float32))
        lines.append(f"utt{i} {path}")
    (root / "src.scp").write_text("\n".join(lines) + "\n")
    return str(root / "src.scp")


def _scp_arrays(scp: str):
    return {line.split()[0]: np.load(line.split()[1]) for line in open(scp).read().splitlines()}


def test_vtn_reference_checkpoint_decodes_as_the_jax_conversion(tmp_path, monkeypatch):
    config = _config(VTN_CONF, **VTN_OPTIONS)
    config["inference"] = dict(config["inference"], threshold=1.1, maxlenratio=1.0)
    ckpt = _reference(tmp_path, config, seed=1)
    conf = str(tmp_path / "config.yml")
    state, variables = _jax_convert(monkeypatch, ckpt, conf, str(tmp_path / "jax.ckpt"))
    assert (int(state["steps"]), int(state["epochs"])) == (7, 2)
    assert set(variables) == {"params", "batch_stats"}
    port = _port_convert(ckpt, conf, str(tmp_path / "checkpoint-7steps.pt"))
    assert (port["steps"], port["epochs"]) == (7, 2)
    counters = [v for k, v in port["model"].items() if k.endswith("num_batches_tracked")]
    assert counters and all(int(c) == 0 for c in counters)  # the JAX converter drops them

    feats = _write_feats(tmp_path, LENS, seed=2)
    out = tmp_path / "out"
    vc_decode.main(["--dumpdir", feats, "--checkpoint", str(tmp_path / "checkpoint-7steps.pt"),
                    "--outdir", str(out), "--batch-size", "1", "--device", "cpu"])
    got = _scp_arrays(str(out / "feats.scp"))
    src = _scp_arrays(feats)
    inf = config["inference"]
    drv = jax_ar_driver.ChunkedARDecoder(JaxVTN(**config["model_params"]), JaxVTN,
                                         threshold=inf["threshold"], maxlenratio=inf["maxlenratio"])
    for i, n_src in enumerate(LENS):
        x = np.zeros((1, -(-n_src // vc_decode.BUCKET_FRAMES) * vc_decode.BUCKET_FRAMES, 80),
                     np.float32)
        x[0, :n_src] = src[f"utt{i}"]
        ref = drv(variables, x, np.array([n_src]), jax.random.PRNGKey(0),
                  est_steps=int(np.ceil(1.2 * n_src / 4)))
        n = int(ref["out_lens"][0])
        assert got[f"utt{i}"].shape == (n, 80)
        np.testing.assert_allclose(got[f"utt{i}"], np.asarray(ref["outs"])[0, :n], **AR_TOL)


def test_aasvc_reference_checkpoint_infers_as_the_jax_conversion(tmp_path, monkeypatch):
    config = _config(AAS_CONF, **AAS_OPTIONS)
    ckpt = _reference(tmp_path, config, seed=3, bare=True)  # a bare state dict
    conf = str(tmp_path / "config.yml")
    _, variables = _jax_convert(monkeypatch, ckpt, conf, str(tmp_path / "jax.ckpt"))
    assert {"postnet", "encoder", "decoder"} <= set(variables["batch_stats"])
    port = _port_convert(ckpt, conf, str(tmp_path / "port.pt"))
    assert (port["steps"], port["epochs"]) == (0, 0)
    model = vc_decode.load_model(config, str(tmp_path / "port.pt"), torch.device("cpu"))
    x = (-4 + np.random.default_rng(4).standard_normal((2, 64, 80))).astype(np.float32)
    ilens = np.array([64, 50])
    jax_model = JaxAASVC(**config["model_params"])
    want = jax.jit(lambda v, a, n: jax_model.apply(v, a, n, a, max_output_frames=128,
                                                   method=JaxAASVC.inference))(variables, x, ilens)
    got = model.inference(torch.from_numpy(x), torch.from_numpy(ilens), torch.from_numpy(x),
                          max_output_frames=128)
    np.testing.assert_array_equal(got["out_lens"].numpy(), np.asarray(want["out_lens"]))
    for b, n in enumerate(got["out_lens"].numpy()):
        np.testing.assert_allclose(got["outs"][b, :n].numpy(), np.asarray(want["outs"])[b, :n],
                                   **TOL)


@pytest.mark.parametrize("norm", ["postnet_norm_type", "conformer_conv_norm_type"])
def test_both_clis_refuse_statistics_that_group_norm_cannot_hold(tmp_path, monkeypatch, norm):
    ckpt = _reference(tmp_path, _config(AAS_CONF, **AAS_OPTIONS), seed=5)
    config = _config(AAS_CONF, **dict(AAS_OPTIONS, **{norm: "group_norm"}))
    (tmp_path / "config.yml").write_text(yaml.safe_dump(config))
    conf = str(tmp_path / "config.yml")
    want = f"set {norm}='batch_norm'"
    with pytest.raises(ValueError, match=want):
        _jax_convert(monkeypatch, ckpt, conf, str(tmp_path / "jax.ckpt"))
    with pytest.raises(ValueError, match=want):
        _port_convert(ckpt, conf, str(tmp_path / "port.pt"))


def test_names_load_strictly_with_the_jax_converters_mappings(tmp_path):
    config = _config(AAS_CONF, **AAS_OPTIONS)
    ckpt = _reference(tmp_path, config, seed=6, bare=True)
    conf = str(tmp_path / "config.yml")
    sd = torch.load(ckpt, weights_only=True)
    # the reference's duration-predictor projection may name its Linear out.0
    renamed = {k.replace("duration_predictor_projection.out.", "duration_predictor_projection"
                         ".out.0."): v for k, v in sd.items()}
    assert renamed.keys() != sd.keys()
    torch.save(renamed, ckpt)
    got = _port_convert(ckpt, conf, str(tmp_path / "port.pt"))["model"]
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    for bad in ({k: v for k, v in sd.items() if k != "feat_out.bias"},
                dict(sd, **{"extra.weight": torch.zeros(2)})):
        torch.save(bad, ckpt)
        with pytest.raises(ValueError, match="does not match"):
            _port_convert(ckpt, conf, str(tmp_path / "port.pt"))
