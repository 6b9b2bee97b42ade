"""Port: data parallelism (seq2seq_vc_torch/parallel/) on the CPU, two
``gloo`` ranks launched by ``torchrun`` (tests/_torch_ddp_worker.py).

``vc_train`` of the tiny AAS-VC takes one step on a global batch of 3
utterances of unequal lengths: the 2 ranks pad it to 4 rows by wrap-around
(as the JAX package's ``shard_batch`` does) and hold 2 rows each, with
different valid frame counts. Its logged loss terms and the checkpoint's
parameters must equal the port's single-process step on the same padded
global batch and the JAX trainer's step on it: every loss is normalised by
its count over the global batch. Dropout is off and the duration loss
waits (``dp_train_start_steps``), so that no draw differs between a rank
and a run of one. Then ``vc_decode --data-parallel 2`` must write the
files of ``--data-parallel 1`` (its duration noise on: the ranks take their
rows of the whole batch's draw), and the ``--data-parallel`` refusals.

Each launch has its own timeout (a hang fails its test). Tolerances
(float32): loss terms rtol 1e-5 (sums of the ranks' shares in another
order, and JAX's); parameters after one clipped Adam step atol 1e-5, as
tests/test_torch_train.py holds the JAX step; decoded features atol 1e-5
(a rank's rows in a smaller batch: sums in another order; measured under
2e-6), durations exactly; the Griffin-Lim waves, whose iterations amplify
those differences at a few samples of the saturated waves that random
weights give (measured: up to 99 of 32767, 0.3 on average), a mean
difference of at most one 16-bit step and a largest of 256.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from _torch_port import NO_DROPOUT, TINY_AASVC, release_jax_executables  # noqa: F401
from seq2seq_vc_tpu.convert.reference import convert_aasvc
from seq2seq_vc_tpu.losses import get_criterion as jax_criterion
from seq2seq_vc_tpu.models import AASVC as JaxAASVC
from seq2seq_vc_tpu.train.aas_vc import AASVCTrainer as JaxAASVCTrainer
from seq2seq_vc_tpu.train.optim import build_optimizer as jax_build_optimizer
from seq2seq_vc_tpu.train.state import TrainState as JaxTrainState
from seq2seq_vc_torch.bin import vc_decode, vc_train
from seq2seq_vc_torch.convert import aasvc_state_dict
from seq2seq_vc_torch.models.aas_vc import AASVC
from seq2seq_vc_torch.parallel import shard_batch
from seq2seq_vc_torch.train.aas_vc import AASVCTrainer
from seq2seq_vc_torch.train.data import DataLoader, ParallelVCMelDataset
from test_torch_cli import SYNTH, _conf, _write_feats

REPO = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT = 300  # seconds a torchrun launch may take (a hang fails its test)
OPT = dict(optimizer_params={"lr": 1e-3}, scheduler_params={"warmup_steps": 10}, grad_norm=1.0)
MODEL = dict(TINY_AASVC, **NO_DROPOUT, postnet_dropout_rate=0.0,
             stochastic_duration_predictor_dropout_rate=0.0, compute_dtype="float32",
             attention_backend="xla")
TERMS = ("loss", "l1_loss", "forward_sum_loss", "binary_loss")


def _torchrun(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", str(REPO / "tests/_torch_ddp_worker.py"),
                          *map(str, args)], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=LAUNCH_TIMEOUT)
    assert run.returncode == 0, run.stderr[-4000:]


def _config(**model):
    config = _conf(SYNTH, **dict(MODEL, **model))
    config.update(OPT, batch_size=3, train_max_steps=1, log_interval_steps=1, seed=0,
                  eval_interval_steps=1000, save_interval_steps=1000, dp_train_start_steps=100,
                  num_save_intermediate_results=0)
    return config


def _corpus(root: Path):
    # 3 utterances: the global batch pads to 4 rows, and the ranks' rows
    # hold different numbers of valid frames
    return (_write_feats(root, "src", [40, 47, 33], seed=4),
            _write_feats(root, "trg", [44, 50, 36], seed=5))


def _jax_step(state0, padded, config):
    """The JAX trainer's loss terms and updated parameters on the padded
    global batch, from the port's initial weights."""
    jax_model = JaxAASVC(**MODEL, alignment_dist_form="direct")
    flax = convert_aasvc(state0, jax_model)
    tx, _ = jax_build_optimizer(**OPT)
    trainer = JaxAASVCTrainer(jax_model, JaxTrainState.create(flax, tx),
                              {"L1Loss": jax_criterion("L1Loss")}, dict(config), [],
                              mesh=None, writer=False)
    arrays = trainer._array_batch(padded)
    rngs = {"dropout": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: trainer.loss_fn(p, arrays, rngs, trainer._flags()), has_aux=True))(flax)
    return dict({k: float(v) for k, v in metrics.items()}, loss=float(loss)), \
        trainer.state.apply_gradients(grads).params


def test_ddp_step_equals_single_process_and_jax_steps(tmp_path):
    src, trg = _corpus(tmp_path / "corpus")
    config = _config()
    conf = tmp_path / "conf.yaml"
    conf.write_text(yaml.safe_dump(config))
    out = tmp_path / "ddp"
    _torchrun("train", tmp_path / "history.json", "--src-train-dumpdir", src,
              "--src-dev-dumpdir", src, "--trg-train-dumpdir", trg, "--trg-dev-dumpdir", trg,
              "--train-dp-input-dir", src, "--dev-dp-input-dir", src, "--outdir", out,
              "--config", conf, "--device", "cpu")
    ddp = json.loads((tmp_path / "history.json").read_text())[0]
    ddp_params = torch.load(out / "checkpoint-1steps.pt", weights_only=True)["model"]

    # the same global batch as vc_train's loader, padded as the ranks pad it
    dataset = ParallelVCMelDataset(src, trg, dp_feats=src, feat_key="mel")
    batch = next(iter(DataLoader(dataset, vc_train.build_collater(config), 3, shuffle=True,
                                 seed=0)))
    halves = [shard_batch(batch, r, 2) for r in range(2)]
    assert [len(h["utt_ids"]) for h in halves] == [2, 2]
    assert halves[0]["olens"].sum() != halves[1]["olens"].sum()
    padded = {k: (np.concatenate([h[k] for h in halves]) if isinstance(v, np.ndarray)
                  else sum((h[k] for h in halves), [])) for k, v in batch.items()}

    torch.manual_seed(0)
    model = AASVC(**MODEL)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = AASVCTrainer(vc_train.build_state(model, config, "", "cpu"),
                           vc_train.build_criterion(config), config, [padded], device="cpu")
    trainer.run()
    one = trainer.history[0]
    want, jax_params = _jax_step(state0, padded, config)
    for name in TERMS:
        np.testing.assert_allclose(ddp[f"train/{name}"], one[f"train/{name}"], rtol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(ddp[f"train/{name}"], want[name], rtol=1e-5, err_msg=name)
    jax_sd = aasvc_state_dict(jax_params, model)
    for name, w in model.state_dict().items():
        np.testing.assert_allclose(ddp_params[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(ddp_params[name].numpy(), jax_sd[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert any(not torch.equal(ddp_params[k], state0[k]) for k in state0)  # a step was taken


def _decoded(out: Path):
    lines = (out / "feats.scp").read_text().split()
    utts = lines[::2]
    return utts, {u: (np.load(out / f"{u}.npy"), np.loadtxt(out / "durations" / f"{u}.txt"),
                      (out / "wav" / f"{u}.wav").read_bytes()) for u in utts}


def test_data_parallel_decode_equals_one_rank(tmp_path):
    src, _ = _corpus(tmp_path / "corpus")
    exp = tmp_path / "exp"
    exp.mkdir()
    # the duration predictor's noise on, so the ranks must take the whole
    # batch's draw
    config = _config(stochastic_duration_predictor_noise_scale=0.5)
    (exp / "config.yml").write_text(yaml.safe_dump(config))
    torch.manual_seed(1)
    torch.save({"model": AASVC(**config["model_params"]).state_dict()}, exp / "ckpt.pt")
    args = ["--dumpdir", src, "--dp-input-dir", src, "--checkpoint", exp / "ckpt.pt",
            "--batch-size", "2", "--skip-plots", "--device", "cpu"]
    vc_decode.main([str(a) for a in args + ["--outdir", tmp_path / "one"]])
    _torchrun("decode", "-", *args, "--outdir", tmp_path / "two", "--data-parallel", "2")
    utts, one = _decoded(tmp_path / "one")
    utts2, two = _decoded(tmp_path / "two")
    assert utts2 == utts and len(utts) == 3
    for u in utts:
        np.testing.assert_allclose(two[u][0], one[u][0], rtol=0, atol=1e-5, err_msg=u)
        np.testing.assert_array_equal(two[u][1], one[u][1], err_msg=u)
        a, b = (np.frombuffer(w[2][44:], np.int16).astype(np.int32) for w in (two[u], one[u]))
        # Griffin-Lim's iterations on the (clipped) waves of random weights
        # move a few 16-bit samples by the features' ~1e-6 differences
        assert np.abs(a - b).mean() <= 1 and np.abs(a - b).max() <= 256, u


@pytest.mark.parametrize("batch,match", [("4", "available devices 1"), ("6", "multiple"),
                                         ("0", "multiple")])
def test_data_parallel_refusals(tmp_path, batch, match):
    # --data-parallel 4 on one process: a batch size that is not a positive
    # multiple of 4, or more ranks than there are
    with pytest.raises(ValueError, match=match):
        vc_decode.main(["--dumpdir", "x", "--checkpoint", "x", "--outdir", str(tmp_path),
                        "--data-parallel", "4", "--batch-size", batch, "--device", "cpu"])
