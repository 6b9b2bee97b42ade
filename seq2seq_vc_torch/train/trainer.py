"""Step-driven trainer base (mirrors seq2seq_vc_tpu/train/trainer.py).

The run loop, the train step (loss, backward, one optimizer update per
``gradient_accumulate_steps`` micro-batches), the log, eval and save
intervals, and checkpoints in the port's own ``torch.save`` format.
``steps`` counts optimizer updates, as in the JAX package.

Randomness: dropout draws from torch's default generators, which the
trainer seeds from ``config["seed"]`` (PyTorch's dropout takes no
generator argument). Every other draw of the step (the stochastic duration
predictor's ``e_q``, the VTN prenet's always-on dropout) comes from
``self.generator``, a CPU generator that the trainer owns, so that a step on
the card and one on the CPU draw the same numbers, and each evaluation from
a fresh one seeded 1, so that the dev loss of the same weights is the same.
A checkpoint keeps the generators' states and the update count, and
``load_checkpoint`` puts the loader where an uninterrupted run's would be,
so a resumed run takes the steps that an uninterrupted one takes.

At each evaluation, ``generate_intermediate`` decodes the first dev batch
into ``<outdir>/predictions/<steps>steps``; a trainer that does not define
it (the FastSpeech-VC one, as in the JAX package) writes none.

Metrics stay on the device until the log interval, where one sync fetches
them all. Each log appends the interval's averages to ``history``.
"""

from __future__ import annotations

import logging
import os
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .state import TrainState


def save_intermediate(outdir: str, batch: Dict[str, Any], outs: np.ndarray, out_lens,
                      probs: Optional[np.ndarray] = None) -> None:
    """Write each generated item as ``<utt>.npy`` (its valid frames) and,
    where matplotlib imports, a plot of it under its ground truth (and its
    stop probabilities, for an AR model) as ``<utt>.png``."""
    os.makedirs(outdir, exist_ok=True)
    for i, n in enumerate(out_lens):
        np.save(os.path.join(outdir, f"{batch['utt_ids'][i]}.npy"), outs[i, :n])
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = 2 if probs is None else 3
    for i, n in enumerate(out_lens):
        fig, axes = plt.subplots(rows, 1, figsize=(8, 3 * rows))
        axes[0].imshow(batch["ys"][i, : batch["olens"][i]].T, aspect="auto", origin="lower")
        axes[0].set_title("groundtruth")
        axes[1].imshow(outs[i, :n].T, aspect="auto", origin="lower")
        axes[1].set_title("generated")
        if probs is not None:
            axes[2].plot(probs[i, :n])
            axes[2].set_title("stop probs")
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, f"{batch['utt_ids'][i]}.png"))
        plt.close(fig)


def refuse_batch_norm(model: torch.nn.Module) -> None:
    """Raise for a model with a batch norm (``postnet_norm_type`` or
    ``conformer_conv_norm_type: batch_norm``), as the JAX package's
    trainers do: they keep no ``batch_stats`` collection, so their train
    step raises flax's ``ModifyScopeVariableError`` on the first batch
    norm. Such a model (a converted reference checkpoint) decodes and
    serves; it trains with ``group_norm``."""
    from ..nn.conformer import ConvBatchNorm

    if any(isinstance(m, ConvBatchNorm) for m in model.modules()):
        raise NotImplementedError(
            "a model with batch norm (postnet_norm_type or conformer_conv_norm_type "
            "batch_norm) does not train: the JAX package's trainers keep no batch_stats "
            "and their train step raises ModifyScopeVariableError; train with group_norm")


class Trainer:
    """Base trainer. Subclasses implement ``loss_fn(batch, flags,
    generator) -> (loss, metrics)`` and may implement
    ``generate_intermediate(batch, outdir)``."""

    def __init__(
        self,
        state: TrainState,
        criterion: Dict[str, Any],
        config: Dict[str, Any],
        train_loader,
        dev_loader=None,
        device=None,
    ):
        refuse_batch_norm(state.model)
        self.device = resolve_device(device)
        self.state = state
        self.model = state.model.to(self.device)  # in place: the optimizer keeps its parameters
        self.criterion = criterion
        self.config = config
        self.train_loader = train_loader
        self.dev_loader = dev_loader
        seed = int(config.get("seed", 0))
        torch.manual_seed(seed)  # dropout (CPU and CUDA default generators)
        self.generator = torch.Generator().manual_seed(seed)
        self.epochs = 0
        self.finish_train = False
        self.outdir = config.get("outdir", "exp")
        self.grad_accum = int(config.get("gradient_accumulate_steps", 1) or 1)
        self._micro_total = self.steps * self.grad_accum
        self._pending_metrics: List[Dict[str, torch.Tensor]] = []
        self._interval_tick = time.perf_counter()
        self.history: List[Dict[str, float]] = []

    @property
    def steps(self) -> int:
        return self.state.steps

    # ------------------------------------------------------------------ api
    def run(self):
        """Train until ``config["train_max_steps"]`` optimizer updates."""
        self._check_train_finish()
        logging.info("training to %d steps", self.config["train_max_steps"])
        self._interval_tick = time.perf_counter()
        while not self.finish_train:
            self._train_epoch()
        logging.info("finished training (%d steps)", self.steps)

    # ----------------------------------------------------------------- core
    def loss_fn(self, batch: Dict[str, Any], flags, generator):
        raise NotImplementedError

    def _flags(self) -> Any:
        return ()

    def _array_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """numpy arrays -> tensors on the device (float32, int64)."""
        out: Dict[str, Any] = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(v)
                t = t.float() if t.is_floating_point() else t.long()
                out[k] = t.to(self.device, non_blocking=True)
        return out

    def _train_step(self, batch: Dict[str, Any]) -> bool:
        """One micro-batch; returns whether it completed an optimizer step."""
        self.model.train()
        loss, metrics = self.loss_fn(self._array_batch(batch), self._flags(), self.generator)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        self._pending_metrics.append(metrics)
        self._micro_total += 1
        boundary = self._micro_total % self.grad_accum == 0
        if boundary:
            norm = self.state.apply_gradients()
            if norm is not None:
                metrics["grad_norm"] = norm
            self._check_train_finish()
        return boundary

    def _train_epoch(self):
        for batch in self.train_loader:
            if self._train_step(batch):
                self._check_log_interval()
                self._check_eval_interval()
                self._check_save_interval()
            if self.finish_train:
                return
        self.epochs += 1

    # ------------------------------------------------------------ intervals
    def _check_train_finish(self):
        if self.steps >= self.config["train_max_steps"]:
            self.finish_train = True

    def _check_log_interval(self):
        interval = self.config.get("log_interval_steps", 100)
        if not (self.steps % interval == 0 and self.steps > 0 and self._pending_metrics):
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        n_micro = len(self._pending_metrics)
        avg_t = (time.perf_counter() - self._interval_tick) / n_micro
        total: Dict[str, float] = defaultdict(float)
        for metrics in self._pending_metrics:
            for k, v in metrics.items():
                total[k] += float(v)
        # averages over micro-batches, as the JAX package logs them
        record = {f"train/{k}": v / n_micro for k, v in total.items()}
        record["train/step_time_sec"] = avg_t
        if self.device.type == "cuda":
            record["train/peak_memory_mib"] = torch.cuda.max_memory_allocated(self.device) / 2**20
        for k, v in record.items():
            logging.info("(steps: %d) %s = %.4f.", self.steps, k, v)
        self.history.append(dict(steps=self.steps, **record))
        self._pending_metrics = []
        self._interval_tick = time.perf_counter()

    def _check_eval_interval(self):
        interval = self.config.get("eval_interval_steps", 0)
        if interval and self.steps % interval == 0 and self.dev_loader is not None:
            self._eval_epoch()

    def _check_save_interval(self):
        interval = self.config.get("save_interval_steps", 0)
        if interval and self.steps % interval == 0:
            path = os.path.join(self.outdir, f"checkpoint-{self.steps}steps.pt")
            self.save_checkpoint(path)
            logging.info("saved checkpoint @ %d steps", self.steps)

    # ----------------------------------------------------------------- eval
    def evaluate(self) -> Dict[str, float]:
        """Mean loss terms over the dev set, dropout off and no autograd
        (a fixed generator draws the duration predictor's noise)."""
        return self._dev_pass()[0]

    def _dev_pass(self) -> Tuple[Dict[str, float], Optional[Dict[str, Any]]]:
        """``evaluate``'s metrics and the first dev batch (None for an
        empty dev set)."""
        total: Dict[str, float] = defaultdict(float)
        n, first = 0, None
        self.model.eval()
        try:
            with torch.no_grad():
                for batch in self.dev_loader:
                    first = batch if first is None else first
                    gen = torch.Generator().manual_seed(1)
                    loss, metrics = self.loss_fn(self._array_batch(batch), self._flags(), gen)
                    total["loss"] += float(loss)
                    for k, v in metrics.items():
                        total[k] += float(v)
                    n += 1
        finally:
            self.model.train()
        return {k: v / max(n, 1) for k, v in total.items()}, first

    def _eval_epoch(self):
        result, first = self._dev_pass()
        for k, v in result.items():
            logging.info("(steps: %d) dev/%s = %.4f.", self.steps, k, v)
        self.history.append(dict(steps=self.steps, **{f"dev/{k}": v for k, v in result.items()}))
        if first is not None and self.has_intermediate():
            outdir = os.path.join(self.outdir, "predictions", f"{self.steps}steps")
            self.model.eval()
            try:
                self.generate_intermediate(first, outdir)
            finally:
                self.model.train()

    def generate_intermediate(self, batch: Dict[str, Any], outdir: str):
        """Decode the first ``num_save_intermediate_results`` items of a dev
        batch into ``outdir``."""
        raise NotImplementedError

    def has_intermediate(self) -> bool:
        """Whether this trainer's class defines ``generate_intermediate``."""
        return type(self).generate_intermediate is not Trainer.generate_intermediate

    def _intermediate_items(self, batch: Dict[str, Any]) -> int:
        return min(self.config.get("num_save_intermediate_results", 4), len(batch["xs"]))

    # ----------------------------------------------------------- checkpoint
    def _rng_state(self) -> Dict[str, torch.Tensor]:
        state = {"generator": self.generator.get_state(), "cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            state["cuda"] = torch.cuda.get_rng_state(self.device)
        return state

    def _set_rng_state(self, state: Dict[str, torch.Tensor]) -> None:
        self.generator.set_state(state["generator"].cpu())
        torch.set_rng_state(state["cpu"].cpu())
        if "cuda" in state and self.device.type == "cuda":
            torch.cuda.set_rng_state(state["cuda"].cpu(), self.device)

    def save_checkpoint(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(dict(self.state.state_dict(), steps=self.steps, epochs=self.epochs,
                        rng=self._rng_state()), path)

    def load_checkpoint(self, path: str, load_only_params: bool = False):
        """Restore a checkpoint. Unless ``load_only_params``, also the
        optimizer, the generators and the loader's position: the epochs and
        batches that ``steps`` updates consumed."""
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.state.load_state_dict(ckpt, load_only_params)
        if not load_only_params:
            self._micro_total = self.steps * self.grad_accum
            self.epochs, batch = divmod(self._micro_total, len(self.train_loader))
            self.train_loader.seek(self.epochs, batch)
            self._set_rng_state(ckpt["rng"])
