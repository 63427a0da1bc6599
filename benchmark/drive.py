"""Drives the port (targetvae_tpu_torch) through one run of a cell.

A traffic mix's "kind" picks the run's class: "train" runs whole epochs of
Trainer.train_epoch over a resident, seeded set; "embed" runs a closed loop
of whole numpy stacks through cli/clustering_common.py::embed_dataset. Each
class builds the port's objects from the generated inputs in set-up,
reads what the judge compares, warms up the shapes the window will use, and
then runs the window. The port is imported here only, after the cell's
encoder tier is in the environment.
"""

from __future__ import annotations

import gc
import json
import os
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from . import generate, judge
from .trace import WINDOW, span


@dataclass
class Window:
    """What the window did, for the metrics and the readers."""
    kind: str
    seconds: float
    model: object                 # the configuration as attributes
    batches: dict = field(default_factory=dict)   # batch size -> count
    images: int = 0
    steps: int = 0
    attempted: int = 0
    failed: int = 0
    launches: dict = field(default_factory=dict)
    ctf_dim: int = None


def model_namespace(model: dict):
    """The "model" section of a configuration file as attributes, the mode
    included, for the frozen counts."""
    ns = {k: SimpleNamespace(**v) for k, v in model.items()}
    e = ns["encoder"]
    e.mode = ("A" if e.t_inf == "unimodal" and e.r_inf == "unimodal" else
              "B" if e.t_inf == "attention" and e.r_inf == "unimodal" else
              "C")
    return SimpleNamespace(**ns)


def _port(config: dict):
    """The port's modules, imported once the cell's encoder tier is set."""
    os.environ["TARGETVAE_ENCODER_TIER"] = config["encoder_tier"]
    from targetvae_tpu_torch import kernels
    from targetvae_tpu_torch.cli.clustering_common import embed_dataset
    from targetvae_tpu_torch.data.ctf import ctf_filter
    from targetvae_tpu_torch.models.targetvae import TargetVAE
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.train.state import create_train_state
    from targetvae_tpu_torch.utils.config import ModelConfig, TrainConfig
    return SimpleNamespace(
        kernels=kernels, embed_dataset=embed_dataset, ctf_filter=ctf_filter,
        TargetVAE=TargetVAE, Trainer=Trainer,
        create_train_state=create_train_state, TrainConfig=TrainConfig,
        model_config=ModelConfig.from_json(json.dumps(config["model"])))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    """Return the freed program's memory, and set the reference's
    arithmetic (float32 without TF32)."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    judge.exact_float32()


class TrainRun:
    """Whole epochs of Trainer.train_epoch over `train_images` resident
    images (and their CTF kernels), B = minibatch_size, the tail included."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg = cell.config
        self.p = _port(cfg)
        self.marks = [("the port's import", time.perf_counter())]
        self.B, self.n = cfg["minibatch_size"], cfg["train_images"]
        self.data, self.micrograph, self.table = generate.images(
            cfg, self.n, seed, device)
        self.params = generate.weights(cfg["model"], seed, device)
        _sync(device)
        self.marks.append(("inputs and weights", time.perf_counter()))
        model = self.p.TargetVAE(self.p.model_config, device)
        model.load_params(generate.clone(self.params))
        self.trainer = self.p.Trainer(model, self.p.TrainConfig(
            learning_rate=cfg["learning_rate"], minibatch_size=self.B,
            compute_dtype=cfg["compute_dtype"]), device=device)
        # one host generator samples the checked steps, the warm-up and
        # the window; the reference draws the checked steps' noise again
        self.noise_seed = int(seed) % generate.SEED_MOD
        self.state = self.p.create_train_state(
            model, cfg["learning_rate"],
            torch.Generator().manual_seed(self.noise_seed))
        self.ctf = None
        if self.table is not None:
            k = cfg["ctf_dim"]
            host = {c: v.cpu().numpy() for c, v in self.table.items()}
            self.ctf = torch.as_tensor(self.p.ctf_filter(host, k, k),
                                       device=device)[self.micrograph]
        _sync(device)
        self.marks.append(("the port's objects", time.perf_counter()))

    def _rows(self, a, b):
        return (self.data[a:b],
                None if self.ctf is None else self.ctf[a:b])

    def check_steps(self) -> dict:
        """The first steps, on rows that all differ, through the window's
        own call, sampled: each step's loss and KL term, the first gradient
        from Adam's first moment (the tensors and their norms), each leaf's
        change."""
        out = {"losses": [], "kls": []}
        named = lambda: {k.replace("spatial_generator.", "generator.", 1): p
                         for k, p in self.state.model.named_parameters()}
        for i in range(self.cell.traffic["check_steps"]):
            self.state, m = self.trainer.train_epoch(
                self.state, *self._rows(i * self.B, (i + 1) * self.B))
            out["losses"].append(-m[0])
            out["kls"].append(m[2])
            if i == 0:
                opt = self.state.optimizer.state
                # a leaf Adam has not stepped has no moment yet: zero
                out["first"] = {
                    k: opt[p].get("exp_avg", torch.zeros_like(p)).detach()
                    .cpu() / (1 - judge.BETA1) for k, p in named().items()}
                out["grads"] = {k: float(g.norm())
                                for k, g in out["first"].items()}
        start = judge.leaves(self.params)
        out["updates"] = {k: float((p.detach() - start[k]).norm())
                          for k, p in named().items()}
        return out

    def warm_up(self) -> None:
        """A full batch and the tail, sampled: every shape of the
        window."""
        a = self.cell.traffic["check_steps"] * self.B
        self.state, _ = self.trainer.train_epoch(
            self.state, *self._rows(a, a + self.B + self.n % self.B))
        _sync(self.device)

    def window(self, seconds: float) -> Window:
        w = Window("train", 0.0, model_namespace(self.cell.config["model"]),
                   ctf_dim=self.cell.config.get("ctf_dim"))
        kernels = self.p.kernels
        kernels.reset_launch_counts()
        epochs, bad = 0, 0
        t0 = time.perf_counter()
        with span(WINDOW):
            while True:
                with span("bench.epoch"):
                    self.state, m = self.trainer.train_epoch(
                        self.state, self.data, self.ctf)
                epochs += 1
                bad += not all(np.isfinite(m))
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(self.device)
        w.seconds = time.perf_counter() - t0
        w.launches = kernels.launch_counts()
        full, tail = divmod(self.n, self.B)
        w.batches = {self.B: epochs * full}
        if tail:
            w.batches[tail] = epochs
        w.steps = sum(w.batches.values())
        w.images = w.attempted = epochs * self.n
        w.failed = bad * self.n
        return w

    def release(self) -> dict:
        """Free the program; what the reference needs to follow its checked
        steps: the weights, the checked rows and their CTF kernels, worked
        out again from the table."""
        k = self.cell.traffic["check_steps"]
        ys = self.data[:k * self.B].clone()
        micro = None if self.micrograph is None else \
            self.micrograph[:k * self.B].clone()
        params = judge.to_device(self.params, "cpu")
        del self.trainer, self.state, self.data, self.ctf, self.params
        _free(self.device)
        ctf = judge.reference_ctf(self.table, micro,
                                  self.cell.config.get("ctf_dim"),
                                  self.device)
        return {"params": params, "model": self.cell.config["model"],
                "lr": self.cell.config["learning_rate"],
                "noise_seed": self.noise_seed,
                "batches": [(ys[i * self.B:(i + 1) * self.B],
                             None if ctf is None
                             else ctf[i * self.B:(i + 1) * self.B])
                            for i in range(k)]}

    def numbers(self, prog: dict) -> dict:
        """The train numbers of the program's checked steps."""
        return judge.train_numbers(prog, judge.reference_steps(
            **self.release()))


class EmbedRun:
    """A closed loop of one client: each request the configuration's whole
    stack (the mix's "stack" key names its size) through embed_dataset in
    one call, as the clustering CLIs embed a data set."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.p = _port(cfg)
        self.marks = [("the port's import", time.perf_counter())]
        self.B = tr["minibatch_size"]
        stack, _, _ = generate.images(cfg, cfg[tr["stack"]], seed, device)
        self.stack = np.ascontiguousarray(stack.cpu().numpy())
        del stack
        self.params = generate.weights(cfg["model"], seed, device)
        _sync(device)
        self.marks.append(("inputs and weights", time.perf_counter()))
        self.model = self.p.TargetVAE(self.p.model_config, device)
        self.model.load_params(generate.clone(self.params))
        self.mparams = self.model.params()
        self.marks.append(("the port's objects", time.perf_counter()))
        self.dtype = cfg["compute_dtype"]
        self.answers = []

    def _embed(self):
        return self.p.embed_dataset(self.model, self.mparams, self.stack,
                                    self.B, self.dtype)

    def check_steps(self) -> None:
        """An embed has no steps to check before its window."""
        return None

    def warm_up(self) -> None:
        """One request: every shape of the window (the full batches and
        the tail)."""
        self._embed()
        _sync(self.device)

    def window(self, seconds: float) -> Window:
        w = Window("embed", 0.0, model_namespace(self.cell.config["model"]))
        n = len(self.stack)
        full, tail = divmod(n, self.B)
        zd = self.cell.config["model"]["encoder"]["z_dim"]
        kernels = self.p.kernels
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with span(WINDOW):
            while time.perf_counter() - t0 < seconds:
                with span("bench.request"):
                    z, rot, tr = self._embed()
                self.answers.append((z, rot, tr))
                w.attempted += 1
                w.images += n
                bad = (z.shape != (n, 2 * zd)
                       or not (np.isfinite(z).all() and np.isfinite(rot).all()
                               and np.isfinite(tr).all()))
                w.failed += int(bad)
            _sync(self.device)
        w.seconds = time.perf_counter() - t0
        w.launches = kernels.launch_counts()
        w.batches = {self.B: w.attempted * full}
        if tail:
            w.batches[tail] = w.attempted
        w.steps = sum(w.batches.values())
        return w

    def release(self) -> dict:
        """Free the program; the stack, every request's answers and the
        weights, for the reference."""
        out = {"params": judge.to_device(self.params, "cpu"),
               "enc": self.cell.config["model"]["encoder"],
               "images": self.stack, "answers": self.answers,
               "device": self.device}
        del self.model, self.mparams, self.params
        _free(self.device)
        return out

    def numbers(self, prog) -> dict:
        """The embed numbers of every request's answers."""
        return judge.embed_numbers(**self.release())


RUNS = {"train": TrainRun, "embed": EmbedRun}


def prepare(cell, seed: int, device):
    return RUNS[cell.traffic["kind"]](cell, seed, device)


def end_to_end(w: Window, setup_s: float) -> dict:
    """The end-to-end metrics a window gives, by name."""
    out = {"setup_s": setup_s}
    out[f"{w.kind}_img_s"] = w.images / w.seconds
    return out
