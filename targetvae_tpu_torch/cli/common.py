"""Shared CLI plumbing (mirror of targetvae_tpu/cli/common.py): argparse
groups with the reference's exact flag names and defaults (SURVEY.md section
5 config row), device selection and config construction."""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from ..models.targetvae import resolve_device
from ..parallel.distributed import (initialize_from_env, launched_by_torchrun,
                                    local_device)
from ..utils.config import (
    EncoderConfig, GeneratorConfig, LikelihoodConfig, ModelConfig, TrainConfig,
    fourier_sigma_for)


def add_model_args(parser: argparse.ArgumentParser, *, kernel_size: int,
                   padding: int, in_channels: int = 1,
                   image_dim: Optional[int] = None,
                   generator_num_layers: int = 2) -> None:
    parser.add_argument("-z", "--z-dim", type=int, default=2,
                        help="latent variable dimension (default: 2)")
    parser.add_argument("--t-inf", default="attention",
                        choices=["unimodal", "attention"],
                        help="unimodal | attention (default: attention)")
    parser.add_argument("--r-inf", default="attention+offsets",
                        choices=["unimodal", "attention", "attention+offsets"],
                        help="unimodal | attention | attention+offsets "
                             "(default: attention+offsets)")
    parser.add_argument("--groupconv", type=int, default=8,
                        choices=[0, 4, 8, 16], help="0 | 4 | 8 | 16 (default:8)")
    parser.add_argument("--encoder-num-layers", type=int, default=2,
                        help="number of hidden layers in the inference model "
                             "when the translation and rotation inference are "
                             "unimodal (default:2)")
    parser.add_argument("--encoder-kernel-number", type=int, default=128,
                        help="number of kernels in each layer of the encoder "
                             "(default: 128)")
    parser.add_argument("--encoder-kernel-size", type=int, default=kernel_size,
                        help=f"size of kernels in the first layer of the "
                             f"encoder (default: {kernel_size})")
    parser.add_argument("--encoder-padding", type=int, default=padding,
                        help=f"amount of the padding for the encoder "
                             f"(default: {padding})")
    parser.add_argument("--in-channels", type=int, default=in_channels,
                        help=f"number of channels in the images "
                             f"(default:{in_channels})")
    if image_dim is not None:
        parser.add_argument("--image-dim", type=int, default=image_dim,
                            help=f"input image of the shape image_dim x "
                                 f"image_dim (default:{image_dim})")
    parser.add_argument("--fourier-expansion", action="store_true",
                        help="using random fourier feature expansion in "
                             "generator")
    parser.add_argument("--generator-hidden-dim", type=int, default=512,
                        help="dimension of hidden layers (default: 512)")
    parser.add_argument("--generator-num-layers", type=int,
                        default=generator_num_layers,
                        help=f"number of hidden layers "
                             f"(default: {generator_num_layers})")
    parser.add_argument("--generator-resid-layers", action="store_true",
                        help="using skip connections in generator")
    parser.add_argument("--activation", choices=["tanh", "leakyrelu"],
                        default="leakyrelu",
                        help="activation function (default: leakyrelu)")


def add_train_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-l", "--learning-rate", type=float, default=2e-4,
                        help="learning rate (default: 2e-4)")
    parser.add_argument("--minibatch-size", type=int, default=100,
                        help="minibatch size (default: 100)")
    parser.add_argument("--log-root", default="./training_logs",
                        help="path prefix to save models "
                             "(default:./training_logs)")
    parser.add_argument("--save-interval", default=20, type=int,
                        help="save frequency in epochs (default: 20)")
    parser.add_argument("--num-epochs", type=int, default=500,
                        help="number of training epochs (default: 500)")
    parser.add_argument("-d", "--device", type=int, default=0,
                        help="compute device to use (default:0)")
    # extensions of the JAX package (not in the reference); --dp / --tp
    # above 1 run under torchrun, one process a rank
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="matmul/conv compute dtype; bfloat16 also enables "
                             "the fused CUDA kernels on the card "
                             "(default: float32)")
    parser.add_argument("--seed", type=int, default=0,
                        help="PRNG seed (default: 0)")
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel devices: shard the batch over a "
                             "('data','model') mesh; gradients all-reduced "
                             "(default: 1 = single device)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel devices: shard the encoder "
                             "kernel / generator hidden axes over 'model', "
                             "or with --sp the posterior grid (default: 1)")
    parser.add_argument("--sp", action="store_true",
                        help="sequence parallelism: shard the joint "
                             "R*H'*W' posterior grid over the 'model' mesh "
                             "axis (cross-device log-sum-exp + psum'd "
                             "moments) — for grids too large for one card; "
                             "requires --tp > 1")
    parser.add_argument("--host-stream", action="store_true",
                        help="stream train batches from host RAM (threaded "
                             "shuffle/gather/prefetch) instead of keeping "
                             "the whole train set in device memory — for "
                             "datasets that don't fit in the card's memory")
    parser.add_argument("--stream-bf16", action="store_true",
                        help="with --host-stream: stage batches (and CTF "
                             "kernels) to the device in bfloat16, halving "
                             "the host->device bytes — for "
                             "bandwidth-starved links; compute under "
                             "--compute-dtype bfloat16 rounds to bf16 "
                             "anyway, this just moves the rounding onto "
                             "the wire")
    parser.add_argument("--resume", default=None, metavar="RUN_DIR",
                        help="resume training from a previous run directory "
                             "(restores params, optimizer state, RNG, "
                             "schedulers)")
    parser.add_argument("--profile-dir", default=None,
                        help="capture a torch.profiler trace of one epoch "
                             "to this directory")
    parser.add_argument("--debug-nans", action="store_true",
                        help="enable autograd anomaly detection (error at "
                             "the op whose backward produced a NaN)")


def select_device(device_index: int) -> torch.device:
    """-1 -> the CPU; i -> cuda:i. Without CUDA, or with fewer devices, it
    raises: it never falls back to the CPU, which -1 asks for. Under
    torchrun each local rank takes cuda:(i + local rank) where the cards
    suffice, else the ranks share cuda:i
    (parallel.distributed.local_device)."""
    if device_index == -1:
        return torch.device("cpu")
    if launched_by_torchrun():
        device_index = torch.device(local_device(device_index)).index
    if not torch.cuda.is_available():
        resolve_device()                  # raises the package's message
    if not 0 <= device_index < torch.cuda.device_count():
        raise ValueError(f"-d {device_index}: there are "
                         f"{torch.cuda.device_count()} CUDA devices")
    selected = resolve_device(f"cuda:{device_index}")
    print(f"# using device: {selected} "
          f"({torch.cuda.get_device_name(selected)})", file=sys.stderr)
    return selected


def model_config_from_args(args, image_dim: int, n_out: int,
                           likelihood: LikelihoodConfig,
                           theta_prior: float,
                           normal_prior_over_r: bool,
                           fourier_sigma: Optional[float] = None) -> ModelConfig:
    if fourier_sigma is None:
        fourier_sigma = fourier_sigma_for(image_dim)
    gen = GeneratorConfig(
        z_dim=args.z_dim, hidden_dim=args.generator_hidden_dim, n_out=n_out,
        num_layers=args.generator_num_layers, activation=args.activation,
        resid=args.generator_resid_layers,
        fourier_expansion=args.fourier_expansion, fourier_sigma=fourier_sigma)
    enc = EncoderConfig(
        t_inf=args.t_inf, r_inf=args.r_inf, image_dim=image_dim,
        in_channels=args.in_channels,
        # unimodal x unimodal infers (theta, dx, z) jointly: z_dim + 3
        # (reference train_mnist.py:552)
        z_dim=args.z_dim, kernels_num=args.encoder_kernel_number,
        kernels_size=args.encoder_kernel_size, padding=args.encoder_padding,
        num_layers=args.encoder_num_layers, activation=args.activation,
        groupconv=args.groupconv, theta_prior=theta_prior,
        normal_prior_over_r=normal_prior_over_r)
    return ModelConfig(generator=gen, encoder=enc, likelihood=likelihood)


def launch_training(args, model, train_cfg, run_name: str, y_train, y_test,
                    ctf_train=None, ctf_test=None):
    """Shared tail of every train CLI: the process group of a multi-rank run
    (torchrun's environment), logger/run-dir setup on rank 0 (or resume
    into an existing run dir, which every rank reads), optional anomaly
    detection, then fit(), which puts the data on the model's device or,
    with --host-stream, streams it from host RAM."""
    from ..train import NullLogger, RunLogger, fit

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    ranks = train_cfg.dp * train_cfg.tp
    joined = False
    if ranks > 1 and not dist.is_initialized():
        if not launched_by_torchrun():
            raise SystemExit(
                f"--dp {train_cfg.dp} x --tp {train_cfg.tp} runs {ranks} "
                f"ranks, one process each: launch it as `torchrun "
                f"--standalone --nproc_per_node {ranks} -m "
                f"targetvae_tpu_torch.cli.<train CLI> ...`")
        initialize_from_env(model.device)
        joined = True
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    resume_dir = args.resume.rstrip("/") if args.resume else None
    if not rank0:
        logger = NullLogger()
    elif resume_dir:
        logger = RunLogger(os.path.dirname(resume_dir) or ".",
                           os.path.basename(resume_dir), append=True)
    else:
        logger = RunLogger(args.log_root, run_name, args_repr=str(args),
                           model_repr=model.cfg.to_json())
    try:
        return fit(model, train_cfg, logger, y_train, y_test,
                   ctf_train=ctf_train, ctf_test=ctf_test,
                   resume_dir=resume_dir, profile_dir=args.profile_dir)
    finally:
        logger.close()
        if joined:
            dist.destroy_process_group()


def train_config_from_args(args, **overrides) -> TrainConfig:
    return TrainConfig(
        learning_rate=args.learning_rate, minibatch_size=args.minibatch_size,
        num_epochs=args.num_epochs, save_interval=args.save_interval,
        log_root=args.log_root, seed=getattr(args, "seed", 0),
        compute_dtype=(None if args.compute_dtype == "float32"
                       else args.compute_dtype),
        dp=getattr(args, "dp", 1), tp=getattr(args, "tp", 1),
        sp=getattr(args, "sp", False),
        host_stream=getattr(args, "host_stream", False),
        stream_bf16=getattr(args, "stream_bf16", False),
        **overrides)
