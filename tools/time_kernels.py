#!/usr/bin/env python3
"""Time the port's kernels on the card with chip_smoke.py's device timer.

    python3 tools/time_kernels.py [--root DIR] [--r1-only]

Builds flagship-shape inputs (random weights, synthetic images and seeded
tensors, as chip_smoke.py makes them) for the port found under --root (a
checkout of the repository; this one by default) and times, for each
kernel K1-K12 (K1-K4 also at R = 1, on mode B's mnist-b and mnist-b-p8,
where the checkout has them): the kernel (chip_smoke.device_ms: the calls
replayed from a CUDA graph, their inputs cold in L2, the median of 5
windows of at least 2 ms) and its plain version the same way. K3 and K4 are timed sampled and
deterministic; beside K3-K6 a yardstick: one PyTorch pass over the same
input bytes (a sum over each image's bytes for the forwards, a negation
that reads and writes them for the backwards). K2's and K12's cotangent is
seeded noise (chip_smoke's phase 8 feeds them a train step's). Then the
posterior stage of the train step and of the eval batch on each encoder
tier (chip_smoke.posterior_stage: the device ms between the encoder kernel
and K7, and between K8 and K2's or K12's chain), and of the SP train step
on rank 0 of two ranks sharing the card over gloo (gloo's copies left out,
chip_smoke.sp_posterior_stage). chip_smoke.py times this checkout's
kernels with the same timer; this tool exists to time another checkout's
beside it in one call, the parent of a change. K5/K6 take the checkout's
contract: the exchanged planes (B, 3 + 2 zd, C), or the JAX package's
separate attn, th and z of the checkouts before it. With --r1-only it times
the R = 1 kernels alone (a few seconds after the build). Prints one JSON
line with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sp_stage_rank(rank: int, world: int) -> dict:
    """A rank of the SP train step (chip_smoke's flagship, bf16, conv tier)
    of the port at --root: five steps, rank 0's under the profiler; rank 0
    returns chip_smoke.sp_posterior_stage of its trace. The rank inherits
    main's path, --root first, and has imported the port from it to start;
    chip_smoke comes from this checkout."""
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    dev = torch.device("cuda", 0)
    cfg = cs.flagship_config()
    y = torch.from_numpy(cs.synthetic_images(cs.B, cfg.encoder.image_dim,
                                             3)).to(dev)
    with cs.encoder_tier("conv"):
        trainer = Trainer(cfg, TrainConfig(compute_dtype="bfloat16", tp=world,
                                           sp=True), device=dev)
        state = trainer.init_state(0)
        step = lambda: trainer.train_step(state, y)
        if rank == 0:
            return cs.sp_posterior_stage(cs.device_ops(torch, step))
        for _ in range(5):
            step()
    return {}


def r1_kernels(cs, torch, dev, rn, time) -> None:
    """K1 and K2 at R = 1 on the lift rows of chip_smoke's mnist-b and
    mnist-b-p8 (KI = 128, 1,024), K3 and K4 at R = 1 on seeded heads of
    their 2,601 cells, where the checkout at --root has them (mode B)."""
    import targetvae_tpu_torch.kernels.mix_heads as mh
    if not hasattr(mh, "mix_heads_r1_fwd"):
        print("R = 1 kernels: not in this checkout", flush=True)
        return
    import targetvae_tpu_torch.kernels.posterior as post
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.losses.elbo import posterior_constants
    from targetvae_tpu_torch.models.encoders import (
        conv_rows, head_weights, mode_b_matrices)
    bf = torch.bfloat16
    y = torch.from_numpy(cs.synthetic_images(cs.B, 50, 3)).to(dev)
    for name in ("mnist-b", "mnist-b-p8"):
        cfg = cs.mode_config(name)
        e = cfg.encoder
        params = TargetVAE(cfg, device=dev).init(
            torch.Generator().manual_seed(0))["encoder"]
        w, bc, mix_w, mix_b = mode_b_matrices(params, e)
        rows, _ = conv_rows(w, y, e.image_dim // 2)
        wh, bh = head_weights(params)
        K, D = e.kernels_num, 3 + 2 * e.z_dim
        k1 = (rows, bc.float().contiguous(), mix_w.to(bf).contiguous(),
              mix_b.float().contiguous(), wh.to(bf).contiguous(),
              bh.float().contiguous())
        time(f"K1 R=1 {name}", lambda *a: mh.mix_heads_r1_fwd(*a, K=K), k1,
             lambda *a: mh.lift_act_mix_heads_plain(*a, R=1, K=K), k1)
        a2 = (*k1[:5], rn(rows.shape[0], D) * 1e-2)
        time(f"K2 R=1 {name}", lambda *a: mh.mix_heads_r1_bwd(*a, K=K), a2,
             lambda *a: mh.lift_act_mix_heads_bwd_plain(*a, R=1, K=K), a2)
        del k1, a2, rows
    const = posterior_constants(cfg.encoder, dev)
    m, zd = const["grid"].shape[0], cfg.encoder.z_dim
    scale = torch.tensor([2.0, 1.0, 0.3] + [1.0] * zd + [0.3] * zd,
                         device=dev)
    k3 = (rn(cs.B, m, 1, 3 + 2 * zd) * scale, const["p_r"],
          const["offsets"], const["p_tr"], const["grid"], const["sig_r"])
    g3 = rn(cs.B, 2 * zd + 5)
    noise = post.philox_gumbel(9, cs.B, 1, m, dev)
    for det, tag in ((False, ""), (True, " deterministic")):
        time("K3 R=1" + tag,
             lambda *a: post.posterior_fwd(9, *a, deterministic=det), k3,
             lambda *a: post.posterior_plain(
                 *a, noise=None if det else noise), k3)
        time("K4 R=1" + tag,
             lambda *a: post.posterior_bwd(9, g3, *a, deterministic=det), k3,
             lambda *a: post.posterior_bwd_plain(
                 g3, *a, noise=None if det else noise), k3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--r1-only", action="store_true",
                    help="time only K1-K4 at R = 1 (mode B)")
    args = ap.parse_args()
    # this checkout's chip_smoke (its timer and its inputs), then the
    # package of the checkout at --root, which chip_smoke imports at call
    # time
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL no CUDA device: the timing runs only on a GPU", flush=True)
        return 1
    import targetvae_tpu_torch.kernels.posterior as post
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.kernels.decoder_mlp import (
        decoder_mlp_bwd, decoder_mlp_bwd_plain, decoder_mlp_fwd,
        decoder_mlp_plain)
    from targetvae_tpu_torch.kernels.decoder_pose import (
        fused_pose_decoder_tables, pose_decoder_bwd, pose_decoder_bwd_plain,
        pose_decoder_plain)
    from targetvae_tpu_torch.kernels.lifted_encoder import (
        lifted_encoder_bwd, lifted_encoder_bwd_plain, lifted_encoder_fwd,
        lifted_encoder_plain)
    from targetvae_tpu_torch.kernels.mix_heads import (
        lift_act_mix_heads_bwd_plain, lift_act_mix_heads_plain, mix_heads_bwd,
        mix_heads_fwd)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cfg = cs.flagship_config()
    ecfg = cfg.encoder
    R, K, zd = ecfg.groupconv, ecfg.kernels_num, ecfg.z_dim
    model = TargetVAE(cfg, device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(13)
    rn = lambda *s: torch.randn(s, generator=gen, device=dev)
    res = {}

    def time(name, kfn, kargs, pfn, pargs, yfn=None, yargs=None):
        row = {"ms": cs.device_ms(kfn, kargs),
               "plain_ms": cs.device_ms(pfn, pargs)}
        if yfn is not None:
            row["yardstick_ms"] = cs.device_ms(yfn, yargs)
        res[name] = row
        print(f"{name}: " + json.dumps({k: round(v, 5) for k, v in row.items()}),
              flush=True)

    if args.r1_only:
        with torch.inference_mode():
            r1_kernels(cs, torch, dev, rn, time)
        print(json.dumps({"root": os.path.abspath(args.root), "card": smi,
                          "device": torch.cuda.get_device_name(0),
                          "kernels": res}), flush=True)
        return 0
    with torch.inference_mode():
        k1, _, k7, _, k9, _, k11, _ = cs.kernel_inputs(params, cfg, dev)
        heads_args = cs.posterior_inputs(torch, ecfg, cs.B, dev)
        heads = heads_args[0]
        b = heads.shape[0]
        total = lambda a: sum(t.numel() for t in a if torch.is_tensor(t))
        flat = rn(b, total(heads_args) // b)
        ysum = lambda x: x.view(b, -1).sum(1)
        yneg = lambda x: torch.neg(x)
        k3 = heads_args
        g3 = rn(b, 2 * zd + 5)
        noise = post.philox_gumbel(9, b, R, heads.shape[1], dev)
        for det, tag in ((False, ""), (True, " deterministic")):
            time("K3" + tag,
                 lambda *a: post.posterior_fwd(9, *a, deterministic=det),
                 k3, lambda *a: post.posterior_plain(
                     *a, noise=None if det else noise), k3, ysum, (flat,))
            time("K4" + tag,
                 lambda *a: post.posterior_bwd(9, g3, *a, deterministic=det),
                 k3, lambda *a: post.posterior_bwd_plain(
                     g3, *a, noise=None if det else noise), k3, yneg, (flat,))
        del k3, heads_args, heads, flat
        shards, _ = cs.sp_shard_inputs(torch, cfg, dev, True)
        a5 = shards[0]
        planes = "planes" in inspect.signature(
            post.posterior_shard_fwd).parameters
        k5 = cs.as_planes(a5) if planes else a5
        sig_r = float(np.pi / R)
        flat5 = rn(b, total(a5) // b)
        g5 = rn(b, 2 * zd + 5)
        time("K5", lambda *a: post.posterior_shard_fwd(*a, sig_r), k5,
             lambda *a: post.posterior_shard_plain(*a, sig_r), a5,
             ysum, (flat5,))
        time("K6", lambda *a: post.posterior_shard_bwd(*a, sig_r, g5), k5,
             lambda *a: post.posterior_shard_bwd_plain(*a, sig_r, g5), a5,
             yneg, (flat5,))
        del shards, a5, flat5
        time("K1", lambda *a: mix_heads_fwd(*a, R=R, K=K), k1,
             lambda *a: lift_act_mix_heads_plain(*a, R=R, K=K), k1)
        a2 = (*k1[:5], rn(k1[0].shape[0], R * (3 + 2 * zd)))
        time("K2", lambda *a: mix_heads_bwd(*a, R=R, K=K), a2,
             lambda *a: lift_act_mix_heads_bwd_plain(*a, R=R, K=K), a2)
        time("K7", fused_pose_decoder_tables, k7, pose_decoder_plain, k7)
        y7, hs = fused_pose_decoder_tables(*k7, save_res=True)
        a8 = (*k7[:4], hs, k7[5], k7[7], k7[9], rn(*y7.shape))
        time("K8", pose_decoder_bwd, a8, pose_decoder_bwd_plain, a8)
        del hs, a8
        time("K9", decoder_mlp_fwd, k9, decoder_mlp_plain, k9)
        a10 = (*k9, rn(*k9[0].shape[:2], 1))
        time("K10", decoder_mlp_bwd, a10, decoder_mlp_bwd_plain, a10)
        time("K11", lambda *a: lifted_encoder_fwd(*a, R=R, K=K), k11,
             lambda *a: lifted_encoder_plain(*a, R=R, K=K), k11)
        _, h1 = lifted_encoder_fwd(*k11, R=R, K=K, save_h1=True)
        a12 = (k11[0], h1, *k11[3:6], rn(k11[0].shape[0], R * (3 + 2 * zd)))
        time("K12", lambda *a: lifted_encoder_bwd(*a, R=R, K=K), a12,
             lambda *a: lifted_encoder_bwd_plain(*a, R=R, K=K), a12)
        del h1, a12, k1, k7, k9, k11
        r1_kernels(cs, torch, dev, rn, time)

    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    y = torch.from_numpy(cs.synthetic_images(cs.B, ecfg.image_dim, 3)).to(dev)
    x_coord = model.base_grid()
    sample = torch.Generator().manual_seed(5)
    stage = {}
    for tier in ("conv", "patch"):
        with cs.encoder_tier(tier):
            trainer = Trainer(cfg, TrainConfig(compute_dtype="bfloat16",
                                               minibatch_size=cs.B),
                              device=dev)
            state = trainer.init_state(0)
            stage[tier + " train"] = cs.posterior_stage(cs.device_ops(
                torch, lambda: trainer.train_step(state, y)))
            with torch.inference_mode():
                stage[tier + " eval"] = cs.posterior_stage(cs.device_ops(
                    torch, lambda: model.elbo(params, x_coord, y, sample,
                                              torch.bfloat16)))
            del trainer, state
        for key in (tier + " train", tier + " eval"):
            print(f"stage {key}: " + json.dumps(stage[key]), flush=True)
    from targetvae_tpu_torch.parallel.distributed import run_local
    stage["sp train"] = run_local(sp_stage_rank, 2, backend="gloo",
                                  timeout=cs.SP_TIMEOUT)[0]
    print("stage sp train: " + json.dumps(stage["sp train"]), flush=True)
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi,
                      "device": torch.cuda.get_device_name(0),
                      "shard_contract": "planes" if planes else "separate",
                      "kernels": res,
                      "stage": {k: {n: v for n, v in s.items()
                                    if n.endswith("_ms")}
                                for k, s in stage.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
