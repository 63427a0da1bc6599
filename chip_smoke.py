#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (targetvae_tpu_torch) on one GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It builds the
hand-written kernels from targetvae_tpu_torch/csrc/ (into the ignored
targetvae_tpu_torch/build/), then, at the full flagship width (50x50x1
images, mode C, P8, K=128, k=28, padding 8, z=2, Fourier decoder F=1024,
hidden 512, 2 layers, Bernoulli, bf16 compute, batch 100; random weights
from a seed):

  1. prints the card (nvidia-smi name and power limit) and the versions;
  2. holds each kernel against its plain PyTorch version at flagship shapes,
     and the sampled posterior by seed, batch split and distribution;
  3. embeds ~1,000 synthetic images with embed_dataset (bf16 serving tier);
  4. evaluates the held-out ELBO over a few batches in bf16, and against the
     float32 tier with deterministic noise;
  5. times each kernel against its plain version, embed and eval img/s.

Every failed check exits non-zero. With no CUDA device, or outside a
checkout, it fails without printing a result. Its last line is
{"ok": true, "device": {...}}; the line before it is the kernels' JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

B = 100             # batch
N_EMBED = 1000      # images embedded in phase 3
EVAL_BATCHES = 3    # batches of the held-out ELBO in phase 4
SEEDS = 64          # seeds for the sampled-posterior distribution check
TOL_K1 = 5e-3       # abs, kernel vs plain (same bf16 rounding points; f32 sum order)
TOL_K3 = 1e-4       # abs per unit of max(1, |value|), deterministic posterior
TOL_K7 = 1e-2       # abs, kernel vs plain pose decoder
TOL_ELBO = 2e-2     # rel, bf16 kernel tier vs float32 tier, deterministic noise
TOL_DX = 2e-2       # abs, bf16 vs float32 embed dx (half an attention-grid pitch)


class CheckFailed(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    print(("PASS " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        raise CheckFailed(msg)


def flagship_config():
    from targetvae_tpu_torch.utils.config import (
        EncoderConfig, GeneratorConfig, LikelihoodConfig, ModelConfig)
    d = 50
    return ModelConfig(
        generator=GeneratorConfig(z_dim=2, hidden_dim=512, n_out=1,
                                  num_layers=2, fourier_expansion=True,
                                  fourier_sigma=2.0 / (d - 1)),
        encoder=EncoderConfig(t_inf="attention", r_inf="attention+offsets",
                              image_dim=d, in_channels=1, z_dim=2,
                              kernels_num=128, kernels_size=28, padding=8,
                              groupconv=8, theta_prior=np.pi,
                              normal_prior_over_r=False),
        likelihood=LikelihoodConfig(kind="bernoulli"))


def synthetic_images(n: int, d: int, seed: int) -> np.ndarray:
    """MNIST-U-shaped stand-ins: three Gaussian strokes per image at random
    positions, in [0, 1], (n, d, d, 1) float32."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-1, 1, d, dtype=np.float32)
    yy, xx = np.meshgrid(g, g, indexing="ij")
    img = np.zeros((n, d, d), np.float32)
    for _ in range(3):
        cx, cy = rng.uniform(-0.5, 0.5, (2, n, 1, 1)).astype(np.float32)
        sx, sy = rng.uniform(0.05, 0.25, (2, n, 1, 1)).astype(np.float32)
        img += np.exp(-((xx - cx) / sx) ** 2 - ((yy - cy) / sy) ** 2)
    return np.clip(img, 0, 1)[..., None]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() in ms over `reps` calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_inputs(params, cfg, dev):
    """Flagship-shape inputs for each kernel: K1 from the real lift conv of
    synthetic images, K3 and K7 seeded like tests/test_kernels.py."""
    import torch
    from targetvae_tpu_torch.models.encoders import head_weights, lift_rows
    from targetvae_tpu_torch.kernels.decoder_pose import pose_tables

    ecfg, gcfg = cfg.encoder, cfg.generator
    R, K, zd = ecfg.groupconv, ecfg.kernels_num, ecfg.z_dim
    pe, pg = params["encoder"], params["generator"]
    y = torch.from_numpy(synthetic_images(B, ecfg.image_dim, 1)).to(dev)
    rows, hp = lift_rows(pe, ecfg, y)
    wh, bh = head_weights(pe)
    k1 = (rows, pe["conv1"]["b"].repeat(R), pe["conv2"]["w"], pe["conv2"]["b"],
          wh, bh)

    M = hp * hp
    g = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    from targetvae_tpu_torch.ops.coords import attention_grid
    p_tr = torch.log_softmax(rn(R * M), dim=0).reshape(R, M)
    grid = torch.as_tensor(attention_grid(hp, ecfg.image_dim), device=dev)
    offs = torch.as_tensor([2 * np.pi * r / R for r in range(R)],
                           dtype=torch.float32, device=dev)
    offs = torch.where(offs > np.pi, offs - 2 * np.pi, offs)
    k3 = (rn(B, R, M) * 2, rn(B, R, M), rn(B, R, M) * 0.3, rn(B, zd, R, M),
          rn(B, zd, R, M) * 0.3, p_tr, grid, offs, float(np.pi / R))

    theta, dx, z = rn(B), rn(B, 2) * 0.2, rn(B, zd)
    wf = pg["fourier"]["w"] / gcfg.fourier_sigma
    u, v, p, q = pose_tables(theta, dx, wf, pg["fourier"]["b"], ecfg.image_dim)
    k7 = (u, v, p, q, z @ pg["latent_linear"]["w"], pg["coord_linear"]["w"],
          pg["coord_linear"]["b"], torch.stack([h["w"] for h in pg["hidden"]]),
          torch.stack([h["b"] for h in pg["hidden"]]), pg["out"]["w"],
          pg["out"]["b"])
    return k1, k3, k7


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "targetvae_tpu_torch")):
        print("FAIL chip_smoke.py must run from a checkout holding "
              "targetvae_tpu_torch/", flush=True)
        return 1
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        print("FAIL no CUDA device: this smoke test runs only on a GPU",
              flush=True)
        return 1
    try:
        return run(torch, torch.device("cuda", 0))
    except CheckFailed:
        return 1


def run(torch, dev) -> int:
    import targetvae_tpu_torch.kernels as kernels
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.cli.clustering_common import embed_dataset
    from targetvae_tpu_torch.kernels import _build
    from targetvae_tpu_torch.kernels.decoder_pose import (
        fused_pose_decoder_tables, pose_decoder_plain)
    from targetvae_tpu_torch.kernels.mix_heads import (
        fused_lift_act_mix_heads, lift_act_mix_heads_plain)
    from targetvae_tpu_torch.kernels.posterior import (
        fused_posterior, per_image_gumbel, posterior_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16 = torch.bfloat16

    # ---- phase 1: the card, the versions, the build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(card, flush=True)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(f"phase 1: python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, nvcc: {nvcc[-1] if nvcc else '?'}; "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower():
            print("  ptxas:", line.strip(), flush=True)

    cfg = flagship_config()
    model = TargetVAE(cfg, device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    zd = cfg.encoder.z_dim
    results = {}

    with torch.inference_mode():
        # ---- phase 2: each kernel against its plain version ----
        k1, k3, k7 = kernel_inputs(params, cfg, dev)
        R, K = cfg.encoder.groupconv, cfg.encoder.kernels_num
        o_k = fused_lift_act_mix_heads(*k1, R=R, K=K)
        o_p = lift_act_mix_heads_plain(*k1, R=R, K=K)
        torch.cuda.synchronize()
        err1 = float((o_k - o_p).abs().max())
        check(bool(torch.isfinite(o_k).all()) and err1 <= TOL_K1,
              f"phase 2: K1 mix_heads_fwd {tuple(k1[0].shape)} -> "
              f"{tuple(o_k.shape)}: max_abs_err {err1:.3e} <= {TOL_K1}")
        results["mix_heads_fwd"] = {"max_abs_err": err1}

        det_k = fused_posterior(7, *k3, deterministic=True)
        det_p = posterior_plain(*k3)
        torch.cuda.synchronize()
        err3 = 0.0
        for name in det_p:
            e = float(((det_k[name] - det_p[name]).abs()
                       / det_p[name].abs().clamp(min=1.0)).max())
            err3 = max(err3, e)
        abs3 = max(float((det_k[n] - det_p[n]).abs().max()) for n in det_p)
        check(err3 <= TOL_K3,
              f"phase 2: K3 posterior_fwd deterministic {tuple(k3[0].shape)}: "
              f"max err {err3:.3e} (abs {abs3:.3e}) <= {TOL_K3} * max(1, |ref|)")
        results["posterior_fwd"] = {"max_abs_err": abs3}

        s1 = fused_posterior(11, *k3)
        s2 = fused_posterior(11, *k3)
        check(all(torch.equal(s1[n], s2[n]) for n in s1),
              "phase 2: K3 sampled: same seed gives identical output")
        half = [fused_posterior(11 + i, *(t[i:i + B // 2] for t in k3[:5]),
                                *k3[5:]) for i in (0, B // 2)]
        check(all(torch.equal(s1[n], torch.cat([h[n] for h in half]))
                  for n in s1),
              "phase 2: K3 sampled: rows identical for batch 100 vs 2 x 50")
        kl_err = float((s1["kl"] - det_k["kl"]).abs().max())
        check(kl_err <= 1e-6 * float(det_k["kl"].abs().max().clamp(min=1.0)),
              f"phase 2: K3 sampled kl equals deterministic kl (max diff "
              f"{kl_err:.3e})")
        keys = [("dx", 0), ("dx", 1), ("z_mu_e", 0), ("z_mu_e", 1),
                ("theta_mu_e", None)]
        pick = lambda o, k, i: (o[k] if i is None else o[k][:, i]).mean()
        mk = np.zeros((SEEDS, len(keys)))
        mp = np.zeros((SEEDS, len(keys)))
        for s in range(SEEDS):
            ok_ = fused_posterior(1000 + s * B, *k3)
            noise = per_image_gumbel(1000 + s * B, k3[0].shape, dev)
            op_ = posterior_plain(*k3, noise=noise)
            mk[s] = [float(pick(ok_, k, i)) for k, i in keys]
            mp[s] = [float(pick(op_, k, i)) for k, i in keys]
        se = np.sqrt(mk.var(0, ddof=1) / SEEDS + mp.var(0, ddof=1) / SEEDS)
        z = np.abs(mk.mean(0) - mp.mean(0)) / np.maximum(se, 1e-12)
        check(bool((z <= 4.0).all()),
              f"phase 2: K3 sampled: means over {SEEDS} seeds of dx, z_mu_e, "
              f"theta_mu_e within 4 standard errors of plain "
              f"(|diff|/se = {np.round(z, 2).tolist()})")

        y7k = fused_pose_decoder_tables(*k7)
        y7p = pose_decoder_plain(*k7)
        torch.cuda.synchronize()
        err7 = float((y7k - y7p).abs().max())
        check(bool(torch.isfinite(y7k).all()) and err7 <= TOL_K7,
              f"phase 2: K7 pose_decoder_fwd {tuple(k7[0].shape)} -> "
              f"{tuple(y7k.shape)}: max_abs_err {err7:.3e} <= {TOL_K7}")
        results["pose_decoder_fwd"] = {"max_abs_err": err7}

        # ---- phases 3 and 4: the main path, with launch counts ----
        images = synthetic_images(N_EMBED, cfg.encoder.image_dim, 2)
        kernels.reset_launch_counts()
        z_c, rot, tr = embed_dataset(model, params, images, B, "bfloat16")
        embed_counts = kernels.launch_counts()
        ok3 = (z_c.shape == (N_EMBED, 2 * zd) and rot.shape == (N_EMBED, 1)
               and tr.shape == (N_EMBED, 2)
               and all(np.isfinite(a).all() for a in (z_c, rot, tr)))
        check(ok3 and embed_counts["mix_heads_fwd"] > 0,
              f"phase 3: embed_dataset bf16 over {N_EMBED} images: shapes "
              f"{z_c.shape} {rot.shape} {tr.shape}, finite, launches "
              f"{embed_counts}")
        yb = torch.from_numpy(images[:B]).to(dev)
        dx32 = model.embed(params, yb)["dx"].cpu().numpy()
        dx_err = float(np.abs(tr[:B] - dx32).max())
        check(dx_err <= TOL_DX, f"phase 3: bf16 vs float32 embed dx max abs "
              f"diff {dx_err:.3e} <= {TOL_DX}")

        x_coord = model.base_grid()
        gen = torch.Generator().manual_seed(5)
        elbos = []
        for i in range(EVAL_BATCHES):
            yb = torch.from_numpy(images[i * B:(i + 1) * B]).to(dev)
            elbos.append([float(t) for t in model.elbo(
                params, x_coord, yb, gen, compute_dtype=bf16)])
        counts = kernels.launch_counts()
        check(bool(np.isfinite(elbos).all())
              and all(v > 0 for v in counts.values()),
              f"phase 4: held-out ELBO bf16 over {EVAL_BATCHES} batches "
              f"(elbo, log_p, kl) = {np.round(elbos, 3).tolist()}, launches "
              f"{counts}")
        yb = torch.from_numpy(images[:B]).to(dev)
        e16 = [float(t) for t in model.elbo(params, x_coord, yb, None, bf16)]
        e32 = [float(t) for t in model.elbo(params, x_coord, yb, None, None)]
        rel = abs(e16[0] - e32[0]) / abs(e32[0])
        check(rel <= TOL_ELBO,
              f"phase 4: deterministic ELBO bf16 kernels {e16[0]:.4f} vs "
              f"float32 tier {e32[0]:.4f}: rel diff {rel:.3e} <= {TOL_ELBO}")
        main_counts = kernels.launch_counts()

        # ---- phase 5: timings ----
        for name, kfn, pfn in (
                ("mix_heads_fwd",
                 lambda: fused_lift_act_mix_heads(*k1, R=R, K=K),
                 lambda: lift_act_mix_heads_plain(*k1, R=R, K=K)),
                ("posterior_fwd",
                 lambda: fused_posterior(9, *k3),
                 lambda: posterior_plain(*k3, noise=k3[0])),
                ("pose_decoder_fwd",
                 lambda: fused_pose_decoder_tables(*k7),
                 lambda: pose_decoder_plain(*k7))):
            p1, k1_, k2_, p2 = (cuda_ms(pfn), cuda_ms(kfn), cuda_ms(kfn),
                                cuda_ms(pfn))
            results[name].update(ms=min(k1_, k2_), plain_ms=min(p1, p2))
            print(f"phase 5: {name}: kernel {k1_:.4f} / {k2_:.4f} ms, plain "
                  f"{p1:.4f} / {p2:.4f} ms (plain, kernel, kernel, plain)",
                  flush=True)

        def embed_all():
            embed_dataset(model, params, images, B, "bfloat16")
        embed_all()
        torch.cuda.synchronize()
        t = time.perf_counter()
        embed_all()
        torch.cuda.synchronize()
        embed_s = time.perf_counter() - t
        yb = torch.from_numpy(images[:B]).to(dev)
        eval_ms = cuda_ms(lambda: model.elbo(params, x_coord, yb, gen, bf16))
        print(f"phase 5: embed {N_EMBED / embed_s:.1f} img/s (embed_dataset, "
              f"B={B}, bf16, host to host); eval {B / eval_ms * 1e3:.1f} img/s "
              f"(ELBO bf16, B={B}, {eval_ms:.3f} ms/batch, device time)",
              flush=True)

    sources = {"mix_heads_fwd": ("targetvae_tpu_torch/csrc/mix_heads.cu",
                                 "targetvae_tpu/kernels/mix_heads.py:232"),
               "posterior_fwd": ("targetvae_tpu_torch/csrc/posterior.cu",
                                 "targetvae_tpu/kernels/posterior.py:241"),
               "pose_decoder_fwd": ("targetvae_tpu_torch/csrc/decoder_pose.cu",
                                    "targetvae_tpu/kernels/decoder_pose.py:390")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_counts[name], **results[name]}
        for name, (src, rep) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
