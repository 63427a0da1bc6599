#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (targetvae_tpu_torch) on one GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It builds the
hand-written kernels from targetvae_tpu_torch/csrc/ (into the ignored
targetvae_tpu_torch/build/), then, at the full flagship width (50x50x1
images, mode C, P8, K=128, k=28, padding 8, z=2, Fourier decoder F=1024,
hidden 512, 2 layers, Bernoulli, bf16 compute, batch 100; random weights
from a seed):

  1. prints the card (nvidia-smi name and power limit) and the versions;
  2. holds each forward kernel against its plain PyTorch version at flagship
     shapes, the sampled posterior (K3) against its plain version fed the
     kernel's own Philox noise, by seed, batch split and distribution;
  3. embeds ~1,000 synthetic images with embed_dataset (bf16 serving tier);
  4. evaluates the held-out ELBO over a few batches in bf16, and against the
     float32 tier with deterministic noise;
  5. times each forward kernel against its plain version (device_ms: CUDA
     graph replays, inputs cold in L2), embed and eval img/s; K13 (the
     conv tier's lift) at the flagship and at mnist-b-p8's image-sized
     lift held against the float32 sums of its plain version and timed
     beside its bound and cuDNN's bf16 conv (library_ms);
  6. holds each backward kernel (K2, K4, K8, K10, K12) and K7's
     save-residuals mode against its plain version at flagship shapes (K12
     also at the galaxy encoder's C = 3 shape), the sampled K4 against its
     plain version fed the kernel's noise and against a central difference
     of K3's own forward, and K3 and K4 (not timed) at P16, at dSprites'
     H' = 65 (also streamed through a cluster of 4 CTAs) and at z = 8;
     and the bf16 ELBO at z_dim 8 and 10, past the encoder kernels' 16
     heads (and at 10 past K3/K4's z <= 8), against the float32 tier;
  7. trains: ~30 bf16 Trainer.train_step calls on fixed synthetic batches
     (finite, rising ELBO; every kernel launched), and one deterministic
     step's gradients on the bf16 kernel tier against the float32 tier;
  8. times each backward kernel against its plain version, K8's, K10's and
     K12's passes one by one (profiler), K7 with and without saved
     residuals, one cuBLAS bf16 GEMM at the decoders' layer-1 shape and one
     at K12's dWc shape as yardsticks, the train step's img/s, and the
     posterior stage (profiler: the device ops between the encoder kernel
     and K7, and between K8 and K2 or K12) of the train step and the eval
     batch on each tier;
  9. decodes at posed coordinates in bf16 (K9) against float32, and takes
     a gradient through it (K10); times bf16 decode of the batch (img/s,
     device ms) with and without the gradient;
 10. the grid-sharded (sequence-parallel) posterior: K5/K6 against their
     plain versions at the two-rank shard shape (B=100, 6,144 of the
     12,288 padded cells; z_dim 2, 8 and 10; a shard that is no multiple
     of the CTA's chunk; B=100 against two batches of 50), then the SP
     bf16 Trainer (tp=2, sp=True) as two ranks sharing cuda:0 over gloo
     (run_local): one deterministic step against the unsharded step (loss
     and gradients), SP_STEPS sampled steps (finite, rising ELBO, K5/K6
     launched every step, K3/K4 never, parameters bitwise equal across
     ranks), a profile of rank 0 and its posterior stage;
 11. the bf16 tier at a generator width no decoder kernel takes (hidden
     384): eval, three train steps and decode, the generator on the XLA
     bf16 recipe, no decoder kernel launched;
 12. the training run through the CLI on each encoder tier:
     targetvae_tpu_torch.cli.train_mnist.main in-process on an MNIST-U
     directory of synthetic images (1,050 train, 250 test, each split
     ending in a 50-image tail), 3 epochs with snapshots every 2: finite
     TSV lines, a rising test ELBO, the checkpoints written, K1-K4, K7, K8
     (patch tier: K11, K12, K3, K4, K7, K8) launched once a step and once
     a test batch, tails included, and load_encoder's embed of
     inference.sav bitwise the run's own; then a resume of the conv-tier
     run to epoch 4, whose loaded parameters and Adam moments equal the
     saved ones bitwise. Each tier's epoch img/s (the CLI's own line) is
     printed beside phase 8's train_step img/s.
 13. the other inference modes at full width, tools/bench_config.py's
     mnist-a (mode A, an MLP), mnist-b (mode B, one 50 x 50 conv) and
     mnist-b-p8 (mode B, a P8 lift and fc_r): K1 and K2 at R = 1 with the
     rectangular mixing (KI = 128 and 1,024) and K3 and K4 at R = 1 over
     the 2,601 cells, each against its plain version and timed;
     embed_dataset, the held-out and the deterministic ELBO (against
     float32), one deterministic step's gradients against float32, 20
     sampled train steps (each of the mode's kernels launched once a
     step: mode A K7, K8; mode B K1-K4 at R = 1, K7, K8), and train, eval
     and embed img/s (mode B also the lift's share: K13 and its cuDNN
     weight gradient);
 14. clustering through the CLIs: tools/make_synthetic_shapes.py writes a
     labelled MNIST-U directory (1,050 train, 250 test images), train_mnist
     trains 2 epochs in mode C (conv tier) and in mode B (groupconv 0),
     clustering_mnist clusters each run's test latents (bf16, k-means, 5
     clusters): results.txt with a finite accuracy and three finite
     correlations; then the time of k-means with 100 restarts on the card.
 15. the particles model at the EMPIAR-10025 shape, full width, B = 100
     (110 x 110, mode C, P8, K = 128, k = 64, padding 16: 49,928 cells
     an image, 624,100 positions a batch; Gaussian with 109 x 109 CTF
     kernels and mask radius 45): K1, K2, K3, K4, K7 and K8 (n_out 1 and
     2), K11 and K12 (the patches' 2.56e9 elements) against their plain
     versions and timed; the deterministic bf16 ELBO of each encoder tier
     and its CTF-filtered decoded mean against float32, one deterministic
     step's gradients (the CTF tables in physical units); 20 sampled
     train steps on each tier (finite, rising ELBO, each kernel once a
     step); train, eval and embed img/s on each tier and the lift's (K13
     and its cuDNN weight gradient) share of the conv tier's step; then train_particles (2 epochs of
     tools/make_synthetic_particles_torch.py's stand-in, 1,050 / 250 by
     --train-portion, --mask-radius 45 --normalize, CTF) and
     clustering_particles on its inference.sav: finite TSV lines, the _ctf
     tag, launches once a step, cluster_assignments.npy, results.txt; then
     one epoch with --fit-noise and no CTF table, held the same way (with
     a CTF table the variance is CTF-filtered and a --fit-noise run
     diverges, in the JAX package as in the port).
 16. dSprites and galaxy through their CLIs at full width: train_dsprites
     and train_galaxy 2 epochs each on the synthetic tools' data (launches
     once a step, K7 and K8 at galaxy's depth 4 and n_out 3), then
     clustering_dsprites and clustering_galaxy; each config's bf16 train
     step on each encoder tier (img/s).
 17. the host feed at the EMPIAR shape (bf16, B = 100) on
     tools/make_synthetic_particles_torch.py's stand-in of 2,050
     particles with CTF (a 50-image tail): the native library's build
     time (phase 1), load_mrc_f32 and gather_f32 bitwise numpy's; every
     streamed row (y and CTF) and weight of an epoch on the float32 and
     the bf16 wire against the numpy gather of the pipeline's own order
     (per-row checksums on the card), the tail's 50 weights of 1/50 and 50
     of zero; train_epoch_stream on the patch tier bitwise its
     train_steps on the same batches, K11, K12, K3, K4, K7 and K8 once a
     step; a 3-batch streamed epoch on the conv tier (K1, K2);
     eval_epoch_stream against eval_epoch; resident against streamed
     epoch img/s on each wire at EMPIAR and at the flagship (patch tier),
     the consumer's wait and the copy's device time a batch, and, from one
     profiler window, the host-to-device copies on the side stream that
     overlap a kernel (at least one a step).
 18. ranks sharing the card over gloo (run_local): dp = 2 at EMPIAR
     (patch tier, CTF) - one deterministic step against the one-process
     step (PERF.md section 2's SP bounds), 10 sampled steps with the
     parameters bitwise equal across the ranks, a ragged resident epoch of
     1,025 particles (the tail of 25 padded to 26) at learning rate 0
     against one process, a host-streamed epoch with each rank gathering
     its rows; SP with tp = 2 at EMPIAR with CTF and a zero-weight pad
     against the unsharded step, K5 and K6 once each a rank; dp = 2 x tp
     = 2 SP on 4 ranks at the flagship against the unsharded step; then
     torchrun --standalone --nproc_per_node 2 -m
     targetvae_tpu_torch.cli.train_particles --dp 2 --host-stream
     --stream-bf16 (1,050 / 250 particles with CTF, 2 epochs, patch tier:
     one run directory, rank 0's, finite test ELBOs), and a single-process
     --host-stream run resumed after 1 epoch, bitwise equal to 2 epochs at
     once.
 19. the rest of the (data, model) mesh on ranks sharing the card over
     gloo: (a) dp = 2 x tp = 2 (4 ranks; the parameters and Adam's moments
     sharded over the model axis) at the flagship, bf16, each encoder
     tier: one deterministic step against the one-process step (section
     2's SP bounds), TP_STEPS sampled steps (finite, rising ELBO, each
     kernel of the tier once a step on each rank, the gathered parameters
     bitwise equal across the ranks), each rank's bytes of whole
     parameters, their gradients and Adam's moments against one
     process's; (b) a ragged
     epoch of 2 B - 1 images there at learning rate 0 against one process
     (two steps, the tail's weights); the multichip dry run's four
     scenarios at the JAX dry run's shapes on the same ranks; then on 2
     ranks (tp = 2): (c) mode B at mnist-b width with the Gaussian
     likelihood, 49 x 49 CTF kernels and the mask, TP-sharded, one
     deterministic step against one process, then sampled steps; (d)
     mode B's bf16 SP step at mnist-b and mnist-b-p8: K5/K6 at R = 1 on
     the 100 x 2,048-cell shard against their plain versions and timed,
     the deterministic step against the unsharded step, MODE_B_SP_STEPS
     sampled steps with K5/K6 once a step and K3/K4 never; (e) the float32
     SP step at the flagship, deterministic and sampled, against the
     unsharded float32 step from the same generator state; (f) torchrun
     --standalone --nproc-per-node 4 -m targetvae_tpu_torch.cli.
     train_mnist --dp 2 --tp 2 (phase 12's synthetic split, 2 epochs),
     then its checkpoint resumed in one process, the loaded parameters and
     Adam moments bitwise the saved ones.
 20. the reference's pickled .sav files, the serving tools and the
     figures: each mode's encoder at full width (the flagship's mode C,
     mnist-a, mnist-b, mnist-b-p8) exported as the reference's
     inference.sav and imported bitwise (config and parameters), its bf16
     embed_dataset through load_encoder bitwise the original's with the
     encoder kernel once a batch (K1 and K11; K1 at R = 1 in mode B);
     embed_stack on a 1,000-image flagship .mrcs and on phase 17's 2,050
     EMPIAR particles on each tier, bitwise embed_dataset's, img/s with
     the MRC read; export_torch_checkpoint of phase 12's run directory,
     read back bitwise; clustering_mnist on the exported inference.sav
     with its PNG figures; reconstruct on the exported pair (its PNG's
     size, its float32 decode against the CPU's); the t-SNE on the card at
     N = 1,000 and 10,000, timed, its P against the CPU's. Phases 14-16
     also check each clustering CLI's PNG figures (signature, CRC, size)
     and that no "not written" line appears.
 21. the measurement layer: tools/bench_config_torch.py's bf16 train step
     of each of its nine configs (tools/bench_config.py's: the flagship,
     P16, modes A and B, dSprites, galaxy, particles with and without CTF)
     at its default batch, mode C on each encoder tier: ms/step (median of
     BENCH_WINDOWS windows of BENCH_STEPS steps between CUDA events),
     img/s, TFLOP/step (targetvae_tpu_torch/utils/flops.py::step_flops)
     and MFU against the bf16 peak, each in (0, 1), each kernel of the
     step launched once a step; then one step each of the flagship (each
     tier), mnist-b-p8 and particles-ctf under FlopCounterMode, whose
     count of cuDNN's and cuBLAS's products plus the kernels' own
     (flops.kernel_products over the step's launches, the recomputed
     products left out, and K13's, flops.lift_conv_products) equals
     step_flops within TOL_FLOPS.

Phases 2-8 cover both mode-C encoder tiers: the default "conv" tier (the
lift on K13, its weight gradient on cuDNN, K1/K2) and the fused patch encoder (K11/K12) that
TARGETVAE_ENCODER_TIER=patch selects (phases 3, 4 and 7 drive each tier's
embed, eval and train path; phases 2 and 6 also check K11 and K12 at the
galaxy encoder's C = 3 shape). Each of phases 3, 4, 6 (the z_dim routes),
7, 9, 10, 11, 12, 13, 15, 16, 17, 18, 19, 20 and 21 sets the launch counts to 0
just before it drives its path and reads them just after (phases 10, 18
and 19 in each rank). Every failed check exits
non-zero. With no CUDA device, or outside a checkout, it fails without
printing a result. Its last line is {"ok": true, "device": {...}}; the line
before it is the kernels' JSON.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

B = 100             # batch
N_EMBED = 1000      # images embedded in phase 3
EVAL_BATCHES = 3    # batches of the held-out ELBO in phase 4
SEEDS = 64          # seeds for the sampled-posterior distribution check
TRAIN_STEPS = 30    # flagship train steps in phase 7 (conv tier)
PATCH_STEPS = 10    # and on the patch tier, from fresh weights
TRAIN_BATCHES = 5   # fixed synthetic batches they cycle through
B_GALAXY = 8        # images of the C = 3 shape K11 is checked at
TOL_K1 = 5e-3       # abs, kernel vs plain (same bf16 rounding points; f32 sum order)
TOL_K11 = TOL_K1    # abs, as K1: the same heads from a bf16 h1 one step apart at most
TOL_K3 = 1e-4       # abs per unit of max(1, |value|), deterministic posterior
TOL_K7 = 1e-2       # abs, kernel vs plain pose decoder
TOL_K9 = TOL_K7     # abs, as K7: the decoder chain on other features
# K9's on-chip features against the plain version's bf16(cos(phase)): the
# kernel's accurate cosf and torch.cos may differ by an ulp, which moves a
# bf16 feature by one step (2^-8) only where the value sits at a rounding
# boundary, about 2^-16 of the entries; __cosf's error at phases of tens of
# radians would move most of them
TOL_FEAT_SHARE = 1e-4
# patch tier vs conv tier, each encoder head, relative L2: the conv tier
# rounds the lift conv's output to bf16 before its bias and activation, the
# patch tier does not: h1 one bf16 step (2^-8) apart where they differ
TOL_TIER = 2e-2
TOL_ELBO = 2e-2     # rel, bf16 kernel tier vs float32 tier, deterministic noise
TOL_DX = 2e-2       # abs, bf16 vs float32 embed dx (half an attention-grid pitch)
# Backward kernels against their plain versions, which round at the same
# points: the f32 outputs differ by summation order only, so 1e-3 relative
# L2 per output (K2's and K8's sums run over 152,100 positions and 250,000
# pixels); K7's saved bf16 h may sit one bf16 step from the plain value
# where a sum lands near a rounding boundary: max abs error <= 2^-7 of its
# largest magnitude.
TOL_BWD_REL = 1e-3
# K10 recomputes its forward, as the TPU kernel does, so unlike K8 it does
# not share the h tiles with the plain version: where an f32 sum lands near
# a bf16 rounding boundary the two h sit one step apart and a leaky slope
# near zero may flip; 5e-3 relative L2 per output
TOL_K10_REL = 5e-3
# K2's bf16 dpre1: K2 recomputes pre2 = h1 W2 + b2 as a sum in another order
# than the plain version's. Where that sum lies within the two orders' f32
# rounding of zero its sign, and with it the leaky slope (1 or 0.01) of the
# whole (position, rotation) row of dpre1, may differ between the two.
# Outside such rows dpre1 must sit within one bf16 step (1/128) of its
# largest magnitude; each row beyond that must come within the same step of
# the plain row once the slope is flipped at some of its near-zero pre2
# entries (at most K2_MAX_FLIPS). Over all N x R*K entries, relative L2
# <= 1e-2.
K2_MAX_FLIPS = 4
TOL_DPRE1_REL = 1e-2
TOL_K4 = 1e-4       # abs per unit of max(1, |value|), as K3: same f32 formulas
# K4's cotangents each scale with their cell's softmax weight (a typical
# cell's is ~1e-5 at the flagship), so TOL_K4 alone compares only the few
# dominant cells. Each element is also held to its own magnitude: |got - ref|
# <= TOL_K4_SCALED (|ref| + K4_FLOOR max |ref|), the max over its image's
# cells in its channel (scaled_err). The limit lies between what rounding
# alone moves (the float32 plain version against a float64 one) and what
# two planted faults move (the e^q S2 term dropped in the cells below 1e-3
# of their image's largest weight; one CTA's noise counters shifted by
# one), each read at every shape K4 is checked at (planted_k4_faults; the
# card's readings in PERF.md).
K4_FLOOR = 1e-3
TOL_K4_SCALED = 1e-2
# the sampled K3 and K4 against their plain versions fed the kernels' own
# noise (philox_gumbel): the same formulas on the same uniforms, whose two
# logs (the card's logf, torch.log) may differ by an ulp: as deterministic
TOL_K3_SAMPLED = TOL_K3
TOL_K4_SAMPLED = TOL_K4
TOL_K4_FD = 2e-2    # rel, central difference of K3 (step 1e-2) vs <grad, dir>
# bf16 kernel tier vs float32 tier, gradients of one deterministic step, per
# parameter leaf, relative L2: the bound the JAX kernels' gradients were held
# to (tests/test_kernels.py:512-517)
TOL_GRAD = 0.05
# bf16 decode's gradients against float32 decode's, relative L2: the bound
# the JAX package holds its bf16 decoder gradients to (tests/test_kernels.py:
# 175-181), 0.15 for the weights and 0.2 for the inputs x and z (a reduced
# width measured up to 0.11 for z on the CPU)
TOL_DECODE_GRAD, TOL_DECODE_GRAD_IN = 0.15, 0.2
TOL_K5 = TOL_K3     # abs per unit of max(1, |value|): K3's formulas on one shard
# SP step (two ranks) vs the unsharded step, deterministic, same weights and
# 100 images: they differ by sum order (the softmax normalised over two
# shards, the partials all-reduced) and by cuDNN and K1/K2 seeing 50 rather
# than 100 rows, whose sums may round a bf16 value one step the other way:
# the loss within 1e-4 relative, each parameter leaf's gradient within 1e-2
# relative L2, a fifth of TOL_GRAD (the bf16 tier's own distance from f32)
TOL_SP_LOSS = 1e-4
TOL_SP_GRAD = 1e-2
SP_RANKS = 2        # ranks of phase 10, sharing cuda:0 over gloo
SP_STEPS = 20       # sampled SP train steps a rank takes in phase 10
SP_PROFILE_STEPS = 3  # further steps profiled on rank 0
SP_TIMEOUT = 600    # seconds for phase 10's ranks, all included
SP_EXCHANGE_US = 50.0  # the exchange's copies through host memory take longer
SP_PLANE_BLOCKS = 64   # grid blocks of a copy kernel that moves a plane
ROUTED_HIDDEN = 384  # phase 11's generator width, which no decoder kernel takes
CLI_TRAIN = 1050    # phase 12's split sizes: each ends in a 50-image tail
CLI_TEST = 250
CLI_EPOCHS = 3      # phase 12's epochs, snapshots every CLI_SAVE_INTERVAL
CLI_SAVE_INTERVAL = 2
CLI_STEP_REPS = 10  # train steps timed beside each tier's CLI run
MODE_CONFIGS = ("mnist-a", "mnist-b", "mnist-b-p8")   # phase 13's
MODE_STEPS = 20     # sampled train steps of each of them
# mode B's theta heads (encoder.conv_r), bf16 tier vs float32 tier, one
# deterministic step, relative L2: under theta's weak N(0, pi) prior their
# gradient is a near-cancellation of the decoder's and the KL's terms over
# the cells, which bf16 rounding moves far more than any other leaf. The JAX
# package's own bf16 TPU tier (its kernels interpreted on the CPU,
# tools/calibrate_mode_b_grad_tol.py) reads up to 0.207 there over 24
# inputs of mnist-b and mnist-b-p8 (10 and 25 images, seeds 0-7 / 0-3), and
# the port on the card reads 0.001-0.220 on the same inputs
# (tools/read_mode_b_grad_gap.py --from): 0.25 is that largest JAX reading
# rounded up. Every other leaf stays held to TOL_GRAD.
THETA_HEADS = ("encoder.conv_r.w", "encoder.conv_r.b")
TOL_GRAD_THETA = 0.25
CLUSTER_EPOCHS = 2  # phase 14's training runs before clustering
EMPIAR_DIM = 110    # phase 15: the EMPIAR-10025 particles' size
EMPIAR_STEPS = 20   # sampled train steps on each encoder tier
EMPIAR_EMBED = 500  # particles embedded for the embed img/s
EMPIAR_REPS = 3     # calls cuda_ms averages for phase 15's step and batch
PARTICLES_TOTAL = 1300       # phase 15's CLI stack, split 1,050 / 250 by
PARTICLES_PORTION = "0.8077"  # --train-portion (int(1300 * 0.8077) = 1050)
PARTICLES_TEST = 100         # the held-out stack clustering_particles embeds
VERTICAL_EPOCHS = 2  # phases 15-16's CLI training runs
DSPRITES_TRAIN, DSPRITES_TEST = 1000, 100   # train_dsprites' default limit
# The particles model at the EMPIAR shape (phase 15), bf16 tier vs float32
# tier, no noise, at the initial weights on this phase's batch (B = 100,
# CTF tables in physical units). Under the Gaussian with CTF and mask the
# theta head's gradient (conv_r) nearly cancels, as mode B's does (PR 13),
# and so do the lift and mixing layers' (conv1, conv2), which it reaches:
# the JAX package's own bf16 TPU tier (its kernels interpreted on the CPU,
# tools/calibrate_particles_grad_tol.py, phase 15's inputs, seeds 0-1)
# reads up to 0.315 there, the port on the same inputs up to 0.25; every
# other leaf reads <= 0.03 and keeps TOL_GRAD. The bound is that largest
# reading rounded up, under 1, so that a zero or disconnected gradient
# (1.0) fails. The CTF-filtered decoded mean that the Gaussian scores:
# 0.0121 in the JAX package, 0.0120 in the port; its bound is TOL_ELBO's
# 2e-2.
TOL_GRAD_EMPIAR_ENC = 0.35
EMPIAR_CANCELLING = ("encoder.conv1.", "encoder.conv2.", "encoder.conv_r.")
TOL_MU_EMPIAR = TOL_ELBO
VERTICAL_REPS = 5    # train steps cuda_ms averages in phase 16, each tier
STREAM_TOTAL = 2050  # phase 17's stand-in: 20 batches and a 50-image tail
STREAM_TEST = 250    # its held-out stack (the CLI's test split)
STREAM_CONV_BATCHES = 3   # the conv tier's streamed epoch
FLAGSHIP_STREAM = 5000    # flagship images of phase 17's epoch rates
RATE_REPS = 2        # readings of each epoch rate, taken in turns
PROFILE_SKIP = 3     # streamed steps before phase 17's profiler window
PROFILE_BATCHES = 20  # the batches of its epoch
DP_RANKS = 2         # phase 18's dp ranks, sharing cuda:0 over gloo
DP_STEPS = 10        # their sampled steps
DP_RAGGED = 1025     # their ragged resident epoch: a tail of 25
RANK_TIMEOUT = 600   # seconds for each of phase 18's spawns and runs
CLI_DP_EPOCHS = 2    # epochs of phase 18's torchrun CLI run
TP_STEPS = 10        # phase 19 (a): sampled dp = 2 x tp = 2 steps a tier
SCENARIO4_STEPS = 5  # phase 19 (c): sampled steps of mode B with CTF, TP
SCENARIO4_MASK = 20  # its mask radius at 50 x 50 (EMPIAR's 45 at 110)
MODE_B_SP_STEPS = 20  # phase 19 (d): sampled mode-B SP steps a config
CLI_TP_EPOCHS = 2    # phase 19 (f): epochs of the torchrun --tp 2 run
EMBED_STACK_N = 1000  # phase 20's flagship .mrcs and each mode's .sav embed
RECON_N = 8          # images phase 20's reconstruct decodes
# reconstruct's float32 decode on the card against the same on the CPU,
# max abs on sigmoid outputs in [0, 1]: the two devices' float32 sums in
# other orders (TF32 off), through embed, the pose and the decoder
TOL_RECON = 1e-4
TSNE_SIZES = (1000, 10000)   # phase 20's t-SNE runs on the card
# the t-SNE's P on the card against the CPU's: float64 throughout (the
# neighbours' distances, the perplexity search), entries ~1e-5
TOL_TSNE_P = 1e-12
ROUTED_STEPS = 3     # its train steps
# device_ms, the kernel timer: windows of at least 2 ms of replayed calls,
# the median of 5; calls rotate over copies of their inputs so that 60 MB
# (more than the H100's 50 MB L2) lie between two uses of one copy, at most
# 32 copies
TIMER_WINDOW_MS = 2.0
TIMER_WINDOWS = 5
TIMER_COLD_BYTES = 60_000_000
TIMER_MAX_COPIES = 32
BENCH_STEPS = 4      # phase 21: steps a timed window of each config
BENCH_WINDOWS = 3    # its windows (the median is the reading)
# Phase 21's count on the card: FlopCounterMode's (cuDNN, cuBLAS) plus the
# kernels' products against step_flops, relative. What neither side counts
# is named: the filter bank's bilinear rotation (a 4-tap product that only
# FlopCounterMode sees: 7e-6 of the flagship's step, 1e-5 of mnist-b-p8's,
# 8e-6 of particles-ctf's) and the CTF's FFTs (which step_flops counts and
# FlopCounterMode does not see: 5.5e-5 of particles-ctf's)
TOL_FLOPS = 1e-4


class CheckFailed(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    print(("PASS " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        raise CheckFailed(msg)


def with_lift(expect):
    """A launch-count expectation with K13 beside the conv tier's encoder
    forward: the lift (kernels/lift_conv.py) runs once before each launch
    of K1, or of K1 at R = 1 in mode B. A dict of counts gains K13's; a
    tuple or set of the kernels that launch gains K13 where K1 is in it."""
    if isinstance(expect, dict):
        return {**expect, "lift_conv_fwd": expect.get("mix_heads_fwd", 0)
                + expect.get("mix_heads_r1_fwd", 0)}
    k1 = {"mix_heads_fwd", "mix_heads_r1_fwd"} & set(expect)
    return tuple(expect) + (("lift_conv_fwd",) if k1 else ())


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


def galaxy_encoder_config():
    """The galaxy encoder's C = 3 shape (targetvae_tpu/cli/train_galaxy.py
    defaults: 64x64x3, k = 65, padding 16), C k^2 = 12,675 patch columns."""
    from targetvae_tpu_torch.utils.config import EncoderConfig
    return EncoderConfig(image_dim=64, in_channels=3, z_dim=2, kernels_num=128,
                         kernels_size=65, padding=16, groupconv=8)


@contextlib.contextmanager
def encoder_tier(tier: str):
    """TARGETVAE_ENCODER_TIER set to `tier` ("conv" or "patch") for the
    block, restored after it."""
    old = os.environ.get("TARGETVAE_ENCODER_TIER")
    os.environ["TARGETVAE_ENCODER_TIER"] = tier
    try:
        yield
    finally:
        if old is None:
            del os.environ["TARGETVAE_ENCODER_TIER"]
        else:
            os.environ["TARGETVAE_ENCODER_TIER"] = old


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
    """Mean time of fn() in ms over `reps` calls, after one warm-up, CUDA
    events around the calls: host-inclusive, since the events also time
    whatever host work keeps the card waiting between the launches (a
    kernel of ~0.1 ms behind a Python wrapper is timed by its host)."""
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


def device_ms(fn, args, windows: int = TIMER_WINDOWS) -> float:
    """Device time of one fn(*args) in ms, the host taken out: the calls
    are captured in a CUDA graph and the graph is replayed between two CUDA
    events, so only the kernels' own time and the gaps between them on the
    card are counted. The calls rotate over enough copies of args' tensors
    that TIMER_COLD_BYTES of other data are touched between two uses of
    one copy, so each call finds its inputs cold in the 50 MB L2, as after
    an unrelated kernel. One replay is a window of at least TIMER_WINDOW_MS;
    returns the median per-call time of `windows` windows."""
    import torch
    size = sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))
    n = min(TIMER_MAX_COPIES, 1 + -(-TIMER_COLD_BYTES // max(size, 1)))
    copies = [tuple(args)] + [
        tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        for _ in range(n - 1)]
    fn(*args)
    torch.cuda.synchronize()

    def capture(reps):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for i in range(reps):
                fn(*copies[i % n])
        return g

    def replay(g, reps):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    g = capture(n)
    g.replay()
    one = replay(g, n)
    del g                       # its pool, before the next capture takes one
    reps = n * max(1, -(-int(TIMER_WINDOW_MS / max(one, 1e-4)) // n))
    g = capture(reps)
    g.replay()
    times = sorted(replay(g, reps) for _ in range(windows))
    del g
    return times[len(times) // 2]


def time_kernel(results, name: str, phase: str, kfn, kargs, pfn, pargs,
                yardstick=None) -> None:
    """A kernel's row of the kernels line: its device time and its plain
    version's (device_ms, in turns: plain, kernel, kernel, plain; the
    smaller of each pair), and the yardstick (fn, args) given, timed by
    device_ms."""
    p1, k1, k2, p2 = (device_ms(pfn, pargs), device_ms(kfn, kargs),
                      device_ms(kfn, kargs), device_ms(pfn, pargs))
    row = {"ms": min(k1, k2), "plain_ms": min(p1, p2)}
    if yardstick is not None:
        row["yardstick_ms"] = device_ms(*yardstick)
    results[name].update(row)
    print(f"phase {phase}: {name}: kernel {k1:.4f} / {k2:.4f} ms, plain "
          f"{p1:.4f} / {p2:.4f} ms (device time, plain, kernel, kernel, "
          f"plain)" + (f"; yardstick {row['yardstick_ms']:.4f} ms"
                       if yardstick else ""), flush=True)


def posterior_inputs(torch, ecfg, b: int, dev, seed: int = 3):
    """K3's inputs for b images of encoder config ecfg: seeded raw heads
    (b, M, R, D) as the encoder leaves them (attention logit x 2, theta
    mean, theta log-std x 0.3, z means, z log-stds x 0.3), the rotation
    prior and offsets of the config, a seeded joint log-prior p_tr (M, R),
    the attention grid (M, 2) and sig_r, in posterior_fwd's order after the
    seed."""
    from targetvae_tpu_torch.models.encoders import (
        attn_dim_for, group_offsets, rotation_log_prior)
    from targetvae_tpu_torch.ops.coords import attention_grid
    R, zd, hp = ecfg.groupconv, ecfg.z_dim, attn_dim_for(ecfg)
    M = hp * hp
    g = torch.Generator(device=dev).manual_seed(seed)
    scale = torch.tensor([2.0, 1.0, 0.3] + [1.0] * zd + [0.3] * zd,
                         device=dev)
    heads = torch.randn((b, M, R, 3 + 2 * zd), generator=g,
                        device=dev) * scale
    p_tr = torch.log_softmax(torch.randn(M * R, generator=g, device=dev),
                             dim=0).reshape(M, R)
    as_t = lambda a: torch.as_tensor(a, device=dev)
    return (heads, as_t(rotation_log_prior(ecfg, R)),
            as_t(group_offsets(R) if ecfg.rot_refinement
                 else np.zeros(R, np.float32)),
            p_tr, as_t(attention_grid(hp, ecfg.image_dim)), float(np.pi / R))


def device_ops(torch, fn, calls: int = 3) -> list:
    """The device operations (kernels, copies, fills) of `calls` calls of
    fn after two warm-ups, from the profiler's trace: (name, start us,
    duration us, blocks of its grid, 0 where the trace gives none), in
    order of their start on the card."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    blocks = lambda e: int(np.prod(e.get("args", {}).get("grid", [0])))
    ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), blocks(e))
           for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return sorted(ops, key=lambda o: o[1])


def _named(name: str, base: str, wg: bool = False) -> bool:
    """Is `name` (a demangled kernel name) the kernel `base` of
    csrc/decoder_wgmma.cuh's namespace wg (wg=True) or of another source?"""
    import re
    if not re.search(r"(?:^|[\s:])" + base + r"\b", name):
        return False
    return ("wg::" + base in name) == wg


def posterior_stage(ops: list) -> dict:
    """The posterior stage of each call in a device_ops list: forward, the
    ops after the encoder kernel (K1 or K11) ends and before K7 starts;
    backward, the ops after K8 ends (the ordered sum that follows its pose
    pass) and before K2's or K12's chain starts. Returns the device ms a
    call of each (summed durations) and each window's ops by name (ms a
    call, count a call)."""
    is_enc = lambda n: _named(n, "fwd_kernel") or _named(n, "lifted_fwd_kernel")
    is_k7 = lambda n: _named(n, "fwd_kernel", wg=True)
    is_chain = lambda n: _named(n, "chain_kernel")
    wins = {"fwd": [], "bwd": []}
    i = 0
    while True:
        e = next((j for j in range(i, len(ops)) if is_enc(ops[j][0])), None)
        k7 = None if e is None else next(
            (j for j in range(e + 1, len(ops)) if is_k7(ops[j][0])), None)
        if k7 is None:
            break
        wins["fwd"].append(ops[e + 1:k7])
        nxt = next((j for j in range(k7 + 1, len(ops))
                    if is_chain(ops[j][0]) or is_enc(ops[j][0])), len(ops))
        if nxt < len(ops) and is_chain(ops[nxt][0]):
            ph = [j for j in range(k7 + 1, nxt)
                  if _named(ops[j][0], "phase_kernel", wg=True)]
            s = next((j for j in range(ph[-1] + 1, nxt)
                      if "sum_partials" in ops[j][0]), None) if ph else None
            if s is not None:
                wins["bwd"].append(ops[s + 1:nxt])
        i = nxt
    out = {}
    for key, ws in wins.items():
        if not ws:
            continue
        by = {}
        for w in ws:
            for name, _, dur, _ in w:
                ms, cnt = by.get(name, (0.0, 0))
                by[name] = (ms + dur / 1e3, cnt + 1)
        out[key + "_ms"] = sum(o[2] for w in ws for o in w) / 1e3 / len(ws)
        out[key + "_ops"] = sorted(
            ([op_label(n), round(ms / len(ws), 4), cnt / len(ws)]
             for n, (ms, cnt) in by.items()), key=lambda o: -o[1])
    return out


def op_label(name: str) -> str:
    """A device op's name for the stage's lists: PyTorch's kernels by the
    at::native names in their template (so that a copy, direct_copy_kernel,
    reads apart from an add or an exp), others by their first 80 chars."""
    import re
    parts = re.findall(r"at::native::(?:\(anonymous namespace\)::)?(\w+)", name)
    return "/".join(dict.fromkeys(parts))[:120] if parts else name[:80]


def sp_posterior_stage(ops: list) -> dict:
    """posterior_stage of the SP step's trace on one rank, gloo's copies
    through host memory (the collectives: the exchange, the all-reduces)
    left out: forward, the device ops between the encoder kernel and K7,
    backward, between K8 and K2's chain. Besides, the two spans around the
    planes, a step: from the batch-to-cell exchange (its last copy through
    host memory of SP_EXCHANGE_US or more) to K5, and from K6 to the
    exchange's backward (its first such copy): their ops by label, and
    "plane_copies", the copy kernels there of SP_PLANE_BLOCKS blocks or
    more (or of a grid the trace does not give): a copy of a plane of
    B x 6,144 cells takes over a thousand, one of the (B, 2) normalisers
    one or two."""
    out = posterior_stage([o for o in ops if not o[0].startswith("Memcpy")])
    big = lambda o: o[0].startswith("Memcpy") and o[2] >= SP_EXCHANGE_US
    spans = {"exchange_to_k5": [], "k6_to_exchange": []}
    for i, op in enumerate(ops):
        if "posterior_shard_fwd_kernel" in op[0]:
            j = max((j for j in range(i) if big(ops[j])), default=None)
            if j is not None:
                spans["exchange_to_k5"].append(ops[j + 1:i])
        elif "posterior_shard_bwd_kernel" in op[0]:
            j = next((j for j in range(i + 1, len(ops)) if big(ops[j])),
                     None)
            if j is not None:
                spans["k6_to_exchange"].append(ops[i + 1:j])
    out["plane_copies"] = 0
    for key, ws in spans.items():
        by = {}
        for w in ws:
            for name, _, _, blocks in w:
                if name.startswith("Memcpy"):
                    continue
                label = op_label(name)
                by[label] = by.get(label, 0) + 1 / len(ws)
                if "copy" in label.lower() and not 0 < blocks < SP_PLANE_BLOCKS:
                    out["plane_copies"] += 1 / len(ws)
        out[key + "_ops"] = by
    return out


def patch_inputs(pe, ecfg, y):
    """K11's inputs for images y: the im2col patches of the padded images
    and the rotated filter matrix, tiled bias, mixing and head weights."""
    import torch.nn.functional as F
    from targetvae_tpu_torch.kernels.lifted_encoder import build_patches
    from targetvae_tpu_torch.models.encoders import attn_dim_for, mode_c_matrices
    pad, hp = ecfg.padding, attn_dim_for(ecfg)
    xp = F.pad(y, (0, 0, pad, pad, pad, pad))
    wc, bc, wh, bh = mode_c_matrices(pe, ecfg)
    return (build_patches(xp, ecfg.kernels_size, hp, hp), wc, bc,
            pe["conv2"]["w"], pe["conv2"]["b"], wh, bh), xp


def kernel_inputs(params, cfg, dev):
    """Flagship-shape inputs for each kernel: K1 and K11 from the real lift
    of synthetic images, K3 from posterior_inputs, K7 and K9 seeded like
    tests/test_kernels.py (K9 at the posed 50x50 grids K7 decodes)."""
    import torch
    from targetvae_tpu_torch.models.encoders import head_weights, lift_rows
    from targetvae_tpu_torch.ops.coords import image_grid, transform_coords

    ecfg, gcfg = cfg.encoder, cfg.generator
    R, K, zd = ecfg.groupconv, ecfg.kernels_num, ecfg.z_dim
    pe, pg = params["encoder"], params["generator"]
    y = torch.from_numpy(synthetic_images(B, ecfg.image_dim, 1)).to(dev)
    rows, hp = lift_rows(pe, ecfg, y)
    wh, bh = head_weights(pe)
    k1 = (rows, pe["conv1"]["b"].repeat(R), pe["conv2"]["w"], pe["conv2"]["b"],
          wh, bh)

    k3 = posterior_inputs(torch, ecfg, B, dev)
    k7, pose, z = pose_inputs(torch, pg, gcfg, ecfg.image_dim, dev)
    theta, dx, wf, bf = pose
    x = transform_coords(torch.as_tensor(image_grid(ecfg.image_dim),
                                         device=dev), dx, theta).contiguous()
    k9 = (x, wf, bf, *k7[4:])
    k11, xp = patch_inputs(pe, ecfg, y)
    return k1, k3, k7, pose, k9, z, k11, (xp, y)


def pose_inputs(torch, pg, gcfg, n: int, dev):
    """K7's inputs for B posed n x n images of generator params pg: seeded
    poses and latents (theta, dx * 0.2, z, from seed 4, as
    tests/test_kernels.py), their pose tables and the generator's weights;
    with the poses (theta, dx, wf, bf) and z."""
    from targetvae_tpu_torch.kernels.decoder_pose import pose_tables
    g = torch.Generator(device=dev).manual_seed(4)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    theta, dx, z = rn(B), rn(B, 2) * 0.2, rn(B, gcfg.z_dim)
    wf = pg["fourier"]["w"] / gcfg.fourier_sigma
    u, v, p, q = pose_tables(theta, dx, wf, pg["fourier"]["b"], n)
    k7 = (u, v, p, q, z @ pg["latent_linear"]["w"], pg["coord_linear"]["w"],
          pg["coord_linear"]["b"], torch.stack([h["w"] for h in pg["hidden"]]),
          torch.stack([h["b"] for h in pg["hidden"]]), pg["out"]["w"],
          pg["out"]["b"])
    return k7, (theta, dx, wf, pg["fourier"]["b"]), z


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp(min=1e-12))


def k2_leaky_flips(torch, k1, g, got, ref, R: int, K: int) -> dict:
    """Accounts for K2's dpre1 `got` against the plain `ref`, row by row
    (one row per position and rotation). A pre2 entry is near zero where
    |pre2| <= 4 K 2^-24 sum_k |h1_k W2_kj|, twice the worst f32 rounding of
    two sums of K exact products, so that only there can the two orders
    disagree on its sign. Returns the step (1/128 of max |ref|), the count
    of near-zero entries and of rows holding one, the largest error of a row
    holding none, the rows past one step, how many of those a flip of the
    slope at some of their near-zero entries brings within one step, and
    the flips that took."""
    from targetvae_tpu_torch.kernels.decoder_pose import (
        LEAKY_SLOPE, _act, _dact_from_h, bf16_round)
    leaky = "leakyrelu"
    pre1, bc, w2, b2, wh = k1[:5]
    rows, d, dev = pre1.shape[0] * R, wh.shape[1], pre1.device
    w2r = bf16_round(w2.float())
    h1 = bf16_round(_act(pre1.float() + bc.float(), leaky)).reshape(rows, K)
    pre2 = h1 @ w2r + b2.float()
    near = pre2.abs() <= 4 * K * 2.0 ** -24 * (h1.abs() @ w2r.abs())
    step = float(ref.float().abs().max()) / 128
    got = got.float().reshape(rows, K)
    err = (got - ref.float().reshape(rows, K)).abs().amax(1)
    suspect = near.any(1)
    bad = (err > step).nonzero().squeeze(1)
    best = torch.full((len(bad),), float("inf"), device=dev)
    flips = torch.zeros(len(bad), dtype=torch.long, device=dev)
    nb = near[bad]
    n_near = nb.sum(1)
    for m in range(1, K2_MAX_FLIPS + 1):
        sel = (n_near == m).nonzero().squeeze(1)
        if not len(sel):
            continue
        at = bad[sel]
        ks = nb[sel].float().topk(m, dim=1).indices
        idx = torch.arange(len(sel), device=dev)
        dh2 = bf16_round(g.float().reshape(rows, d)[at]) @ bf16_round(
            wh.float()).T
        slope0 = _dact_from_h(bf16_round(_act(pre2[at], leaky)), leaky)
        dact1 = _dact_from_h(h1[at], leaky)
        for pattern in range(1, 2 ** m):
            slope = slope0.clone()
            for bit in range(m):
                if pattern >> bit & 1:
                    c = ks[:, bit]
                    slope[idx, c] = torch.where(slope[idx, c] == 1.0,
                                                LEAKY_SLOPE, 1.0)
            cand = bf16_round((bf16_round(dh2 * slope) @ w2r.T) * dact1)
            e = (cand - got[at]).abs().amax(1)
            better = e < best[sel]
            best[sel] = torch.where(better, e, best[sel])
            flips[sel] = torch.where(better, bin(pattern).count("1"),
                                     flips[sel])
    ok = best <= step
    return {"step": step, "near_zero": int(near.sum()),
            "rows_near_zero": int(suspect.sum()),
            "err_other_rows": float(err[~suspect].max()) if bool(
                (~suspect).any()) else 0.0,
            "rows_past_step": len(bad), "rows_explained": int(ok.sum()),
            "flips": int(flips[ok].sum())}


def serve_patch_tier(torch, kernels, model, params, images, x_coord, gen,
                     elbo32):
    """Phases 3 and 4 on the patch encoder tier: embed_dataset and the
    held-out ELBO with their launch counts, the encoder heads against the
    conv tier's and the deterministic ELBO against the float32 tier's.
    Returns the counts of each path."""
    from targetvae_tpu_torch.cli.clustering_common import embed_dataset
    from targetvae_tpu_torch.models.encoders import encoder_apply
    bf16, dev = torch.bfloat16, x_coord.device
    zd = model.cfg.encoder.z_dim
    with encoder_tier("patch"):
        kernels.reset_launch_counts()
        z_c, rot, tr = embed_dataset(model, params, images, B, "bfloat16")
        embed_counts = kernels.launch_counts()
        ok = (z_c.shape == (N_EMBED, 2 * zd) and tr.shape == (N_EMBED, 2)
              and all(np.isfinite(a).all() for a in (z_c, rot, tr)))
        check(ok and embed_counts["lifted_encoder_fwd"] > 0
              and not any(v for k, v in embed_counts.items()
                          if k != "lifted_encoder_fwd"),
              f"phase 3: patch tier: embed_dataset bf16 over {N_EMBED} "
              f"images: shapes {z_c.shape} {rot.shape} {tr.shape}, finite, "
              f"launches {embed_counts} (K11 only)")
        yb = torch.from_numpy(images[:B]).to(dev)
        pe, ecfg = params["encoder"], model.cfg.encoder
        heads_p = encoder_apply(pe, ecfg, yb, None, bf16)
        dx32 = model.embed(params, yb)["dx"].cpu().numpy()
        dx_err = float(np.abs(tr[:B] - dx32).max())
        kernels.reset_launch_counts()
        elbos = [[float(t) for t in model.elbo(
            params, x_coord, torch.from_numpy(images[i * B:(i + 1) * B]).to(dev),
            gen, compute_dtype=bf16)] for i in range(EVAL_BATCHES)]
        eval_counts = kernels.launch_counts()
        e16 = float(model.elbo(params, x_coord, yb, None, bf16)[0])
    with encoder_tier("conv"):
        heads_c = encoder_apply(pe, ecfg, yb, None, bf16)
    names = ("attn", "theta_mu", "theta_logstd", "z_mu", "z_logstd")
    rels = {n: rel_l2(heads_p[n], heads_c[n]) for n in names}
    check(max(rels.values()) <= TOL_TIER and dx_err <= TOL_DX,
          f"phase 3: patch tier vs conv tier encoder heads, rel L2 "
          f"{({n: float(f'{r:.2e}') for n, r in rels.items()})} <= {TOL_TIER};"
          f" embed dx vs float32 max abs diff {dx_err:.3e} <= {TOL_DX}")
    fwd = ("lifted_encoder_fwd", "posterior_fwd", "pose_decoder_fwd")
    check(bool(np.isfinite(elbos).all())
          and all(eval_counts[k] > 0 for k in fwd)
          and not any(eval_counts[k] for k in eval_counts if k not in fwd),
          f"phase 4: patch tier: held-out ELBO bf16 over {EVAL_BATCHES} "
          f"batches (elbo, log_p, kl) = {np.round(elbos, 3).tolist()}, "
          f"launches {eval_counts} (K11, K3, K7 only)")
    rel = abs(e16 - elbo32) / abs(elbo32)
    check(rel <= TOL_ELBO,
          f"phase 4: patch tier: deterministic ELBO bf16 {e16:.4f} vs float32 "
          f"tier {elbo32:.4f}: rel diff {rel:.3e} <= {TOL_ELBO}")
    return {"embed": embed_counts, "eval": eval_counts}


def galaxy_inputs(torch, dev):
    """K11's inputs at the galaxy encoder's C = 3 shape (B_GALAXY random
    images from seed 4) and that encoder's config. Phases 2 and 6 each make
    them anew, so that they hold no device memory in the phases between."""
    from targetvae_tpu_torch.models.encoders import encoder_init
    gcfg_e = galaxy_encoder_config()
    gen_g = torch.Generator().manual_seed(4)
    y_g = torch.rand((B_GALAXY, gcfg_e.image_dim, gcfg_e.image_dim, 3),
                     generator=gen_g).to(dev)
    k11_g, _ = patch_inputs(encoder_init(gen_g, gcfg_e, device=dev), gcfg_e,
                            y_g)
    return k11_g, gcfg_e


def check_k11(torch, k11, R, K, label, phase="2"):
    """K11 serving and in save-h1 mode against its plain version (phase 2,
    and 15 at the EMPIAR shape). Returns the heads' max abs error and the
    saved h1."""
    from targetvae_tpu_torch.kernels.lifted_encoder import (
        lifted_encoder_fwd, lifted_encoder_plain)
    o_k = lifted_encoder_fwd(*k11, R=R, K=K)
    o_s, h1 = lifted_encoder_fwd(*k11, R=R, K=K, save_h1=True)
    o_p, h1_p = lifted_encoder_plain(*k11, R=R, K=K, save_h1=True)
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    step = float(h1_p.float().abs().max()) / 128
    err_h = float((h1.float() - h1_p.float()).abs().max())
    check(bool(torch.isfinite(o_k).all()) and err <= TOL_K11
          and torch.equal(o_k, o_s) and err_h <= step,
          f"phase {phase}: K11 lifted_encoder_fwd {label} P "
          f"{tuple(k11[0].shape)} "
          f"-> {tuple(o_k.shape)}: max_abs_err {err:.3e} <= {TOL_K11}; "
          f"save-h1 output identical, h1 {tuple(h1.shape)} max_abs_err "
          f"{err_h:.3e} <= {step:.3e} (one bf16 step)")
    return err, h1


def per_unit(a, b) -> float:
    """max |a - b| / max(1, |b|)."""
    return float(((a.float() - b.float()).abs()
                  / b.float().abs().clamp(min=1.0)).max())


def scaled_err(a, b, cell_dims=(1, 2)) -> float:
    """max |a - b| / (|b| + K4_FLOOR s), s the max of |b| over cell_dims (an
    image's cells, in each channel): every element against its own
    magnitude, down to a thousandth of its image's largest."""
    a, b = a.double(), b.double()
    den = b.abs() + K4_FLOOR * b.abs().amax(dim=cell_dims, keepdim=True)
    return float(((a - b).abs() / den.clamp(min=1e-300)).max())


def planted_k4_faults(torch, k3, g3, ref, ref_s, noise, chunk) -> dict:
    """The plain K4's cotangents with two faults planted, read by
    scaled_err against the sound ones (ref, deterministic; ref_s, sampled
    with `noise`): "low-weight S2", the logit's -e^q S2 term dropped in the
    cells whose e^q is below 1e-3 of their image's largest; "shifted noise",
    the sampled gradient with CTA 1's cells (those of [chunk, 2 chunk))
    drawing the noise of counter + 1. Also "float64": the float64 plain
    version read against ref, what rounding alone moves."""
    from targetvae_tpu_torch.kernels.posterior import (
        _kl_terms, _posterior_core, posterior_bwd_plain, split_heads)
    heads, p_r, offs, p_tr, grid, sig_r = k3
    b, m, r, _ = heads.shape
    attn, thm, thls, zm, zls = split_heads(heads, p_r, offs)
    q, eq, _ = _posterior_core(attn, None)
    kl_th, kl_z = _kl_terms(eq, thm, torch.exp(thls) + 1e-6, zm,
                            torch.exp(zls) + 1e-6, offs.reshape(1, -1, 1),
                            sig_r)
    d_q = g3[:, -1, None, None] * eq * ((q - p_tr.T) + 1.0 + kl_th + kl_z)
    s2 = eq * d_q.sum(dim=(1, 2), keepdim=True)                 # (B, R, M)
    low = eq < 1e-3 * eq.amax(dim=(1, 2), keepdim=True)
    f1 = ref.clone()
    f1[..., 0] += torch.where(low, s2, 0.0).transpose(1, 2)
    cell = torch.arange(m * r, device=heads.device).reshape(m, r).T
    cta1 = (cell >= chunk) & (cell < 2 * chunk)                  # (R, M)
    shifted = torch.roll(noise.reshape(b, r * m), -1, dims=1).reshape(noise.shape)
    f2 = posterior_bwd_plain(g3, *k3, noise=torch.where(cta1, shifted, noise))
    f64 = posterior_bwd_plain(g3.double(), *(
        t.double() if torch.is_tensor(t) else t for t in k3))
    return {"low-weight S2": scaled_err(f1, ref),
            "shifted noise": scaled_err(f2, ref_s),
            "float64": scaled_err(ref, f64)}


def check_posterior_fwd(torch, k3, results, label, schedule=None,
                        phase="2"):
    """K3 on k3 (posterior_inputs' arguments; on `schedule`'s grid, a
    k3_schedule, if given)
    against its plain version: deterministic, and sampled against the plain
    version fed the kernel's own noise (philox_gumbel); the same seed gives
    the same output; the rows of B images equal two calls on B / 2 with
    the seed offset; the sampled kl equals the deterministic one."""
    from targetvae_tpu_torch.kernels.posterior import (
        philox_gumbel, posterior_fwd, posterior_plain)
    heads, rest = k3[0], k3[1:]
    b, m, r, _ = heads.shape
    plain = lambda noise: torch.cat(
        [v if v.dim() == 2 else v[:, None]
         for v in posterior_plain(*k3, noise=noise).values()], dim=1)
    fwd = lambda seed, h, det=False: posterior_fwd(
        seed, h, *rest, deterministic=det, schedule=schedule)
    det_k = fwd(7, heads, True)
    err = per_unit(det_k, plain(None))
    abs3 = float((det_k - plain(None)).abs().max())
    check(bool(torch.isfinite(det_k).all()) and err <= TOL_K3,
          f"phase {phase}: K3 posterior_fwd deterministic {label} heads "
          f"{tuple(heads.shape)}: max err {err:.3e} (abs {abs3:.3e}) <= "
          f"{TOL_K3} * max(1, |ref|)")
    s1, s2 = fwd(11, heads), fwd(11, heads)
    err_s = per_unit(s1, plain(philox_gumbel(11, b, r, m, heads.device)))
    check(err_s <= TOL_K3_SAMPLED,
          f"phase {phase}: K3 sampled {label} vs plain fed the kernel's Philox "
          f"noise: max err {err_s:.3e} <= {TOL_K3_SAMPLED} * max(1, |ref|)")
    half = [fwd(11 + i, heads[i:i + b // 2]) for i in (0, b // 2)]
    check(torch.equal(s1, s2) and torch.equal(s1, torch.cat(half)),
          f"phase {phase}: K3 sampled {label}: same seed gives identical output; "
          f"rows identical for batch {b} vs 2 x {b // 2}")
    kl_err = float((s1[:, -1] - det_k[:, -1]).abs().max())
    check(kl_err <= 1e-6 * float(det_k[:, -1].abs().max().clamp(min=1.0)),
          f"phase {phase}: K3 sampled {label}: kl equals deterministic kl (max "
          f"diff {kl_err:.3e})")
    if label == "flagship":
        results["posterior_fwd"] = {"max_abs_err": abs3,
                                    "max_err_sampled": err_s}
    return abs3, err_s


def check_posterior_bwd(torch, k3, g3, results, label, schedule=None,
                        schedule3=None, phase="6"):
    """K4 on k3 with the packed cotangent g3 (on `schedule`'s grid, a
    k4_schedule, and K3 on `schedule3`'s, if given)
    against its plain version, deterministic and sampled (fed the kernel's
    own noise), per unit of max(1, |ref|) and by scaled_err; planted
    faults must read above scaled_err's limit; the same seed gives the
    same gradients; the rows of B images equal two calls on B / 2; the
    sampled gradient against a central difference of K3's own forward at
    the same seed."""
    from targetvae_tpu_torch.kernels.posterior import (
        k4_schedule, philox_gumbel, posterior_bwd, posterior_bwd_plain,
        posterior_fwd)
    heads, rest = k3[0], k3[1:]
    b, m, r, d = heads.shape
    bwd = lambda seed, g, h, det=False: posterior_bwd(
        seed, g, h, *rest, deterministic=det, schedule=schedule)
    got = bwd(7, g3, heads, True)
    ref = posterior_bwd_plain(g3, *k3)
    err, sc = per_unit(got, ref), scaled_err(got, ref)
    abs4 = float((got - ref).abs().max())
    check(bool(torch.isfinite(got).all()) and got.shape == heads.shape
          and err <= TOL_K4 and sc <= TOL_K4_SCALED,
          f"phase {phase}: K4 posterior_bwd deterministic {label} heads "
          f"{tuple(heads.shape)}: max err {err:.3e} (abs {abs4:.3e}) <= "
          f"{TOL_K4} * max(1, |ref|); each element {sc:.3e} <= "
          f"{TOL_K4_SCALED} * (|ref| + {K4_FLOOR} * max |ref|)")
    s1 = bwd(11, g3, heads)
    noise = philox_gumbel(11, b, r, m, heads.device)
    ref_s = posterior_bwd_plain(g3, *k3, noise=noise)
    err_s, sc_s = per_unit(s1, ref_s), scaled_err(s1, ref_s)
    check(err_s <= TOL_K4_SAMPLED and sc_s <= TOL_K4_SCALED,
          f"phase {phase}: K4 sampled {label} vs plain fed the kernel's Philox "
          f"noise: max err {err_s:.3e} <= {TOL_K4_SAMPLED} * max(1, |ref|); "
          f"each element {sc_s:.3e} <= {TOL_K4_SCALED} * (|ref| + "
          f"{K4_FLOOR} * max |ref|)")
    chunk = (schedule or k4_schedule(m, r, d))[1]
    reads = planted_k4_faults(torch, k3, g3, ref, ref_s, noise, chunk)
    f64 = reads.pop("float64")
    check(min(reads.values()) > TOL_K4_SCALED,
          f"phase {phase}: K4 {label}: planted faults read "
          f"{({n: float(f'{v:.3e}') for n, v in reads.items()})} > "
          f"{TOL_K4_SCALED}; the sound kernel {max(sc, sc_s):.3e}, the "
          f"float32 plain version against float64 {f64:.3e}")
    h = b // 2
    halves = [bwd(11 + i, g3[i:i + h], heads[i:i + h]) for i in (0, h)]
    check(torch.equal(s1, bwd(11, g3, heads))
          and torch.equal(s1, torch.cat(halves)),
          f"phase {phase}: K4 sampled {label}: same seed gives identical "
          f"gradients; rows identical for batch {b} vs 2 x {h} with the "
          f"seed offset")
    d = torch.randn(heads.shape, generator=torch.Generator(
        device=heads.device).manual_seed(14), device=heads.device)
    step = 1e-2
    fwd = lambda eps: posterior_fwd(11, heads + eps * d, *rest,
                                    schedule=schedule3).double()
    fd = float(((fwd(step) - fwd(-step)) * g3.double()).sum()) / (2 * step)
    an = float((s1.double() * d.double()).sum())
    check(abs(fd - an) <= TOL_K4_FD * max(abs(an), 1.0),
          f"phase {phase}: K4 sampled {label}: <grad, dir> {an:.6g} vs central "
          f"difference of K3 at the same seed {fd:.6g} (step {step}): rel "
          f"{abs(fd - an) / max(abs(an), 1.0):.3e} <= {TOL_K4_FD}")
    if label == "flagship":
        results["posterior_bwd"] = {"max_abs_err": abs4,
                                    "max_err_sampled": err_s,
                                    "scaled_err": max(sc, sc_s)}
    return abs4, err_s, max(sc, sc_s)


def check_posterior_shapes(torch, cfg, dev):
    """Phase 6: K3 and K4 (not timed) at the shapes past the flagship's the
    port takes: P16 (R = 16), dSprites' 64 x 64 images with k = 64 and
    padding 32 (H' = 65: 33,800 cells an image), on its own grid and
    streamed through a cluster of 4 CTAs, and z = 8 (D = 19)."""
    import dataclasses
    from targetvae_tpu_torch.kernels.posterior import k3_schedule, k4_schedule
    e = cfg.encoder
    dsprites = dataclasses.replace(e, image_dim=64, kernels_size=64,
                                   padding=32)
    g = torch.Generator(device=dev).manual_seed(15)
    for label, ecfg, cluster in (
            ("P16", dataclasses.replace(e, groupconv=16), None),
            ("dSprites H'=65", dsprites, None),
            ("dSprites H'=65, 4 CTAs streamed", dsprites, 4),
            ("z=8", dataclasses.replace(e, z_dim=8), None)):
        k3 = posterior_inputs(torch, ecfg, B, dev, seed=16)
        m, r, d = k3[0].shape[1:]
        s3, s4 = k3_schedule(m, r, cluster), k4_schedule(m, r, d, cluster)
        print(f"phase 6: K3/K4 at {label}: heads {tuple(k3[0].shape)}, "
              f"grids: K3 (cluster, chunk) {s3}, K4 (cluster, chunk, sub) "
              f"{s4}", flush=True)
        check_posterior_fwd(torch, k3, None, label, s3)
        g3 = torch.randn((B, 2 * ecfg.z_dim + 5), generator=g, device=dev)
        check_posterior_bwd(torch, k3, g3, None, label, s4, s3)
        del k3


def check_k9_features(torch, k9):
    """Phase 2: the features K9 builds on chip, read through its saved first
    h tile with W1 = [I; 0] (then [0; I]), b1 = hz = 0: h = bf16(act(f))
    exactly, held against the plain version's bf16(cos(phase))."""
    from targetvae_tpu_torch.kernels.decoder_mlp import _phase, decoder_mlp_fwd
    from targetvae_tpu_torch.kernels.decoder_pose import _act, bf16_round
    x, wf, bf, hz, w1 = k9[:5]
    f, h = w1.shape
    feat = bf16_round(torch.cos(_phase(x, wf, bf)))
    mism, worst = 0, 0.0
    for half in range(f // h):
        w = torch.zeros_like(w1)
        w[half * h:(half + 1) * h] = torch.eye(h, device=w.device)
        _, hs = decoder_mlp_fwd(x, wf, bf, torch.zeros_like(hz), w,
                                torch.zeros_like(k9[5]), *k9[6:],
                                save_res=True)
        ref = bf16_round(_act(feat[..., half * h:(half + 1) * h], "leakyrelu"))
        d = (hs[0].float() - ref).abs()
        mism += int((d > 0).sum())
        worst = max(worst, float(d.max()))
    share = mism / feat.numel()
    check(share <= TOL_FEAT_SHARE and worst <= 2.0 ** -8,
          f"phase 2: K9's on-chip features bf16(cos(phase)) vs plain over "
          f"{feat.numel()} entries (phases up to "
          f"{float(_phase(x, wf, bf).abs().max()):.1f} rad): {mism} differ "
          f"(share {share:.2e} <= {TOL_FEAT_SHARE}), by at most {worst:.3e} "
          f"<= one bf16 step of 1")


def cudnn_lift_rows(w, y, padding: int):
    """The conv tier's lift as the port ran it before K13, K13's yardstick
    (library_ms): one bf16 F.conv2d (cuDNN) with channels_last operands,
    its output as (B H' W', N) rows."""
    import torch
    import torch.nn.functional as F
    x = y.permute(0, 3, 1, 2).to(torch.bfloat16)
    pre1 = F.conv2d(x.contiguous(memory_format=torch.channels_last),
                    w.to(torch.bfloat16).contiguous(
                        memory_format=torch.channels_last), padding=padding)
    b, n, hp, wp = pre1.shape
    return pre1.permute(0, 2, 3, 1).reshape(b * hp * wp, n).contiguous()


def lift_conv_rows(torch, dev) -> dict:
    """Phase 5's K13 rows: the conv tier's lift forward at the flagship (B
    = 100, k = 28, padding 8) and at mnist-b-p8's image-sized lift (k =
    50, padding 25, R_lift K = 1,024) on synthetic images, held against
    the float32 sums of its plain version's conv (TF32 off): each row
    within one bf16 rounding of its sum (2^-8 of it) and the float32 error
    of the other sum order (1e-4 of the largest); then timed (device_ms,
    plain, kernel, kernel, plain) beside its bound and cuDNN's bf16 conv
    (library_ms, the call the port made before K13)."""
    import torch.nn.functional as F
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.kernels.lift_conv import (lift_conv_fwd,
                                                       lift_conv_plain)
    from targetvae_tpu_torch.models.encoders import mode_b_matrices
    from targetvae_tpu_torch.ops.groupconv import lifted_weight
    from targetvae_tpu_torch.utils.flops import lift_conv_bound
    rows = {}
    for label, cfg in (("flagship", flagship_config()),
                       ("mnist-b-p8", mode_config("mnist-b-p8"))):
        e = cfg.encoder
        params = TargetVAE(cfg, dev).init(torch.Generator().manual_seed(40))
        pe = params["encoder"]
        if e.mode == "C":
            w, pad = lifted_weight(pe["conv1"]["w"], e.groupconv), e.padding
        else:
            w, pad = mode_b_matrices(pe, e)[0], e.image_dim // 2
        w = w.detach().to(torch.bfloat16)
        y = torch.from_numpy(synthetic_images(B, e.image_dim, 41)).to(dev)
        got = lift_conv_fwd(y, w, pad)
        x = y.to(torch.bfloat16).float().permute(0, 3, 1, 2)
        sums = F.conv2d(x, w.float(), padding=pad)
        sums = sums.permute(0, 2, 3, 1).reshape(-1, sums.shape[1])
        err = (got.float() - sums).abs()
        tol = 2.0 ** -8 * sums.abs() + 1e-4 * float(sums.abs().max())
        over = int((err > tol).sum())
        torch.cuda.synchronize()
        check(over == 0 and bool(torch.isfinite(got.float()).all()),
              f"phase 5: K13 lift_conv_fwd {label} y {tuple(y.shape)}, w "
              f"{tuple(w.shape)}, padding {pad} -> {tuple(got.shape)}: "
              f"max_abs_err {float(err.max()):.3e} against the float32 sums, "
              f"{over} elements past one bf16 rounding + 1e-4 of the "
              f"largest ({float(sums.abs().max()):.3f})")
        del x, sums, err, tol
        key = f"lift_conv_fwd[{label}]"
        rows[key] = {"max_abs_err": float((got.float() - lift_conv_plain(
            y, w, pad).float()).abs().max())}
        kfn = lambda a, b: lift_conv_fwd(a, b, pad)
        pfn = lambda a, b: lift_conv_plain(a, b, pad)
        time_kernel(rows, key, "5", kfn, (y, w), pfn, (y, w))
        lib = min(device_ms(cudnn_lift_rows, (w, y, pad)),
                  device_ms(cudnn_lift_rows, (w, y, pad)))
        bound, by = lift_conv_bound(cfg, B)
        rows[key].update(library_ms=lib, bound_ms=bound, bound_by=by)
        print(f"phase 5: {key}: cuDNN's bf16 conv (library_ms) {lib:.4f} "
              f"ms; bound {bound:.4f} ms ({by}): K13 at "
              f"{100 * bound / rows[key]['ms']:.1f} % of it ({card()})",
              flush=True)
        del params, got, y, w
        torch.cuda.empty_cache()
    return rows


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
        with encoder_tier("conv"):
            return run(torch, torch.device("cuda", 0))
    except CheckFailed:
        return 1


# each kernel's CUDA source in targetvae_tpu_torch/csrc/ and the TPU kernel
# it replaces (file:line in targetvae_tpu/kernels/)
SOURCES = {
    "mix_heads_fwd": ("mix_heads.cu", "mix_heads.py:232"),
    "mix_heads_bwd": ("mix_heads.cu", "mix_heads.py:269"),
    "posterior_fwd": ("posterior.cu", "posterior.py:241"),
    "posterior_bwd": ("posterior.cu", "posterior.py:253"),
    "pose_decoder_fwd": ("decoder_pose.cu", "decoder_pose.py:390"),
    "pose_decoder_bwd": ("decoder_pose_bwd.cu", "decoder_pose.py:439"),
    "decoder_mlp_fwd": ("decoder_mlp.cu", "decoder_mlp.py:99"),
    "decoder_mlp_bwd": ("decoder_mlp.cu", "decoder_mlp.py:234"),
    "lifted_encoder_fwd": ("lifted_encoder.cu", "lifted_encoder.py:179"),
    "lifted_encoder_bwd": ("lifted_encoder.cu", "lifted_encoder.py:215"),
    "posterior_shard_fwd": ("posterior.cu", "posterior.py:466"),
    "posterior_shard_bwd": ("posterior.cu", "posterior.py:477"),
    "mix_heads_r1_fwd": ("mix_heads_r1.cu", "mix_heads.py:232"),
    "mix_heads_r1_bwd": ("mix_heads_r1.cu", "mix_heads.py:269"),
    "lift_conv_fwd": ("lift_conv.cu", None)}


def kernel_entry(key: str, row: dict) -> dict:
    """A row of the kernels' JSON line: the kernel's name (key, with its
    config in brackets for the rows of phases 5, 13 and 15), route,
    source, the TPU kernel it replaces (K13 none: the JAX package leaves
    the lift to XLA), its numbers, and library_ms (no single PyTorch call
    computes any of these kernels but K13: cuDNN's bf16 conv, which its
    row times)."""
    src, replaced = SOURCES[key.split("[")[0]]
    return {"name": key, "route": "cuda",
            "source": "targetvae_tpu_torch/csrc/" + src,
            "replaces": replaced and "targetvae_tpu/kernels/" + replaced,
            "library_ms": None, **row}


def run(torch, dev) -> int:
    import targetvae_tpu_torch.kernels as kernels
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.cli.clustering_common import embed_dataset
    from targetvae_tpu_torch.kernels import _build
    from targetvae_tpu_torch.kernels.decoder_pose import (
        fused_pose_decoder_tables, pose_decoder_plain)
    from targetvae_tpu_torch.kernels.mix_heads import (
        fused_lift_act_mix_heads, lift_act_mix_heads_plain, mix_heads_fwd)
    from targetvae_tpu_torch.kernels.posterior import (
        fused_posterior, per_image_gumbel, philox_gumbel, posterior_fwd,
        posterior_plain)
    from targetvae_tpu_torch.kernels.decoder_mlp import (
        decoder_mlp_fwd, decoder_mlp_plain)
    from targetvae_tpu_torch.kernels.lifted_encoder import (
        build_patches, lifted_encoder_fwd, lifted_encoder_plain)
    from targetvae_tpu_torch.models.encoders import attn_dim_for, lift_rows
    from targetvae_tpu_torch.ops.groupconv import lifted_weight
    from targetvae_tpu_torch.utils.flops import kernel_bounds

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
    from targetvae_tpu_torch.data import native
    t0 = time.perf_counter()
    fresh = not native.library_path().exists()
    native_lib = native.build()
    print(f"phase 1: {'built' if fresh else 'found'} the native data "
          f"runtime {native_lib.name} (g++ -O3 -march=native) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    cfg = flagship_config()
    model = TargetVAE(cfg, device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    zd = cfg.encoder.z_dim
    results = {}

    with torch.inference_mode():
        # ---- phase 2: each kernel against its plain version ----
        k1, k3, k7, pose, k9, z9, k11, (xp, y1) = kernel_inputs(params, cfg,
                                                              dev)
        R, K = cfg.encoder.groupconv, cfg.encoder.kernels_num
        o_k = fused_lift_act_mix_heads(*k1, R=R, K=K)
        o_p = lift_act_mix_heads_plain(*k1, R=R, K=K)
        torch.cuda.synchronize()
        err1 = float((o_k - o_p).abs().max())
        check(bool(torch.isfinite(o_k).all()) and err1 <= TOL_K1,
              f"phase 2: K1 mix_heads_fwd {tuple(k1[0].shape)} -> "
              f"{tuple(o_k.shape)}: max_abs_err {err1:.3e} <= {TOL_K1}")
        results["mix_heads_fwd"] = {"max_abs_err": err1}

        check_posterior_fwd(torch, k3, results, "flagship")
        keys = [("dx", 0), ("dx", 1), ("z_mu_e", 0), ("z_mu_e", 1),
                ("theta_mu_e", None)]
        pick = lambda o, k, i: (o[k] if i is None else o[k][:, i]).mean()
        mk = np.zeros((SEEDS, len(keys)))
        mp = np.zeros((SEEDS, len(keys)))
        for s in range(SEEDS):
            ok_ = fused_posterior(1000 + s * B, *k3)
            noise = per_image_gumbel(1000 + s * B, (B, R, k3[0].shape[1]), dev)
            op_ = posterior_plain(*k3, noise=noise)
            mk[s] = [float(pick(ok_, k, i)) for k, i in keys]
            mp[s] = [float(pick(op_, k, i)) for k, i in keys]
        se = np.sqrt(mk.var(0, ddof=1) / SEEDS + mp.var(0, ddof=1) / SEEDS)
        z = np.abs(mk.mean(0) - mp.mean(0)) / np.maximum(se, 1e-12)
        check(bool((z <= 4.0).all()),
              f"phase 2: K3 sampled: means over {SEEDS} seeds of dx, z_mu_e, "
              f"theta_mu_e within 4 standard errors of the CPU tier's noise "
              f"(per_image_gumbel) (|diff|/se = {np.round(z, 2).tolist()})")

        y7k = fused_pose_decoder_tables(*k7)
        y7p = pose_decoder_plain(*k7)
        torch.cuda.synchronize()
        err7 = float((y7k - y7p).abs().max())
        check(bool(torch.isfinite(y7k).all()) and err7 <= TOL_K7,
              f"phase 2: K7 pose_decoder_fwd {tuple(k7[0].shape)} -> "
              f"{tuple(y7k.shape)}: max_abs_err {err7:.3e} <= {TOL_K7}")
        results["pose_decoder_fwd"] = {"max_abs_err": err7}

        err11, h1 = check_k11(torch, k11, R, K, "flagship")
        results["lifted_encoder_fwd"] = {"max_abs_err": err11}
        k11_g, gcfg_e = galaxy_inputs(torch, dev)
        check_k11(torch, k11_g, gcfg_e.groupconv, gcfg_e.kernels_num,
                  "galaxy C=3")
        del k11_g

        y9k = decoder_mlp_fwd(*k9)
        y9p = decoder_mlp_plain(*k9)
        torch.cuda.synchronize()
        err9 = float((y9k - y9p).abs().max())
        check(bool(torch.isfinite(y9k).all()) and err9 <= TOL_K9,
              f"phase 2: K9 decoder_mlp_fwd x {tuple(k9[0].shape)} -> "
              f"{tuple(y9k.shape)}: max_abs_err {err9:.3e} <= {TOL_K9}")
        results["decoder_mlp_fwd"] = {"max_abs_err": err9}
        check_k9_features(torch, k9)

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
        direct = model.embed(params, yb, compute_dtype=bf16)
        check(all(np.array_equal(direct[k].cpu().numpy(), a[:B]) for k, a in
                  (("z_content", z_c), ("theta_mu", rot), ("dx", tr))),
              f"phase 3: embed_dataset's first {B} rows (pinned staging, "
              f"one copy out) bitwise model.embed's on the same batch")
        dx32 = model.embed(params, yb)["dx"].cpu().numpy()
        dx_err = float(np.abs(tr[:B] - dx32).max())
        check(dx_err <= TOL_DX, f"phase 3: bf16 vs float32 embed dx max abs "
              f"diff {dx_err:.3e} <= {TOL_DX}")

        x_coord = model.base_grid()
        gen = torch.Generator().manual_seed(5)
        kernels.reset_launch_counts()
        elbos = []
        for i in range(EVAL_BATCHES):
            yb = torch.from_numpy(images[i * B:(i + 1) * B]).to(dev)
            elbos.append([float(t) for t in model.elbo(
                params, x_coord, yb, gen, compute_dtype=bf16)])
        counts = kernels.launch_counts()
        eval_counts = dict(counts)
        fwd_names = with_lift(("mix_heads_fwd", "posterior_fwd",
                               "pose_decoder_fwd"))
        check(bool(np.isfinite(elbos).all())
              and all(counts[k] > 0 for k in fwd_names)
              and not any(counts[k] for k in counts if k not in fwd_names),
              f"phase 4: held-out ELBO bf16 over {EVAL_BATCHES} batches "
              f"(elbo, log_p, kl) = {np.round(elbos, 3).tolist()}, launches "
              f"{counts} (forward kernels only)")
        yb = torch.from_numpy(images[:B]).to(dev)
        e16 = [float(t) for t in model.elbo(params, x_coord, yb, None, bf16)]
        e32 = [float(t) for t in model.elbo(params, x_coord, yb, None, None)]
        rel = abs(e16[0] - e32[0]) / abs(e32[0])
        check(rel <= TOL_ELBO,
              f"phase 4: deterministic ELBO bf16 kernels {e16[0]:.4f} vs "
              f"float32 tier {e32[0]:.4f}: rel diff {rel:.3e} <= {TOL_ELBO}")

        # ---- phases 3 and 4 on the patch encoder tier ----
        patch_counts = serve_patch_tier(torch, kernels, model, params, images,
                                        x_coord, gen, e32[0])

        # ---- phase 5: timings ----
        heads = k3[0]
        ysum = (lambda x: x.view(x.shape[0], -1).sum(1), (heads,))
        noise3 = philox_gumbel(9, B, R, heads.shape[1], dev)
        for name, kfn, kargs, pfn, pargs, yard in (
                ("mix_heads_fwd",
                 lambda *a: mix_heads_fwd(*a, R=R, K=K), k1,
                 lambda *a: lift_act_mix_heads_plain(*a, R=R, K=K), k1, None),
                ("posterior_fwd",
                 lambda *a: posterior_fwd(9, *a), k3,
                 lambda *a: posterior_plain(*a, noise=noise3), k3, ysum),
                ("pose_decoder_fwd", fused_pose_decoder_tables, k7,
                 pose_decoder_plain, k7, None),
                ("lifted_encoder_fwd",
                 lambda *a: lifted_encoder_fwd(*a, R=R, K=K), k11,
                 lambda *a: lifted_encoder_plain(*a, R=R, K=K), k11, None),
                ("decoder_mlp_fwd", decoder_mlp_fwd, k9,
                 decoder_mlp_plain, k9, None)):
            time_kernel(results, name, "5", kfn, kargs, pfn, pargs, yard)
        det3 = lambda *a: posterior_fwd(9, *a, deterministic=True)
        results["posterior_fwd"]["det_ms"] = min(device_ms(det3, k3),
                                                 device_ms(det3, k3))
        print(f"phase 5: posterior_fwd deterministic: kernel "
              f"{results['posterior_fwd']['det_ms']:.4f} ms (device time)",
              flush=True)
        # the lift's yardsticks: the patch build, one cuBLAS bf16 GEMM P Wc
        # (what K11 computes in its body, without the epilogue), the conv
        # tier's lift (K13) and the cuDNN bf16 conv it replaced, with its
        # copy into K1's rows
        ecfg = cfg.encoder
        hp = attn_dim_for(ecfg)
        wc16 = k11[1].to(bf16)
        lift = {"patch_build_ms": cuda_ms(lambda: build_patches(
                    xp, ecfg.kernels_size, hp, hp)),
                "lift_gemm_cublas_ms": cuda_ms(lambda: k11[0] @ wc16),
                "lift_conv_k13_ms": cuda_ms(lambda: lift_rows(
                    params["encoder"], ecfg, y1)),
                "lift_conv_cudnn_ms": cuda_ms(lambda: cudnn_lift_rows(
                    lifted_weight(params["encoder"]["conv1"]["w"],
                                  ecfg.groupconv), y1, ecfg.padding))}
        results["lifted_encoder_fwd"].update(lift)
        print(f"phase 5: lift yardsticks: patch build "
              f"{lift['patch_build_ms']:.4f} ms, cuBLAS P @ Wc "
              f"{tuple(k11[0].shape)} x {tuple(wc16.shape)} bf16 "
              f"{lift['lift_gemm_cublas_ms']:.4f} ms, the lift (K13) "
              f"{lift['lift_conv_k13_ms']:.4f} ms, cuDNN's lift conv + rows "
              f"copy {lift['lift_conv_cudnn_ms']:.4f} ms (host included)",
              flush=True)
        lift_rows_k13 = lift_conv_rows(torch, dev)

        yb = torch.from_numpy(images[:B]).to(dev)
        for tier in ("conv", "patch"):
            with encoder_tier(tier):
                embed_dataset(model, params, images, B, "bfloat16")
                torch.cuda.synchronize()
                t = time.perf_counter()
                embed_dataset(model, params, images, B, "bfloat16")
                torch.cuda.synchronize()
                embed_s = time.perf_counter() - t
                eval_ms = cuda_ms(lambda: model.elbo(params, x_coord, yb, gen,
                                                     bf16))
            print(f"phase 5: {tier} tier: embed {N_EMBED / embed_s:.1f} img/s "
                  f"(embed_dataset, B={B}, bf16, host to host); eval "
                  f"{B / eval_ms * 1e3:.1f} img/s (ELBO bf16, B={B}, "
                  f"{eval_ms:.3f} ms/batch, device time)", flush=True)

    # ---- phases 6-9: the training slice, both tiers, and bf16 decode ----
    with torch.inference_mode():
        cot = check_backward_kernels(torch, cfg, dev, k1, k3, k7, pose, k9,
                                     k11, h1, results)
    trainer, state, data, train_counts, g32 = train_path(torch, kernels, cfg,
                                                         dev)
    wide_latent_routes(torch, kernels, cfg, dev, data)
    trainer_p, state_p, patch_counts["train"] = patch_train_path(
        torch, kernels, cfg, dev, data, g32)
    decode_counts, decode_ms = decode_path(torch, kernels, model, params, k9,
                                           z9)
    results["decoder_mlp_fwd"]["decode_ms"] = decode_ms["decode_ms"]
    results["decoder_mlp_bwd"]["decode_grad_ms"] = decode_ms["decode_grad_ms"]
    step_rates = time_training(torch, cfg, k1, k3, k7, k9, k11, h1, cot,
                               trainer, state, trainer_p, state_p, data,
                               results)
    del trainer, state, trainer_p, state_p

    # ---- phase 10: the grid-sharded posterior and the SP train step ----
    shard_cells = sp_kernel_checks(torch, cfg, dev, results)
    sp_counts = sp_train_path(torch, cfg, dev, data)

    # ---- phase 11: the bf16 tier past the decoder kernels' widths ----
    routed_generator_path(torch, kernels, cfg, dev, data)

    # ---- phase 12: the training run through the CLI, each tier ----
    import tempfile
    work = tempfile.TemporaryDirectory()    # phase 12's run and 17's stand-in
    phase12_run = os.path.join(work.name, "phase12_run")
    cli_counts = cli_training_path(torch, kernels, cfg, dev, step_rates,
                                   keep=phase12_run)

    # ---- phase 13: modes A and B at full width; K1-K4 at R = 1 ----
    mode_rows = mode_paths(torch, kernels, dev)

    # ---- phase 14: clustering through the CLIs ----
    clustering_path(torch, kernels, dev)

    # ---- phase 15: the particles model at the EMPIAR shape, its CLIs ----
    vertical_rows, _ = empiar_path(torch, kernels, dev)
    particles_cli(torch, kernels, dev, vertical_rows)

    # ---- phase 16: dSprites and galaxy through their CLIs ----
    vertical_clis(torch, kernels, dev)

    # ---- phases 17-18: the host feed; ranks sharing the card ----
    stand = stand_in(torch, work.name)
    stream_counts = host_feed_path(torch, kernels, dev, stand)
    rank_sp_counts = rank_paths(torch, kernels, dev, stand)

    # ---- phase 19: TP, mode B's SP, the float32 SP, the dry run ----
    mesh_rows, mesh_counts = mesh_paths(torch, kernels, dev)

    # ---- phase 20: .sav interop, the serving tools, the figures ----
    tool_counts = interop_tools_path(torch, kernels, dev, stand, phase12_run)
    work.cleanup()

    # ---- phase 21: each config's train step, its FLOPs and MFU ----
    bench_counts = measurement_path(torch, kernels, dev)

    by_path = {"embed": embed_counts, "eval": eval_counts,
               "train": train_counts, "embed_patch": patch_counts["embed"],
               "eval_patch": patch_counts["eval"],
               "train_patch": patch_counts["train"], "decode": decode_counts,
               "train_sp": sp_counts, "train_cli": cli_counts["conv"],
               "train_cli_patch": cli_counts["patch"],
               "train_stream_empiar": stream_counts,
               "train_sp_ctf_empiar": rank_sp_counts, **mesh_counts,
               **tool_counts, **bench_counts}
    # each kernel's launches on the main path that runs it: the conv tier's
    # train step, the patch tier's (K11, K12), bf16 decode (K9, K10), the
    # SP train step's rank 0 (K5, K6)
    main_path = {"lifted_encoder_fwd": "train_patch",
                 "lifted_encoder_bwd": "train_patch",
                 "decoder_mlp_fwd": "decode", "decoder_mlp_bwd": "decode",
                 "posterior_shard_fwd": "train_sp",
                 "posterior_shard_bwd": "train_sp"}
    bounds = kernel_bounds(cfg, B, shard_cells)
    entries = [
        kernel_entry(name, {
            "launches": by_path[main_path.get(name, "train")][name],
            "launches_by_path": {path: counts[name]
                                 for path, counts in by_path.items()},
            **results[name], "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1]})
        for name in SOURCES if not name.startswith(("mix_heads_r1",
                                                     "lift_conv"))]
    for row in lift_rows_k13.values():
        row.update(launches=by_path["train"]["lift_conv_fwd"],
                   launches_by_path={path: counts["lift_conv_fwd"]
                                     for path, counts in by_path.items()})
    # the R = 1 forms (phase 13) on their config's train steps, and the
    # particles path's kernels at the EMPIAR shape (phase 15)
    entries += [kernel_entry(key, row)
                for key, row in (lift_rows_k13 | mode_rows | vertical_rows
                                 | mesh_rows).items()]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def check_backward_kernels(torch, cfg, dev, k1, k3, k7, pose, k9, k11, h1,
                           results):
    """Phase 6: K2, K4, K8, K10, K12 and K7's save-residuals mode against
    their plain versions on the same flagship-shape inputs, with seeded
    cotangents, and K12 at the galaxy encoder's C = 3 shape. Returns the
    cotangents and K7's saved tiles for the timings."""
    R, K, zd = cfg.encoder.groupconv, cfg.encoder.kernels_num, cfg.encoder.z_dim
    gen = torch.Generator(device=dev).manual_seed(13)
    rn = lambda *s: torch.randn(s, generator=gen, device=dev)

    # K2
    g1 = rn(k1[0].shape[0], R * (3 + 2 * zd))
    results["mix_heads_bwd"] = {"max_abs_err": check_k2(torch, k1, g1, R, K,
                                                        "")}

    # K4, then K3 and K4 at the other shapes the port takes
    g3 = rn(B, 2 * zd + 5)
    check_posterior_bwd(torch, k3, g3, results, "flagship")
    check_posterior_shapes(torch, cfg, dev)

    # K7 save-residuals mode, then K8 and the pose closure
    g7 = rn(B, k7[0].shape[1] ** 2, k7[9].shape[1])
    err8, hs = check_k8(torch, k7, pose, g7, "")
    results["pose_decoder_bwd"] = {"max_abs_err": err8}

    # K12 from K11's saved h1, K10 from K9's inputs
    from targetvae_tpu_torch.kernels.decoder_mlp import (
        decoder_mlp_bwd, decoder_mlp_bwd_plain)
    from targetvae_tpu_torch.kernels.lifted_encoder import lifted_encoder_fwd
    g11 = rn(k11[0].shape[0], R * (3 + 2 * zd))
    results["lifted_encoder_bwd"] = {"max_abs_err": check_k12(
        torch, (k11[0], h1, *k11[3:6], g11), R, K, "")}
    k11_g, ecfg_g = galaxy_inputs(torch, dev)
    Rg, Kg = ecfg_g.groupconv, ecfg_g.kernels_num
    _, h1_g = lifted_encoder_fwd(*k11_g, R=Rg, K=Kg, save_h1=True)
    g11_g = rn(k11_g[0].shape[0], Rg * (3 + 2 * ecfg_g.z_dim))
    check_k12(torch, (k11_g[0], h1_g, *k11_g[3:6], g11_g), Rg, Kg,
              "galaxy C=3")

    g9 = rn(*k9[0].shape[:2], 1)
    got = decoder_mlp_bwd(*k9, g9)
    again = decoder_mlp_bwd(*k9, g9)
    ref = decoder_mlp_bwd_plain(*k9, g9)
    torch.cuda.synchronize()
    names = ("dx", "dhz", "dW1", "db1", "dWh", "dbh", "dW3", "db3")
    rels = {n: rel_l2(a, b) for n, a, b in zip(names, got, ref)}
    check(_finite(got) and max(rels.values()) <= TOL_K10_REL
          and _same(got, again),
          f"phase 6: K10 decoder_mlp_bwd x {tuple(k9[0].shape)}: rel L2 "
          f"{({n: float(f'{r:.2e}') for n, r in rels.items()})} <= "
          f"{TOL_K10_REL}; rerun bitwise identical")
    results["decoder_mlp_bwd"] = {"max_abs_err": _max_abs(got, ref)}
    return g1, g3, g7, hs, g11, g9


def _finite(ts) -> bool:
    return all(bool(ts_.isfinite().all()) for ts_ in ts)


def _same(a, b) -> bool:
    return all(x.equal(y) for x, y in zip(a, b))


def _max_abs(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def check_k2(torch, k1, g1, R, K, label, phase="6") -> float:
    """K2 on K1's inputs with the cotangent g1 against its plain version:
    dpre1 within one bf16 step outside the rows where a near-zero pre2
    flips the leaky slope (k2_leaky_flips), the other gradients within
    TOL_BWD_REL relative L2, a rerun bitwise equal. Returns the max abs
    error over its outputs."""
    from targetvae_tpu_torch.kernels.mix_heads import (
        lift_act_mix_heads_bwd_plain, mix_heads_bwd)
    got = mix_heads_bwd(*k1[:5], g1, R=R, K=K)
    again = mix_heads_bwd(*k1[:5], g1, R=R, K=K)
    ref = lift_act_mix_heads_bwd_plain(*k1[:5], g1, R=R, K=K)
    torch.cuda.synchronize()
    err_dp = float((got[0].float() - ref[0].float()).abs().max())
    rel_dp = rel_l2(got[0], ref[0])
    rels = [rel_l2(a, b) for a, b in zip(got[1:], ref[1:])]
    fl = k2_leaky_flips(torch, k1, g1, got[0], ref[0], R, K)
    check(_finite(got) and fl["err_other_rows"] <= fl["step"]
          and fl["rows_explained"] == fl["rows_past_step"]
          and rel_dp <= TOL_DPRE1_REL and max(rels) <= TOL_BWD_REL
          and _same(got, again),
          f"phase {phase}: K2 mix_heads_bwd {label + ' ' if label else ''}"
          f"{tuple(k1[0].shape)}: "
          f"dpre1 max_abs_err "
          f"{err_dp:.3e}; {fl['near_zero']} pre2 entries near zero in "
          f"{fl['rows_near_zero']} rows; other rows max_abs_err "
          f"{fl['err_other_rows']:.3e} <= one bf16 step {fl['step']:.3e}; "
          f"{fl['rows_past_step']} rows past it, {fl['rows_explained']} "
          f"within it after {fl['flips']} leaky-slope flips at near-zero "
          f"pre2; rel L2 {rel_dp:.3e} <= {TOL_DPRE1_REL}; dbc, dW2, db2, "
          f"dWh, dbh rel L2 {np.round(rels, 7).tolist()} <= {TOL_BWD_REL}; "
          f"rerun bitwise identical")
    return _max_abs(got, ref)


def check_k8(torch, k7, pose, g7, label, phase="6"):
    """K7's save-residuals mode (output identical to serving, h tiles within
    one bf16 step of the plain version's), then K8 with the cotangent g7
    and the pose closure against their plain versions (TOL_BWD_REL relative
    L2 each, a rerun bitwise equal). Returns K8's max abs error and K7's
    saved h tiles."""
    from targetvae_tpu_torch.kernels.decoder_pose import (
        fused_pose_decoder_tables, pose_closure, pose_decoder_bwd,
        pose_decoder_bwd_plain, pose_decoder_plain)
    y, hs = fused_pose_decoder_tables(*k7, save_res=True)
    y0 = fused_pose_decoder_tables(*k7)
    _, hs_p = pose_decoder_plain(*k7, save_res=True)
    torch.cuda.synchronize()
    hscale = float(hs_p.float().abs().max())
    err_hs = float((hs.float() - hs_p.float()).abs().max())
    check(torch.equal(y, y0) and err_hs <= hscale / 128,
          f"phase {phase}: K7 save-residuals{' ' + label if label else ''}: "
          f"output identical to the "
          f"serving forward; h tiles {tuple(hs.shape)} max_abs_err "
          f"{err_hs:.3e} <= {hscale / 128:.3e} (one bf16 step)")
    del hs_p
    bwd_args = (*k7[:4], hs, k7[5], k7[7], k7[9], g7)
    got = pose_decoder_bwd(*bwd_args)
    again = pose_decoder_bwd(*bwd_args)
    ref = pose_decoder_bwd_plain(*bwd_args)
    got = (*got, *pose_closure(*pose, *got[:3]))
    ref = (*ref, *pose_closure(*pose, *ref[:3]))
    torch.cuda.synchronize()
    names = ("dfx", "dfy", "dfc", "dhz", "dW1", "db1", "dWh", "dbh", "dW3",
             "db3", "dtheta", "d(dx)")
    rels = {n: rel_l2(a, b) for n, a, b in zip(names, got, ref)}
    check(_finite(got) and max(rels.values()) <= TOL_BWD_REL
          and _same(got[:10], again),
          f"phase {phase}: K8 pose_decoder_bwd {label + ' ' if label else ''}"
          f"{tuple(k7[0].shape)} "
          f"+ closure: rel "
          f"L2 {({n: float(f'{r:.2e}') for n, r in rels.items()})} <= "
          f"{TOL_BWD_REL}; rerun bitwise identical")
    return _max_abs(got, ref), hs


def check_k12(torch, bwd11, R, K, label, phase="6") -> float:
    """K12 on (P, h1, W2, b2, Wh, g) against its plain version: each
    gradient within TOL_BWD_REL relative L2, a rerun bitwise equal.
    Returns the max abs error over its outputs."""
    from targetvae_tpu_torch.kernels.lifted_encoder import (
        lifted_encoder_bwd, lifted_encoder_bwd_plain)
    got = lifted_encoder_bwd(*bwd11, R=R, K=K)
    again = lifted_encoder_bwd(*bwd11, R=R, K=K)
    ref = lifted_encoder_bwd_plain(*bwd11, R=R, K=K)
    torch.cuda.synchronize()
    names = ("dWc", "dbc", "dW2", "db2", "dWh", "dbh")
    rels = {n: rel_l2(a, b) for n, a, b in zip(names, got, ref)}
    check(_finite(got) and max(rels.values()) <= TOL_BWD_REL
          and _same(got, again),
          f"phase {phase}: K12 lifted_encoder_bwd {label + ' ' if label else ''}P "
          f"{tuple(bwd11[0].shape)}: rel L2 "
          f"{({n: float(f'{r:.2e}') for n, r in rels.items()})} <= "
          f"{TOL_BWD_REL}; rerun bitwise identical")
    return _max_abs(got, ref)


def train_path(torch, kernels, cfg, dev):
    """Phase 7: one deterministic step's gradients, bf16 kernel tier against
    float32 tier, then TRAIN_STEPS bf16 train steps (the main path of this
    slice) with the launch counts read around them."""
    from targetvae_tpu_torch.losses.elbo import compute_elbo
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig

    trainer = Trainer(cfg, TrainConfig(compute_dtype="bfloat16",
                                       minibatch_size=B), device=dev)
    state = trainer.init_state(0)
    model = trainer.model
    data = torch.from_numpy(synthetic_images(TRAIN_BATCHES * B,
                                             cfg.encoder.image_dim, 3)).to(dev)

    def tier_grads(dt):
        model.zero_grad(set_to_none=True)
        elbo = compute_elbo(model.params(), cfg, model.base_grid(), data[:B],
                            None, dt)[0]
        (-elbo).backward()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    with encoder_tier("conv"):
        g16 = tier_grads(torch.bfloat16)
    g32 = tier_grads(None)
    model.zero_grad(set_to_none=True)
    check_tier_grads(torch, g16, g32, "conv")

    with encoder_tier("conv"):
        state, counts = train_steps(torch, kernels, trainer, state, data,
                                    TRAIN_STEPS, "conv")
    used = with_lift(("mix_heads_fwd", "mix_heads_bwd", "posterior_fwd",
                      "posterior_bwd", "pose_decoder_fwd", "pose_decoder_bwd"))
    check(all(counts[k] > 0 for k in used)
          and not any(counts[k] for k in counts if k not in used),
          f"phase 7: conv tier launches {counts} (K13, K1-K4, K7, K8 only)")
    return trainer, state, data, counts, g32


def check_tier_grads(torch, g16, g32, tier, phase="7", leaf_tol=None):
    """One deterministic step's gradients, a bf16 kernel tier against the
    float32 tier, each parameter leaf within TOL_GRAD relative L2 (or its
    bound in leaf_tol). The attention head's bias (modes B and C): the
    softmax over the cells is invariant to a shift of every logit, so its
    exact gradient is zero and both tiers hold rounding noise, held to 1e-3
    of the attention weights' gradient."""
    leaf_tol = leaf_tol or {}
    shift = "encoder.conv_a.b"
    rels = {n: rel_l2(g16[n], g32[n]) for n in g32 if n != shift}
    worst = max(rels, key=lambda n: rels[n] / leaf_tol.get(n, TOL_GRAD))
    shift_ok, shift_msg = True, ""
    if shift in g32:
        floor = 1e-3 * float(g32["encoder.conv_a.w"].norm())
        n16, n32 = float(g16[shift].norm()), float(g32[shift].norm())
        shift_ok = n16 <= floor and n32 <= floor
        shift_msg = f"; {shift} |g| {n16:.2e} / {n32:.2e} <= {floor:.2e}"
    groups = {}
    for n, v in leaf_tol.items():
        groups.setdefault(v, []).append(n)
    check(all(bool(torch.isfinite(g).all()) for g in g16.values())
          and rels[worst] <= leaf_tol.get(worst, TOL_GRAD) and shift_ok,
          f"phase {phase}: deterministic step gradients, bf16 {tier} tier "
          f"vs float32 tier, rel L2 per leaf <= {TOL_GRAD}"
          + "".join(f" ({os.path.commonprefix(ns)}* <= {v:.3g})"
                    for v, ns in groups.items())
          + f": {({n: float(f'{r:.2e}') for n, r in rels.items()})}; worst "
          f"{worst}" + shift_msg)


def train_steps(torch, kernels, trainer, state, data, steps, tier):
    """`steps` bf16 train steps over the fixed batches with the launch
    counts read around them: finite metrics and a rising ELBO. Returns the
    state and the counts."""
    kernels.reset_launch_counts()
    metrics = []
    for i in range(steps):
        j = i % TRAIN_BATCHES
        state, m = trainer.train_step(state, data[j * B:(j + 1) * B])
        metrics.append(m)
    m = torch.stack(metrics).cpu().numpy()
    counts = kernels.launch_counts()
    first, last = float(m[:5, 0].mean()), float(m[-5:, 0].mean())
    check(bool(np.isfinite(m).all()) and last > first and state.step == steps,
          f"phase 7: {tier} tier: {steps} bf16 train steps at B={B} (Adam, lr "
          f"{trainer.cfg.learning_rate}): ELBO finite, mean of the first 5 "
          f"{first:.3f} -> last 5 {last:.3f}; launches {counts}")
    print(f"phase 7: {tier} tier: ELBO per step "
          f"{np.round(m[:, 0], 2).tolist()}", flush=True)
    return state, counts


def patch_train_path(torch, kernels, cfg, dev, data, g32):
    """Phase 7 on the patch encoder tier: one deterministic step's gradients
    against the float32 tier's (g32, the same weights and batch), then
    PATCH_STEPS train steps from the same fresh weights, launching K11 and
    K12 and neither K1 nor K2."""
    from targetvae_tpu_torch.losses.elbo import compute_elbo
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    trainer = Trainer(cfg, TrainConfig(compute_dtype="bfloat16",
                                       minibatch_size=B), device=dev)
    state = trainer.init_state(0)
    model = trainer.model
    with encoder_tier("patch"):
        model.zero_grad(set_to_none=True)
        elbo = compute_elbo(model.params(), cfg, model.base_grid(), data[:B],
                            None, torch.bfloat16)[0]
        (-elbo).backward()
        g16 = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        check_tier_grads(torch, g16, g32, "patch")
        state, counts = train_steps(torch, kernels, trainer, state, data,
                                    PATCH_STEPS, "patch")
    used = ("lifted_encoder_fwd", "lifted_encoder_bwd", "posterior_fwd",
            "posterior_bwd", "pose_decoder_fwd", "pose_decoder_bwd")
    check(all(counts[k] > 0 for k in used)
          and not any(counts[k] for k in counts if k not in used),
          f"phase 7: patch tier launches {counts} (K11, K12, K3, K4, K7, K8 "
          f"only)")
    return trainer, state, counts


def decode_path(torch, kernels, model, params, k9, z):
    """Phase 9: TargetVAE.decode in bf16 (K9) at the posed 50x50 grids
    against float32 decode, then a gradient through it (K10), held against
    float32 decode's; then the device ms of each. Returns the launch counts
    of the two bf16 calls and the times."""
    x = k9[0]
    g = torch.randn(x.shape[:2] + (1,),
                    generator=torch.Generator(device=x.device).manual_seed(17),
                    device=x.device)

    def grads(dt):
        model.zero_grad(set_to_none=True)
        xx, zz = x.clone().requires_grad_(), z.clone().requires_grad_()
        y = model.decode(model.params(), xx, zz, dt)
        y.backward(g)
        out = {"x": xx.grad, "z": zz.grad}
        out.update({n: p.grad for n, p in model.named_parameters()
                    if p.grad is not None})
        return y.detach(), out

    with torch.inference_mode():
        d32 = model.decode(params, x, z)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        d16 = model.decode(params, x, z, torch.bfloat16)
    y16, g16 = grads(torch.bfloat16)
    counts = kernels.launch_counts()
    _, g32 = grads(None)
    model.zero_grad(set_to_none=True)
    err = float((d16 - d32).abs().max())
    scale = float(d32.abs().max())
    rels = {n: rel_l2(g16[n], g32[n]) for n in g32}
    ok_grads = all(r <= (TOL_DECODE_GRAD_IN if n in ("x", "z")
                         else TOL_DECODE_GRAD) for n, r in rels.items())
    check(bool(torch.isfinite(d16).all()) and err <= 2e-2 * scale
          and torch.equal(y16, d16)
          and all(bool(torch.isfinite(v).all()) for v in g16.values())
          and ok_grads and counts["decoder_mlp_fwd"] == 2
          and counts["decoder_mlp_bwd"] == 1
          and not any(v for k, v in counts.items()
                      if k not in ("decoder_mlp_fwd", "decoder_mlp_bwd")),
          f"phase 9: bf16 decode x {tuple(x.shape)} vs float32: max abs diff "
          f"{err:.3e} <= 2e-2 of {scale:.3e}; gradient through it, rel L2 vs "
          f"float32 {({n: float(f'{r:.2e}') for n, r in rels.items()})} <= "
          f"{TOL_DECODE_GRAD} (x, z {TOL_DECODE_GRAD_IN}); launches {counts} "
          f"(K9 twice, K10 once)")
    # serving decode, and decode with the gradient (K9, K10 and autograd's
    # sums into the leaves), device time, each the smaller of two runs
    with torch.inference_mode():
        serve = lambda: model.decode(params, x, z, torch.bfloat16)
        fwd_ms = min(cuda_ms(serve), cuda_ms(serve))
    grad_ms = min(cuda_ms(lambda: grads(torch.bfloat16)),
                  cuda_ms(lambda: grads(torch.bfloat16)))
    model.zero_grad(set_to_none=True)
    n = x.shape[1]
    print(f"phase 9: bf16 decode of {x.shape[0]} posed grids of {n} pixels: "
          f"{x.shape[0] / fwd_ms * 1e3:.1f} img/s ({fwd_ms:.3f} ms/batch "
          f"device time); with the gradient {x.shape[0] / grad_ms * 1e3:.1f} "
          f"img/s ({grad_ms:.3f} ms/batch)", flush=True)
    return counts, {"decode_ms": fwd_ms, "decode_grad_ms": grad_ms}


# K8's, K10's and K12's passes by the kernel names the profiler reports
# (csrc/decoder_pose_bwd.cu, csrc/decoder_mlp.cu, csrc/lifted_encoder.cu;
# the template's first argument is the feature source: 0 a stored matrix,
# 1 the pose tables, 2 the coordinates)
K8_PASSES = (("chain", "chain_kernel"), ("ordered sums", "sum_partials_kernel"),
             ("dW1", "wgrad_kernel<1"), ("dWh", "wgrad_kernel<0"),
             ("pose", "phase_kernel"))
K10_PASSES = (("recompute", "fwd_kernel"), ("chain", "chain_kernel"),
              ("ordered sums", "sum_partials_kernel"),
              ("dW1", "wgrad_kernel<2"), ("dWh", "wgrad_kernel<0"),
              ("dx", "phase_kernel"))
K12_PASSES = (("chain", "chain_kernel"), ("dWc", "wgrad_kernel"),
              ("ordered sums", "sum_partials_kernel"))


def pass_times(torch, fn, passes, label: str, reps: int = 5) -> dict:
    """Device ms of each pass (name, kernel name) of a backward kernel per
    call of fn, from the profiler's kernel times over `reps` calls after a
    warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    out = {}
    for name, key in passes:
        out[name] = sum(dev_us(e) for e in prof.key_averages()
                        if key in e.key) / reps / 1e3
    check(all(v > 0 for v in out.values()),
          f"phase 8: the profiler sees every pass of {label} on the device: "
          f"{ {k: round(v, 4) for k, v in out.items()} }")
    return out


def time_training(torch, cfg, k1, k3, k7, k9, k11, h1, cot, trainer, state,
                  trainer_p, state_p, data, results):
    """Phase 8: each backward kernel against its plain version, K8's, K10's
    and K12's passes one by one, K7 with and without saved residuals, K11
    with and without saving h1, cuBLAS GEMMs at the decoders' layer-1 shape
    and K12's dWc shape, K1, K2, K11 and K12 with tanh, and the train step
    of each encoder tier."""
    from targetvae_tpu_torch.kernels.decoder_mlp import (
        decoder_mlp_bwd, decoder_mlp_bwd_plain)
    from targetvae_tpu_torch.kernels.decoder_pose import (
        fused_pose_decoder_tables, pose_decoder_bwd, pose_decoder_bwd_plain)
    from targetvae_tpu_torch.kernels.lifted_encoder import (
        lifted_encoder_bwd, lifted_encoder_bwd_plain, lifted_encoder_fwd)
    from targetvae_tpu_torch.kernels.mix_heads import (
        lift_act_mix_heads_bwd_plain, mix_heads_bwd, mix_heads_fwd)
    from targetvae_tpu_torch.kernels.posterior import (
        philox_gumbel, posterior_bwd, posterior_bwd_plain)

    R, K = cfg.encoder.groupconv, cfg.encoder.kernels_num
    g1, g3, g7, hs, g11, g9 = cot
    bwd7 = (*k7[:4], hs, k7[5], k7[7], k7[9], g7)
    bwd11 = (k11[0], h1, *k11[3:6], g11)
    with torch.inference_mode():
        noise3 = philox_gumbel(9, B, R, k3[0].shape[1], k3[0].device)
        for name, kfn, kargs, pfn, pargs, yard in (
                ("mix_heads_bwd",
                 lambda *a: mix_heads_bwd(*a, R=R, K=K), (*k1[:5], g1),
                 lambda *a: lift_act_mix_heads_bwd_plain(*a, R=R, K=K),
                 (*k1[:5], g1), None),
                ("posterior_bwd",
                 lambda *a: posterior_bwd(9, g3, *a), k3,
                 lambda *a: posterior_bwd_plain(g3, *a, noise=noise3), k3,
                 (torch.neg, (k3[0],))),
                ("pose_decoder_bwd", pose_decoder_bwd, bwd7,
                 pose_decoder_bwd_plain, bwd7, None),
                ("lifted_encoder_bwd",
                 lambda *a: lifted_encoder_bwd(*a, R=R, K=K), bwd11,
                 lambda *a: lifted_encoder_bwd_plain(*a, R=R, K=K), bwd11,
                 None),
                ("decoder_mlp_bwd", decoder_mlp_bwd, (*k9, g9),
                 decoder_mlp_bwd_plain, (*k9, g9), None)):
            time_kernel(results, name, "8", kfn, kargs, pfn, pargs, yard)
        det4 = lambda *a: posterior_bwd(9, g3, *a, deterministic=True)
        results["posterior_bwd"]["det_ms"] = min(device_ms(det4, k3),
                                                 device_ms(det4, k3))
        print(f"phase 8: posterior_bwd deterministic: kernel "
              f"{results['posterior_bwd']['det_ms']:.4f} ms (device time)",
              flush=True)
        for name, serve, save, args in (
                ("pose_decoder_fwd", fused_pose_decoder_tables,
                 lambda *a: fused_pose_decoder_tables(*a, save_res=True), k7),
                ("lifted_encoder_fwd",
                 lambda *a: lifted_encoder_fwd(*a, R=R, K=K),
                 lambda *a: lifted_encoder_fwd(*a, R=R, K=K, save_h1=True),
                 k11)):
            a1, b1, b2, a2 = (device_ms(serve, args), device_ms(save, args),
                              device_ms(save, args), device_ms(serve, args))
            results[name]["save_ms"] = min(b1, b2)
            print(f"phase 8: {name} saving for the backward {b1:.4f} / "
                  f"{b2:.4f} ms vs serving {a1:.4f} / {a2:.4f} ms (serving, "
                  f"saving, saving, serving)", flush=True)
        for name, label, fn, table in (
                ("pose_decoder_bwd", "K8", lambda: pose_decoder_bwd(*bwd7),
                 K8_PASSES),
                ("decoder_mlp_bwd", "K10", lambda: decoder_mlp_bwd(*k9, g9),
                 K10_PASSES),
                ("lifted_encoder_bwd", "K12",
                 lambda: lifted_encoder_bwd(*bwd11, R=R, K=K), K12_PASSES)):
            passes = pass_times(torch, fn, table, label)
            results[name]["passes_ms"] = passes
            print(f"phase 8: {name} passes (device ms a call, profiler): "
                  f"{json.dumps({k: round(v, 4) for k, v in passes.items()})}",
                  flush=True)
        # yardstick: one cuBLAS bf16 GEMM at K12's dWc shape, P^T (C k^2 x
        # N) @ dpre1 (N x R K), beside K12's dWc pass
        dpre1 = mix_heads_bwd(*k1[:5], g1, R=R, K=K)[0]
        pt = k11[0]
        mm = lambda a, b: a.T @ b
        dwc_ms = min(device_ms(mm, (pt, dpre1)), device_ms(mm, (pt, dpre1)))
        results["lifted_encoder_bwd"]["dwc_gemm_cublas_ms"] = dwc_ms
        dwc_ops = 2 * pt.shape[0] * pt.shape[1] * dpre1.shape[1]
        print(f"phase 8: yardstick cuBLAS bf16 P^T ({pt.shape[1]} x "
              f"{pt.shape[0]}) @ dpre1 ({dpre1.shape[0]} x {dpre1.shape[1]}) "
              f"{dwc_ms:.4f} ms ({dwc_ops / dwc_ms / 1e9:.1f} TFLOP/s) beside "
              f"K12's dWc pass {passes['dWc']:.4f} ms "
              f"({dwc_ops / passes['dWc'] / 1e9:.1f} TFLOP/s)", flush=True)
        del dpre1
        # yardstick: one cuBLAS bf16 GEMM at the decoders' layer-1 shape
        # (all pixels x F) x (F x H), K7's and K9's alike; no single library
        # call computes K7-K10, so it stays out of library_ms, and the port
        # never calls it
        u = k7[0]
        npx_all, F, H = u.shape[0] * u.shape[1] ** 2, u.shape[2], k7[5].shape[1]
        gen = torch.Generator(device=u.device).manual_seed(11)
        a16 = torch.randn((npx_all, F), generator=gen, device=u.device,
                          dtype=torch.bfloat16)
        w16 = k7[5].to(torch.bfloat16)
        gemm = min(device_ms(torch.matmul, (a16, w16)),
                   device_ms(torch.matmul, (a16, w16)))
        del a16
        for name in ("pose_decoder_fwd", "pose_decoder_bwd",
                     "decoder_mlp_fwd", "decoder_mlp_bwd"):
            results[name]["layer1_gemm_cublas_ms"] = gemm
        print(f"phase 8: yardstick cuBLAS bf16 ({npx_all} x {F}) @ ({F} x {H}) "
              f"{gemm:.4f} ms ({2 * npx_all * F * H / gemm / 1e9:.1f} "
              f"TFLOP/s)", flush=True)

    yb = data[:B]
    step_rates = {}
    for tier, tr, st in (("conv", trainer, state), ("patch", trainer_p,
                                                     state_p)):
        with encoder_tier(tier):
            step_ms = cuda_ms(lambda: tr.train_step(st, yb))
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(10):
                tr.train_step(st, yb)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) / 10 * 1e3
        print(f"phase 8: {tier} tier: train {B / step_ms * 1e3:.1f} img/s "
              f"(bf16 train_step, B={B}, {step_ms:.3f} ms/step device time "
              f"incl. Adam; {wall_ms:.3f} ms/step host clock)", flush=True)
        step_rates[tier] = (B / step_ms * 1e3, B / wall_ms * 1e3)

    # the posterior stage: the device ops between the encoder kernel and K7,
    # and between K8 and K2's or K12's chain, of the train step and of the
    # eval batch (sampled), each tier
    gen = torch.Generator().manual_seed(5)
    stage = {}
    for tier, tr, st in (("conv", trainer, state), ("patch", trainer_p,
                                                     state_p)):
        x_coord = tr.model.base_grid()
        with encoder_tier(tier):
            stage[tier + " train"] = posterior_stage(device_ops(
                torch, lambda: tr.train_step(st, yb)))
            with torch.inference_mode():
                stage[tier + " eval"] = posterior_stage(device_ops(
                    torch, lambda: tr.model.elbo(tr.model.params(), x_coord,
                                                 yb, gen, torch.bfloat16)))
    results["posterior_fwd"]["stage_ms"] = {
        k: {n: v for n, v in st_.items() if n.endswith("_ms")}
        for k, st_ in stage.items()}
    check(all("fwd_ms" in v for v in stage.values())
          and all("bwd_ms" in stage[t + " train"] for t in ("conv", "patch")),
          "phase 8: posterior stage found in every profile (device ms a "
          "call, forward: encoder kernel to K7; backward: K8 to K2/K12): "
          + json.dumps({k: {n: round(v, 4) for n, v in st_.items()}
                        for k, st_ in results["posterior_fwd"]["stage_ms"]
                        .items()}))
    for key in ("conv train", "patch eval"):
        for part in ("fwd", "bwd"):
            if part + "_ops" in stage[key]:
                print(f"phase 8: posterior stage, {key}, {part} ops (name, "
                      f"device ms a call, count a call): "
                      + json.dumps(stage[key][part + "_ops"]), flush=True)

    # K1, K2, K11 and K12 once more with tanh, which every CLI's
    # --activation offers: K1 and K2 then take tanh of pre1 in their loader
    # warps and of pre2 in their epilogues, K11 and K12 in their epilogues
    # alone. After the train steps, so that this profiler session does not
    # precede their timing
    with torch.inference_mode():
        k12_tanh = lambda: lifted_encoder_bwd(*bwd11, R=R, K=K,
                                              act_kind="tanh")
        tanh = lambda f: lambda *a: f(*a, R=R, K=K, act_kind="tanh")
        for name, fn, args in (
                ("mix_heads_fwd", tanh(mix_heads_fwd), k1),
                ("mix_heads_bwd", tanh(mix_heads_bwd), (*k1[:5], g1)),
                ("lifted_encoder_fwd", tanh(lifted_encoder_fwd), k11),
                ("lifted_encoder_bwd", tanh(lifted_encoder_bwd), bwd11)):
            t1, t2 = device_ms(fn, args), device_ms(fn, args)
            results[name]["tanh_ms"] = min(t1, t2)
            print(f"phase 8: {name} tanh: kernel {t1:.4f} / {t2:.4f} ms",
                  flush=True)
        tanh_passes = pass_times(torch, k12_tanh, K12_PASSES, "K12 tanh")
        results["lifted_encoder_bwd"]["tanh_passes_ms"] = tanh_passes
        print(f"phase 8: lifted_encoder_bwd tanh passes (device ms a call, "
              f"profiler): "
              f"{json.dumps({k: round(v, 4) for k, v in tanh_passes.items()})}",
              flush=True)
    return step_rates


def wide_latent_routes(torch, kernels, cfg, dev, data) -> None:
    """Phase 6: the bf16 ELBO at z_dim 8 and 10, past the encoder kernels'
    16 heads (the XLA bf16 recipe) and, at 10, past K3/K4's z <= 8 (the
    posterior's model code): the deterministic ELBO of B images within
    TOL_ELBO of the float32 tier's, finite gradients, and the launches of
    the route (K13 and K7/K8 always; K3/K4 at z_dim 8 only; never K1/K2)
    with the fallbacks it counts (the encoder's; at 10 the posterior's)."""
    import dataclasses
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.losses.elbo import compute_elbo
    for zd in (8, 10):
        c = dataclasses.replace(
            cfg, encoder=dataclasses.replace(cfg.encoder, z_dim=zd),
            generator=dataclasses.replace(cfg.generator, z_dim=zd))
        model = TargetVAE(c, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        kernels.reset_launch_counts()
        e16 = compute_elbo(params, c, model.base_grid(), data[:B], None,
                           torch.bfloat16)[0]
        (-e16).backward()
        counts = kernels.launch_counts()
        with torch.no_grad():
            e32 = compute_elbo(params, c, model.base_grid(), data[:B], None,
                               None)[0]
        e16 = e16.detach()
        rel = abs(float(e16) - float(e32)) / abs(float(e32))
        finite = all(bool(torch.isfinite(p.grad).all())
                     for p in model.parameters())
        used = {"lift_conv_fwd", "pose_decoder_fwd", "pose_decoder_bwd",
                "fallback.encoder"} | (
            {"posterior_fwd", "posterior_bwd"} if zd <= 8
            else {"fallback.posterior"})
        check(rel <= TOL_ELBO and finite
              and all(counts[k] > 0 for k in used)
              and not any(counts[k] for k in counts if k not in used),
              f"phase 6: z_dim {zd}: encoder on the XLA bf16 recipe, "
              f"posterior on {'K3/K4' if zd <= 8 else 'model code'}: "
              f"deterministic ELBO bf16 {float(e16):.4f} vs float32 "
              f"{float(e32):.4f} (rel {rel:.3e} <= {TOL_ELBO}), gradients "
              f"finite, launches {counts}")
        del model, params


def routed_generator_path(torch, kernels, cfg, dev, data) -> None:
    """Phase 11: the bf16 tier at a generator width no decoder kernel takes
    (hidden 384), otherwise the flagship: its generator runs the XLA bf16
    recipe. One eval batch (within TOL_ELBO of the float32 tier's,
    deterministic), ROUTED_STEPS train steps and decode with and without a
    gradient, all finite; the encoder and posterior kernels launched, the
    decoder kernels (K7-K10) never."""
    import dataclasses
    from targetvae_tpu_torch.ops.coords import transform_coords
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    c = dataclasses.replace(cfg, generator=dataclasses.replace(
        cfg.generator, hidden_dim=ROUTED_HIDDEN))
    trainer = Trainer(c, TrainConfig(compute_dtype="bfloat16"), device=dev)
    state = trainer.init_state(0)
    model = trainer.model
    x0 = model.base_grid()
    g = torch.Generator(device=dev).manual_seed(23)
    theta, dx = (torch.randn(s, generator=g, device=dev) * 0.3
                 for s in ((B,), (B, 2)))
    z = torch.randn((B, c.generator.z_dim), generator=g, device=dev)
    x = transform_coords(x0, dx, theta).contiguous()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        e16 = model.elbo(model.params(), x0, data[:B], None, torch.bfloat16)
        e32 = model.elbo(model.params(), x0, data[:B], None, None)
        y16 = model.decode(model.params(), x, z, torch.bfloat16)
    metrics = []
    for i in range(ROUTED_STEPS):
        state, m = trainer.train_step(state, data[i * B:(i + 1) * B])
        metrics.append(m)
    xg = x.clone().requires_grad_()
    yg = model.decode(model.params(), xg, z, torch.bfloat16)
    yg.square().mean().backward()
    counts = kernels.launch_counts()
    metrics = torch.stack(metrics).cpu().numpy()
    rel = abs(float(e16[0]) - float(e32[0])) / abs(float(e32[0]))
    decoders = ("pose_decoder_fwd", "pose_decoder_bwd", "decoder_mlp_fwd",
                "decoder_mlp_bwd")
    used = ("mix_heads_fwd", "mix_heads_bwd", "posterior_fwd",
            "posterior_bwd")
    check(rel <= TOL_ELBO and bool(np.isfinite(metrics).all())
          and bool(torch.isfinite(y16).all())
          and bool(torch.isfinite(xg.grad).all())
          and all(counts[k] > 0 for k in used)
          and not any(counts[k] for k in decoders),
          f"phase 11: generator hidden {ROUTED_HIDDEN} (no decoder kernel "
          f"takes it: the XLA bf16 recipe): deterministic ELBO bf16 "
          f"{float(e16[0]):.4f} vs float32 {float(e32[0]):.4f} (rel "
          f"{rel:.3e} <= {TOL_ELBO}); {ROUTED_STEPS} train steps (elbo "
          f"{np.round(metrics[:, 0], 3).tolist()}), decode {tuple(y16.shape)}"
          f" and its gradient finite; launches {counts} (K1-K4, no K7-K10)")


def sp_shard_inputs(torch, cfg, dev, noise: bool, zd=None):
    """K5/K6's inputs at phase 10's shapes, in the JAX package's contract:
    the flagship's 12,168 cells per image padded to a multiple of SP_RANKS
    * 1,024 (the SP step's padding, -1e30 logits and log-prior), seeded
    planes like kernel_inputs' K3 planes (z_dim zd, the config's by
    default), the cell constants of the r-minor flatten, and the
    normalisers over the whole padded grid, for B images. Returns the
    shards' argument tuples (the last shard holds the pads) and the number
    of pads."""
    from targetvae_tpu_torch.models.encoders import attn_dim_for, group_offsets
    from targetvae_tpu_torch.ops.coords import attention_grid
    from targetvae_tpu_torch.ops.gumbel import gumbel_noise
    from targetvae_tpu_torch.train.loop import SP_CELL_UNIT
    e = cfg.encoder
    R, hp = e.groupconv, attn_dim_for(e)
    zd = zd or e.z_dim
    cells = hp * hp * R
    unit = SP_RANKS * SP_CELL_UNIT
    total = -(-cells // unit) * unit
    pad = total - cells
    g = torch.Generator(device=dev).manual_seed(21)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    attn = rn(B, total) * 2
    attn[:, cells:] = -1e30
    gum = (gumbel_noise((B, total), g, dev) if noise
           else torch.zeros(B, total, device=dev))
    p = torch.log_softmax(rn(cells), dim=0)
    grid = torch.as_tensor(np.repeat(attention_grid(hp, e.image_dim), R, 0),
                           device=dev)
    offs = torch.as_tensor(np.tile(group_offsets(R), hp * hp), device=dev)
    zero = torch.zeros(pad, device=dev)
    p, gx, gy, offs = (torch.cat([v, zero]) for v in (p, grid[:, 0],
                                                      grid[:, 1], offs))
    p[cells:] = -1e30
    th, z = rn(B, 2, total) * 0.5, rn(B, 2, zd, total) * 0.5
    lse = lambda x: [x.amax(1, keepdim=True), torch.log(torch.exp(
        x - x.amax(1, keepdim=True)).sum(1, keepdim=True))]
    norms = torch.cat(lse(attn) + lse(attn + gum), dim=1)
    c = total // SP_RANKS
    cut = lambda v, i: v[..., i * c:(i + 1) * c].contiguous()
    return [(norms, *(cut(v, i) for v in (attn, gum, th, z, p, gx, gy, offs)))
            for i in range(SP_RANKS)], pad


def as_planes(args):
    """posterior_shard_partials' arguments (norms, attn, noise, th, z, p,
    gx, gy, offs) as K5/K6's: (norms, planes, noise, p, gx, gy, offs)."""
    from targetvae_tpu_torch.kernels.posterior import pack_planes
    norms, attn, noise, th, z, *consts = args
    return (norms, pack_planes(attn, th, z), noise, *consts)


def check_shard_kernels(torch, args, sig_r, g, label, pad=0,
                        phase="10") -> tuple:
    """Phase 10 (and 19, at R = 1): K5 on the planes and K6 through posterior_shard_partials
    (the JAX package's contract) against their plain versions on one
    shard: each value within TOL_K5 per unit of max(1, |ref|), K6's
    per-cell cotangents each within TOL_K4_SCALED of its own magnitude,
    reruns bitwise, and on a shard with `pad` pads d_q, theta, z and
    d_attn exactly 0 there. Returns the max abs errors (fwd, bwd) and the
    kernels' outputs."""
    from targetvae_tpu_torch.kernels.posterior import (
        posterior_shard_bwd_plain, posterior_shard_fwd, posterior_shard_partials,
        posterior_shard_plain)
    zd = args[4].shape[2]
    pa = as_planes(args)
    out = posterior_shard_fwd(*pa, sig_r)
    again = posterior_shard_fwd(*pa, sig_r)
    ref = posterior_shard_plain(*args, sig_r)
    kw = {"sig_r": sig_r, "zd": zd, "want_grads": True, "g": g}
    got = posterior_shard_partials(*args, **kw)
    got2 = posterior_shard_partials(*args, **kw)
    refb = posterior_shard_bwd_plain(*args, sig_r, g)
    torch.cuda.synchronize()
    per_unit = lambda a, b: float(((a - b).abs() / b.abs().clamp(min=1.0))
                                  .max())
    ef = per_unit(out, ref)
    eb = max(per_unit(a, b) for a, b in zip(got, refb))
    # the per-cell cotangents, each element to its own magnitude
    sb = max(scaled_err(a, b, (-1,)) for a, b in zip(got[:4], refb[:4]))
    dead = "no pads"
    if pad:
        norms, attn = args[0], args[1]
        da, dq, dth, dz, spart = got
        a = torch.exp(attn + args[2] - norms[:, 2:3] - norms[:, 3:4])
        eq = torch.exp(attn - norms[:, 0:1] - norms[:, 1:2])
        d_attn = a * (da - spart[:, 0:1]) + dq - eq * spart[:, 1:2]
        tail = slice(attn.shape[1] - pad, None)
        zero = not any(bool(t[..., tail].any())
                       for t in (dq, dth, dz, d_attn))
        check(zero, f"phase {phase}: K6 {label}: d_q, theta, z and d_attn "
              f"exactly 0 on its {pad} pads")
        dead = f"{pad} pads"
    check(bool(torch.isfinite(out).all()) and ef <= TOL_K5
          and eb <= TOL_K5 and sb <= TOL_K4_SCALED
          and torch.equal(out, again)
          and all(torch.equal(a, b) for a, b in zip(got, got2)),
          f"phase {phase}: K5/K6 {label} {tuple(args[1].shape)} zd={zd} "
          f"({dead}):"
          f" fwd max err {ef:.3e}, bwd {eb:.3e} <= {TOL_K5} * max(1, |ref|);"
          f" bwd's per-cell cotangents, each element {sb:.3e} <= "
          f"{TOL_K4_SCALED} * (|ref| + {K4_FLOOR} * max |ref|); reruns "
          f"bitwise identical")
    return ((float((out - ref).abs().max()),
             max(float((a - b).abs().max()) for a, b in zip(got, refb))),
            out, got)


def sp_kernel_checks(torch, cfg, dev, results) -> int:
    """Phase 10: K5 and K6 against their plain versions at the two-rank
    shard shape, deterministic and with seeded noise, on the first shard
    and on the last, whose tail is -1e30 padding; at z_dim 2 (the
    flagship's), 8 and 10 (past K3/K4's templates: K5/K6 take any z_dim);
    on a shard of 5,000 cells, no multiple of the CTA's chunk; and B = 100
    against two batches of 50, row for row, bitwise. Then their times
    (plain, kernel, kernel, plain) at the flagship's. Returns the shard's
    cells."""
    from targetvae_tpu_torch.kernels.posterior import (
        posterior_shard_bwd, posterior_shard_bwd_plain, posterior_shard_fwd,
        posterior_shard_partials, posterior_shard_plain, shard_schedule)
    sig_r = float(np.pi / cfg.encoder.groupconv)
    gen = torch.Generator(device=dev).manual_seed(22)
    cot = lambda zd: torch.randn(B, 2 * zd + 5, generator=gen, device=dev)
    errs = [0.0, 0.0]
    with torch.inference_mode():
        for zd, noises in ((cfg.encoder.z_dim, (False, True)), (8, (True,)),
                           (10, (True,))):
            g = cot(zd)
            for noise in noises:
                shards, pad = sp_shard_inputs(torch, cfg, dev, noise, zd)
                for i in ((0,) if not noise else (0, len(shards) - 1)):
                    last = i == len(shards) - 1
                    e, _, _ = check_shard_kernels(
                        torch, shards[i], sig_r, g,
                        f"shard {i} ({'seeded noise' if noise else 'no noise'}"
                        f")", pad if last else 0)
                    if zd == cfg.encoder.z_dim:
                        errs = [max(x, y) for x, y in zip(errs, e)]
                del shards
        zd = cfg.encoder.z_dim
        g = cot(zd)
        shards, _ = sp_shard_inputs(torch, cfg, dev, True)
        args = shards[0]
        # a shard that is no multiple of the CTA's chunk
        cut = tuple(a[..., :5000].contiguous() if a.dim() > 1 else a[:5000]
                    for a in args[1:])
        check_shard_kernels(torch, (args[0], *cut), sig_r, g,
                            f"5,000 cells, grid {shard_schedule(5000)}")
        # each row depends on its image alone
        _, out, got = check_shard_kernels(torch, args, sig_r, g, "B=100")
        kw = {"sig_r": sig_r, "zd": zd}
        same = True
        for h in (slice(0, B // 2), slice(B // 2, B)):
            part = tuple(a[h] if a.dim() > 1 else a for a in args)
            same &= torch.equal(posterior_shard_partials(*part, **kw), out[h])
            same &= all(torch.equal(a, b[h]) for a, b in zip(
                posterior_shard_partials(*part, want_grads=True, g=g[h], **kw),
                got))
        check(same, f"phase 10: K5/K6 at B={B} equal two calls of {B // 2}, "
              f"row for row, bitwise")
        # yardstick: one pass over as many bytes as the shard's inputs, a
        # sum for K5, a negation (read and written) for K6
        pa = as_planes(args)
        flat = torch.randn((B, sum(a.numel() for a in args) // B), device=dev)
        for name, kfn, pfn, yard in (
                ("posterior_shard_fwd",
                 lambda *a: posterior_shard_fwd(*a, sig_r),
                 lambda *a: posterior_shard_plain(*a, sig_r),
                 (lambda x: x.sum(1), (flat,))),
                ("posterior_shard_bwd",
                 lambda *a: posterior_shard_bwd(*a, sig_r, g),
                 lambda *a: posterior_shard_bwd_plain(*a, sig_r, g),
                 (torch.neg, (flat,)))):
            results[name] = {"max_abs_err": errs[name.endswith("bwd")]}
            time_kernel(results, name, "10", kfn, pa, pfn, args, yard)
        del flat
    return args[1].shape[1]


def param_digest(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def profile_summary(prof, steps: int) -> dict:
    """Per step: the device time of all kernels, the largest kernels by
    device time, and the host time of the collectives (which includes
    waiting for the other ranks)."""
    from torch.autograd import DeviceType
    ev = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    # the kernels themselves: an operator's self device time is its
    # kernels' again
    kern = sorted((e for e in ev if e.device_type == DeviceType.CUDA
                   and dev_us(e) > 0), key=dev_us, reverse=True)
    coll = [e for e in ev if any(k in e.key for k in ("c10d::", "gloo:",
                                                      "all_reduce",
                                                      "all_to_all"))]
    return {"device_ms": sum(dev_us(e) for e in kern) / steps / 1e3,
            "top": [(e.key[:60], round(dev_us(e) / steps / 1e3, 4))
                    for e in kern[:10]],
            "collectives_host_ms": [(e.key, round(e.cpu_time_total / steps
                                                  / 1e3, 3),
                                     e.count // steps) for e in coll]}


def sp_rank(rank: int, world: int, device: str) -> dict:
    """Phase 10's work on one rank (a process of run_local, on `device`): the
    SP bf16 Trainer at flagship width on phase 7's fixed batches. One
    deterministic step (its loss and all-reduced gradients returned), then
    SP_STEPS sampled steps between a reset and a read of the launch counts,
    then SP_PROFILE_STEPS more under the profiler on rank 0."""
    import torch
    import targetvae_tpu_torch.kernels as kernels
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cfg = flagship_config()
    data = torch.from_numpy(synthetic_images(TRAIN_BATCHES * B,
                                             cfg.encoder.image_dim, 3)).to(dev)
    batch = lambda i: data[(i % TRAIN_BATCHES) * B:(i % TRAIN_BATCHES + 1) * B]
    with encoder_tier("conv"):
        trainer = Trainer(cfg, TrainConfig(compute_dtype="bfloat16",
                                           minibatch_size=B, tp=world,
                                           sp=True), device=dev)
        state = trainer.init_state(0)
        generator, state.generator = state.generator, None
        state, m = trainer.train_step(state, batch(0))
        out = {"det": m.cpu().numpy(),
               "det_grads": {n: p.grad.detach().cpu()
                             for n, p in trainer.model.named_parameters()}}
        state.generator = generator
        kernels.reset_launch_counts()
        metrics, secs = [], []
        for i in range(SP_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = trainer.train_step(state, batch(i))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            metrics.append(m)
        out["counts"] = kernels.launch_counts()
        out["metrics"] = torch.stack(metrics).cpu().numpy()
        out["step_s"] = secs
        prof = None
        if rank == 0:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(SP_PROFILE_STEPS):
            trainer.train_step(state, batch(i))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / SP_PROFILE_STEPS
        if prof is not None:
            prof.__exit__(None, None, None)
            out["profile"] = {"wall_ms": wall * 1e3,
                              **profile_summary(prof, SP_PROFILE_STEPS)}
        # the posterior's windows of the step on rank 0's trace (both ranks
        # take device_ops' five steps)
        step = lambda: trainer.train_step(state, batch(0))
        if rank == 0:
            out["stage"] = sp_posterior_stage(device_ops(torch, step))
        else:
            for _ in range(5):
                step()
        out["collectives_ms"] = collective_times(torch, trainer, dev)
        out["digest"] = param_digest(trainer.model)
        out["steps"] = state.step
    return out


def collective_times(torch, trainer, dev, reps: int = 5) -> dict:
    """The SP step's gloo collectives alone, at its sizes, between the ranks
    with no other work on the card: the batch-to-cell exchange of the
    3 + 2 zd planes of B / ranks images over the padded cells, the
    gradient all-reduce, and an all-reduce of (B, 2 zd + 5) partials.
    Host-clock ms, the median of `reps` after a barrier each."""
    import torch.distributed as dist
    from targetvae_tpu_torch.parallel.grid_softmax import batch_to_cells
    from targetvae_tpu_torch.train.loop import SP_CELL_UNIT
    e = trainer.model.cfg.encoder
    world = dist.get_world_size()
    cells = (e.image_dim + 2 * e.padding - e.kernels_size + 1) ** 2 * e.groupconv
    unit = world * SP_CELL_UNIT
    planes = torch.zeros((B // world, 3 + 2 * e.z_dim,
                          -(-cells // unit) * unit), device=dev)
    grads = torch.zeros(sum(p.numel() for p in trainer.model.parameters()),
                        device=dev)
    part = torch.zeros((B, 2 * e.z_dim + 5), device=dev)
    out = {}
    exchange = lambda v: batch_to_cells(v, dist.group.WORLD)
    for name, x, fn in (("all_to_all planes", planes, exchange),
                        ("all_reduce grads", grads, dist.all_reduce),
                        ("all_reduce partials", part, dist.all_reduce)):
        times = []
        for _ in range(reps + 1):
            dist.barrier()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        out[name] = {"ms": float(np.median(times[1:])) * 1e3,
                     "mb": x.numel() * 4 / 1e6}
    return out


def sp_train_path(torch, cfg, dev, data) -> dict:
    """Phase 10: the SP bf16 Trainer as SP_RANKS ranks sharing cuda:0 over
    gloo, each started by run_local after phase 1 built the kernels, and
    the checks on what they report. Returns rank 0's launch counts of the
    sampled steps."""
    from targetvae_tpu_torch.losses.elbo import compute_elbo
    from targetvae_tpu_torch.parallel.distributed import run_local
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig

    # the unsharded deterministic step's loss and gradients, same weights
    ref = Trainer(cfg, TrainConfig(compute_dtype="bfloat16"), device=dev)
    ref.init_state(0)
    with encoder_tier("conv"):
        elbo = compute_elbo(ref.model.params(), cfg, ref.model.base_grid(),
                            data[:B], None, torch.bfloat16)[0]
        (-elbo).backward()
    g1 = {n: p.grad.detach().cpu() for n, p in ref.model.named_parameters()}
    elbo = float(elbo.detach())
    del ref

    t = time.perf_counter()
    ranks = run_local(sp_rank, SP_RANKS, backend="gloo", timeout=SP_TIMEOUT,
                      args=(str(dev),))
    print(f"phase 10: {SP_RANKS} ranks on {dev} over gloo ran in "
          f"{time.perf_counter() - t:.1f} s (spawn included)", flush=True)
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        m = res["metrics"]
        first, last = float(m[:5, 0].mean()), float(m[-5:, 0].mean())
        c = res["counts"]
        used = with_lift(("posterior_shard_fwd", "posterior_shard_bwd",
                          "mix_heads_fwd", "mix_heads_bwd", "pose_decoder_fwd",
                          "pose_decoder_bwd"))
        check(bool(np.isfinite(m).all()) and bool(np.isfinite(res["det"]).all())
              and last > first
              and c["posterior_shard_fwd"] == SP_STEPS
              and c["posterior_shard_bwd"] == SP_STEPS
              and all(c[k] > 0 for k in used)
              and not any(c[k] for k in c if k not in used),
              f"phase 10: rank {r}: {SP_STEPS} sampled SP train steps at B={B}"
              f" ({B // SP_RANKS} rows a rank): metrics finite, ELBO mean of "
              f"the first 5 {first:.3f} -> last 5 {last:.3f}; launches {c} "
              f"(K5/K6 once a step, K1, K2, K7, K8; never K3/K4)")
    print(f"phase 10: rank 0 ELBO per step "
          f"{np.round(r0['metrics'][:, 0], 2).tolist()}", flush=True)
    digests = {res["digest"] for res in ranks}
    check(len(digests) == 1 and all(res["steps"] == r0["steps"]
                                    for res in ranks),
          f"phase 10: parameters bitwise equal across the {SP_RANKS} ranks "
          f"after {r0['steps']} steps (sha256 {r0['digest'][:16]})")

    shift = "encoder.conv_a.b"
    noise_floor = 1e-3 * float(g1["encoder.conv_a.w"].norm())
    for r, res in enumerate(ranks):
        gs = res["det_grads"]
        rels = {n: rel_l2(gs[n], g1[n]) for n in g1 if n != shift}
        worst = max(rels, key=rels.get)
        rel_loss = abs(float(res["det"][0]) - elbo) / abs(elbo)
        check(rel_loss <= TOL_SP_LOSS
              and rels[worst] <= TOL_SP_GRAD
              and float(gs[shift].norm()) <= noise_floor,
              f"phase 10: rank {r}: deterministic SP step vs the unsharded "
              f"bf16 step: ELBO {float(res['det'][0]):.5f} vs {elbo:.5f} "
              f"(rel {rel_loss:.3e} <= {TOL_SP_LOSS}); gradients rel L2 per "
              f"leaf {({n: float(f'{v:.2e}') for n, v in rels.items()})}, "
              f"worst {worst} <= {TOL_SP_GRAD}; {shift} |g| "
              f"{float(gs[shift].norm()):.2e} <= {noise_floor:.2e}")
    s = np.asarray(r0["step_s"][5:]) * 1e3
    prof = r0["profile"]
    print(f"phase 10: SP train step, {SP_RANKS} ranks sharing one card over "
          f"gloo (not a multi-GPU speed): rank 0 {float(s.mean()):.3f} ms/step "
          f"host clock (mean of steps 6-{SP_STEPS}, min {float(s.min()):.3f}, "
          f"max {float(s.max()):.3f}), {B / float(s.mean()) * 1e3:.1f} img/s "
          f"for the pair; profiled steps {prof['wall_ms']:.3f} ms wall, rank "
          f"0 device {prof['device_ms']:.3f} ms/step", flush=True)
    print("phase 10: rank 0 profile per step: top kernels (name, device ms) "
          + json.dumps(prof["top"]) + "; collectives (name, host ms incl. "
          "waiting for the other rank, calls) "
          + json.dumps(prof["collectives_host_ms"]), flush=True)
    stage = r0["stage"]
    check(bool(stage.get("fwd_ms")) and bool(stage.get("bwd_ms")),
          "phase 10: rank 0's SP posterior stage (device ms a step, gloo's "
          "copies left out): forward (encoder kernel to K7) "
          f"{stage.get('fwd_ms', 0):.4f}, backward (K8 to K2) "
          f"{stage.get('bwd_ms', 0):.4f}")
    for part in ("fwd", "bwd"):
        print(f"phase 10: SP posterior stage, {part} ops (name, ms, count a "
              f"step): " + json.dumps(stage[part + "_ops"]), flush=True)
    spans = ("exchange_to_k5", "k6_to_exchange")
    check(all(stage[k + "_ops"] for k in spans)
          and stage["plane_copies"] == 0,
          "phase 10: rank 0: no copy of the planes between the exchange and "
          "K5 or between K6 and the exchange's backward (copy kernels of "
          f">= {SP_PLANE_BLOCKS} blocks: {stage['plane_copies']}; ops a "
          "step: " + json.dumps({k: stage[k + "_ops"] for k in spans}) + ")")
    print("phase 10: gloo collectives alone at the step's sizes, rank 0 "
          "(host ms, median of 5; MB a rank): "
          + json.dumps(r0["collectives_ms"]), flush=True)
    return r0["counts"]


class _Tee:
    """A text stream that writes to `stream` and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def tsv_rows(run: str) -> dict:
    """{(epoch, split): (elbo, error, kl)} of a run's train_log.txt."""
    rows = {}
    for line in open(os.path.join(run, "train_log.txt")):
        parts = line.strip().split("\t")
        if len(parts) == 5 and parts[1] in ("train", "test"):
            rows[(int(parts[0]), parts[1])] = tuple(map(float, parts[2:]))
    return rows


def state_arrays(torch, state) -> dict:
    """The parameters and Adam's moments of a TrainState as host copies,
    keyed by the parameters' names."""
    named = dict(state.model.named_parameters())
    out = {}
    for name, p in named.items():
        out["param " + name] = p.detach().cpu().numpy().copy()
        for key in ("exp_avg", "exp_avg_sq"):
            out[key + " " + name] = (
                state.optimizer.state[p][key].cpu().numpy().copy())
    return out


def file_arrays(path: str, named: dict) -> dict:
    """training_state.sav's parameters and Adam moments, keyed as
    state_arrays keys them: the file's pytree paths joined by dots are the
    parameters' names, with the module spatial_generator named
    "generator"."""
    from targetvae_tpu_torch.train import load_checkpoint
    params, _, payload = load_checkpoint(path)
    inner = payload["extra"]["opt_state"]["inner_state"]["0"]
    trees = {"param ": params, "exp_avg ": inner["mu"],
             "exp_avg_sq ": inner["nu"]}
    out = {}
    for name in named:
        for prefix, tree in trees.items():
            node = tree
            path = name.replace("spatial_generator.", "generator.", 1)
            for part in path.split("."):
                node = node[int(part) if isinstance(node, list) else part]
            out[prefix + name] = node
    return out


def host_step_ms(torch, cfg, dev, tier, images) -> float:
    """Host-clock ms of one bf16 Trainer.train_step on the uint8 batch
    `images`, from fresh weights, the mean of CLI_STEP_REPS after two
    warm-up steps: the step the CLI's epoch loop runs, timed as its epoch
    line is, beside it on the same card."""
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    trainer = Trainer(cfg, TrainConfig(compute_dtype="bfloat16",
                                       minibatch_size=B), device=dev)
    state = trainer.init_state(0)
    y = torch.from_numpy(images[..., None].astype(np.float32) / 255).to(dev)
    with encoder_tier(tier):
        for _ in range(2):
            trainer.train_step(state, y)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CLI_STEP_REPS):
            trainer.train_step(state, y)
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / CLI_STEP_REPS * 1e3


def cli_training_path(torch, kernels, cfg, dev, step_rates,
                      keep: str) -> dict:
    """Phase 12: targetvae_tpu_torch.cli.train_mnist.main, in-process so that
    the launch counts see it, on an MNIST-U directory of synthetic images
    at the flagship's flags, on each encoder tier; then a resume of the
    conv tier's run, whose run directory is copied to `keep` (phase 20).
    Returns each tier's launch counts."""
    import importlib
    import re
    import shutil
    import tempfile
    from targetvae_tpu_torch.cli import train_mnist
    from targetvae_tpu_torch.cli.clustering_common import load_encoder
    fit_mod = importlib.import_module("targetvae_tpu_torch.train.fit")

    images = np.round(synthetic_images(CLI_TRAIN + CLI_TEST,
                                       cfg.encoder.image_dim, 12)[..., 0]
                      * 255).astype(np.uint8)
    steps = CLI_EPOCHS * -(-CLI_TRAIN // B)
    evals = CLI_EPOCHS * -(-CLI_TEST // B)
    used = {"conv": ("mix_heads_fwd", "mix_heads_bwd"),
            "patch": ("lifted_encoder_fwd", "lifted_encoder_bwd")}
    counts, runs, finals = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "data", "mnist_U"))
        for split, part in (("train", images[:CLI_TRAIN]),
                            ("test", images[CLI_TRAIN:])):
            np.save(os.path.join(root, "data", "mnist_U",
                                 f"images_{split}.npy"), part)
        args = ["--dataset", "mnist-U", "--data-root",
                os.path.join(root, "data"), "--fourier-expansion",
                "--compute-dtype", "bfloat16", "--minibatch-size", str(B),
                "--save-interval", str(CLI_SAVE_INTERVAL)]
        for tier in ("conv", "patch"):
            log_root = os.path.join(root, "logs_" + tier)
            tee = _Tee(sys.stderr)
            with encoder_tier(tier), contextlib.redirect_stderr(tee):
                kernels.reset_launch_counts()
                state = train_mnist.main(args + [
                    "--num-epochs", str(CLI_EPOCHS), "--log-root", log_root])
                torch.cuda.synchronize()
                counts[tier] = kernels.launch_counts()
            run = os.path.join(log_root, os.listdir(log_root)[0])
            runs[tier], finals[tier] = run, state
            rows = tsv_rows(run)
            fwd = used[tier][:1] + ("posterior_fwd", "pose_decoder_fwd")
            bwd = used[tier][1:] + ("posterior_bwd", "pose_decoder_bwd")
            expect = with_lift({k: (steps + evals if k in fwd else steps
                                    if k in bwd else 0) for k in counts[tier]})
            files = ["inference.sav", "generator.sav", "training_state.sav",
                     "inference_epoch2.sav", "generator_epoch2.sav"]
            check(sorted(rows) == sorted((e, s) for e in range(1, 4)
                                         for s in ("train", "test"))
                  and np.isfinite(list(rows.values())).all()
                  and rows[(3, "test")][0] > rows[(1, "test")][0]
                  and all(os.path.exists(os.path.join(run, f))
                          for f in files)
                  and state.step == steps,
                  f"phase 12: {tier} tier: train_mnist {CLI_EPOCHS} epochs "
                  f"of {CLI_TRAIN} images (test {CLI_TEST}), B={B}: finite "
                  f"TSV lines {sorted(rows)}, test ELBO "
                  f"{[round(rows[(e, 'test')][0], 3) for e in (1, 2, 3)]} "
                  f"(epoch 3 above epoch 1), {files} written, {state.step} "
                  f"steps")
            check(counts[tier] == expect,
                  f"phase 12: {tier} tier: launches {counts[tier]} == one "
                  f"a train step ({steps}, the 50-image tails included) and "
                  f"the forwards also one a test batch ({evals})")
            rates = [(int(m[1]), float(m[2]), int(m[3])) for m in re.finditer(
                r"# epoch (\d+): ([\d.]+)s, (\d+) images/sec",
                "".join(tee.parts))]
            check(len(rates) == CLI_EPOCHS,
                  f"phase 12: {tier} tier: the CLI's epoch lines {rates}")
            step_ms = host_step_ms(torch, cfg, dev, tier, images[:B])
            print(f"phase 12: {tier} tier: epoch img/s (the CLI's line, host "
                  f"clock, {CLI_TRAIN} images incl. the tail) "
                  f"{[r[2] for r in rates]} (epoch s "
                  f"{[r[1] for r in rates]}); train_step just after "
                  f"{B / step_ms * 1e3:.1f} img/s ({step_ms:.3f} ms/step, "
                  f"host clock, {CLI_STEP_REPS} steps); phase 8 train_step "
                  f"{step_rates[tier][0]:.1f} img/s (device time), "
                  f"{step_rates[tier][1]:.1f} img/s (host clock)",
                  flush=True)

            model, params = load_encoder(os.path.join(run, "inference.sav"),
                                         dev)
            y = torch.from_numpy(images[:B, ..., None].astype(np.float32)
                                 / 255).to(dev)
            with torch.inference_mode():
                got = model.embed(params, y)
                ref = state.model.embed(state.model.params(), y)
            same = all(torch.equal(got[k], ref[k]) for k in ref)
            check(same, f"phase 12: {tier} tier: load_encoder(inference.sav)"
                  f" then embed of {B} images (float32) bitwise the embed of "
                  f"the parameters the run ended with")

        # the conv tier's run resumed to epoch CLI_EPOCHS + 1
        saved = state_arrays(torch, finals["conv"])
        on_disk = file_arrays(os.path.join(runs["conv"],
                                           "training_state.sav"),
                              dict(finals["conv"].model.named_parameters()))
        loaded = {}
        load = fit_mod.load_train_state

        def spy(*a, **kw):
            out = load(*a, **kw)
            loaded.update(state_arrays(torch, out[0]))
            return out
        fit_mod.load_train_state = spy
        try:
            with encoder_tier("conv"):
                train_mnist.main(args + [
                    "--num-epochs", str(CLI_EPOCHS + 1),
                    "--log-root", os.path.dirname(runs["conv"]),
                    "--resume", runs["conv"]])
        finally:
            fit_mod.load_train_state = load
        rows = tsv_rows(runs["conv"])
        differ = [k for k in saved if not (
            np.array_equal(loaded.get(k), saved[k])
            and np.array_equal(on_disk[k], saved[k]))]
        check(sorted(rows)[-2:] == [(4, "test"), (4, "train")]
              and np.isfinite(list(rows.values())).all()
              and len(saved) == len(loaded) and not differ,
              f"phase 12: conv tier: --resume to epoch {CLI_EPOCHS + 1} "
              f"appends {sorted(rows)[-2:]}; the {len(saved)} arrays (parameters and "
              f"Adam moments) it loaded equal, bitwise, those the run ended "
              f"with and saved (differ: {differ})")
        shutil.copytree(runs["conv"], keep)
    return counts


def mode_config(name: str):
    """tools/bench_config.py's mnist-a, mnist-b and mnist-b-p8, copied (that
    tool imports the JAX package): 50x50x1 images, z = 2, a Fourier decoder
    with F = 1,024, hidden 512 and 2 layers, Bernoulli, theta prior pi.
    mnist-a: mode A, an MLP of 2,500 -> 128 -> 128 -> 10. mnist-b: mode B,
    one 50 x 50 conv of 128 kernels, padding 25 (51 x 51 = 2,601 cells).
    mnist-b-p8: mode B, a P8 group lift of the same size and fc_r."""
    from targetvae_tpu_torch.utils.config import (
        EncoderConfig, GeneratorConfig, LikelihoodConfig, ModelConfig)
    d = 50
    gen = GeneratorConfig(z_dim=2, hidden_dim=512, n_out=1, num_layers=2,
                          fourier_expansion=True, fourier_sigma=2.0 / (d - 1))
    if name == "mnist-a":
        enc = EncoderConfig(t_inf="unimodal", r_inf="unimodal", image_dim=d,
                            in_channels=1, z_dim=2, kernels_num=128,
                            num_layers=2, theta_prior=np.pi)
    else:
        enc = EncoderConfig(t_inf="attention", r_inf="unimodal", image_dim=d,
                            in_channels=1, z_dim=2, kernels_num=128,
                            groupconv=8 if name.endswith("p8") else 0,
                            theta_prior=np.pi)
    return ModelConfig(generator=gen, encoder=enc,
                       likelihood=LikelihoodConfig(kind="bernoulli"))


def r1_kernel_checks(torch, name, cfg, params, y, rows_out: dict) -> None:
    """Phase 13: K1 and K2 at R = 1 on the lift rows of the config's own
    mode-B encoder (N = B * 51 * 51 positions, KI = R_lift K), each against
    its plain version, then timed beside it (device_ms); rows_out gets the
    kernels' rows of the JSON line, keyed "kernel[config]"."""
    from targetvae_tpu_torch.kernels.mix_heads import (
        lift_act_mix_heads_bwd_plain, lift_act_mix_heads_plain,
        mix_heads_r1_bwd, mix_heads_r1_fwd)
    from targetvae_tpu_torch.models.encoders import (
        conv_rows, head_weights, mode_b_matrices)
    from targetvae_tpu_torch.utils.flops import r1_bounds
    e = cfg.encoder
    K, D, bf = e.kernels_num, 3 + 2 * e.z_dim, torch.bfloat16
    w, bc, mix_w, mix_b = mode_b_matrices(params["encoder"], e)
    rows, _ = conv_rows(w, y, e.image_dim // 2)
    wh, bh = head_weights(params["encoder"])
    k1 = (rows, bc.float().contiguous(), mix_w.to(bf).contiguous(),
          mix_b.float().contiguous(), wh.to(bf).contiguous(),
          bh.float().contiguous())
    n, ki = rows.shape
    fwd = lambda *a: mix_heads_r1_fwd(*a, K=K)
    pfwd = lambda *a: lift_act_mix_heads_plain(*a, R=1, K=K)
    got, again, ref = fwd(*k1), fwd(*k1), pfwd(*k1)
    err1 = float((got - ref).abs().max())
    check(bool(torch.isfinite(got).all()) and err1 <= TOL_K1
          and torch.equal(got, again),
          f"phase 13: {name}: K1 at R = 1 mix_heads_r1_fwd pre1 "
          f"{tuple(rows.shape)} W2 {tuple(mix_w.shape)} -> "
          f"{tuple(got.shape)}: max_abs_err {err1:.3e} <= {TOL_K1}; a rerun "
          f"bitwise equal")
    g = torch.randn((n, D), generator=torch.Generator(
        device=rows.device).manual_seed(17), device=rows.device) * 1e-2
    k2 = k1[:5] + (g,)
    bwd = lambda *a: mix_heads_r1_bwd(*a, K=K)
    pbwd = lambda *a: lift_act_mix_heads_bwd_plain(*a, R=1, K=K)
    got2, again2, ref2 = bwd(*k2), bwd(*k2), pbwd(*k2)
    rel_dp = rel_l2(got2[0], ref2[0])
    abs_dp = float((got2[0].float() - ref2[0].float()).abs().max())
    rels = [rel_l2(a, b) for a, b in zip(got2[1:], ref2[1:])]
    check(got2[0].dtype == bf and rel_dp <= TOL_DPRE1_REL
          and max(rels) <= TOL_BWD_REL
          and all(torch.equal(a, b) for a, b in zip(got2, again2)),
          f"phase 13: {name}: K2 at R = 1 mix_heads_r1_bwd: dpre1 "
          f"{tuple(got2[0].shape)} rel L2 {rel_dp:.3e} <= {TOL_DPRE1_REL}; "
          f"dbc, dW2, db2, dWh, dbh rel L2 "
          f"{[float(f'{r:.2e}') for r in rels]} <= {TOL_BWD_REL}; reruns "
          f"bitwise equal")
    del got, again, ref, got2, again2, ref2
    bounds = r1_bounds(n, ki, K, D, y.shape[0], n // y.shape[0], e.z_dim)
    for kname, kfn, pfn, args, errs in (
            ("mix_heads_r1_fwd", fwd, pfwd, k1, {"max_abs_err": err1}),
            ("mix_heads_r1_bwd", bwd, pbwd, k2,
             {"max_abs_err": abs_dp, "dpre1_rel_l2": rel_dp,
              "grads_rel_l2": max(rels)})):
        key = f"{kname}[{name}]"
        rows_out[key] = dict(errs, bound_ms=bounds[kname][0],
                             bound_by=bounds[kname][1])
        time_kernel(rows_out, key, "13", kfn, args, pfn, args)


def r1_posterior_checks(torch, cfg, dev, rows_out: dict) -> None:
    """Phase 13: K3 and K4 at R = 1 (mode B's posterior over 51 x 51 =
    2,601 cells, B = 100, z = 2: seeded raw heads under the mode's own
    constants) against their plain versions, deterministic and sampled
    (the kernel's Philox noise fed to the plain version; scaled_err and
    the planted faults for K4), then timed (device_ms)."""
    from targetvae_tpu_torch.kernels.posterior import (
        philox_gumbel, posterior_bwd, posterior_bwd_plain, posterior_fwd,
        posterior_plain)
    from targetvae_tpu_torch.losses.elbo import posterior_constants
    from targetvae_tpu_torch.utils.flops import r1_bounds
    e = cfg.encoder
    const = posterior_constants(e, dev)
    m, zd = const["grid"].shape[0], e.z_dim
    g = torch.Generator(device=dev).manual_seed(18)
    scale = torch.tensor([2.0, 1.0, 0.3] + [1.0] * zd + [0.3] * zd,
                         device=dev)
    heads = torch.randn((B, m, 1, 3 + 2 * zd), generator=g,
                        device=dev) * scale
    k3 = (heads, const["p_r"], const["offsets"], const["p_tr"],
          const["grid"], const["sig_r"])
    label = f"R = 1, {m} cells"
    abs3, err3 = check_posterior_fwd(torch, k3, None, label, phase="13")
    g3 = torch.randn((B, 2 * zd + 5), generator=g, device=dev)
    abs4, err4, sc4 = check_posterior_bwd(torch, k3, g3, None, label,
                                          phase="13")
    bounds = r1_bounds(0, 8, 16, 1, B, m, zd)
    noise = philox_gumbel(9, B, 1, m, dev)
    for kname, kfn, kargs, pfn, pargs, row in (
            ("posterior_fwd", lambda *a: posterior_fwd(9, *a), k3,
             lambda *a: posterior_plain(*a, noise=noise), k3,
             {"max_abs_err": abs3, "max_err_sampled": err3}),
            ("posterior_bwd", lambda *a: posterior_bwd(9, *a), (g3,) + k3,
             lambda *a: posterior_bwd_plain(*a, noise=noise), (g3,) + k3,
             {"max_abs_err": abs4, "max_err_sampled": err4,
              "scaled_err": sc4})):
        key = f"{kname}[R=1]"
        rows_out[key] = dict(row, bound_ms=bounds[kname][0],
                             bound_by=bounds[kname][1])
        time_kernel(rows_out, key, "13", kfn, kargs, pfn, pargs)
    det = lambda *a: posterior_fwd(9, *a, deterministic=True)
    rows_out["posterior_fwd[R=1]"]["det_ms"] = min(device_ms(det, k3),
                                                  device_ms(det, k3))


def mode_paths(torch, kernels, dev) -> dict:
    """Phase 13: the other inference modes at full width, each of mnist-a,
    mnist-b and mnist-b-p8 through the entry points: embed_dataset (bf16)
    over N_EMBED images, a held-out bf16 ELBO and a deterministic one
    against the float32 tier, one deterministic step's gradients against
    the float32 tier, MODE_STEPS sampled train steps with the launch counts
    read around them (each kernel of the mode once a step), and train,
    eval and embed img/s; the R = 1 kernels checked and timed on the mode-B
    configs' own shapes. Returns the kernels' rows (keyed
    "kernel[config]") with each one's launches on its config's steps."""
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.cli.clustering_common import embed_dataset
    from targetvae_tpu_torch.losses.elbo import compute_elbo
    from targetvae_tpu_torch.models.encoders import conv_rows, mode_b_matrices
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    bf16 = torch.bfloat16
    rows = {}
    images = synthetic_images(N_EMBED, 50, 2)
    data = torch.from_numpy(synthetic_images(TRAIN_BATCHES * B, 50, 3)).to(dev)
    posterior_done = False
    for name in MODE_CONFIGS:
        cfg = mode_config(name)
        mode_b = cfg.encoder.mode == "B"
        model = TargetVAE(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        y = torch.from_numpy(images[:B]).to(dev)
        x_coord = model.base_grid()
        with torch.inference_mode():
            if mode_b:
                r1_kernel_checks(torch, name, cfg, params, y, rows)
                if not posterior_done:
                    r1_posterior_checks(torch, cfg, dev, rows)
                    posterior_done = True
            kernels.reset_launch_counts()
            z_c, rot, tr = embed_dataset(model, params, images, B, "bfloat16")
            emb = kernels.launch_counts()
            check(z_c.shape == (N_EMBED, 4) and rot.shape == (N_EMBED, 1)
                  and tr.shape == (N_EMBED, 2)
                  and all(np.isfinite(a).all() for a in (z_c, rot, tr))
                  and emb == with_lift({k: (N_EMBED // B if mode_b
                                            and k == "mix_heads_r1_fwd" else 0)
                                        for k in emb}),
                  f"phase 13: {name}: embed_dataset bf16 over {N_EMBED} "
                  f"images: shapes {z_c.shape} {rot.shape} {tr.shape}, "
                  f"finite, launches {emb} (mode B: K1 at R = 1 once a "
                  f"batch; mode A: none)")
            gen = torch.Generator().manual_seed(5)
            kernels.reset_launch_counts()
            elbos = [[float(t) for t in model.elbo(
                params, x_coord, torch.from_numpy(
                    images[i * B:(i + 1) * B]).to(dev), gen, bf16)]
                for i in range(EVAL_BATCHES)]
            ev = kernels.launch_counts()
            fwd = (("mix_heads_r1_fwd", "posterior_fwd") if mode_b
                   else ()) + ("pose_decoder_fwd",)
            check(bool(np.isfinite(elbos).all())
                  and ev == with_lift({k: EVAL_BATCHES if k in fwd else 0
                                       for k in ev}),
                  f"phase 13: {name}: held-out ELBO bf16 over {EVAL_BATCHES} "
                  f"batches {np.round(elbos, 3).tolist()}, launches {ev}")
            e16 = float(model.elbo(params, x_coord, y, None, bf16)[0])
            e32 = float(model.elbo(params, x_coord, y, None, None)[0])
            rel = abs(e16 - e32) / abs(e32)
            check(rel <= TOL_ELBO,
                  f"phase 13: {name}: deterministic ELBO bf16 {e16:.4f} vs "
                  f"float32 {e32:.4f}: rel diff {rel:.3e} <= {TOL_ELBO}")

        def tier_grads(dt):
            model.zero_grad(set_to_none=True)
            (-compute_elbo(model.params(), cfg, x_coord, data[:B], None,
                           dt)[0]).backward()
            return {n: p.grad.detach().clone()
                    for n, p in model.named_parameters()}
        g16, g32 = tier_grads(bf16), tier_grads(None)
        leaf_tol = {n: TOL_GRAD_THETA for n in THETA_HEADS} if mode_b else {}
        model.zero_grad(set_to_none=True)
        check_tier_grads(torch, g16, g32, name, phase="13",
                         leaf_tol=leaf_tol)
        del g16, g32

        trainer = Trainer(cfg, TrainConfig(compute_dtype="bfloat16",
                                           minibatch_size=B), device=dev)
        state = trainer.init_state(0)
        kernels.reset_launch_counts()
        metrics = []
        for i in range(MODE_STEPS):
            j = i % TRAIN_BATCHES
            state, m = trainer.train_step(state, data[j * B:(j + 1) * B])
            metrics.append(m)
        m = torch.stack(metrics).cpu().numpy()
        counts = kernels.launch_counts()
        used = (("mix_heads_r1_fwd", "mix_heads_r1_bwd", "posterior_fwd",
                 "posterior_bwd") if mode_b else ()) + (
            "pose_decoder_fwd", "pose_decoder_bwd")
        first, last = float(m[:5, 0].mean()), float(m[-5:, 0].mean())
        check(bool(np.isfinite(m).all()) and last > first
              and counts == with_lift({k: MODE_STEPS if k in used else 0
                                       for k in counts}),
              f"phase 13: {name}: {MODE_STEPS} sampled bf16 train steps at "
              f"B={B}: ELBO finite, mean of the first 5 {first:.3f} -> last 5 "
              f"{last:.3f}; launches {counts} (each of the mode's kernels "
              f"once a step)")
        for key in rows:
            kname = key.split("[")[0]
            if key.endswith(f"[{name}]") or (mode_b and key.endswith(
                    "[R=1]") and "launches" not in rows[key]):
                rows[key]["launches"] = counts[kname]
        yb = data[:B]
        step_ms = cuda_ms(lambda: trainer.train_step(state, yb))
        with torch.inference_mode():
            eval_ms = cuda_ms(lambda: model.elbo(params, x_coord, yb, gen,
                                                 bf16))
            embed_dataset(model, params, images, B, "bfloat16")
            torch.cuda.synchronize()
            t = time.perf_counter()
            embed_dataset(model, params, images, B, "bfloat16")
            torch.cuda.synchronize()
            embed_s = time.perf_counter() - t
        line = (f"phase 13: {name}: train {B / step_ms * 1e3:.1f} img/s "
                f"({step_ms:.3f} ms/step), eval {B / eval_ms * 1e3:.1f} img/s "
                f"({eval_ms:.3f} ms/batch) (CUDA events, host included, "
                f"B={B}); embed {N_EMBED / embed_s:.1f} img/s (embed_dataset, "
                f"host to host)")
        if mode_b:
            e = cfg.encoder
            w0 = mode_b_matrices(params["encoder"], e)[0].detach()
            w = w0.clone().requires_grad_(True)
            rows_g = torch.randn((B * 51 * 51, w.shape[0]), device=dev,
                                 dtype=bf16)

            def lift_train():
                conv_rows(w, yb, e.image_dim // 2)[0].backward(rows_g)
            with torch.inference_mode():
                lift_ms = cuda_ms(lambda: conv_rows(w0, yb,
                                                    e.image_dim // 2))
            lift_train_ms = cuda_ms(lift_train)
            line += (f"; the lift (K13) {lift_ms:.3f} ms forward, "
                     f"{lift_train_ms:.3f} ms with its weight gradient "
                     f"({100 * lift_train_ms / step_ms:.1f} % of the step)")
            del rows_g, w
        print(line, flush=True)
        del trainer, state, model, params
        torch.cuda.empty_cache()
    return rows


def clustering_path(torch, kernels, dev) -> None:
    """Phase 14: clustering through the CLIs. tools/make_synthetic_shapes.py
    (a subprocess: numpy and scipy) writes a labelled MNIST-U directory of
    CLI_TRAIN + CLI_TEST images; train_mnist trains CLUSTER_EPOCHS epochs in
    mode C (conv tier) and in mode B (groupconv 0); clustering_mnist embeds
    the test images (bf16), corrects the poses by the plain images', and
    clusters them (k-means, 100 restarts on the card) into 5 clusters:
    results.txt written, the accuracy and the three correlations finite.
    Then times k-means of 100 restarts on the card."""
    import tempfile
    from targetvae_tpu_torch.cli import clustering_mnist, train_mnist
    from targetvae_tpu_torch.cli.clustering_algorithms import kmeans
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        subprocess.run([sys.executable, os.path.join(
            here, "tools", "make_synthetic_shapes.py"), "--out-root", data,
            "--n-train", str(CLI_TRAIN), "--n-test", str(CLI_TEST)],
            check=True, capture_output=True, timeout=300)
        for label, flags in (
                ("mode C, conv tier", []),
                ("mode B, groupconv 0", ["--t-inf", "attention", "--r-inf",
                                         "unimodal", "--groupconv", "0"])):
            logs = os.path.join(root, "logs", str(len(flags)))
            with contextlib.redirect_stderr(io.StringIO()):
                train_mnist.main(["--dataset", "mnist-U", "--data-root", data,
                                  "--fourier-expansion", "--compute-dtype",
                                  "bfloat16", "--num-epochs",
                                  str(CLUSTER_EPOCHS), "--log-root", logs]
                                 + flags)
            run = os.path.join(logs, os.listdir(logs)[0])
            t = time.perf_counter()
            tee = _Tee(sys.stderr)
            with contextlib.redirect_stderr(tee):
                res = clustering_mnist.main([
                    "--dataset", "mnist-U", "--data-root", data,
                    "--path-to-encoder", os.path.join(run, "inference.sav"),
                    "--path-to-labels", os.path.join(data, "mnist_U",
                                                     "labels_test.npy"),
                    "--n-clusters", "5", "--compute-dtype", "bfloat16"])
            secs = time.perf_counter() - t
            check_figures(run, {"tsne.png": (1000, 1000),
                                "confusion_matrix.png": None},
                          "".join(tee.parts), f"phase 14: {label}")
            text = open(os.path.join(run, "results.txt")).read()
            vals = [res["acc"], res["rot_corr"], *res["tr_corr"]]
            check("accuracy for clustering" in text
                  and "circular correlation" in text
                  and "Pearson correlation" in text
                  and bool(np.isfinite(np.asarray(vals, float)).all()),
                  f"phase 14: {label}: train_mnist {CLUSTER_EPOCHS} epochs, "
                  f"then clustering_mnist (bf16, k-means, 5 clusters) in "
                  f"{secs:.1f} s: results.txt written; accuracy "
                  f"{res['acc']:.4f}, rotation circular correlation "
                  f"{res['rot_corr']:.4f}, translation Pearson (x, y) "
                  f"{res['tr_corr'][0]:.4f}, {res['tr_corr'][1]:.4f} (finite)")
            z = res["z_values"]
    rng = np.random.default_rng(19)
    big = np.concatenate([z] + [z + rng.normal(size=z.shape) * 0.1
                                for _ in range(39)])
    for pts in (z, big):
        kmeans(pts, 5, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, inertia = kmeans(pts, 5, device=dev)
        torch.cuda.synchronize()
        print(f"phase 14: k-means, 100 restarts batched on the card, N = "
              f"{pts.shape[0]}, dimension {pts.shape[1]}, 5 clusters: "
              f"{(time.perf_counter() - t) * 1e3:.1f} ms (host clock), "
              f"inertia {inertia:.4f}", flush=True)


def empiar_config(fit_noise: bool = False):
    """Phase 15's particles model at the EMPIAR-10025 shape
    (targetvae_tpu/cli/train_particles.py's defaults at 110 x 110,
    tools/bench_config.py's particles-ctf): 110x110x1, mode C, P8, K = 128,
    k = 64, padding 16 (79 x 79 = 6,241 positions, 49,928 cells an image),
    z = 2, a Fourier decoder F = 1,024, hidden 512, 2 layers (n_out 2 with
    fit_noise), Gaussian with CTF kernels and mask radius 45, theta prior
    pi."""
    from targetvae_tpu_torch.utils.config import (
        EncoderConfig, GeneratorConfig, LikelihoodConfig, ModelConfig)
    d = EMPIAR_DIM
    return ModelConfig(
        generator=GeneratorConfig(z_dim=2, hidden_dim=512,
                                  n_out=2 if fit_noise else 1, num_layers=2,
                                  fourier_expansion=True,
                                  fourier_sigma=2.0 / (d - 1)),
        encoder=EncoderConfig(t_inf="attention", r_inf="attention+offsets",
                              image_dim=d, in_channels=1, z_dim=2,
                              kernels_num=128, kernels_size=64, padding=16,
                              groupconv=8, theta_prior=np.pi,
                              normal_prior_over_r=False),
        likelihood=LikelihoodConfig(kind="gaussian", fit_noise=fit_noise,
                                    mask_radius=45, use_ctf=True))


def empiar_ctf(torch, n: int, dev):
    """(n, 109, 109) CTF kernels from the port's ctf_filter over
    tools/bench_config.py's spread (:126-131) in the units the CTF tables
    and ctf_filter take: the defocus spread linearly over 1.0-2.5 um, cs
    2.0 mm, 300 kV, 1.5 A/px, amplitude contrast 7 %, no B-factor.
    (bench_config.py writes the defocus in A and the amplitude contrast as
    a fraction, which ctf_filter reads as um and percent: a defocus of
    1-2.5 cm, whose kernels are aliased noise.)"""
    from targetvae_tpu_torch.data.ctf import ctf_filter
    full = lambda v: np.full(n, v)
    table = {"defocus": np.linspace(1.0, 2.5, n), "cs": full(2.0),
             "voltage": full(300.0), "apix": full(1.5), "bfactor": full(0.0),
             "ampcont": full(7.0), "dfdiff": full(0.0), "dfang": full(0.0)}
    kc = EMPIAR_DIM - 1
    return torch.from_numpy(ctf_filter(table, kc, kc)).to(dev)


@contextlib.contextmanager
def filtered_mean(module, apply_ctf, seen: dict):
    """Replaces module.reconstruction_log_prob (the likelihood that the
    ELBO's reconstruction calls) with one that also stores, in seen["mu"],
    the decoded mean filtered by the batch's CTF kernels (apply_ctf(mean
    (B, n, n), kernels)): what the Gaussian scores against the particles.
    tools/calibrate_particles_grad_tol.py also spies on the JAX package's
    module with it."""
    inner = module.reconstruction_log_prob

    def spy(y_hat, y, kind, **kw):
        b, n = y.shape[0], y.shape[1]
        seen["mu"] = apply_ctf(y_hat[..., 0].reshape(b, n, n), kw["ctf"])
        return inner(y_hat, y, kind, **kw)
    module.reconstruction_log_prob = spy
    try:
        yield
    finally:
        module.reconstruction_log_prob = inner


def particle_images(n: int, seed: int) -> np.ndarray:
    """synthetic_images at 110 x 110, each standardised by its own mean and
    std as train_particles --normalize does: (n, 110, 110, 1) float32."""
    from targetvae_tpu_torch.data.datasets import preprocess_particles
    imgs = synthetic_images(n, EMPIAR_DIM, seed)[..., 0]
    return np.ascontiguousarray(
        preprocess_particles(imgs, 0, True)[..., None], dtype=np.float32)


def empiar_kernel_checks(torch, cfg, params, dev) -> dict:
    """Phase 15: each kernel of the particles path against its plain
    version at the EMPIAR shape, B = 100, then timed beside it (device_ms):
    K1 and K2 on the lift rows of 100 synthetic particles (624,100
    positions), K3 and K4 over 49,928 cells (their default cluster grids),
    K7 and K8 over 12,100 pixels at n_out 1 and, with a fit-noise
    generator, 2, K11 and K12 on the 624,100 x 4,096 patches (2.56e9 bf16
    elements, past 2^31). Returns the kernels' rows, keyed
    "kernel[EMPIAR]" (K7 / K8 at n_out 2 "kernel[EMPIAR n_out 2]")."""
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.kernels.decoder_pose import (
        fused_pose_decoder_tables, pose_decoder_bwd, pose_decoder_bwd_plain,
        pose_decoder_plain)
    from targetvae_tpu_torch.kernels.lifted_encoder import (
        lifted_encoder_bwd, lifted_encoder_bwd_plain, lifted_encoder_fwd,
        lifted_encoder_plain)
    from targetvae_tpu_torch.kernels.mix_heads import (
        fused_lift_act_mix_heads, lift_act_mix_heads_bwd_plain,
        lift_act_mix_heads_plain, mix_heads_bwd, mix_heads_fwd)
    from targetvae_tpu_torch.kernels.posterior import (
        k3_schedule, k4_schedule, philox_gumbel, posterior_bwd,
        posterior_bwd_plain, posterior_fwd, posterior_plain)
    from targetvae_tpu_torch.models.encoders import attn_dim_for
    from targetvae_tpu_torch.utils.flops import kernel_bounds
    e = cfg.encoder
    R, K, zd, n = e.groupconv, e.kernels_num, e.z_dim, e.image_dim
    gen = torch.Generator(device=dev).manual_seed(21)
    rn = lambda *s: torch.randn(s, generator=gen, device=dev)
    rows = {}
    key = lambda k, label="EMPIAR": f"{k}[{label}]"
    k1, k3, k7, pose, _, _, k11, _ = kernel_inputs(params, cfg, dev)
    n_pos, m = k1[0].shape[0], k3[0].shape[1]
    hp = attn_dim_for(e)
    print(f"phase 15: EMPIAR shape: {n} x {n} images, H' = W' = {hp}, "
          f"{n_pos} positions a batch, {m * R} cells an image, patches "
          f"{tuple(k11[0].shape)} ({k11[0].numel()} elements); K3 grid "
          f"(cluster, chunk) {k3_schedule(m, R)}, K4 (cluster, chunk, sub) "
          f"{k4_schedule(m, R, 3 + 2 * zd)}", flush=True)
    bounds = kernel_bounds(cfg, B)

    def timed(name, label, kfn, kargs, pfn, pargs, row, bnd=bounds):
        rows[key(name, label)] = dict(row, bound_ms=bnd[name][0],
                                      bound_by=bnd[name][1])
        torch.cuda.empty_cache()     # the checks' tensors, before the graphs
        time_kernel(rows, key(name, label), "15", kfn, kargs, pfn, pargs)

    # K1 and K2: the conv tier's mixing on the lift's rows
    o_k = fused_lift_act_mix_heads(*k1, R=R, K=K)
    o_p = lift_act_mix_heads_plain(*k1, R=R, K=K)
    torch.cuda.synchronize()
    err1 = float((o_k - o_p).abs().max())
    check(bool(torch.isfinite(o_k).all()) and err1 <= TOL_K1,
          f"phase 15: K1 mix_heads_fwd EMPIAR {tuple(k1[0].shape)} -> "
          f"{tuple(o_k.shape)}: max_abs_err {err1:.3e} <= {TOL_K1}")
    del o_k, o_p
    g1 = rn(n_pos, R * (3 + 2 * zd))
    err2 = check_k2(torch, k1, g1, R, K, "EMPIAR", "15")
    timed("mix_heads_fwd", "EMPIAR", lambda *a: mix_heads_fwd(*a, R=R, K=K),
          k1, lambda *a: lift_act_mix_heads_plain(*a, R=R, K=K), k1,
          {"max_abs_err": err1})
    k2 = (*k1[:5], g1)
    timed("mix_heads_bwd", "EMPIAR", lambda *a: mix_heads_bwd(*a, R=R, K=K),
          k2, lambda *a: lift_act_mix_heads_bwd_plain(*a, R=R, K=K), k2,
          {"max_abs_err": err2})
    del k1, k2, g1
    torch.cuda.empty_cache()

    # K3 and K4 over 49,928 cells
    abs3, err3 = check_posterior_fwd(torch, k3, None, "EMPIAR", phase="15")
    g3 = rn(B, 2 * zd + 5)
    abs4, err4, sc4 = check_posterior_bwd(torch, k3, g3, None, "EMPIAR",
                                          phase="15")
    noise3 = philox_gumbel(9, B, R, m, dev)
    timed("posterior_fwd", "EMPIAR", lambda *a: posterior_fwd(9, *a), k3,
          lambda *a: posterior_plain(*a, noise=noise3), k3,
          {"max_abs_err": abs3, "max_err_sampled": err3})
    timed("posterior_bwd", "EMPIAR", lambda *a: posterior_bwd(9, *a),
          (g3,) + k3, lambda *a: posterior_bwd_plain(*a, noise=noise3),
          (g3,) + k3, {"max_abs_err": abs4, "max_err_sampled": err4,
                       "scaled_err": sc4})
    del k3, noise3

    # K7 and K8 at n_out 1 and (a fit-noise generator) 2
    cfg2 = empiar_config(fit_noise=True)
    pg2 = TargetVAE(cfg2, device=dev).init(
        torch.Generator().manual_seed(0))["generator"]
    k7b, pose_b, _ = pose_inputs(torch, pg2, cfg2.generator, n, dev)
    for label, c, k7_, pose_ in (("EMPIAR", cfg, k7, pose),
                                 ("EMPIAR n_out 2", cfg2, k7b, pose_b)):
        y7k = fused_pose_decoder_tables(*k7_)
        y7p = pose_decoder_plain(*k7_)
        torch.cuda.synchronize()
        err7 = float((y7k - y7p).abs().max())
        check(bool(torch.isfinite(y7k).all()) and err7 <= TOL_K7,
              f"phase 15: K7 pose_decoder_fwd {label} {tuple(k7_[0].shape)} "
              f"-> {tuple(y7k.shape)}: max_abs_err {err7:.3e} <= {TOL_K7}")
        g7 = rn(*y7k.shape)
        del y7k, y7p
        err8, hs = check_k8(torch, k7_, pose_, g7, label, "15")
        bnd = kernel_bounds(c, B)
        timed("pose_decoder_fwd", label, fused_pose_decoder_tables, k7_,
              pose_decoder_plain, k7_, {"max_abs_err": err7}, bnd)
        bwd7 = (*k7_[:4], hs, k7_[5], k7_[7], k7_[9], g7)
        timed("pose_decoder_bwd", label, pose_decoder_bwd, bwd7,
              pose_decoder_bwd_plain, bwd7, {"max_abs_err": err8}, bnd)
        del hs, bwd7, g7
    del k7, k7b, pg2
    torch.cuda.empty_cache()

    # K11 and K12: the patch tier at B = 100
    err11, h1 = check_k11(torch, k11, R, K, "EMPIAR", phase="15")
    g11 = rn(n_pos, R * (3 + 2 * zd))
    bwd11 = (k11[0], h1, *k11[3:6], g11)
    err12 = check_k12(torch, bwd11, R, K, "EMPIAR", "15")
    timed("lifted_encoder_fwd", "EMPIAR",
          lambda *a: lifted_encoder_fwd(*a, R=R, K=K), k11,
          lambda *a: lifted_encoder_plain(*a, R=R, K=K), k11,
          {"max_abs_err": err11})
    timed("lifted_encoder_bwd", "EMPIAR",
          lambda *a: lifted_encoder_bwd(*a, R=R, K=K), bwd11,
          lambda *a: lifted_encoder_bwd_plain(*a, R=R, K=K), bwd11,
          {"max_abs_err": err12})
    del k11, h1, g11, bwd11
    torch.cuda.empty_cache()
    return rows


def empiar_path(torch, kernels, dev) -> tuple:
    """Phase 15: the particles model at the EMPIAR shape, full width, B =
    100 (empiar_config, CTF kernels from empiar_ctf, standardised
    synthetic particles): its kernels against their plain versions and
    timed (empiar_kernel_checks); the deterministic bf16 ELBO of each
    encoder tier against the float32 tier, and one deterministic step's
    gradients; EMPIAR_STEPS sampled train steps on each tier (finite,
    rising ELBO, each kernel of the tier once a step); train, eval and
    embed img/s on each tier, and the cuDNN lift's share of the conv
    tier's step. Returns the kernels' rows and the launch counts of each
    tier's steps."""
    import targetvae_tpu_torch.losses.elbo as elbo_module
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.cli.clustering_common import embed_dataset
    from targetvae_tpu_torch.losses.elbo import compute_elbo
    from targetvae_tpu_torch.losses.likelihoods import ctf_apply
    from targetvae_tpu_torch.models.encoders import lift_rows
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    bf16 = torch.bfloat16
    cfg = empiar_config()
    e = cfg.encoder
    model = TargetVAE(cfg, device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        rows = empiar_kernel_checks(torch, cfg, params, dev)

    ctf = empiar_ctf(torch, 2 * B, dev)
    data = torch.from_numpy(particle_images(2 * B, 3)).to(dev)
    yb, cb = data[:B], ctf[:B]
    x_coord = model.base_grid()
    seen = {}
    with torch.inference_mode(), filtered_mean(elbo_module, ctf_apply, seen):
        e32 = float(model.elbo(params, x_coord, yb, None, None, ctf=cb)[0])
        mu32 = seen["mu"]
        for tier in ("conv", "patch"):
            with encoder_tier(tier):
                e16 = float(model.elbo(params, x_coord, yb, None, bf16,
                                       ctf=cb)[0])
            rel = abs(e16 - e32) / abs(e32)
            rel_mu = rel_l2(seen["mu"], mu32)
            check(np.isfinite(e16) and rel <= TOL_ELBO
                  and rel_mu <= TOL_MU_EMPIAR,
                  f"phase 15: {tier} tier: deterministic ELBO with CTF and "
                  f"mask, bf16 {e16:.4f} vs float32 {e32:.4f}: rel diff "
                  f"{rel:.3e} <= {TOL_ELBO}; the CTF-filtered decoded mean, "
                  f"rel L2 {rel_mu:.3e} <= {TOL_MU_EMPIAR}")
        del mu32, seen

    def tier_grads(dt):
        model.zero_grad(set_to_none=True)
        (-compute_elbo(model.params(), cfg, x_coord, yb, None, dt,
                       ctf=cb)[0]).backward()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    g32 = tier_grads(None)
    leaf_tol = {n: (TOL_GRAD_EMPIAR_ENC if n.startswith(EMPIAR_CANCELLING)
                    else TOL_GRAD) for n in g32}
    for tier in ("conv", "patch"):
        with encoder_tier(tier):
            g16 = tier_grads(bf16)
        check_tier_grads(torch, g16, g32, tier + " (EMPIAR)", phase="15",
                         leaf_tol=leaf_tol)
        del g16
    del g32
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    images = particle_images(EMPIAR_EMBED, 2)
    # the train steps cycle over TRAIN_BATCHES batches, so that the first
    # and the last 5 steps see the same particles
    steps_y = torch.from_numpy(particle_images(TRAIN_BATCHES * B, 4)).to(dev)
    steps_ctf = empiar_ctf(torch, TRAIN_BATCHES * B, dev)
    counts, step_ms = {}, {}
    used = {"conv": ("mix_heads_fwd", "mix_heads_bwd"),
            "patch": ("lifted_encoder_fwd", "lifted_encoder_bwd")}
    for tier in ("conv", "patch"):
        trainer = Trainer(model, TrainConfig(compute_dtype="bfloat16",
                                             minibatch_size=B), device=dev)
        state = trainer.init_state(0)
        with encoder_tier(tier):
            kernels.reset_launch_counts()
            metrics = []
            for i in range(EMPIAR_STEPS):
                j = slice((i % TRAIN_BATCHES) * B, (i % TRAIN_BATCHES + 1) * B)
                state, m = trainer.train_step(state, steps_y[j],
                                              ctf=steps_ctf[j])
                metrics.append(m)
            m = torch.stack(metrics).cpu().numpy()
            counts[tier] = kernels.launch_counts()
            expect = used[tier] + ("posterior_fwd", "posterior_bwd",
                                   "pose_decoder_fwd", "pose_decoder_bwd")
            first, last = float(m[:5, 0].mean()), float(m[-5:, 0].mean())
            check(bool(np.isfinite(m).all()) and last > first
                  and counts[tier] == with_lift(
                      {k: EMPIAR_STEPS if k in expect else 0
                       for k in counts[tier]}),
                  f"phase 15: {tier} tier: {EMPIAR_STEPS} sampled bf16 train "
                  f"steps at B={B} with CTF kernels and the mask: ELBO "
                  f"finite, mean of the first 5 {first:.3f} -> last 5 "
                  f"{last:.3f}; launches {counts[tier]} (each of the tier's "
                  f"kernels once a step)")
            print(f"phase 15: {tier} tier: ELBO per step "
                  f"{np.round(m[:, 0], 2).tolist()}", flush=True)
            step_ms[tier] = cuda_ms(lambda: trainer.train_step(
                state, yb, ctf=cb), reps=EMPIAR_REPS)
            gen = torch.Generator().manual_seed(5)
            with torch.inference_mode():
                p_ = model.params()
                eval_ms = cuda_ms(lambda: model.elbo(p_, x_coord, yb, gen,
                                                     bf16, ctf=cb),
                                  reps=EMPIAR_REPS)
                embed_dataset(model, p_, images[:B], B, "bfloat16")
                torch.cuda.synchronize()
                t = time.perf_counter()
                embed_dataset(model, p_, images, B, "bfloat16")
                torch.cuda.synchronize()
                embed_s = time.perf_counter() - t
        line = (f"phase 15: {tier} tier: train {B / step_ms[tier] * 1e3:.1f} "
                f"img/s ({step_ms[tier]:.3f} ms/step), eval "
                f"{B / eval_ms * 1e3:.1f} img/s ({eval_ms:.3f} ms/batch) "
                f"(CUDA events, host included, B={B}, with CTF); embed "
                f"{EMPIAR_EMBED / embed_s:.1f} img/s (embed_dataset, host to "
                f"host, {EMPIAR_EMBED} particles)")
        if tier == "conv":
            pe = model.params()["encoder"]
            with torch.inference_mode():
                lift_ms = cuda_ms(lambda: lift_rows(pe, e, yb),
                                  reps=EMPIAR_REPS)
            rows_g = torch.randn_like(lift_rows(pe, e, yb)[0].detach())

            def lift_train():
                lift_rows(pe, e, yb)[0].backward(rows_g)
            lift_train_ms = cuda_ms(lift_train, reps=EMPIAR_REPS)
            model.zero_grad(set_to_none=True)
            line += (f"; the lift (K13; 64 x 64 kernels, 1,024 "
                     f"outputs) {lift_ms:.3f} ms forward, {lift_train_ms:.3f} "
                     f"ms with its weight gradient "
                     f"({100 * lift_train_ms / step_ms[tier]:.1f} % of the "
                     f"step)")
            del rows_g
        print(line, flush=True)
        del trainer, state
        torch.cuda.empty_cache()
    del model, params, data, ctf, steps_y, steps_ctf
    torch.cuda.empty_cache()
    # each kernel's launches on the steps of the tier that runs it: the
    # patch tier's for K11 and K12, the conv tier's for the rest
    for k, row in rows.items():
        name = k.split("[")[0]
        if k.endswith("[EMPIAR]"):
            row["launches"] = counts["patch" if name.startswith("lifted")
                                     else "conv"][name]
    return rows, counts


def particles_cli(torch, kernels, dev, rows: dict) -> dict:
    """Phase 15, the CLIs: tools/make_synthetic_particles_torch.py (a
    subprocess: the port's ctf_filter and mrc.write, no pandas) writes
    QUALITY.md's stand-in at 110 x 110 (3 classes, CTF, SNR 0.2):
    PARTICLES_TOTAL particles with one CTF table, and PARTICLES_TEST more.
    train_particles, on the conv tier, 1,050 / 250 of them split by
    --train-portion (each split ending in a 50-image tail), with CTF,
    --mask-radius 45 and --normalize: VERTICAL_EPOCHS epochs with finite
    TSV lines, the _ctf tag, the checkpoints, each kernel once a step and
    the forwards once a test batch; then clustering_particles embeds the
    held-out stack (bf16) and clusters it into 3: cluster_assignments.npy
    and results.txt with finite correlations. Then one epoch with
    --fit-noise and no CTF table (K7 and K8 at n_out 2, the rows' n_out 2
    launches), held as the first run is. With a CTF table a --fit-noise
    run diverges, in the JAX package as in the port: the variance is
    CTF-filtered, and the 'same' correlation's truncated windows near the
    edge take it <= 0 on a part of the mask, where the Gaussian's
    (mu - y)^2 / var is unbounded above
    (tests/test_torch_port_particles.py::
    test_fit_noise_with_ctf_diverges_in_jax_as_in_the_port). Returns the
    first run's launch counts."""
    import re
    import tempfile
    from targetvae_tpu_torch.cli import clustering_particles, train_particles
    from targetvae_tpu_torch.cli.clustering_common import cluster_acc
    here = os.path.dirname(os.path.abspath(__file__))
    n_train = int(PARTICLES_TOTAL * float(PARTICLES_PORTION))
    n_test = PARTICLES_TOTAL - n_train
    fwd = ("mix_heads_fwd", "posterior_fwd", "pose_decoder_fwd")
    bwd = ("mix_heads_bwd", "posterior_bwd", "pose_decoder_bwd")
    files = ("inference.sav", "generator.sav", "training_state.sav")
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "particles")
        t = time.perf_counter()
        subprocess.run([sys.executable, os.path.join(
            here, "tools", "make_synthetic_particles_torch.py"), "--out-root",
            data, "--n-train", str(PARTICLES_TOTAL), "--n-test",
            str(PARTICLES_TEST), "--image-dim", str(EMPIAR_DIM)],
            check=True, capture_output=True, timeout=300)
        gen_s = time.perf_counter() - t
        runs = {}
        ctf_args = ["--ctf-train", os.path.join(data, "ctf_train.txt")]
        for label, extra, epochs in (("", ctf_args, VERTICAL_EPOCHS),
                                     (" --fit-noise", ["--fit-noise"], 1)):
            logs = os.path.join(root, "logs" + label.strip())
            steps = epochs * -(-n_train // B)
            evals = epochs * -(-n_test // B)
            tee = _Tee(sys.stderr)
            with contextlib.redirect_stderr(tee):
                kernels.reset_launch_counts()
                state = train_particles.main([
                    "--train-path", os.path.join(data, "particles_train.mrcs"),
                    "--train-portion", PARTICLES_PORTION, "--mask-radius",
                    "45", "--normalize", "--fourier-expansion",
                    "--compute-dtype", "bfloat16", "--num-epochs",
                    str(epochs), "--log-root", logs] + extra)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
            run = os.path.join(logs, os.listdir(logs)[0])
            runs[label] = (run, counts)
            tsv = tsv_rows(run)
            expect = with_lift({k: (steps + evals if k in fwd else steps
                                    if k in bwd else 0) for k in counts})
            rates = [int(r[1]) for r in re.finditer(
                r"# epoch \d+: [\d.]+s, (\d+) images/sec",
                "".join(tee.parts))]
            finite = bool(np.isfinite(list(tsv.values())).all())
            check(sorted(tsv) == sorted((ep, sp) for ep in range(
                1, epochs + 1) for sp in ("train", "test"))
                  and finite
                  and ("_ctf" in os.path.basename(run)) == (not label)
                  and all(os.path.exists(os.path.join(run, f))
                          for f in files)
                  and state.step == steps and counts == expect,
                  f"phase 15: train_particles{label} (conv tier, "
                  f"{'no CTF' if label else 'CTF'}, --mask-radius 45 "
                  f"--normalize) {epochs} epochs of "
                  f"{n_train} particles (test {n_test}) from a stack of "
                  f"{PARTICLES_TOTAL} written in {gen_s:.1f} s: TSV lines "
                  f"{ {k: [round(v, 2) for v in tsv[k]] for k in sorted(tsv)} }"
                  f" (finite: {finite}), "
                  f"run {os.path.basename(run)}, {files} written, "
                  f"{state.step} steps; launches {counts} == one a train "
                  f"step ({steps}) and the forwards also one a test batch "
                  f"({evals}); epoch img/s (the CLI's line) {rates}")
        run = runs[""][0]
        t = time.perf_counter()
        tee = _Tee(sys.stderr)
        with contextlib.redirect_stderr(tee):
            res = clustering_particles.main([
                "--test-path", os.path.join(data, "particles_test.mrcs"),
                "--path-to-encoder", os.path.join(run, "inference.sav"),
                "--path-to-transformations",
                os.path.join(data, "transforms_test.npy"), "--normalize",
                "--n-clusters", "3", "--compute-dtype", "bfloat16"])
        secs = time.perf_counter() - t
        check_figures(run, {"tsne.png": (1000, 1000),
                            "rotation_hist.png": (500, 800),
                            "translation_hist.png": (500, 800)},
                      "".join(tee.parts), "phase 15: clustering_particles")
        cluster = np.load(os.path.join(run, "cluster_assignments.npy"))
        _, acc = cluster_acc(np.load(os.path.join(data, "labels_test.npy")),
                             cluster)
        text = open(os.path.join(run, "results.txt")).read()
        vals = [res["rot_corr"], *res["tr_corr"]]
        check(cluster.shape == (PARTICLES_TEST,)
              and np.array_equal(cluster, res["cluster"])
              and "circular correlation" in text and "Pearson" in text
              and bool(np.isfinite(np.asarray(vals, float)).all()),
              f"phase 15: clustering_particles (bf16, Ward, 3 clusters) of "
              f"{PARTICLES_TEST} held-out particles in {secs:.1f} s: "
              f"cluster_assignments.npy {cluster.shape}, results.txt with "
              f"rotation circular correlation {res['rot_corr']:.4f}, "
              f"translation Pearson (x, y) {res['tr_corr'][0]:.4f}, "
              f"{res['tr_corr'][1]:.4f} (finite); accuracy against the "
              f"labels after {VERTICAL_EPOCHS} epochs {acc:.4f}")
    fit_noise_counts = runs[" --fit-noise"][1]
    for k, row in rows.items():
        if k.endswith("[EMPIAR n_out 2]"):
            row["launches"] = fit_noise_counts[k.split("[")[0]]
    return runs[""][1]


def vertical_clis(torch, kernels, dev) -> dict:
    """Phase 16: dSprites and galaxy through their CLIs at full width.
    tools/make_synthetic_dsprites.py and make_synthetic_galaxies.py
    (subprocesses: numpy and scipy) write their stand-ins; train_dsprites
    (its default 1,000 / 100 images; 64 x 64, k = 64, padding 32: 65 x 65
    positions) and train_galaxy (1,050 / 250 RGB 64 x 64 images; k = 65,
    padding 16; K7 and K8 at depth 4 and n_out 3) each train
    VERTICAL_EPOCHS epochs on the conv tier: finite TSV lines, the
    checkpoints, each kernel once a step and the forwards once a test
    batch; then clustering_dsprites (results.txt with a finite accuracy
    and correlations) and clustering_galaxy (the assignments and the
    embeddings). Then each config's bf16 train step on each encoder tier
    (cuda_ms, B = 100). Returns each config's CLI launch counts."""
    import tempfile
    from targetvae_tpu_torch.cli import (clustering_dsprites,
                                         clustering_galaxy, train_dsprites,
                                         train_galaxy)
    from targetvae_tpu_torch.train import Trainer, load_checkpoint
    from targetvae_tpu_torch.utils.config import TrainConfig
    here = os.path.dirname(os.path.abspath(__file__))
    tool = lambda name: os.path.join(here, "tools", name)
    fwd = ("mix_heads_fwd", "posterior_fwd", "pose_decoder_fwd")
    bwd = ("mix_heads_bwd", "posterior_bwd", "pose_decoder_bwd")
    all_counts = {}
    with tempfile.TemporaryDirectory() as root:
        ds, gal = os.path.join(root, "dsprites"), os.path.join(root, "galaxy")
        for script, out, n_tr, n_te in (
                ("make_synthetic_dsprites.py", ds, DSPRITES_TRAIN,
                 DSPRITES_TEST),
                ("make_synthetic_galaxies.py", gal, CLI_TRAIN, CLI_TEST)):
            subprocess.run([sys.executable, tool(script), "--out-root", out,
                            "--n-train", str(n_tr), "--n-test", str(n_te)],
                           check=True, capture_output=True, timeout=300)
        common = ["--fourier-expansion", "--compute-dtype", "bfloat16",
                  "--num-epochs", str(VERTICAL_EPOCHS)]
        cases = (
            ("dSprites", train_dsprites, [
                "--train-path", os.path.join(ds, "imgs_train.npy"),
                "--test-path", os.path.join(ds, "imgs_test.npy")],
             DSPRITES_TRAIN, DSPRITES_TEST,
             os.path.join(ds, "imgs_train.npy"), 1.0),
            ("galaxy", train_galaxy, [
                "--train-path", os.path.join(gal, "galaxy_zoo_train.npy"),
                "--test-path", os.path.join(gal, "galaxy_zoo_test.npy")],
             CLI_TRAIN, CLI_TEST, os.path.join(gal, "galaxy_zoo_train.npy"),
             1 / 255))
        for label, module, paths, n_tr, n_te, train_npy, scale in cases:
            logs = os.path.join(root, "logs_" + label)
            steps = VERTICAL_EPOCHS * -(-n_tr // B)
            evals = VERTICAL_EPOCHS * -(-n_te // B)
            with contextlib.redirect_stderr(io.StringIO()):
                kernels.reset_launch_counts()
                state = module.main(paths + common + ["--log-root", logs])
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
            run = os.path.join(logs, os.listdir(logs)[0])
            tsv = tsv_rows(run)
            expect = with_lift({k: (steps + evals if k in fwd else steps
                                    if k in bwd else 0) for k in counts})
            _, cfg, _ = load_checkpoint(os.path.join(run, "inference.sav"))
            g = cfg.generator
            check(sorted(tsv) == sorted((ep, sp) for ep in range(
                1, VERTICAL_EPOCHS + 1) for sp in ("train", "test"))
                  and np.isfinite(list(tsv.values())).all()
                  and state.step == steps and counts == expect
                  and os.path.exists(os.path.join(run, "generator.sav")),
                  f"phase 16: {label}: {module.__name__.split('.')[-1]} "
                  f"{VERTICAL_EPOCHS} epochs of {n_tr} images (test {n_te}), "
                  f"generator depth {g.num_layers}, n_out {g.n_out}: finite "
                  f"TSV lines "
                  f"{ {k: [round(v, 2) for v in tsv[k]] for k in sorted(tsv)} }"
                  f", {state.step} steps; launches {counts} == one a train "
                  f"step ({steps}) and the forwards also one a test batch "
                  f"({evals})")
            all_counts[label] = counts
            enc = os.path.join(run, "inference.sav")
            with contextlib.redirect_stderr(io.StringIO()) as err:
                if label == "dSprites":
                    res = clustering_dsprites.main([
                        *paths, "--train-labels",
                        os.path.join(ds, "latent_train.npy"), "--test-labels",
                        os.path.join(ds, "latent_test.npy"),
                        "--path-to-encoder", enc, "--compute-dtype",
                        "bfloat16"])
                    vals = [res["acc"], res["rot_corr"], *res["tr_corr"]]
                    ok = ("accuracy for clustering" in open(os.path.join(
                        run, "results.txt")).read()
                        and bool(np.isfinite(np.asarray(vals, float)).all()))
                    msg = (f"accuracy {res['acc']:.4f}, rotation circular "
                           f"correlation {res['rot_corr']:.4f}, translation "
                           f"Pearson {np.round(res['tr_corr'], 4).tolist()}")
                else:
                    res = clustering_galaxy.main([
                        *paths, "--path-to-encoder", enc, "--compute-dtype",
                        "bfloat16"])
                    z = np.load(os.path.join(run, "z_values.npy"))
                    ok = (z.shape == (n_tr + n_te, 4)
                          and np.array_equal(np.load(os.path.join(
                              run, "cluster_assignments.npy")),
                              res["cluster"])
                          and os.path.exists(os.path.join(run,
                                                          "results.txt")))
                    msg = (f"z_values.npy {z.shape}, cluster_assignments.npy "
                           f"{res['cluster'].shape}")
            check(ok, f"phase 16: {label}: the clustering CLI (bf16, Ward): "
                      + msg)
            check_figures(run, {"tsne.png": (1000, 1000),
                                ("confusion_matrix.png" if label == "dSprites"
                                 else "z_vals.png"):
                                (None if label == "dSprites"
                                 else (1000, 1000))},
                          err.getvalue(), f"phase 16: {label}")
            yb = torch.from_numpy(np.load(train_npy)[:B].astype(np.float32)
                                  * scale).to(dev)
            if yb.dim() == 3:
                yb = yb[..., None]
            trainer = Trainer(cfg, TrainConfig(compute_dtype="bfloat16",
                                               minibatch_size=B), device=dev)
            st = trainer.init_state(0)
            rates = {}
            for tier in ("conv", "patch"):
                with encoder_tier(tier):
                    rates[tier] = B / cuda_ms(lambda: trainer.train_step(
                        st, yb), reps=VERTICAL_REPS) * 1e3
            print(f"phase 16: {label}: train img/s (bf16 train_step, B={B}, "
                  f"CUDA events, host included): conv tier "
                  f"{rates['conv']:.1f}, patch tier {rates['patch']:.1f}",
                  flush=True)
            del trainer, st, yb
            torch.cuda.empty_cache()
    return all_counts


# ---- phases 17-18: the host feed and the ranks ----

def stand_in(torch, root: str) -> dict:
    """The particles stand-in of phases 17-18 at 110 x 110:
    tools/make_synthetic_particles_torch.py (a subprocess) writes
    STREAM_TOTAL particles with their CTF table (and STREAM_TEST more);
    they are read as train_particles --normalize reads them (the native
    loader, the per-image standardisation, the CTF kernels of the table).
    The preprocessed arrays are saved beside them for the ranks, and the
    first CLI_TRAIN raw particles and their table rows are written as the
    CLI's train stack. Returns the paths, arrays and the seconds taken."""
    from targetvae_tpu_torch.cli.train_particles import _ctf_kernels
    from targetvae_tpu_torch.data import mrc
    from targetvae_tpu_torch.data.datasets import (load_particles,
                                                   preprocess_particles)
    here = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(root, "particles")
    t = time.perf_counter()
    subprocess.run([sys.executable, os.path.join(
        here, "tools", "make_synthetic_particles_torch.py"), "--out-root",
        data, "--n-train", str(STREAM_TOTAL), "--n-test", str(STREAM_TEST),
        "--image-dim", str(EMPIAR_DIM)], check=True, capture_output=True,
        timeout=600)
    gen_s = time.perf_counter() - t
    path = lambda name: os.path.join(data, name)
    t = time.perf_counter()
    raw = load_particles(path("particles_train.mrcs"))
    images = np.ascontiguousarray(
        preprocess_particles(raw, 0, True)[..., None], dtype=np.float32)
    ctf = np.ascontiguousarray(_ctf_kernels(path("ctf_train.txt"), EMPIAR_DIM,
                                            EMPIAR_DIM, 1.0), np.float32)
    load_s = time.perf_counter() - t
    np.save(path("images.npy"), images)
    np.save(path("ctf.npy"), ctf)
    mrc.write(path("cli_train.mrcs"), raw[:CLI_TRAIN])
    with open(path("ctf_train.txt")) as f:
        rows = [line for line in f if line.strip()]
    with open(path("cli_ctf_train.txt"), "w") as f:
        f.writelines(rows[:CLI_TRAIN])
    return {"dir": data, "path": path, "images": images, "ctf": ctf,
            "gen_s": gen_s, "load_s": load_s}


def row_sums(torch, t):
    """Per-row checksums of a batch's bits (B, ...) -> (B,) int64 on t's
    device: each element's bit pattern (int32 for float32, int16 for bf16)
    weighted by its position in the row (1 + index mod 65,521), summed, so
    that a stale, shifted or reordered row changes its sum."""
    bits = t.reshape(t.shape[0], -1).view(
        torch.int32 if t.dtype == torch.float32 else torch.int16)
    pos = torch.arange(bits.shape[1], device=t.device) % 65521 + 1
    return (bits.to(torch.int64) * pos).sum(1)


def stream_reference(torch, pipe, images, ctf, epoch: int) -> list:
    """What the pipeline must stream in `epoch`: the numpy gather of its own
    order, B rows a batch, the tail wrapped around to B (on the bf16 wire
    rounded by torch's cast on the host), as (y sums, ctf sums, w, n_real)
    on the host."""
    order, n = pipe.order(epoch), len(images)
    out = []
    for lo in range(0, n, B):
        idx = order[lo:lo + B]
        rem = len(idx)
        idx = np.resize(idx, B)
        w = np.zeros(B, np.float32)
        w[:rem] = 1.0 / rem
        y, c = (torch.from_numpy(v[idx]).to(pipe.wire)
                for v in (images, ctf))
        out.append((row_sums(torch, y), row_sums(torch, c),
                    torch.from_numpy(w), rem))
    return out


def checked(torch, batches, sums: list, keep=None):
    """Pass a streamed epoch's batches on, recording each batch's row sums
    and weights on the device (and, with keep, a copy of the batch)."""
    from targetvae_tpu_torch.data.pipeline import StreamBatch
    for b in batches:
        sums.append((row_sums(torch, b.y), row_sums(torch, b.ctf),
                     b.w.clone(), b.n_real))
        if keep is not None:
            keep.append(StreamBatch(b.y.clone(), b.ctf.clone(), b.w.clone(),
                                    b.n_real))
        yield b


def rows_agree(sums: list, ref: list) -> bool:
    return len(sums) == len(ref) and all(
        bool((a[0].cpu() == r[0]).all()) and bool((a[1].cpu() == r[1]).all())
        and bool((a[2].cpu() == r[2]).all()) and a[3] == r[3]
        for a, r in zip(sums, ref))


def overlapping_copies(prof, tmp: str) -> dict:
    """From a profiler window's trace: the host-to-device copies on streams
    other than the compute stream (the one most kernels ran on), and how
    many of them overlap a kernel on the compute stream in time."""
    trace = os.path.join(tmp, "stream_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    stream = lambda e: (e.get("args") or {}).get("stream")
    kern = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    copies = [e for e in events if "memcpy" in str(e.get("cat", "")).lower()
              and "HtoD" in e.get("name", "")]
    if not kern:
        return {"kernels": 0, "side_copies": 0, "overlapping": 0,
                "categories": sorted({str(e.get("cat")) for e in events})}
    streams = [stream(e) for e in kern]
    compute = max(set(streams), key=streams.count)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kern
                   if stream(e) == compute)
    side = [e for e in copies if stream(e) != compute]
    overlap = sum(any(a < e["ts"] + e["dur"] and e["ts"] < b
                      for a, b in spans) for e in side)
    return {"kernels": len(spans), "compute_stream": compute,
            "side_copies": len(side), "overlapping": overlap,
            "copy_streams": sorted({str(stream(e)) for e in side})}


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
    except OSError:
        return "unknown"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else "unknown"


def epoch_rate(torch, fn, n: int) -> float:
    """img/s of fn() (an epoch of n images), host clock, the card idle
    before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t)


def host_feed_path(torch, kernels, dev, stand: dict) -> dict:
    """Phase 17: the host feed at the EMPIAR shape (empiar_config, bf16,
    B = 100) on the stand-in's STREAM_TOTAL particles and their CTF
    kernels (a 50-image tail): the native loader and gather against numpy;
    every streamed row (y and CTF) and weight of an epoch on the float32
    and the bf16 wire against the numpy gather of the pipeline's order; the
    streamed train epoch (patch tier) bitwise against its train_steps on
    the same batches, each kernel once a step; a 3-batch streamed epoch on
    the conv tier; eval_epoch_stream against eval_epoch; then resident and
    streamed epoch img/s at EMPIAR and at the flagship (patch tier), the
    consumer's wait and the copy's device time a batch, and, from one
    profiler window, the copies on the side stream that overlap a kernel.
    Returns the streamed epoch's launch counts."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.data import native
    from targetvae_tpu_torch.data.pipeline import HostDataPipeline
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.train.loop import _weighted_mean
    from targetvae_tpu_torch.utils.config import TrainConfig
    images, ctf = stand["images"], stand["ctf"]
    n = len(images)
    stack = stand["path"]("particles_train.mrcs")
    plain = native.load_mrc_f32(stack)
    idx = np.random.RandomState(5).permutation(n)[:B]
    check(np.array_equal(plain, native.load_mrc_f32(stack, native=False))
          and np.array_equal(native.gather_f32(images, idx), images[idx])
          and np.array_equal(native.gather_f32(ctf, idx), ctf[idx]),
          f"phase 17: the native loader: load_mrc_f32 of the stand-in "
          f"{plain.shape} bitwise numpy's read, gather_f32 of {B} rows of "
          f"the particles and of their CTF kernels bitwise numpy's take "
          f"(stand-in written in {stand['gen_s']:.1f} s, read and "
          f"preprocessed in {stand['load_s']:.1f} s)")

    cfg = empiar_config()
    trainer = Trainer(TargetVAE(cfg, device=dev), TrainConfig(
        compute_dtype="bfloat16", minibatch_size=B), device=dev)
    pipe = lambda wire=None, m=n, **kw: HostDataPipeline(
        images[:m], ctf[:m], batch_size=B, seed=0, device=dev,
        wire_dtype=wire, timing=True, **kw)
    tail = n % B
    with encoder_tier("patch"):
        state = trainer.init_state(0)
        p32 = pipe()
        sums, kept = [], []
        kernels.reset_launch_counts()
        state, means = trainer.train_epoch_stream(
            state, checked(torch, p32.epoch(0), sums, kept))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        digest = param_digest(trainer.model)
        ref = stream_reference(torch, p32, images, ctf, 0)
        last = sums[-1]
        w_tail = last[2].cpu().numpy()
        check(rows_agree(sums, ref) and last[3] == tail
              and bool((w_tail[:tail] == np.float32(1 / tail)).all())
              and bool((w_tail[tail:] == 0).all()),
              f"phase 17: float32 wire: every row of the {len(sums)} "
              f"streamed batches (y and CTF, per-row checksums on the card) "
              f"bitwise the numpy gather of the pipeline's order, the "
              f"weights 1/B, the tail's {tail} weights of 1/{tail} and "
              f"{B - tail} of zero, n_real {last[3]}")
        steps = len(kept)
        used = ("lifted_encoder_fwd", "lifted_encoder_bwd", "posterior_fwd",
                "posterior_bwd", "pose_decoder_fwd", "pose_decoder_bwd")
        ref_tr = Trainer(TargetVAE(cfg, device=dev), TrainConfig(
            compute_dtype="bfloat16", minibatch_size=B), device=dev)
        ref_state = ref_tr.init_state(0)
        ms = []
        for b in kept:
            ref_state, m = ref_tr.train_step(ref_state, b.y, b.w, b.ctf)
            ms.append(m)
        ref_means = _weighted_mean(torch.stack(ms).cpu().numpy(),
                                   [float(b.n_real) for b in kept])
        check(param_digest(ref_tr.model) == digest and ref_means == means
              and ref_state.step == state.step == steps
              and bool(np.isfinite(means).all()),
              f"phase 17: patch tier: train_epoch_stream over {n} particles "
              f"({steps} steps, the tail padded) bitwise its train_steps on "
              f"the same batches from the same generator (parameters sha256 "
              f"{digest[:16]}, means {np.round(means, 4).tolist()})")
        check(counts == {k: steps if k in used else 0 for k in counts},
              f"phase 17: patch tier: the streamed epoch's launches {counts} "
              f"(K11, K12, K3, K4, K7, K8 once a step)")
        del kept, ref_tr, ref_state
        p16 = pipe("bfloat16")
        sums16 = []
        state, means16 = trainer.train_epoch_stream(
            state, checked(torch, p16.epoch(1), sums16))
        check(rows_agree(sums16, stream_reference(torch, p16, images, ctf, 1))
              and bool(np.isfinite(means16).all()),
              f"phase 17: bf16 wire: every row of the {len(sums16)} streamed "
              f"batches bitwise the numpy gather of the pipeline's order "
              f"rounded to bf16 on the host, weights and tail as on the "
              f"float32 wire; the epoch's means "
              f"{np.round(means16, 4).tolist()} finite")
        # the streamed eval against the resident eval over one split
        m_ev = 3 * B
        ev_dev = [torch.from_numpy(v[:m_ev]).to(dev) for v in (images, ctf)]
        resident = trainer.eval_epoch(state, *ev_dev, seed=7)
        streamed = trainer.eval_epoch_stream(
            state, pipe(m=m_ev, shuffle=False).epoch(0), seed=7)
        rel = max(abs(a - b) / abs(b) for a, b in zip(streamed, resident))
        check(rel <= 1e-5,
              f"phase 17: eval_epoch_stream (shuffle=False, seed 7) over "
              f"{m_ev} particles {np.round(streamed, 5).tolist()} vs "
              f"eval_epoch {np.round(resident, 5).tolist()}: max rel "
              f"{rel:.2e} <= 1e-5 (weighted sums of 1/B against means)")
        del ev_dev
    with encoder_tier("conv"):
        st = trainer.init_state(0)
        kernels.reset_launch_counts()
        st, mc = trainer.train_epoch_stream(st, pipe(m=STREAM_CONV_BATCHES
                                                     * B).epoch(0))
        torch.cuda.synchronize()
        cc = kernels.launch_counts()
        used_c = ("mix_heads_fwd", "mix_heads_bwd", "posterior_fwd",
                  "posterior_bwd", "pose_decoder_fwd", "pose_decoder_bwd")
        check(cc == with_lift({k: STREAM_CONV_BATCHES if k in used_c else 0
                               for k in cc})
              and bool(np.isfinite(mc).all()),
              f"phase 17: conv tier: a {STREAM_CONV_BATCHES}-batch streamed "
              f"epoch, means {np.round(mc, 4).tolist()}; launches {cc} (K1, "
              f"K2 in place of K11, K12)")
        del st

    rates = {}
    with encoder_tier("patch"), tempfile.TemporaryDirectory() as tmp:
        # the profiler window: a streamed epoch of PROFILE_BATCHES
        # batches, profiled from its 4th step on (the worker stages a few
        # batches ahead, so the first copies precede the window)
        state = trainer.init_state(0)
        win = {"steps": 0}
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

        def window(batches):
            for i, b in enumerate(batches):
                if i == PROFILE_SKIP:
                    torch.cuda.synchronize()
                    prof.__enter__()
                if i >= PROFILE_SKIP:
                    win["steps"] += 1
                yield b
        trainer.train_epoch_stream(state, window(pipe(
            m=PROFILE_BATCHES * B).epoch(0)))
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        ov = overlapping_copies(prof, tmp)
        check(ov["overlapping"] >= win["steps"],
              f"phase 17: profiler window of {win['steps']} streamed steps: "
              f"{ov['side_copies']} host-to-device copies on streams "
              f"{ov.get('copy_streams')} (not the compute stream "
              f"{ov.get('compute_stream')}), {ov['overlapping']} of them "
              f"overlapping a kernel (>= one a step); {ov['kernels']} "
              f"kernels on the compute stream"
              + (f"; trace categories {ov['categories']}"
                 if "categories" in ov else ""))
        del prof

        # resident against streamed img/s: EMPIAR, then the flagship
        for label, c, ys, cs in (
                ("EMPIAR", cfg, images, ctf),
                ("flagship", flagship_config(),
                 synthetic_images(FLAGSHIP_STREAM, 50, 11), None)):
            tr = trainer if label == "EMPIAR" else Trainer(
                TargetVAE(c, device=dev), TrainConfig(
                    compute_dtype="bfloat16", minibatch_size=B), device=dev)
            st = tr.init_state(0)
            yd = torch.from_numpy(ys).to(dev)
            cd = None if cs is None else torch.from_numpy(cs).to(dev)
            m = len(ys)
            pipes = {w: HostDataPipeline(ys, cs, batch_size=B, seed=0,
                                         device=dev, wire_dtype=w,
                                         timing=True)
                     for w in (None, "bfloat16")}
            out = {"resident": [], None: [], "bfloat16": []}
            tr.train_epoch(st, yd[:2 * B], None if cd is None
                           else cd[:2 * B])                   # warm-up
            for rep in range(RATE_REPS):
                out["resident"].append(epoch_rate(
                    torch, lambda: tr.train_epoch(st, yd, cd), m))
                for w, p in pipes.items():
                    out[w].append(epoch_rate(
                        torch, lambda p=p: tr.train_epoch_stream(
                            st, p.epoch(rep)), m))
            waits = {w: np.asarray(p.stats()["wait_s"]) * 1e3
                     for w, p in pipes.items()}
            copies = {w: np.asarray(p.stats()["copy_ms"])
                      for w, p in pipes.items()}
            rates[label] = out
            res = float(np.mean(out["resident"]))
            line = (f"phase 17: {label} patch tier, {m} images, B={B}, "
                    f"{card()}: "
                    f"resident train_epoch "
                    f"{[round(v, 1) for v in out['resident']]} img/s; ")
            for w, name in ((None, "float32"), ("bfloat16", "bf16")):
                line += (f"streamed {name} wire "
                         f"{[round(v, 1) for v in out[w]]} img/s "
                         f"({float(np.mean(out[w])) / res:.3f} of resident), "
                         f"consumer wait a batch median "
                         f"{float(np.median(waits[w])):.3f} ms / max "
                         f"{float(waits[w].max()):.3f} ms (host clock), copy "
                         f"to the card a batch median "
                         f"{float(np.median(copies[w])):.3f} ms (side-stream "
                         f"events); ")
            print(line.rstrip("; "), flush=True)
            del yd, cd, st, pipes
            if tr is not trainer:
                del tr
            torch.cuda.empty_cache()
    del trainer
    torch.cuda.empty_cache()
    return counts


def dp_rank(rank: int, world: int, device: str, data_dir: str) -> dict:
    """Phase 18's EMPIAR work on one of DP_RANKS ranks sharing `device`
    over gloo, patch tier, bf16: dp = 2 (one deterministic step's metrics
    and gradients, DP_STEPS sampled steps, a ragged resident epoch of
    DP_RAGGED particles, a host-streamed epoch of the stand-in, each rank
    gathering its rows), then SP with tp = 2 on a CTF batch of B - 1
    particles and one zero-weight pad."""
    import torch
    import targetvae_tpu_torch.kernels as kernels
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.data.pipeline import HostDataPipeline
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    images = np.load(os.path.join(data_dir, "images.npy"))
    ctf = np.load(os.path.join(data_dir, "ctf.npy"))
    cfg = empiar_config()
    yd = torch.from_numpy(images[:DP_RAGGED]).to(dev)
    cd = torch.from_numpy(ctf[:DP_RAGGED]).to(dev)
    grads = lambda tr: {n: p.grad.detach().cpu()
                        for n, p in tr.model.named_parameters()}
    out = {}
    with encoder_tier("patch"):
        make = lambda **kw: Trainer(TargetVAE(cfg, device=dev), TrainConfig(
            compute_dtype="bfloat16", minibatch_size=B, **kw), device=dev)
        tr = make(dp=world)
        state = tr.init_state(0)
        generator, state.generator = state.generator, None
        state, m = tr.train_step(state, yd[:B], ctf=cd[:B])
        out["det"] = {"metrics": m.cpu().numpy(), "grads": grads(tr)}
        state.generator = generator
        metrics, secs = [], []
        for i in range(DP_STEPS):
            j = slice((i % TRAIN_BATCHES) * B, (i % TRAIN_BATCHES + 1) * B)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = tr.train_step(state, yd[j], ctf=cd[j])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            metrics.append(m)
        out["sampled"] = {"metrics": torch.stack(metrics).cpu().numpy(),
                          "digest": param_digest(tr.model), "step_s": secs}
        tr = make(dp=world, learning_rate=0.0)
        state = tr.init_state(0)
        state.generator = None
        t = time.perf_counter()
        state, means = tr.train_epoch(state, yd, cd)
        torch.cuda.synchronize()
        out["ragged"] = {"means": means, "steps": state.step,
                         "grads": grads(tr), "s": time.perf_counter() - t}
        tr = make(dp=world)
        state = tr.init_state(0)
        pipe = HostDataPipeline(images, ctf, batch_size=B, seed=0, device=dev,
                                rows=tr.batch_rows(B))
        shapes = set()

        def seen(batches):
            for b in batches:
                shapes.add(tuple(b.y.shape))
                yield b
        t = time.perf_counter()
        state, means = tr.train_epoch_stream(state, seen(pipe.epoch(0)))
        torch.cuda.synchronize()
        out["stream"] = {"means": means, "steps": state.step,
                         "digest": param_digest(tr.model),
                         "shapes": sorted(shapes),
                         "s": time.perf_counter() - t}
        del tr, state, pipe
        tr = make(tp=world, sp=True)
        state = tr.init_state(0)
        state.generator = None
        rows = torch.cat([torch.arange(B - 1), torch.zeros(1, dtype=torch.long)]
                         ).to(dev)
        w = torch.cat([torch.full((B - 1,), 1.0 / (B - 1)), torch.zeros(1)]
                      ).to(dev)
        kernels.reset_launch_counts()
        state, m = tr.train_step(state, yd[rows], w, cd[rows])
        torch.cuda.synchronize()
        out["sp"] = {"metrics": m.cpu().numpy(), "grads": grads(tr),
                     "counts": kernels.launch_counts()}
    return out


def dp_sp_rank(rank: int, world: int, device: str) -> dict:
    """Phase 18's dp = 2 x tp = 2 SP step at the flagship on one of 4
    ranks sharing `device` (conv tier, bf16, deterministic): its metrics
    and all-reduced gradients."""
    import torch
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    y = torch.from_numpy(synthetic_images(B, 50, 3)).to(dev)
    with encoder_tier("conv"):
        tr = Trainer(flagship_config(), TrainConfig(
            compute_dtype="bfloat16", minibatch_size=B, dp=2, tp=world // 2,
            sp=True), device=dev)
        state = tr.init_state(0)
        state.generator = None
        t = time.perf_counter()
        state, m = tr.train_step(state, y)
        torch.cuda.synchronize()
        return {"metrics": m.cpu().numpy(), "mesh": (tr.mesh.data_index,
                                                      tr.mesh.rank),
                "grads": {n: p.grad.detach().cpu()
                          for n, p in tr.model.named_parameters()},
                "s": time.perf_counter() - t}


def unsharded(torch, cfg, dev, tier: str, y, ctf=None,
              compute_dtype="bfloat16", sampled=False):
    """The one-process step's metrics and gradients: deterministic, or
    sampled from the initial state's generator."""
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    with encoder_tier(tier):
        tr = Trainer(cfg, TrainConfig(compute_dtype=compute_dtype,
                                      minibatch_size=B), device=dev)
        state = tr.init_state(0)
        if not sampled:
            state.generator = None
        _, m = tr.train_step(state, y, ctf=ctf)
        out = {"metrics": m.cpu().numpy(), "grads": {
            n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}}
    del tr, state
    torch.cuda.empty_cache()
    return out


def held_to_bounds(got: dict, ref: dict, label: str, phase="18") -> None:
    """A sharded step against the unsharded one: the ELBO within
    TOL_SP_LOSS relative, every gradient leaf within TOL_SP_GRAD relative
    L2, the attention bias's gradient (exactly 0: rounding noise) below
    1e-3 of the attention weight's."""
    shift = "encoder.conv_a.b"
    g, g1 = got["grads"], ref["grads"]
    rels = {n: rel_l2(g[n], g1[n]) for n in g1 if n != shift}
    worst = max(rels, key=rels.get)
    e, e1 = float(got["metrics"][0]), float(ref["metrics"][0])
    rel_loss = abs(e - e1) / abs(e1)
    floor = 1e-3 * float(g1["encoder.conv_a.w"].norm())
    check(rel_loss <= TOL_SP_LOSS and rels[worst] <= TOL_SP_GRAD
          and float(g[shift].norm()) <= floor,
          f"phase {phase}: {label}: ELBO {e:.5f} vs the unsharded step's "
          f"{e1:.5f} (rel {rel_loss:.3e} <= {TOL_SP_LOSS}); gradients rel L2 "
          f"worst {worst} {rels[worst]:.2e} <= {TOL_SP_GRAD} (median "
          f"{float(np.median(list(rels.values()))):.2e}); {shift} |g| "
          f"{float(g[shift].norm()):.2e} <= {floor:.2e}")


def rank_paths(torch, kernels, dev, stand: dict) -> dict:
    """Phase 18: ranks sharing the one card over gloo (run_local; not a
    speed across GPUs). dp = 2 at EMPIAR (dp_rank) against one process;
    SP with CTF and a zero-weight pad against the unsharded step; dp = 2 x
    tp = 2 SP on 4 ranks at the flagship; then torchrun's 2-rank
    train_particles --dp 2 --host-stream --stream-bf16 (one run directory,
    written by rank 0), and a host-streamed single-process run resumed
    after 1 epoch against 2 epochs at once, bitwise. Returns rank 0's
    launch counts of the SP step."""
    from targetvae_tpu_torch.parallel.distributed import run_local
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    images, ctf = stand["images"], stand["ctf"]
    cfg = empiar_config()
    yd = torch.from_numpy(images[:DP_RAGGED]).to(dev)
    cd = torch.from_numpy(ctf[:DP_RAGGED]).to(dev)
    ref = unsharded(torch, cfg, dev, "patch", yd[:B], cd[:B])
    ref_sp = unsharded(torch, cfg, dev, "patch", yd[:B - 1], cd[:B - 1])
    # the ragged epoch at learning rate 0: every step of both runs sees the
    # initial parameters, so the epoch's means and its last (tail) step's
    # gradients face a single step's bounds (with Adam moving the weights,
    # bf16 rounding differences compound from step to step)
    with encoder_tier("patch"):
        tr = Trainer(cfg, TrainConfig(compute_dtype="bfloat16",
                                      minibatch_size=B, learning_rate=0.0),
                     device=dev)
        state = tr.init_state(0)
        state.generator = None
        state, ref_means = tr.train_epoch(state, yd, cd)
        ref_tail = {"metrics": np.asarray(ref_means), "grads": {
            n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}}
    del tr, state, yd, cd
    torch.cuda.empty_cache()

    t = time.perf_counter()
    ranks = run_local(dp_rank, DP_RANKS, backend="gloo",
                      timeout=RANK_TIMEOUT, args=(str(dev), stand["dir"]))
    print(f"phase 18: {DP_RANKS} ranks on {dev} over gloo ran the EMPIAR "
          f"work in {time.perf_counter() - t:.1f} s (spawn included)",
          flush=True)
    for r, res in enumerate(ranks):
        held_to_bounds(res["det"], ref, f"rank {r}: dp = 2, one "
                       f"deterministic step at EMPIAR ({B // DP_RANKS} rows "
                       f"a rank, CTF, patch tier)")
    s = [res["sampled"] for res in ranks]
    check(len({x["digest"] for x in s}) == 1
          and all(np.isfinite(x["metrics"]).all() for x in s)
          and np.array_equal(s[0]["metrics"], s[1]["metrics"]),
          f"phase 18: dp = 2: {DP_STEPS} sampled steps: metrics finite and "
          f"equal on the ranks, parameters bitwise equal across them "
          f"(sha256 {s[0]['digest'][:16]}); ELBO per step "
          f"{np.round(s[0]['metrics'][:, 0], 2).tolist()}")
    step_ms = np.asarray(s[0]["step_s"][1:]) * 1e3
    print(f"phase 18: dp = 2 train step at EMPIAR ({card()}), 2 ranks "
          f"sharing one card "
          f"over gloo (the collectives and the shared card, not dp's speed "
          f"across GPUs): rank 0 {float(step_ms.mean()):.3f} ms/step host "
          f"clock (mean of steps 2-{DP_STEPS}, min {float(step_ms.min()):.3f}, "
          f"max {float(step_ms.max()):.3f})", flush=True)
    steps = -(-DP_RAGGED // B)
    for r, res in enumerate(ranks):
        rg = res["ragged"]
        rel_m = max(abs(a - b) / abs(b) for a, b in zip(rg["means"],
                                                         ref_means))
        check(rg["steps"] == steps and rel_m <= TOL_SP_LOSS,
              f"phase 18: rank {r}: a ragged resident epoch of {DP_RAGGED} "
              f"particles on dp = 2 ({steps} steps, the tail of "
              f"{DP_RAGGED % B} padded to {DP_RAGGED % B + 1}), "
              f"deterministic, learning rate 0, vs one process: means "
              f"{np.round(rg['means'], 4).tolist()} vs "
              f"{np.round(ref_means, 4).tolist()} (max rel {rel_m:.2e} <= "
              f"{TOL_SP_LOSS})")
        held_to_bounds({"metrics": np.asarray(rg["means"]),
                        "grads": rg["grads"]}, ref_tail,
                       f"rank {r}: the ragged epoch's tail step ({DP_RAGGED % B}"
                       f" particles and a zero-weight pad over 2 ranks vs "
                       f"the {DP_RAGGED % B} in one batch)")
    st = [res["stream"] for res in ranks]
    n = len(images)
    check(len({x["digest"] for x in st}) == 1
          and all(x["steps"] == -(-n // B) for x in st)
          and all(x["shapes"] == [(B // DP_RANKS, EMPIAR_DIM, EMPIAR_DIM, 1)]
                  for x in st)
          and bool(np.isfinite(st[0]["means"]).all())
          and st[0]["means"] == st[1]["means"],
          f"phase 18: dp = 2: a host-streamed epoch of {n} particles, each "
          f"rank gathering its {B // DP_RANKS} rows of every batch: "
          f"{st[0]['steps']} steps in {st[0]['s']:.2f} s "
          f"({n / st[0]['s']:.1f} img/s for the pair, one shared card), "
          f"means {np.round(st[0]['means'], 4).tolist()}, parameters bitwise "
          f"equal across the ranks")
    for r, res in enumerate(ranks):
        c = res["sp"]["counts"]
        held_to_bounds(res["sp"], ref_sp, f"rank {r}: SP, tp = 2, at EMPIAR "
                       f"with CTF: {B - 1} particles and a zero-weight pad "
                       f"vs the unsharded step on the {B - 1}")
        check(c["posterior_shard_fwd"] == 1 and c["posterior_shard_bwd"] == 1
              and c["posterior_fwd"] == 0 and c["posterior_bwd"] == 0,
              f"phase 18: rank {r}: SP step launches {c} (K5, K6 once; K3, "
              f"K4 never)")
    sp_counts = ranks[0]["sp"]["counts"]
    del ranks
    torch.cuda.empty_cache()

    # dp = 2 x tp = 2 SP on 4 ranks at the flagship
    y = torch.from_numpy(synthetic_images(B, 50, 3)).to(dev)
    ref_f = unsharded(torch, flagship_config(), dev, "conv", y)
    del y
    t = time.perf_counter()
    four = run_local(dp_sp_rank, 4, backend="gloo", timeout=RANK_TIMEOUT,
                     args=(str(dev),))
    print(f"phase 18: 4 ranks (dp = 2 x tp = 2) on {dev} over gloo ran in "
          f"{time.perf_counter() - t:.1f} s (spawn included)", flush=True)
    for r, res in enumerate(four):
        check(res["mesh"] == (r // 2, r % 2),
              f"phase 18: rank {r} at (data, model) {res['mesh']}")
        held_to_bounds(res, ref_f, f"rank {r}: dp = 2 x tp = 2 SP at the "
                       f"flagship ({B // 4} rows a rank, the exchange over "
                       f"the data row's 2 ranks)")
    del four
    torch.cuda.empty_cache()

    cli_dp(torch, stand)
    resumed_stream(torch, kernels, stand)
    return sp_counts


def particles_args(stand: dict, logs: str, epochs: int) -> list:
    """train_particles' flags for phase 18's runs on the stand-in:
    CLI_TRAIN / STREAM_TEST particles with their CTF tables, streamed on
    the bf16 wire, bf16."""
    path = stand["path"]
    return ["--train-path", path("cli_train.mrcs"), "--test-path",
            path("particles_test.mrcs"), "--ctf-train",
            path("cli_ctf_train.txt"), "--ctf-test", path("ctf_test.txt"),
            "--mask-radius", "45", "--normalize", "--fourier-expansion",
            "--compute-dtype", "bfloat16", "--host-stream", "--stream-bf16",
            "--num-epochs", str(epochs), "--log-root", logs]


def cli_dp(torch, stand: dict) -> None:
    """torchrun --standalone --nproc_per_node 2 -m
    targetvae_tpu_torch.cli.train_particles --dp 2 --host-stream
    --stream-bf16 (patch tier) on the stand-in: one run directory, rank 0's,
    with its epoch lines, a finite test ELBO and the backend named."""
    import shutil
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    runner = shutil.which("torchrun")
    runner = [runner] if runner else [sys.executable, "-m",
                                      "torch.distributed.run"]
    with tempfile.TemporaryDirectory() as logs:
        cmd = runner + ["--standalone", "--nproc_per_node", "2", "-m",
                        "targetvae_tpu_torch.cli.train_particles", "--dp",
                        "2"] + particles_args(stand, logs, CLI_DP_EPOCHS)
        env = dict(os.environ, TARGETVAE_ENCODER_TIER="patch",
                   PYTHONPATH=here + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t = time.perf_counter()
        done = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                              text=True, timeout=RANK_TIMEOUT)
        secs = time.perf_counter() - t
        runs = os.listdir(logs)
        log = ""
        if len(runs) == 1:
            with open(os.path.join(logs, runs[0], "train_log.txt")) as f:
                log = f.read()
        tsv = tsv_rows(os.path.join(logs, runs[0])) if log else {}
        tests = [v[0] for (ep, sp), v in tsv.items() if sp == "test"]
        rates = re.findall(r"# epoch \d+: [\d.]+s, (\d+) images/sec",
                           done.stderr)
        check(done.returncode == 0 and len(runs) == 1
              and sorted(tsv) == sorted((ep, sp) for ep in range(
                  1, CLI_DP_EPOCHS + 1) for sp in ("train", "test"))
              and len(tests) == CLI_DP_EPOCHS
              and bool(np.isfinite(tests).all())
              and "# mesh: data=2 model=1 (2 ranks, gloo backend)" in log
              and "(bf16 wire)" in log,
              f"phase 18: torchrun --standalone --nproc_per_node 2 -m "
              f"targetvae_tpu_torch.cli.train_particles --dp 2 --host-stream "
              f"--stream-bf16 --compute-dtype bfloat16, {CLI_TRAIN} / "
              f"{STREAM_TEST} particles with CTF, patch tier "
              f"(exit {done.returncode}, {secs:.1f} s): run directories "
              f"{runs} (one, rank 0's), TSV lines "
              f"{ {k: [round(v, 2) for v in tsv[k]] for k in sorted(tsv)} }, "
              f"test ELBO finite, the mesh and the gloo backend logged; "
              f"epoch img/s (rank 0's line) {rates}"
              + ("" if done.returncode == 0 else
                 f"; stderr tail: {done.stderr[-3000:]}"))


def resumed_stream(torch, kernels, stand: dict) -> None:
    """A host-streamed single-process train_particles run (patch tier):
    1 epoch, then --resume for 1 more, against 2 epochs at once: the final
    parameters and Adam moments bitwise equal."""
    import tempfile
    from targetvae_tpu_torch.cli import train_particles
    with tempfile.TemporaryDirectory() as root, encoder_tier("patch"):
        states = {}
        for label, epochs in (("full", 2), ("half", 1)):
            logs = os.path.join(root, label)
            with contextlib.redirect_stderr(io.StringIO()):
                states[label] = train_particles.main(
                    particles_args(stand, logs, epochs))
        half = os.path.join(root, "half")
        run = os.path.join(half, os.listdir(half)[0])
        with contextlib.redirect_stderr(io.StringIO()):
            resumed = train_particles.main(
                particles_args(stand, half, 2) + ["--resume", run])
        full = states["full"]
        a, b = state_arrays(torch, full), state_arrays(torch, resumed)
        same = a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                            for k in a)
        check(same and full.step == resumed.step,
              f"phase 18: train_particles --host-stream --stream-bf16, 1 "
              f"epoch then --resume for 1 more: {len(a)} parameter and Adam "
              f"arrays bitwise those of 2 epochs at once, {resumed.step} "
              f"steps")

# ---- phase 19: the (data, model) mesh ----

def _grads_cpu(tr) -> dict:
    return {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}


def _timed_steps(torch, kernels, tr, state, data, steps, ctf=None) -> dict:
    """`steps` sampled train steps cycling over the batches of `data` (and
    its CTF kernels), the launch counts set to 0 just before and read just
    after: the metrics, the counts, each step's host seconds and a digest
    of the parameters after them."""
    n = data.shape[0] // B
    metrics, secs = [], []
    kernels.reset_launch_counts()
    for i in range(steps):
        j = slice((i % n) * B, (i % n + 1) * B)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = tr.train_step(state, data[j],
                                 ctf=None if ctf is None else ctf[j])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        metrics.append(m)
    return {"metrics": torch.stack(metrics).cpu().numpy(),
            "counts": kernels.launch_counts(), "step_s": secs,
            "digest": param_digest(tr.model)}


def tp_rank(rank: int, world: int, device: str) -> dict:
    """Phase 19 (a) and (b) on one of 4 ranks (dp = 2 x tp = 2) sharing
    `device` over gloo, bf16 at the flagship: on each encoder tier one
    deterministic step's metrics and all-reduced gradients, then TP_STEPS
    sampled steps, the rank's bytes; a ragged epoch of 2 B - 1 images at
    learning rate 0 (conv tier); then the multichip dry run's four
    scenarios at the JAX dry run's shapes."""
    import torch
    import targetvae_tpu_torch.kernels as kernels
    from targetvae_tpu_torch.parallel.dryrun import dryrun_rank
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    data = torch.from_numpy(synthetic_images(TRAIN_BATCHES * B, 50, 3)).to(dev)
    make = lambda **kw: Trainer(flagship_config(), TrainConfig(
        compute_dtype="bfloat16", minibatch_size=B, dp=2, tp=world // 2,
        **kw), device=dev)
    out = {}
    for tier in ("conv", "patch"):
        with encoder_tier(tier):
            tr = make()
            state = tr.init_state(0)
            generator, state.generator = state.generator, None
            state, m = tr.train_step(state, data[:B])
            out[tier] = {"det": {"metrics": m.cpu().numpy(),
                                 "grads": _grads_cpu(tr)},
                         "mesh": (tr.mesh.data_index, tr.mesh.rank),
                         "rows": tr.batch_rows(B)}
            state.generator = generator
            out[tier].update(_timed_steps(torch, kernels, tr, state, data,
                                          TP_STEPS))
            out[tier]["bytes"] = state.shards.nbytes(state.optimizer)
            del tr, state
            torch.cuda.empty_cache()
    with encoder_tier("conv"):
        tr = make(learning_rate=0.0)
        state = tr.init_state(0)
        state.generator = None
        tail, w = tr._pad_tail(torch.arange(B - 1), B - 1)
        state, means = tr.train_epoch(state, data[:2 * B - 1])
        out["ragged"] = {"means": means, "steps": state.step,
                         "grads": _grads_cpu(tr), "tail": tail.numpy(),
                         "w": w.cpu().numpy()}
        del tr, state
    torch.cuda.empty_cache()
    out["dryrun"] = dryrun_rank(rank, world, device)
    return out


def scenario4_config():
    """Phase 19 (c): mnist-b's width (50 x 50, one 50 x 50 conv of 128
    kernels, hidden 512) with the Gaussian likelihood, CTF kernels and a
    mask, as the multichip dry run's scenario 4."""
    import dataclasses
    from targetvae_tpu_torch.utils.config import LikelihoodConfig
    return dataclasses.replace(mode_config("mnist-b"), likelihood=(
        LikelihoodConfig(kind="gaussian", use_ctf=True,
                         mask_radius=SCENARIO4_MASK)))


def scenario4_inputs(torch, dev):
    """TRAIN_BATCHES batches of 50 x 50 images, each standardised by its
    own mean and std (train_particles --normalize), and their 49 x 49 CTF
    kernels over empiar_ctf's spread (1.0-2.5 um, cs 2.0, 300 kV, 1.5
    A/px, 7 %)."""
    from targetvae_tpu_torch.data.datasets import preprocess_particles
    from targetvae_tpu_torch.parallel.dryrun import ctf_kernels
    n = TRAIN_BATCHES * B
    imgs = preprocess_particles(synthetic_images(n, 50, 19)[..., 0], 0, True)
    y = torch.from_numpy(np.ascontiguousarray(imgs[..., None],
                                              dtype=np.float32)).to(dev)
    ctf = torch.from_numpy(np.concatenate(
        [ctf_kernels(B, 50, 1.5)] * TRAIN_BATCHES)).to(dev)
    return y, ctf


def mode_b_rank(rank: int, world: int, device: str) -> dict:
    """Phase 19 (c), (d) and (e) on one of 2 ranks (tp = 2) sharing
    `device` over gloo: (c) mode B with CTF and the mask, TP-sharded,
    bf16; (d) mode B's bf16 SP step at mnist-b and mnist-b-p8; (e) the
    float32 SP step at the flagship. Each: one deterministic step's
    metrics and gradients, then sampled steps (e: one, from the initial
    generator's state)."""
    import torch
    import targetvae_tpu_torch.kernels as kernels
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    out = {}
    runs = [("scenario4", scenario4_config(), "bfloat16", False,
             SCENARIO4_STEPS)]
    runs += [(name, mode_config(name), "bfloat16", True, MODE_B_SP_STEPS)
             for name in ("mnist-b", "mnist-b-p8")]
    runs += [("f32_sp", flagship_config(), None, True, 0)]
    y4, ctf4 = scenario4_inputs(torch, dev)
    data = torch.from_numpy(synthetic_images(TRAIN_BATCHES * B, 50, 3)).to(dev)
    for key, cfg, dtype, sp, steps in runs:
        y, ctf = (y4, ctf4) if key == "scenario4" else (data, None)
        tr = Trainer(cfg, TrainConfig(compute_dtype=dtype, minibatch_size=B,
                                      tp=world, sp=sp), device=dev)
        state = tr.init_state(0)
        generator, state.generator = state.generator, None
        kernels.reset_launch_counts()
        state, m = tr.train_step(state, y[:B],
                                 ctf=None if ctf is None else ctf[:B])
        torch.cuda.synchronize()
        out[key] = {"det": {"metrics": m.cpu().numpy(),
                            "grads": _grads_cpu(tr)},
                    "det_counts": kernels.launch_counts()}
        if steps:
            state.generator = generator
            out[key].update(_timed_steps(torch, kernels, tr, state, y, steps,
                                         ctf))
        else:
            state = tr.init_state(0)
            state, m = tr.train_step(state, y[:B])
            out[key]["sampled"] = {"metrics": m.cpu().numpy(),
                                   "grads": _grads_cpu(tr)}
        del tr, state
        torch.cuda.empty_cache()
    return out


def r1_shard_inputs(torch, cfg, dev):
    """K5/K6's inputs on mode B's SP step at tp = 2: B images of the 2,601
    cells padded to 2 x 2,048 (-1e30 logits and log-prior), seeded planes
    and Gumbel noise, the mode's constants (the translation prior, zero
    offsets, sig_r = theta_prior) and the normalisers over the whole padded
    grid. Returns the two shards' argument tuples and the pads."""
    from targetvae_tpu_torch.losses.elbo import SP_CELL_UNIT, posterior_constants
    from targetvae_tpu_torch.ops.gumbel import gumbel_noise
    const = posterior_constants(cfg.encoder, dev)
    cells, zd = const["grid"].shape[0], cfg.encoder.z_dim
    total = -(-cells // (2 * SP_CELL_UNIT)) * 2 * SP_CELL_UNIT
    g = torch.Generator(device=dev).manual_seed(23)
    rn = lambda *sh: torch.randn(sh, generator=g, device=dev)
    pad = lambda v, value: torch.cat([v, torch.full(
        (total - cells,), value, device=dev)])
    attn = rn(B, total) * 2
    attn[:, cells:] = -1e30
    noise = gumbel_noise((B, total), g, dev)
    th, z = rn(B, 2, total) * 0.5, rn(B, 2, zd, total) * 0.5
    p = pad(const["p_tr"].reshape(-1), -1e30)
    gx, gy = pad(const["grid"][:, 0], 0.0), pad(const["grid"][:, 1], 0.0)
    offs = torch.zeros(total, device=dev)
    lse = lambda x: [x.amax(1, keepdim=True), torch.log(torch.exp(
        x - x.amax(1, keepdim=True)).sum(1, keepdim=True))]
    norms = torch.cat(lse(attn) + lse(attn + noise), dim=1)
    c = total // 2
    cut = lambda v, i: v[..., i * c:(i + 1) * c].contiguous()
    return [(norms, *(cut(v, i) for v in (attn, noise, th, z, p, gx, gy,
                                          offs))) for i in range(2)], \
        total - cells


def r1_shard_checks(torch, cfg, dev) -> dict:
    """Phase 19 (d): K5 and K6 at mode B's SP shard (B = 100, 2,048 cells,
    R = 1, sig_r = pi, zero offsets) against their plain versions on both
    shards (the second ends in pads), then timed on the first (plain,
    kernel, kernel, plain), each beside its bound. Returns their rows."""
    from targetvae_tpu_torch.kernels.posterior import (
        posterior_shard_bwd, posterior_shard_bwd_plain, posterior_shard_fwd,
        posterior_shard_plain, shard_schedule)
    from targetvae_tpu_torch.utils.flops import shard_bounds
    sig_r = float(cfg.encoder.theta_prior)
    zd = cfg.encoder.z_dim
    g = torch.randn(B, 2 * zd + 5, generator=torch.Generator(
        device=dev).manual_seed(24), device=dev)
    rows = {}
    with torch.inference_mode():
        shards, pads = r1_shard_inputs(torch, cfg, dev)
        c = shards[0][1].shape[1]
        errs = [check_shard_kernels(
            torch, shards[i], sig_r, g, f"R = 1 (mode B, 2,601 cells, "
            f"shard {i} of 2, grid {shard_schedule(c)})",
            pads if i else 0, phase="19")[0] for i in range(2)]
        bounds = shard_bounds(B, zd, c)
        args = shards[0]
        pa = as_planes(args)
        for i, (name, kfn, pfn) in enumerate((
                ("posterior_shard_fwd",
                 lambda *a: posterior_shard_fwd(*a, sig_r),
                 lambda *a: posterior_shard_plain(*a, sig_r)),
                ("posterior_shard_bwd",
                 lambda *a: posterior_shard_bwd(*a, sig_r, g),
                 lambda *a: posterior_shard_bwd_plain(*a, sig_r, g)))):
            key = f"{name}[R=1]"
            rows[key] = {"max_abs_err": max(e[i] for e in errs),
                         "bound_ms": bounds[name][0],
                         "bound_by": bounds[name][1]}
            time_kernel(rows, key, "19", kfn, pa, pfn, args)
            print(f"phase 19: {key}: bound {bounds[name][0]:.4f} ms "
                  f"({bounds[name][1]}) at {tuple(args[1].shape)} ({card()})",
                  flush=True)
    return rows


def cli_tp(torch, cfg) -> None:
    """Phase 19 (f): torchrun --standalone --nproc-per-node 4 -m
    targetvae_tpu_torch.cli.train_mnist --dp 2 --tp 2 on phase 12's
    synthetic split (conv tier, bf16, CLI_TP_EPOCHS epochs): one run
    directory, finite TSV lines, the mesh logged; then the run resumed in
    one process (train_mnist.main --resume, one more epoch), the loaded
    parameters and Adam moments bitwise the saved ones."""
    import importlib
    import shutil
    import tempfile
    from targetvae_tpu_torch.cli import train_mnist
    fit_mod = importlib.import_module("targetvae_tpu_torch.train.fit")
    here = os.path.dirname(os.path.abspath(__file__))
    images = np.round(synthetic_images(CLI_TRAIN + CLI_TEST,
                                       cfg.encoder.image_dim, 12)[..., 0]
                      * 255).astype(np.uint8)
    runner = shutil.which("torchrun")
    runner = [runner] if runner else [sys.executable, "-m",
                                      "torch.distributed.run"]
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        os.makedirs(os.path.join(data, "mnist_U"))
        for split, part in (("train", images[:CLI_TRAIN]),
                            ("test", images[CLI_TRAIN:])):
            np.save(os.path.join(data, "mnist_U", f"images_{split}.npy"),
                    part)
        logs = os.path.join(root, "logs")
        args = ["--dataset", "mnist-U", "--data-root", data,
                "--fourier-expansion", "--compute-dtype", "bfloat16",
                "--minibatch-size", str(B), "--log-root", logs]
        cmd = runner + ["--standalone", "--nproc-per-node", "4", "-m",
                        "targetvae_tpu_torch.cli.train_mnist", "--dp", "2",
                        "--tp", "2", "--num-epochs", str(CLI_TP_EPOCHS)] + args
        env = dict(os.environ, TARGETVAE_ENCODER_TIER="conv",
                   PYTHONPATH=here + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t = time.perf_counter()
        done = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                              text=True, timeout=RANK_TIMEOUT)
        secs = time.perf_counter() - t
        runs = os.listdir(logs) if os.path.isdir(logs) else []
        run = os.path.join(logs, runs[0]) if len(runs) == 1 else None
        log = open(os.path.join(run, "train_log.txt")).read() if run else ""
        tsv = tsv_rows(run) if log else {}
        rates = re.findall(r"# epoch \d+: [\d.]+s, (\d+) images/sec",
                           done.stderr)
        check(done.returncode == 0 and run is not None
              and sorted(tsv) == sorted((ep, sp) for ep in range(
                  1, CLI_TP_EPOCHS + 1) for sp in ("train", "test"))
              and bool(np.isfinite(list(tsv.values())).all())
              and "# mesh: data=2 model=2 (4 ranks, gloo backend)" in log
              and os.path.exists(os.path.join(run, "training_state.sav")),
              f"phase 19: torchrun --standalone --nproc-per-node 4 -m "
              f"targetvae_tpu_torch.cli.train_mnist --dp 2 --tp 2, "
              f"{CLI_TRAIN} / {CLI_TEST} images, {CLI_TP_EPOCHS} epochs, "
              f"conv tier, bf16 (exit {done.returncode}, {secs:.1f} s, "
              f"{card()}): run directories {runs} (one, rank 0's), TSV "
              f"lines { {k: [round(v, 2) for v in tsv[k]] for k in sorted(tsv)} }"
              f", the mesh and the gloo backend logged; epoch img/s (rank "
              f"0's line) {rates}" + ("" if done.returncode == 0 else
                                       f"; stderr tail: {done.stderr[-3000:]}"))
        # the file as the TP run left it, before the resume rewrites it
        from targetvae_tpu_torch import TargetVAE
        from targetvae_tpu_torch.train import load_checkpoint
        path = os.path.join(run, "training_state.sav")
        model = TargetVAE(load_checkpoint(path)[1], device="cpu")
        model.init(torch.Generator())
        on_disk = file_arrays(path, dict(model.named_parameters()))
        loaded = {}
        load = fit_mod.load_train_state

        def spy(*a, **kw):
            out = load(*a, **kw)
            loaded.update(state_arrays(torch, out[0]))
            return out
        fit_mod.load_train_state = spy
        try:
            with encoder_tier("conv"), contextlib.redirect_stderr(
                    io.StringIO()):
                state = train_mnist.main(args + [
                    "--num-epochs", str(CLI_TP_EPOCHS + 1), "--resume", run])
        finally:
            fit_mod.load_train_state = load
        differ = [k for k in on_disk
                  if not np.array_equal(loaded.get(k), on_disk[k])]
        rows = tsv_rows(run)
        check(len(loaded) == len(on_disk) > 0 and not differ
              and state.step > 0 and sorted(rows)[-2:] == [(CLI_TP_EPOCHS + 1, "test"),
                                        (CLI_TP_EPOCHS + 1, "train")],
              f"phase 19: the --dp 2 --tp 2 run's training_state.sav "
              f"(written by rank 0 from the gathered shards) resumed in one "
              f"process for epoch {CLI_TP_EPOCHS + 1}: the {len(loaded)} "
              f"arrays it loaded (parameters and Adam moments) bitwise the "
              f"file's (differ: {differ}); {sorted(rows)[-2:]} appended")


def mesh_paths(torch, kernels, dev) -> tuple:
    """Phase 19: the rest of the (data, model) mesh on ranks sharing the
    card over gloo (run_local; not a speed across GPUs). Returns the K5/K6
    rows at R = 1 (their launches on mode B's SP step) and the launch
    counts of the new paths by name."""
    from targetvae_tpu_torch.parallel.distributed import run_local
    from targetvae_tpu_torch.parallel.dryrun import check_reports
    t0 = time.perf_counter()
    flag = flagship_config()
    data = torch.from_numpy(synthetic_images(TRAIN_BATCHES * B, 50, 3)).to(dev)
    refs = {tier: unsharded(torch, flag, dev, tier, data[:B])
            for tier in ("conv", "patch")}
    with encoder_tier("conv"):
        from targetvae_tpu_torch.train import Trainer
        from targetvae_tpu_torch.utils.config import TrainConfig
        tr = Trainer(flag, TrainConfig(compute_dtype="bfloat16",
                                       minibatch_size=B, learning_rate=0.0),
                     device=dev)
        state = tr.init_state(0)
        state.generator = None
        state, ref_means = tr.train_epoch(state, data[:2 * B - 1])
        ref_tail = {"metrics": np.asarray(ref_means), "grads": _grads_cpu(tr)}
        one_bytes = sum(p.numel() * p.element_size()
                        for p in tr.model.parameters())
        del tr, state
    torch.cuda.empty_cache()

    # (a), (b) and the dry run on 4 ranks
    t = time.perf_counter()
    ranks = run_local(tp_rank, 4, backend="gloo", timeout=RANK_TIMEOUT,
                      args=(str(dev),))
    print(f"phase 19: 4 ranks (dp = 2 x tp = 2) on {dev} over gloo ran in "
          f"{time.perf_counter() - t:.1f} s (spawn included; {card()})",
          flush=True)
    used = {"conv": ("mix_heads_fwd", "mix_heads_bwd"),
            "patch": ("lifted_encoder_fwd", "lifted_encoder_bwd")}
    for tier in ("conv", "patch"):
        run = [r[tier] for r in ranks]
        for i, res in enumerate(run):
            check(res["mesh"] == (i // 2, i % 2)
                  and res["rows"] == slice(25 * i, 25 * i + 25),
                  f"phase 19: {tier} tier: rank {i} at (data, model) "
                  f"{res['mesh']}, rows {res['rows']}")
            held_to_bounds(res["det"], refs[tier], f"{tier} tier: rank {i}: "
                           f"dp = 2 x tp = 2 (25 rows a rank, the parameters "
                           f"and Adam's moments sharded over tp), one "
                           f"deterministic step at the flagship", phase="19")
            kern = used[tier] + ("posterior_fwd", "posterior_bwd",
                                 "pose_decoder_fwd", "pose_decoder_bwd")
            expect = with_lift({k: TP_STEPS if k in kern else 0
                                for k in res["counts"]})
            check(res["counts"] == expect,
                  f"phase 19: {tier} tier: rank {i}: {TP_STEPS} sampled "
                  f"steps launch {res['counts']} (each kernel of the tier "
                  f"once a step)")
        m = run[0]["metrics"][:, 0]
        check(len({x["digest"] for x in run}) == 1
              and all(np.array_equal(x["metrics"], run[0]["metrics"])
                      for x in run)
              and bool(np.isfinite(m).all()) and m[-3:].mean() > m[:3].mean(),
              f"phase 19: {tier} tier: dp = 2 x tp = 2: {TP_STEPS} sampled "
              f"steps, metrics finite, equal on the 4 ranks and rising (ELBO "
              f"{np.round(m, 2).tolist()}); the gathered parameters bitwise "
              f"equal across the ranks (sha256 {run[0]['digest'][:16]})")
        ms = np.asarray(run[0]["step_s"][1:]) * 1e3
        b = run[0]["bytes"]
        print(f"phase 19: {tier} tier: dp = 2 x tp = 2 train step at the "
              f"flagship ({card()}), 4 ranks sharing one card over gloo (the "
              f"collectives and the shared card, not a speed across GPUs): "
              f"rank 0 {float(ms.mean()):.3f} ms/step host clock (mean of "
              f"steps 2-{TP_STEPS}, min {float(ms.min()):.3f}, max "
              f"{float(ms.max()):.3f}); bytes a rank: whole parameters "
              f"{b['params']:,}, their gradients {b['grads']:,}, Adam's "
              f"moments {b['adam']:,} (one process: {one_bytes:,}, "
              f"{one_bytes:,}, {2 * one_bytes:,}; TP cuts the moments "
              f"alone)", flush=True)
    for i, r in enumerate(ranks):
        rg = r["ragged"]
        rel_m = max(abs(a - b) / abs(b) for a, b in zip(rg["means"],
                                                         ref_means))
        n_tail = B - 1
        check(rg["steps"] == 2 and rel_m <= TOL_SP_LOSS
              and np.array_equal(rg["tail"], list(range(n_tail)) + [0])
              and bool((rg["w"][:n_tail] == np.float32(1.0 / n_tail)).all())
              and rg["w"][n_tail] == 0.0,
              f"phase 19: rank {i}: a ragged epoch of {2 * B - 1} images on "
              f"dp = 2 x tp = 2 (2 steps, the tail of {n_tail} padded to "
              f"{B} with a zero-weight copy of its first row, weights "
              f"1/{n_tail}), learning rate 0, vs one process: means "
              f"{np.round(rg['means'], 4).tolist()} vs "
              f"{np.round(ref_means, 4).tolist()} (max rel {rel_m:.2e} <= "
              f"{TOL_SP_LOSS})")
        held_to_bounds({"metrics": np.asarray(rg["means"]),
                        "grads": rg["grads"]}, ref_tail,
                       f"rank {i}: the ragged epoch's tail step", phase="19")
    for line in check_reports([r["dryrun"] for r in ranks]):
        print(f"phase 19: the dry run's scenarios at the JAX dry run's "
              f"shapes on {dev} (4 ranks): {line}", flush=True)
    counts = {"train_tp": ranks[0]["conv"]["counts"],
              "train_tp_patch": ranks[0]["patch"]["counts"]}
    del ranks
    torch.cuda.empty_cache()

    # (c), (d), (e) on 2 ranks
    y4, ctf4 = scenario4_inputs(torch, dev)
    refs = {"scenario4": unsharded(torch, scenario4_config(), dev, "conv",
                                   y4[:B], ctf4[:B])}
    for name in ("mnist-b", "mnist-b-p8"):
        refs[name] = unsharded(torch, mode_config(name), dev, "conv",
                               data[:B])
    refs["f32_sp"] = unsharded(torch, flag, dev, "conv", data[:B],
                               compute_dtype=None)
    ref_f32_sampled = unsharded(torch, flag, dev, "conv", data[:B],
                                compute_dtype=None, sampled=True)
    del y4, ctf4
    rows = r1_shard_checks(torch, mode_config("mnist-b"), dev)
    t = time.perf_counter()
    pair = run_local(mode_b_rank, 2, backend="gloo", timeout=RANK_TIMEOUT,
                     args=(str(dev),))
    print(f"phase 19: 2 ranks (tp = 2) on {dev} over gloo ran in "
          f"{time.perf_counter() - t:.1f} s (spawn included; {card()})",
          flush=True)
    labels = {"scenario4": "mode B at mnist-b width with the Gaussian "
                           "likelihood, 49 x 49 CTF kernels and mask radius "
                           f"{SCENARIO4_MASK}, tp = 2 (parameters sharded)",
              "mnist-b": "mnist-b's bf16 SP step (tp = 2)",
              "mnist-b-p8": "mnist-b-p8's bf16 SP step (tp = 2)",
              "f32_sp": "the float32 SP step at the flagship (tp = 2)"}
    for key, label in labels.items():
        for i, r in enumerate(pair):
            held_to_bounds(r[key]["det"], refs[key], f"rank {i}: {label}, "
                           f"deterministic", phase="19")
    sp_kern = ("mix_heads_r1_fwd", "mix_heads_r1_bwd", "posterior_shard_fwd",
               "posterior_shard_bwd", "pose_decoder_fwd", "pose_decoder_bwd")
    tp_kern = ("mix_heads_r1_fwd", "mix_heads_r1_bwd", "posterior_fwd",
               "posterior_bwd", "pose_decoder_fwd", "pose_decoder_bwd")
    for key, steps, kern in (("scenario4", SCENARIO4_STEPS, tp_kern),
                             ("mnist-b", MODE_B_SP_STEPS, sp_kern),
                             ("mnist-b-p8", MODE_B_SP_STEPS, sp_kern)):
        run = [r[key] for r in pair]
        m = run[0]["metrics"][:, 0]
        expect = with_lift({k: steps if k in kern else 0
                            for k in run[0]["counts"]})
        check(all(x["counts"] == expect for x in run)
              and len({x["digest"] for x in run}) == 1
              and bool(np.isfinite(m).all()) and m[-3:].mean() > m[:3].mean(),
              f"phase 19: {labels[key]}: {steps} sampled steps, each rank "
              f"launching {run[0]['counts']} (K5/K6 on the SP steps, never "
              f"K3/K4; K3/K4 on the TP steps), ELBO finite and rising "
              f"{np.round(m, 2).tolist()}, parameters bitwise equal across "
              f"the ranks; rank 0 "
              f"{float(np.mean(run[0]['step_s'][1:])) * 1e3:.3f} ms/step "
              f"host clock ({card()})")
    for i, r in enumerate(pair):
        got = r["f32_sp"]["sampled"]
        held_to_bounds(got, ref_f32_sampled, f"rank {i}: the float32 SP step "
                       f"at the flagship, sampled from the initial "
                       f"generator's state (the Gumbel noise one draw for "
                       f"the whole grid: the unsharded step's sample)",
                       phase="19")
        c = r["f32_sp"]["det_counts"]
        check(not any(c.values()),
              f"phase 19: rank {i}: the float32 SP step launches no kernel "
              f"({c})")
    for name in ("mnist-b", "mnist-b-p8"):
        counts["train_sp_" + name] = pair[0][name]["counts"]
    for key in rows:
        name = key.split("[")[0]
        rows[key]["launches"] = counts["train_sp_mnist-b"][name]
        rows[key]["launches_by_path"] = {
            p: counts[p][name] for p in ("train_sp_mnist-b",
                                         "train_sp_mnist-b-p8")}
    del pair
    torch.cuda.empty_cache()

    # (f) the torchrun CLI, then a one-process resume
    cli_tp(torch, flag)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s ({card()})",
          flush=True)
    return rows, counts


# ---- phase 20: reference .sav interop, the serving tools, the figures ----

def check_figures(run: str, sizes: dict, err: str, label: str) -> None:
    """The figures a clustering CLI wrote beside its encoder: each a PNG
    (signature and IHDR CRC, utils/png.py::png_size) of the size given
    (None: any), no .jpg, and no line of the CLI's standard error saying a
    figure was not written."""
    from targetvae_tpu_torch.utils.png import png_size
    got = {}
    for name in sizes:
        try:
            got[name] = png_size(os.path.join(run, name))
        except (OSError, ValueError) as e:
            got[name] = f"{type(e).__name__}: {e}"
    ok = all(isinstance(got[n], tuple) and (s is None or got[n] == s)
             for n, s in sizes.items())
    jpg = [f for f in os.listdir(run) if f.endswith(".jpg")]
    check(ok and not jpg and "not written" not in err,
          f"{label}: figures (height, width) {got}, expected "
          f"{ {n: s or 'a PNG' for n, s in sizes.items()} }; no .jpg "
          f"({jpg}), no 'not written' line")


def tsne_points(n: int, seed: int = 21) -> np.ndarray:
    """n points of ten Gaussian clusters in 4 dimensions (a z_dim-2 model's
    [z_mu; z_std] rows), float32."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(10, 4)) * 3
    return (centres[rng.integers(0, 10, n)]
            + rng.normal(size=(n, 4))).astype(np.float32)


def sav_round_trips(torch, kernels, dev, root: str) -> dict:
    """Phase 20 (a): each mode's encoder at full width (mode C at the
    flagship; mnist-a, mnist-b, mnist-b-p8) written as the reference's
    pickled inference.sav by utils/torch_export.py and read back by
    utils/torch_import.py: the config and every parameter bitwise; then
    load_encoder on the file and bf16 embed_dataset of EMBED_STACK_N images
    bitwise the original parameters' embed, the encoder's kernel once a
    batch (mode C: K1 on the conv tier, K11 on the patch tier; mode B: K1 at
    R = 1; mode A: none, its MLP is float32 on both tiers). Returns the
    flagship's .sav path."""
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.cli.clustering_common import (embed_dataset,
                                                           load_encoder)
    from targetvae_tpu_torch.utils import torch_export, torch_import
    from targetvae_tpu_torch.utils.jax_params import params_to_jax
    images = synthetic_images(EMBED_STACK_N, 50, 20)
    batches = -(-EMBED_STACK_N // B)
    cases = (("mode C (flagship)", flagship_config(),
              (("conv", "mix_heads_fwd"), ("patch", "lifted_encoder_fwd"))),
             ("mode A (mnist-a)", mode_config("mnist-a"), (("conv", None),)),
             ("mode B (mnist-b)", mode_config("mnist-b"),
              (("conv", "mix_heads_r1_fwd"),)),
             ("mode B (mnist-b-p8)", mode_config("mnist-b-p8"),
              (("conv", "mix_heads_r1_fwd"),)))
    paths = {}
    for k, (label, cfg, tiers) in enumerate(cases):
        model = TargetVAE(cfg, dev)
        params = model.init(torch.Generator().manual_seed(30 + k))
        path = os.path.join(root, f"inference_{k}.sav")
        t = time.perf_counter()
        torch_export.export_encoder_sav(path, cfg.encoder, params["encoder"])
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        got_cfg, got = torch_import.encoder_from_sav(path)
        read_s = time.perf_counter() - t
        want = params_to_jax(params["encoder"])
        differ = trees_differ(got, want, "encoder")
        n_params = sum(int(np.prod(v.shape)) for v in leaves(want))
        check(got_cfg == cfg.encoder and not differ,
              f"phase 20: {label}: export_encoder_sav ({os.path.getsize(path)}"
              f" bytes, {write_s:.2f} s) then encoder_from_sav ({read_s:.2f} "
              f"s): config equal, {n_params} parameters bitwise (differ: "
              f"{differ})")
        with contextlib.redirect_stderr(io.StringIO()) as err:
            imported, iparams = load_encoder(path, dev)
        check("reference torch checkpoint, importing" in err.getvalue(),
              f"phase 20: {label}: load_encoder says it imports a reference "
              f"file")
        for tier, kernel in tiers:
            with encoder_tier(tier):
                ref = embed_dataset(model, params, images, B, "bfloat16")
                kernels.reset_launch_counts()
                out = embed_dataset(imported, iparams, images, B, "bfloat16")
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
            expect = with_lift({n: (batches if n == kernel else 0)
                                for n in counts})
            check(all(np.array_equal(a, r) for a, r in zip(out, ref)),
                  f"phase 20: {label}, {tier} tier: bf16 embed_dataset of "
                  f"{EMBED_STACK_N} images through the imported .sav bitwise "
                  f"the original parameters' (z, rotation, translation)")
            check(counts == expect,
                  f"phase 20: {label}, {tier} tier: launches {counts} == "
                  f"{kernel or 'no kernel'} once a batch ({batches})")
        paths[label] = path
        del model, params, imported, iparams
        torch.cuda.empty_cache()
    return paths


def leaves(tree) -> list:
    """The arrays of a nested dict / list."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def trees_differ(a, b, name: str) -> list:
    """The paths at which two nested dicts / lists of arrays differ in
    structure, dtype or any bit."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)
                and set(a) == set(b)):
            return [name]
        return [p for k in a for p in trees_differ(a[k], b[k],
                                                   f"{name}.{k}")]
    if isinstance(a, list) or isinstance(b, list):
        if not (isinstance(a, list) and isinstance(b, list)
                and len(a) == len(b)):
            return [name]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in trees_differ(x, y, f"{name}[{i}]")]
    a, b = np.asarray(a), np.asarray(b)
    return [] if a.dtype == b.dtype and np.array_equal(a, b) else [name]


def embed_stack_rates(torch, kernels, dev, root: str, flagship_sav: str,
                      stand: dict) -> dict:
    """Phase 20 (b): embed_stack, in-process so that the launch counts see
    it, on a 1,000-image flagship .mrcs (through the reference .sav of (a))
    and on phase 17's EMPIAR stand-in of STREAM_TOTAL particles with
    --normalize (through a checkpoint of this package), on each encoder
    tier, bf16: the files bitwise embed_dataset's arrays on the same
    preprocessed images, the encoder's kernel once a batch; img/s of the
    whole call (MRC read and files included, host clock), of its embed
    alone, and of embed_dataset just after. Returns the launch counts by
    path."""
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.cli import embed_stack
    from targetvae_tpu_torch.cli.clustering_common import (embed_dataset,
                                                           load_encoder)
    from targetvae_tpu_torch.data import mrc
    from targetvae_tpu_torch.train.checkpoint import save_model_pair
    flagship = os.path.join(root, "flagship.mrcs")
    images = synthetic_images(EMBED_STACK_N, 50, 22)
    mrc.write(flagship, images[..., 0])
    cfg = empiar_config()
    params = TargetVAE(cfg, dev).init(torch.Generator().manual_seed(40))
    empiar_dir = os.path.join(root, "empiar_run")
    os.makedirs(empiar_dir)
    save_model_pair(empiar_dir, params, cfg)
    del params
    kernel = {"conv": "mix_heads_fwd", "patch": "lifted_encoder_fwd"}
    by_path = {}
    for shape, stack, enc, flags, ref_images in (
            ("flagship", flagship, flagship_sav, [], images),
            ("EMPIAR", stand["path"]("particles_train.mrcs"),
             os.path.join(empiar_dir, "inference.sav"), ["--normalize"],
             stand["images"])):
        n = len(ref_images)
        batches = -(-n // B)
        with contextlib.redirect_stderr(io.StringIO()):
            model, params = load_encoder(enc, dev)
        for tier in ("conv", "patch"):
            out = os.path.join(root, f"{shape}_{tier}")
            with encoder_tier(tier):
                embed_dataset(model, params, ref_images[:B], B, "bfloat16")
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t = time.perf_counter()
                with contextlib.redirect_stderr(io.StringIO()):
                    res = embed_stack.main(["--input", stack,
                                            "--path-to-encoder", enc,
                                            "--out", out, "-d", "0"] + flags)
                torch.cuda.synchronize()
                whole = time.perf_counter() - t
                counts = kernels.launch_counts()
                t = time.perf_counter()
                ref = embed_dataset(model, params, ref_images, B, "bfloat16")
                torch.cuda.synchronize()
                ref_s = time.perf_counter() - t
            files = [np.load(f"{out}_{p}.npy") for p in ("z", "rot", "trans")]
            expect = with_lift({k: (batches if k == kernel[tier] else 0)
                                for k in counts})
            label = (f"phase 20: embed_stack {shape} ({n} x "
                     f"{ref_images.shape[1]} x {ref_images.shape[2]}), "
                     f"{tier} tier, bf16")
            check(all(np.array_equal(a, r) for a, r in zip(files, ref))
                  and files[0].shape == (n, 2 * cfg.encoder.z_dim),
                  f"{label}: <out>_{{z,rot,trans}}.npy bitwise "
                  f"embed_dataset's")
            check(counts == expect, f"{label}: launches {counts} == "
                  f"{kernel[tier]} once a batch ({batches})")
            print(f"phase 20: embed_stack {shape}, {tier} tier: "
                  f"{n / whole:.1f} img/s (the whole call: MRC read, "
                  f"preprocessing, embed, files; host clock), "
                  f"{n / res['seconds']:.1f} img/s (its embed alone); "
                  f"embed_dataset just after {n / ref_s:.1f} img/s", flush=True)
            by_path[f"embed_stack_{shape}_{tier}"] = counts
        del model, params
        torch.cuda.empty_cache()
    return by_path


def interop_tools_path(torch, kernels, dev, stand: dict,
                       phase12_run: str) -> dict:
    """Phase 20: (a) sav_round_trips; (b) embed_stack_rates; (c)
    export_torch_checkpoint on phase 12's conv-tier run directory, the
    pair read back bitwise; (d) clustering_mnist on that pair's
    inference_torch.sav (tools/make_synthetic_shapes.py's labelled test
    split, bf16, k-means, 5 clusters): results.txt, the figures; (e)
    reconstruct on the pair: its PNG's size, no kernel launched, its
    float32 decode on the card against the same on the CPU; (f) the t-SNE
    on the card at N = 1,000 and 10,000, timed, its P at N = 1,000 against
    the CPU's. Returns the launch counts of (b) by path."""
    import tempfile
    from targetvae_tpu_torch.cli import (clustering_mnist,
                                         export_torch_checkpoint, reconstruct)
    from targetvae_tpu_torch.cli.tsne import joint_probabilities, tsne
    from targetvae_tpu_torch.train.checkpoint import load_checkpoint
    from targetvae_tpu_torch.utils import torch_import
    from targetvae_tpu_torch.utils.png import png_size
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        savs = sav_round_trips(torch, kernels, dev, root)
        by_path = embed_stack_rates(torch, kernels, dev, root,
                                    savs["mode C (flagship)"], stand)

        # (c) phase 12's run as the reference's pair, read back
        pair_dir = os.path.join(root, "pair")
        with contextlib.redirect_stderr(io.StringIO()):
            written = export_torch_checkpoint.main([phase12_run, "--out-dir",
                                                    pair_dir])
        eparams, ecfg, _ = load_checkpoint(os.path.join(phase12_run,
                                                        "inference.sav"))
        gparams, _, _ = load_checkpoint(os.path.join(phase12_run,
                                                     "generator.sav"))
        got_e = torch_import.encoder_from_sav(written[0])
        got_g = torch_import.generator_from_sav(written[1])
        differ = (trees_differ(got_e[1], eparams["encoder"], "encoder")
                  + trees_differ(got_g[1], gparams["generator"], "generator"))
        sigma = float(np.float32(ecfg.generator.fourier_sigma))
        check([os.path.basename(p) for p in written]
              == ["inference_torch.sav", "generator_torch.sav"]
              and got_e[0] == ecfg.encoder and not differ
              and got_g[0].fourier_sigma == sigma
              and got_g[0].hidden_dim == ecfg.generator.hidden_dim,
              f"phase 20: export_torch_checkpoint of phase 12's run "
              f"directory: {[os.path.basename(p) for p in written]} read "
              f"back by torch_import: configs equal (fourier_sigma as its "
              f"float32, {sigma!r}), every parameter bitwise (differ: "
              f"{differ})")

        # (d) clustering_mnist on the pair's inference_torch.sav
        data = os.path.join(root, "shapes")
        subprocess.run([sys.executable, os.path.join(
            here, "tools", "make_synthetic_shapes.py"), "--out-root", data,
            "--n-train", "50", "--n-test", str(CLI_TEST)], check=True,
            capture_output=True, timeout=300)
        tee = _Tee(sys.stderr)
        t = time.perf_counter()
        with contextlib.redirect_stderr(tee):
            res = clustering_mnist.main([
                "--dataset", "mnist-U", "--data-root", data,
                "--path-to-encoder", written[0], "--path-to-labels",
                os.path.join(data, "mnist_U", "labels_test.npy"),
                "--n-clusters", "5", "--compute-dtype", "bfloat16"])
        secs = time.perf_counter() - t
        err = "".join(tee.parts)
        text = open(os.path.join(pair_dir, "results.txt")).read()
        vals = [res["acc"], res["rot_corr"], *res["tr_corr"]]
        check("reference torch checkpoint, importing" in err
              and "accuracy for clustering" in text
              and bool(np.isfinite(np.asarray(vals, float)).all()),
              f"phase 20: clustering_mnist on the exported "
              f"inference_torch.sav (bf16, k-means, 5 clusters, "
              f"{CLI_TEST} shapes) in {secs:.1f} s: read as a reference "
              f"file; accuracy {res['acc']:.4f}, correlations "
              f"{res['rot_corr']:.4f}, {res['tr_corr'][0]:.4f}, "
              f"{res['tr_corr'][1]:.4f} (finite)")
        check_figures(pair_dir, {"tsne.png": (1000, 1000),
                                 "confusion_matrix.png": None}, err,
                      "phase 20: clustering_mnist")

        # (e) reconstruct on the pair
        out = os.path.join(root, "reconstructions.png")
        shapes = os.path.join(data, "mnist_U", "images_test.npy")
        kernels.reset_launch_counts()
        with contextlib.redirect_stderr(io.StringIO()):
            rec = reconstruct.main([
                "--path-to-encoder", written[0], "--path-to-generator",
                written[1], "--images", shapes, "--n", str(RECON_N),
                "--scale255", "--out", out])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        imgs = (np.load(shapes)[:RECON_N, ..., None] / 255.0).astype(
            np.float32)
        cpu_model, cpu_params = reconstruct.load_model(written[0],
                                                       written[1], "cpu")
        cpu = reconstruct.reconstruct(cpu_model, cpu_params, imgs)
        err_r = max(float(np.abs(a - b).max()) for a, b in
                    zip((rec["recon"], rec["canon"]), cpu))
        gap, d = reconstruct.GAP, 50
        size = (gap + 3 * (d + gap), gap + RECON_N * (d + gap))
        check(png_size(out) == size and not any(counts.values())
              and err_r <= TOL_RECON
              and all(bool(np.isfinite(a).all()) for a in cpu),
              f"phase 20: reconstruct on the pair, {RECON_N} images: PNG "
              f"{png_size(out)} == {size}; float32 decode (no kernel: "
              f"{counts}) on the card vs on the CPU max abs diff "
              f"{err_r:.3e} <= {TOL_RECON}")

    # (f) the t-SNE on the card
    pts = tsne_points(max(TSNE_SIZES))
    r1, c1, v1 = joint_probabilities(torch.from_numpy(pts[:1000]).to(dev))
    r2, c2, v2 = joint_probabilities(torch.from_numpy(pts[:1000]))
    p_err = (float((v1.cpu() - v2).abs().max())
             if torch.equal(r1.cpu(), r2) and torch.equal(c1.cpu(), c2)
             else float("inf"))
    check(p_err <= TOL_TSNE_P,
          f"phase 20: t-SNE P at N = 1,000 on the card vs on the CPU: the "
          f"same {len(v2)} entries, max abs diff {p_err:.3e} <= {TOL_TSNE_P}")
    tsne(pts[:200], device=dev, max_iter=300)          # warm-up
    for n in TSNE_SIZES:
        torch.cuda.synchronize()
        t = time.perf_counter()
        emb, kl = tsne(pts[:n], device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        check(emb.shape == (n, 2) and bool(np.isfinite(emb).all())
              and 0 < kl < 10,
              f"phase 20: t-SNE of N = {n} points (4-D, ten clusters) on the "
              f"card: {secs:.2f} s (host clock, P and 1,000 iterations), "
              f"final KL {kl:.4f}, embedding finite")
    print(f"phase 20: {time.perf_counter() - t0:.1f} s ({card()})",
          flush=True)
    return by_path



# ---- phase 21: the measurement layer ----

def bench_tool():
    """tools/bench_config_torch.py of this checkout, as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "bench_config_torch.py")
    spec = importlib.util.spec_from_file_location("bench_config_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_kernels(cfg, tier: str) -> set:
    """The kernels a bf16 train step of cfg launches on the encoder tier
    `tier`, each once."""
    e = cfg.encoder
    out = {"pose_decoder_fwd", "pose_decoder_bwd"}
    if e.mode == "A":
        return out
    enc = ("mix_heads_r1" if e.mode == "B"
           else "lifted_encoder" if tier == "patch" else "mix_heads")
    return out | {"posterior_fwd", "posterior_bwd", enc + "_fwd",
                  enc + "_bwd"} | set(with_lift((enc + "_fwd",)))


def counted_flops(torch, kernels, tool, name: str, tier: str, dev) -> dict:
    """One bf16 train step of the bench's config `name` on `tier` (after one
    step not counted) under FlopCounterMode, which sees cuDNN's and
    cuBLAS's products but not the hand-written kernels'; the kernels' own
    products (flops.kernel_products over the step's launches, less the
    forward products each recomputes); step_flops; the launches."""
    from torch.utils.flop_counter import FlopCounterMode
    from targetvae_tpu_torch.utils import flops
    step, cfg, batch, ctf_dim = tool.make_step(name, device=dev)
    with tool.encoder_tier(tier):
        step()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with FlopCounterMode(display=False) as fc:
            step()
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
    products = flops.kernel_products(cfg, batch)
    if cfg.encoder.mode != "A":
        products["lift_conv_fwd"] = (flops.lift_conv_products(cfg, batch), 0)
    return {"counter": fc.get_total_flops(),
            "kernels": sum(v * (products[k][0] - products[k][1])
                           for k, v in counts.items() if k in products),
            "unknown": sorted(set(counts) - set(products)),
            "step_flops": flops.step_flops(cfg, batch, ctf_dim)["total"],
            "launches": counts, "expected": step_kernels(cfg, tier),
            "batch": batch}


def measurement_path(torch, kernels, dev) -> dict:
    """Phase 21 (the module's docstring). Returns the launch counts of each
    config's timed windows, by path ("bench_<config>_<tier>")."""
    tool = bench_tool()
    t0 = time.perf_counter()
    by_path = {}
    for name in tool.CONFIGS:
        cfg = tool.build(name)[0]
        mode = cfg.encoder.mode
        for tier in ("conv", "patch") if mode == "C" else ("conv",):
            torch.cuda.empty_cache()
            r = tool.bench(name, steps=BENCH_STEPS, windows=BENCH_WINDOWS,
                           tier=tier, device=dev)
            per_step = r["launches_per_step"]
            want = step_kernels(cfg, tier)
            check(0 < r["mfu"] < 1
                  and per_step == {k: 1.0 for k in want},
                  f"phase 21: {name}{' ' + tier if mode == 'C' else ''} "
                  f"(mode {mode}), B = {r['batch']}, bf16: "
                  f"{r['ms_per_step']:.3f} ms/step (windows "
                  f"{[round(m, 3) for m in r['ms_windows']]}), "
                  f"{r['images_per_sec']:.1f} img/s, "
                  f"{r['tflops_per_step']:.4f} TFLOP/step, MFU "
                  f"{r['mfu']:.4f} in (0, 1); each of {sorted(want)} once a "
                  f"step ({card()})")
            by_path[f"bench_{name}_{tier}"] = {
                k: round(per_step.get(k, 0) * BENCH_STEPS * BENCH_WINDOWS)
                for k in kernels.WRAPPERS}
    for name, tier in (("mnist", "conv"), ("mnist", "patch"),
                       ("mnist-b-p8", "conv"), ("particles-ctf", "conv")):
        torch.cuda.empty_cache()
        c = counted_flops(torch, kernels, tool, name, tier, dev)
        got = c["counter"] + c["kernels"]
        rel = abs(got - c["step_flops"]) / c["step_flops"]
        check(not c["unknown"] and set(c["launches"]) == c["expected"]
              and all(v == 1 for v in c["launches"].values())
              and rel <= TOL_FLOPS,
              f"phase 21: {name} {tier}, B = {c['batch']}, one bf16 step: "
              f"FlopCounterMode {c['counter']:.6e} + the kernels' products "
              f"{c['kernels']:.6e} = {got:.6e} against step_flops "
              f"{c['step_flops']:.6e}: rel {rel:.2e} <= {TOL_FLOPS}; "
              f"launches {c['launches']}")
    print(f"phase 21: {time.perf_counter() - t0:.1f} s ({card()})",
          flush=True)
    return by_path

if __name__ == "__main__":
    sys.exit(main())
