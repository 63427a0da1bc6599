"""Plain versions of the port's kernels against the JAX Pallas kernels, run in
interpret mode as tests/test_kernels.py runs them, at that file's shapes and
tolerances; plus kernel-against-plain cases that need a CUDA device (they
skip on a machine without one).

The CUDA cases need no JAX, so on a GPU machine without it they run as
    python -m pytest --noconftest tests/test_torch_port_kernels.py -k cuda
(--noconftest: tests/conftest.py configures JAX); the JAX comparisons then
skip.
"""

import types

import numpy as np
import pytest
import torch

import targetvae_tpu_torch.kernels as kernels
from targetvae_tpu_torch.kernels.decoder_mlp import (
    decoder_mlp_bwd, decoder_mlp_bwd_plain, decoder_mlp_fwd, decoder_mlp_plain)
from targetvae_tpu_torch.kernels.decoder_pose import (
    fused_pose_decoder, fused_pose_decoder_tables, pose_decoder_bwd,
    pose_decoder_bwd_plain, pose_decoder_plain, pose_tables)
from targetvae_tpu_torch.kernels.lifted_encoder import (
    lifted_encoder_bwd, lifted_encoder_bwd_plain, lifted_encoder_fwd,
    lifted_encoder_plain)
from targetvae_tpu_torch.kernels.mix_heads import (
    fused_lift_act_mix_heads, lift_act_mix_heads_bwd_plain,
    lift_act_mix_heads_plain, mix_heads_bwd)
from targetvae_tpu_torch.kernels.posterior import (
    HEADS_SMEM_BYTES, K3_CELLS, SHARD_CELLS, fused_posterior, k3_schedule,
    k4_schedule, pack_planes, philox4x32, philox_gumbel, posterior_bwd,
    posterior_bwd_plain, posterior_fwd, posterior_plain,
    posterior_shard_bwd_plain, posterior_shard_fwd, posterior_shard_partials,
    posterior_shard_plain, shard_schedule)
from targetvae_tpu_torch.models.generator import generator_init
from targetvae_tpu_torch.ops.coords import image_grid, transform_coords
from targetvae_tpu_torch.utils.config import GeneratorConfig
from targetvae_tpu_torch.utils.jax_params import params_from_jax


@pytest.fixture
def jx():
    """The JAX reference: jax, jnp and the Pallas kernels' entry points."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from targetvae_tpu.kernels.decoder_pose import fused_pose_decoder
    from targetvae_tpu.kernels.mix_heads import fused_lift_act_mix_heads
    from targetvae_tpu.kernels.posterior import fused_posterior
    from targetvae_tpu.models.generator import generator_init
    from targetvae_tpu.utils.config import GeneratorConfig as JaxGenConfig
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, pose=fused_pose_decoder, mix=fused_lift_act_mix_heads,
        post=fused_posterior, gen_init=generator_init, GenConfig=JaxGenConfig)


@pytest.fixture
def cuda():
    """The CUDA device; decided inside the test, so every worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


def _mix_inputs(R=4, K=128, D=7, N=700):
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (f(N, R * K) * 0.5, f(R * K) * 0.1, f(K, K) * 0.05, f(K) * 0.1,
            f(K, D) * 0.1, f(D) * 0.1)


def _posterior_inputs(B=3, R=4, M=25, zd=2, seed=1):
    """K3's inputs under the heads contract, numpy: the raw heads
    (B, M, R, D) (logit x 2, theta mean, theta log-std x 0.3, z means, z
    log-stds x 0.3), log p(r) (R,) (not uniform, so that its add shows),
    the offsets (R,), p_tr (M, R), the grid (M, 2) and sig_r; at
    tests/test_kernels.py:218's shapes by default."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    scale = np.asarray([2.0, 1.0, 0.3] + [1.0] * zd + [0.3] * zd, np.float32)
    heads = f(B, M, R, 3 + 2 * zd) * scale
    p = f(M * R)
    p_tr = (p - np.log(np.exp(p - p.max()).sum()) - p.max()).reshape(M, R)
    offs = 2 * np.pi * np.arange(R) / R
    offs = np.where(offs > np.pi + 1e-9, offs - 2 * np.pi, offs)
    return (heads, f(R) * 0.5 - np.log(4 * np.pi).astype(np.float32),
            offs.astype(np.float32), p_tr.astype(np.float32), f(M, 2),
            float(np.pi / R))


def _jax_planes(heads, p_r, offs, p_tr):
    """The JAX kernel's (B, R, M) planes of heads-contract inputs, as the
    JAX package's ELBO forms them: attn and theta_mu with log p(r) and the
    offsets added, z (B, zd, R, M), p_tr (R, M)."""
    zd = (heads.shape[-1] - 3) // 2
    hp = heads.transpose(0, 3, 2, 1)                              # (B, D, R, M)
    c = np.ascontiguousarray
    return (c(hp[:, 0] + p_r[:, None]), c(hp[:, 1] + offs[:, None]),
            c(hp[:, 2]), c(hp[:, 3:3 + zd]), c(hp[:, 3 + zd:]), c(p_tr.T))


def _pose_config(num_layers, n=18, zd=2):
    return GeneratorConfig(z_dim=zd, hidden_dim=64, num_layers=num_layers,
                           n_out=1, fourier_expansion=True,
                           fourier_sigma=2 / (n - 1))


def _pose_inputs(B=3, zd=2):
    rng = np.random.default_rng(2)
    theta = rng.normal(size=(B,)).astype(np.float32)
    dx = (rng.normal(size=(B, 2)) * 0.2).astype(np.float32)
    z = rng.normal(size=(B, zd)).astype(np.float32)
    return theta, dx, z


@pytest.mark.parametrize("K, R, act", [
    (K, R, act) for K in (16, 128) for R in (1, 8)
    for act in ("leakyrelu", "tanh")])
def test_mix_heads_plain_matches_jax_kernel(jx, K, R, act):
    """K1's plain version against the Pallas kernel (interpret mode) at
    the narrowest and widest K the kernels take, one and eight rotations,
    both activations: the heads within 5e-3 (tests/test_kernels.py:94's
    bound; both round h1 and h2 to bf16 at the same points and differ in
    f32 summation order only)."""
    args = _mix_inputs(R=R, K=K)
    jargs = [jx.jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(jx.jnp.bfloat16)
    ref = np.asarray(jx.mix(*jargs, R=R, K=K, act_kind=act, interpret=True))
    targs = [torch.from_numpy(a) for a in args]
    targs[0] = targs[0].to(torch.bfloat16)
    got = lift_act_mix_heads_plain(*targs, R=R, K=K, act_kind=act)
    assert got.shape == ref.shape == (700, R * 7)
    assert float(np.abs(got.numpy() - ref).max()) < 5e-3
    # the wrapper on a CPU tensor is the plain version, and counts nothing
    kernels.reset_launch_counts()
    np.testing.assert_array_equal(
        fused_lift_act_mix_heads(*targs, R=R, K=K, act_kind=act).numpy(),
        got.numpy())
    assert kernels.launch_counts()["mix_heads_fwd"] == 0


def test_posterior_plain_matches_jax_kernel_deterministic(jx):
    """The heads contract's plain version and the CPU wrapper against the
    Pallas kernel (interpret mode) fed the planes the JAX package's ELBO
    forms from the same heads: float32 on both sides, 1e-4."""
    heads, p_r, offs, p_tr, grid, sig_r = _posterior_inputs()
    planes = [jx.jnp.asarray(a) for a in _jax_planes(heads, p_r, offs, p_tr)]
    ref = jx.post(jx.jax.random.key(9), *planes, jx.jnp.asarray(grid),
                  jx.jnp.asarray(offs), sig_r, deterministic=True,
                  interpret=True)
    targs = [torch.from_numpy(a) for a in (heads, p_r, offs, p_tr, grid)]
    for got in (posterior_plain(*targs, sig_r),
                fused_posterior(9, *targs, sig_r, deterministic=True)):
        for name in ref:
            assert float(np.abs(got[name].numpy()
                                - np.asarray(ref[name])).max()) < 1e-4, name


def test_posterior_sampled_cpu_is_split_invariant():
    heads, *consts = _posterior_inputs(B=4)
    targs = [torch.from_numpy(a) for a in consts[:4]] + [consts[4]]
    h = torch.from_numpy(heads)
    full = fused_posterior(5, h, *targs)
    halves = [fused_posterior(5 + i, h[i:i + 2], *targs) for i in (0, 2)]
    det = fused_posterior(5, h, *targs, deterministic=True)
    for name in full:
        torch.testing.assert_close(
            full[name], torch.cat([h_[name] for h_ in halves]), rtol=0, atol=0)
    # the KL does not depend on the sample
    torch.testing.assert_close(full["kl"], det["kl"], rtol=1e-6, atol=1e-6)
    assert not torch.equal(full["dx"], det["dx"])


def test_philox_matches_random123_known_answers():
    """philox4x32 (PyTorch integer operations) against Random123's known
    answers for Philox4x32-10 (its kat_vectors): counter and key all zeros,
    all ones, and the digits of pi."""
    w = lambda *v: tuple(torch.tensor(x, dtype=torch.int64) for x in v)
    cases = [
        (w(0, 0, 0, 0), w(0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        (w(*[0xFFFFFFFF] * 4), w(0xFFFFFFFF, 0xFFFFFFFF),
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        (w(0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         w(0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for counter, key, want in cases:
        assert tuple(int(x) for x in philox4x32(counter, key)) == want


def test_philox_gumbel_is_the_kernels_draw():
    """philox_gumbel against a scalar reading of csrc/posterior.cu's gumbel:
    key (seed & 0x7FFFFFFF) + image, counter r M + m, the first output
    word's top 23 bits as a [1, 2) mantissa minus 1, clipped to
    [1e-20, 1 - 1e-7], then -log(-log(u)). The uniform is exact; the two
    logs in float32 within 1e-6 relative."""
    seed, b, R, M = 0x7FFFFFF0 + 2 ** 31, 3, 4, 7
    got = philox_gumbel(seed, b, R, M)
    assert got.shape == (b, R, M) and got.dtype == torch.float32
    for i, r, m in ((0, 0, 0), (2, 3, 6), (1, 2, 5), (2, 0, 3)):
        key = ((seed & 0x7FFFFFFF) + i) & 0xFFFFFFFF
        t = lambda x: torch.tensor(x, dtype=torch.int64)
        bits = int(philox4x32((t(r * M + m), t(0), t(0), t(0)),
                              (t(key), t(0)))[0])
        u = np.array([(bits >> 9) | 0x3F800000], np.uint32).view(
            np.float32)[0] - np.float32(1)
        u = min(max(u, np.float32(1e-20)), np.float32(1 - 1e-7))
        want = -np.log(-np.log(np.float64(u)))
        assert abs(float(got[i, r, m]) - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("M, R, D, cluster, budget", [
    (1521, 8, 7, None, HEADS_SMEM_BYTES), (1521, 16, 7, None, HEADS_SMEM_BYTES),
    (4225, 8, 7, None, HEADS_SMEM_BYTES), (1521, 8, 19, None, HEADS_SMEM_BYTES),
    (4225, 8, 7, 4, HEADS_SMEM_BYTES), (25, 4, 5, None, HEADS_SMEM_BYTES),
    (25, 4, 7, 16, 256), (49, 8, 9, 2, 512)])
def test_posterior_schedule_covers_each_cell_once(M, R, D, cluster, budget):
    """K3's and K4's grids: `cluster` CTAs of `chunk` cells (a multiple of
    4) cover the image's R M cells, each cell in one CTA. K3 streams at
    most K3_CELLS a CTA by default (the flagship: 4 CTAs of 3,044 cells);
    K4 holds at most `sub` cells at a time, a multiple of 4 within the
    shared-memory budget, by default on the smallest cluster whose chunks
    fit it (the flagship: 8 CTAs of 1,524 cells)."""
    c = R * M
    ceil4 = lambda n: -(-n // 4) * 4
    cs, chunk = k3_schedule(M, R, cluster)
    assert chunk % 4 == 0 and cs * chunk >= c
    if cluster is None:
        assert cs in (1, 2, 4, 8, 16)
        assert chunk <= K3_CELLS or cs == 16
        assert cs == 1 or ceil4(-(-c // (cs // 2))) > K3_CELLS
    else:
        assert cs == cluster
    cs, chunk, sub = k4_schedule(M, R, D, cluster, budget)
    assert chunk % 4 == 0 and sub % 4 == 0 and 4 <= sub <= chunk
    assert cs * chunk >= c
    assert sub * 4 * D <= budget or sub == 4
    if cluster is None:
        assert cs in (1, 2, 4, 8, 16)
        assert chunk * 4 * D <= budget or cs == 16
        assert cs == 1 or ceil4(-(-c // (cs // 2))) * 4 * D > budget
    else:
        assert cs == cluster
    if (M, R, D, cluster) == (1521, 8, 7, None):
        assert k3_schedule(M, R) == (4, 3044)
        assert (cs, chunk, sub) == (8, 1524, 1524)


@pytest.mark.parametrize("num_layers", [2, 4])
def test_pose_decoder_plain_matches_jax_kernel(jx, num_layers):
    cfg = _pose_config(num_layers)
    jcfg = jx.GenConfig(**cfg.__dict__)
    jp = jx.gen_init(jx.jax.random.key(0), jcfg)
    theta, dx, z = _pose_inputs()
    n = 18
    jnp = jx.jnp
    ref = np.asarray(jx.pose(jnp.asarray(theta), jnp.asarray(dx),
                             jnp.asarray(z), jp, jcfg, n, tr=8,
                             interpret=True))
    tp = params_from_jax(jx.jax.tree.map(np.asarray, jp))
    got = fused_pose_decoder(torch.from_numpy(theta), torch.from_numpy(dx),
                             torch.from_numpy(z), tp, cfg, n)
    assert got.shape == ref.shape == (3, n * n, 1)
    assert float(np.abs(got.numpy() - ref).max()) < 1e-2


# ---- on the card: each kernel against its plain version ----

# K1's forward chain at shapes that together cover every K, R, N, act and
# D the kernel is checked at: K < 128 runs zero-padded to 128 channels; N =
# 1, 65 and 700 leave a 128-position tile's second half partly or wholly
# past N; N = 20,000 gives each block several tiles, some split between two
# blocks (their heads leave by plain stores, whole tiles by a bulk copy);
# R = 16, D = 16 leaves no room for the heads buffer (heads stored
# directly)
FWD = [(128, 4, 700, "leakyrelu", 7), (128, 8, 65, "tanh", 16),
       (128, 16, 1, "leakyrelu", 7), (128, 1, 700, "tanh", 16),
       (128, 8, 20_000, "leakyrelu", 7), (64, 1, 700, "tanh", 7),
       (64, 8, 65, "leakyrelu", 16), (64, 16, 700, "tanh", 16),
       (32, 4, 1, "tanh", 16), (32, 16, 700, "leakyrelu", 7),
       (32, 8, 20_000, "tanh", 7), (16, 8, 700, "tanh", 7),
       (16, 1, 65, "leakyrelu", 16), (16, 16, 65, "tanh", 7),
       (16, 4, 700, "leakyrelu", 16)]


@pytest.mark.parametrize("K, R, N, act, D", FWD)
def test_mix_heads_kernel_on_cuda(cuda, K, R, N, act, D):
    args = [torch.from_numpy(a).to(cuda)
            for a in _mix_inputs(R=R, K=K, D=D, N=N)]
    args[0] = args[0].to(torch.bfloat16)
    kernels.reset_launch_counts()
    got = fused_lift_act_mix_heads(*args, R=R, K=K, act_kind=act)
    again = fused_lift_act_mix_heads(*args, R=R, K=K, act_kind=act)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["mix_heads_fwd"] == 2
    ref = lift_act_mix_heads_plain(*args, R=R, K=K, act_kind=act)
    assert got.shape == ref.shape == (N, R * D)
    assert float((got - ref).abs().max()) < 5e-3
    assert torch.equal(got, again)


def _cuda_posterior(cuda, **kw):
    heads, *consts = _posterior_inputs(**kw)
    return ([torch.from_numpy(a).to(cuda) for a in (heads, *consts[:4])]
            + [consts[4]])


def _close_per_unit(a, b) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def _scaled_err(a, b, cell_dims=(1, 2)) -> float:
    """max |a - b| / (|b| + 1e-3 s), s the max of |b| over an image's cells
    in each channel (chip_smoke.scaled_err): the posterior cotangents scale
    with their cells' softmax weights, so each element is held to its own
    magnitude, down to a thousandth of its image's largest."""
    a, b = a.double(), b.double()
    den = b.abs() + 1e-3 * b.abs().amax(dim=cell_dims, keepdim=True)
    return float(((a - b).abs() / den.clamp(min=1e-300)).max())


def test_posterior_kernel_on_cuda(cuda):
    targs = _cuda_posterior(cuda)
    got = fused_posterior(9, *targs, deterministic=True)
    ref = posterior_plain(*targs)
    for name in ref:
        assert float((got[name] - ref[name]).abs().max()) < 1e-4, name
    s1, s2 = fused_posterior(3, *targs), fused_posterior(3, *targs)
    for name in s1:
        assert torch.equal(s1[name], s2[name])
    torch.testing.assert_close(s1["kl"], got["kl"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("num_layers", [2, 4])
def test_pose_decoder_kernel_on_cuda(cuda, num_layers):
    cfg = _pose_config(num_layers)
    tp = generator_init(torch.Generator().manual_seed(0), cfg, device=cuda)
    th, d, zz = (torch.from_numpy(a).to(cuda) for a in _pose_inputs())
    wf = tp["fourier"]["w"] / cfg.fourier_sigma
    u, v, p, q = pose_tables(th, d, wf, tp["fourier"]["b"], 18)
    args = (u, v, p, q, zz @ tp["latent_linear"]["w"],
            tp["coord_linear"]["w"], tp["coord_linear"]["b"],
            torch.stack([h["w"] for h in tp["hidden"]]),
            torch.stack([h["b"] for h in tp["hidden"]]),
            tp["out"]["w"], tp["out"]["b"])
    got = fused_pose_decoder_tables(*args)
    ref = pose_decoder_plain(*args)
    assert float((got - ref).abs().max()) < 1e-2


# ---- on the card: each backward kernel against its plain version ----
#
# Tolerances: kernel and plain round at the same points, so they differ by
# f32 summation order only. The f32 gradients summed over many pixels or
# positions: relative L2 distance <= 1e-3. A saved bf16 h may land one bf16
# step (2^-8 relative) apart where the f32 value sits near a rounding
# boundary: max abs error <= 2^-7 of the largest magnitude. K2 recomputes
# h2 from a sum taken in another order, and where it sits at zero the leaky
# slope differs between the two sides: its bf16 dpre1 within 0.05 of the
# largest magnitude (the JAX package's K2 gradient bound), 1e-2 relative L2.

def _rel(got, ref):
    return float((got.float() - ref.float()).norm()
                 / ref.float().norm().clamp(min=1e-12))


# K2's chain kernel at shapes that together cover every K, R, N, act and D
# the wrapper takes (K < 128 runs zero-padded to 128 channels; N = 1 and 65
# leave most of a 64-position tile past N)
CHAIN = [(128, 4, 700, "leakyrelu", 7), (128, 8, 65, "tanh", 16),
         (128, 16, 1, "leakyrelu", 7), (64, 1, 700, "tanh", 7),
         (64, 8, 65, "leakyrelu", 16), (32, 4, 1, "tanh", 16),
         (32, 16, 700, "leakyrelu", 7), (16, 8, 700, "tanh", 7),
         (16, 1, 65, "leakyrelu", 16), (16, 16, 65, "tanh", 7)]


@pytest.mark.parametrize("K, R, N, act, D", CHAIN)
def test_mix_heads_backward_kernel_on_cuda(cuda, K, R, N, act, D):
    args = [torch.from_numpy(a).to(cuda)
            for a in _mix_inputs(R=R, K=K, D=D, N=N)]
    args[0] = args[0].to(torch.bfloat16)
    g = torch.randn(N, R * D, generator=torch.Generator().manual_seed(4)).to(cuda)
    kernels.reset_launch_counts()
    got = mix_heads_bwd(*args[:5], g, R=R, K=K, act_kind=act)
    again = mix_heads_bwd(*args[:5], g, R=R, K=K, act_kind=act)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["mix_heads_bwd"] == 2
    ref = lift_act_mix_heads_bwd_plain(*args[:5], g, R=R, K=K, act_kind=act)
    assert got[0].dtype == torch.bfloat16
    scale = float(ref[0].float().abs().max())
    assert float((got[0].float() - ref[0].float()).abs().max()) <= 0.05 * scale
    assert _rel(got[0], ref[0]) <= 1e-2
    for i in range(1, 6):
        assert got[i].shape == ref[i].shape, i
        assert _rel(got[i], ref[i]) < 1e-3, (i, _rel(got[i], ref[i]))
    # fixed grid and in-order sums: a rerun is bitwise the same
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_posterior_backward_kernel_on_cuda(cuda):
    targs = _cuda_posterior(cuda)
    g = torch.randn(3, 9, generator=torch.Generator().manual_seed(5)).to(cuda)
    got = posterior_bwd(9, g, *targs, deterministic=True)
    ref = posterior_bwd_plain(g, *targs)
    assert got.shape == ref.shape == targs[0].shape
    assert _close_per_unit(got, ref) < 1e-4
    assert _scaled_err(got, ref) < 1e-2
    s1 = posterior_bwd(3, g, *targs)
    s2 = posterior_bwd(3, g, *targs)
    assert torch.equal(s1, s2)


def test_posterior_sampled_backward_is_its_forwards_derivative_on_cuda(cuda):
    """The sampled backward regenerates the forward's noise: its gradient
    matches a central difference of the kernel's own forward at the same
    seed, along a seeded direction (float32 differences of O(1) values at
    step 1e-2: relative tolerance 2e-2)."""
    targs = _cuda_posterior(cuda)
    gen = torch.Generator().manual_seed(6)
    g = torch.randn(3, 9, generator=gen).to(cuda)
    d = torch.randn(targs[0].shape, generator=gen).to(cuda)
    grads = posterior_bwd(21, g, *targs)
    fwd = lambda eps: kernels.posterior_fwd(21, targs[0] + eps * d,
                                            *targs[1:])
    h = 1e-2
    fd = float(((fwd(h) - fwd(-h)) * g).sum()) / (2 * h)
    an = float((grads * d).sum())
    assert abs(fd - an) <= 2e-2 * max(abs(an), 1.0), (fd, an)


# K3 and K4 over the shapes the wrappers take: odd and even M, R = 4, 8
# and 16, zd = 1, 2, 3 and 8, B = 0, 1, 2 and 3, on the default grids and
# on forced ones: clusters of 2 to 16 CTAs (16 needs the non-portable
# cluster size), CTAs left without cells, K4's chunks streamed through a
# small shared-memory budget, K3's through several rounds of its ring, and
# heads 4 bytes off 16-byte alignment (which the wrappers copy to an
# aligned tensor for the bulk copies). (B, M, R, zd, cluster, budget,
# offset)
POSTERIOR_CUDA = [
    (3, 25, 4, 2, None, None, 0), (3, 36, 16, 1, None, None, 0),
    (1, 49, 8, 8, None, None, 0), (0, 25, 4, 2, None, None, 0),
    (3, 100, 4, 2, 4, None, 0), (3, 25, 4, 3, 8, None, 0),
    (3, 64, 16, 8, 16, 1024, 0), (2, 81, 8, 2, 2, 2048, 0),
    (3, 25, 4, 2, 2, None, 1), (2, 81, 8, 8, 4, 1024, 1)]


@pytest.mark.parametrize("B, M, R, zd, cluster, budget, offset",
                         POSTERIOR_CUDA)
def test_posterior_kernels_over_shapes_on_cuda(cuda, B, M, R, zd, cluster,
                                               budget, offset):
    """K3 and K4, deterministic and sampled, against their plain versions
    fed the kernels' own noise (philox_gumbel): float32 formulas on both
    sides, sums in other orders, 1e-4 per unit of max(1, |value|) (two
    logs of the noise may differ by an ulp between the card's logf and
    torch.log), and K4's cotangents each within 1e-2 of their own
    magnitude (_scaled_err). Reruns bitwise equal; one launch counted
    each."""
    heads, *consts = _cuda_posterior(cuda, B=max(B, 1), M=M, R=R, zd=zd)
    heads = heads[:B]
    if offset:
        flat = torch.empty(heads.numel() + offset, device=cuda)
        flat[offset:] = heads.reshape(-1)
        heads = flat[offset:].view(heads.shape)
    sched3 = k3_schedule(M, R, cluster)
    sched4 = k4_schedule(M, R, 3 + 2 * zd, cluster,
                         budget or HEADS_SMEM_BYTES)
    g = torch.randn(B, 2 * zd + 5,
                    generator=torch.Generator().manual_seed(8)).to(cuda)
    noise = philox_gumbel(11, B, R, M, cuda)
    for det in (True, False):
        kernels.reset_launch_counts()
        out = posterior_fwd(11, heads, *consts, deterministic=det,
                            schedule=sched3)
        again = posterior_fwd(11, heads, *consts, deterministic=det,
                              schedule=sched3)
        dh = posterior_bwd(11, g, heads, *consts, deterministic=det,
                           schedule=sched4)
        dh2 = posterior_bwd(11, g, heads, *consts, deterministic=det,
                            schedule=sched4)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["posterior_fwd"] == counts["posterior_bwd"] == (
            2 if B else 0)
        nz = None if det else noise
        ref = torch.cat([v if v.dim() == 2 else v[:, None]
                         for v in posterior_plain(heads, *consts,
                                                  noise=nz).values()], dim=1)
        assert out.shape == ref.shape == (B, 2 * zd + 5)
        assert torch.equal(out, again) and torch.equal(dh, dh2)
        if B:
            assert _close_per_unit(out, ref) < 1e-4, det
            refb = posterior_bwd_plain(g, heads, *consts, noise=nz)
            assert dh.shape == heads.shape
            assert _close_per_unit(dh, refb) < 1e-4, det
            assert _scaled_err(dh, refb) < 1e-2, det


@pytest.mark.parametrize("num_layers", [2, 4])
def test_pose_decoder_backward_kernel_on_cuda(cuda, num_layers):
    cfg = _pose_config(num_layers)
    tp = generator_init(torch.Generator().manual_seed(0), cfg, device=cuda)
    th, d, zz = (torch.from_numpy(a).to(cuda) for a in _pose_inputs())
    wf = tp["fourier"]["w"] / cfg.fourier_sigma
    u, v, p, q = pose_tables(th, d, wf, tp["fourier"]["b"], 18)
    wh = torch.stack([h["w"] for h in tp["hidden"]])
    args = (u, v, p, q, zz @ tp["latent_linear"]["w"],
            tp["coord_linear"]["w"], tp["coord_linear"]["b"], wh,
            torch.stack([h["b"] for h in tp["hidden"]]),
            tp["out"]["w"], tp["out"]["b"])
    y, hs = fused_pose_decoder_tables(*args, save_res=True)
    # the save-residuals mode leaves the output as it was
    assert torch.equal(y, fused_pose_decoder_tables(*args))
    y_p, hs_p = pose_decoder_plain(*args, save_res=True)
    assert hs.shape == hs_p.shape == (num_layers, 3, 18 * 18, 64)
    assert float((hs.float() - hs_p.float()).abs().max()) <= float(
        hs_p.float().abs().max()) / 128
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(7)).to(cuda)
    kernels.reset_launch_counts()
    got = pose_decoder_bwd(u, v, p, q, hs, args[5], wh, args[9], g)
    again = pose_decoder_bwd(u, v, p, q, hs, args[5], wh, args[9], g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pose_decoder_bwd"] == 2
    ref = pose_decoder_bwd_plain(u, v, p, q, hs, args[5], wh, args[9], g)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        assert _rel(a, b) < 1e-3, (i, _rel(a, b))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# The wgmma kernels' edges: pixel counts that leave a ragged tail in the
# 64-pixel tile (n = 18: 324 = 5 x 64 + 4; n = 30: 900, no multiple of 128),
# each hidden width's consumer layout (64, 128: one warpgroup; 256, 512: two),
# L = 3, tanh, n_out > 1, and F that is no multiple of the 512-feature pose
# block or of the 128-row weight-gradient tile (F = 192, 64), or (forward
# only) no multiple of the 64-feature slice (F = 96).
WIDE = [  # (layers, n, hidden, act, n_out, F)
    (2, 18, 512, "leakyrelu", 1, 1024),
    (3, 30, 256, "tanh", 3, 192),
    (3, 18, 64, "tanh", 3, 1024),
    (2, 30, 128, "leakyrelu", 2, 64),
]


def _wide_args(dev, layers, n, hidden, act, n_out, F):
    cfg = GeneratorConfig(z_dim=2, hidden_dim=hidden, num_layers=layers,
                          n_out=n_out, activation=act, fourier_expansion=True,
                          fourier_sigma=2 / (n - 1), embedding_dim=F)
    tp = generator_init(torch.Generator().manual_seed(0), cfg, device=dev)
    th, d, zz = (torch.from_numpy(a).to(dev) for a in _pose_inputs())
    wf = tp["fourier"]["w"] / cfg.fourier_sigma
    u, v, p, q = pose_tables(th, d, wf, tp["fourier"]["b"], n)
    return (u, v, p, q, zz @ tp["latent_linear"]["w"],
            tp["coord_linear"]["w"], tp["coord_linear"]["b"],
            torch.stack([h["w"] for h in tp["hidden"]]),
            torch.stack([h["b"] for h in tp["hidden"]]),
            tp["out"]["w"], tp["out"]["b"])


@pytest.mark.parametrize("layers, n, hidden, act, n_out, F",
                         WIDE + [(2, 18, 64, "leakyrelu", 1, 96)])
def test_pose_decoder_kernel_shapes_on_cuda(cuda, layers, n, hidden, act,
                                            n_out, F):
    args = _wide_args(cuda, layers, n, hidden, act, n_out, F)
    got = fused_pose_decoder_tables(*args, act_kind=act)
    y, hs = fused_pose_decoder_tables(*args, act_kind=act, save_res=True)
    ref, hs_p = pose_decoder_plain(*args, act_kind=act, save_res=True)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (3, n * n, n_out)
    assert float((got - ref).abs().max()) < 1e-2
    # saving the h tiles leaves the output bitwise as serving gives it
    assert torch.equal(y, got)
    assert float((hs.float() - hs_p.float()).abs().max()) <= float(
        hs_p.float().abs().max()) / 128


@pytest.mark.parametrize("layers, n, hidden, act, n_out, F", WIDE)
def test_pose_decoder_backward_kernel_shapes_on_cuda(cuda, layers, n, hidden,
                                                     act, n_out, F):
    args = _wide_args(cuda, layers, n, hidden, act, n_out, F)
    u, v, p, q, _, w1, _, wh, _, w3, _ = args
    _, hs = fused_pose_decoder_tables(*args, act_kind=act, save_res=True)
    g = torch.randn((3, n * n, n_out),
                    generator=torch.Generator().manual_seed(7)).to(cuda)
    got = pose_decoder_bwd(u, v, p, q, hs, w1, wh, w3, g, act_kind=act)
    again = pose_decoder_bwd(u, v, p, q, hs, w1, wh, w3, g, act_kind=act)
    ref = pose_decoder_bwd_plain(u, v, p, q, hs, w1, wh, w3, g, act_kind=act)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        assert _rel(a, b) < 1e-3, (i, _rel(a, b))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("rows, m, n, sms, rebuilt", [
    (250_000, 1024, 512, 132, True), (250_000, 512, 512, 132, False),
    (972, 192, 256, 132, True), (324, 64, 64, 132, True),
    (900, 1024, 512, 8, False), (64, 128, 128, 1, True),
    (65, 1024, 512, 132, True), (1, 64, 64, 132, False),
    (152_100, 784, 1024, 132, False), (8_192, 12_680, 1024, 132, False),
    (700, 832, 320, 132, False)])
def test_wgrad_schedule_covers_each_row_and_tile_once(rows, m, n, sms,
                                                      rebuilt):
    """The split-K grid of K8's and K12's weight gradients (K12's dWc at the
    flagship and the galaxy encoder's shapes): every pixel row falls in
    exactly one split, no
    split is empty, every (m, n) output entry in exactly one tile, and the
    grid fills at most one wave unless the tiles alone exceed it."""
    from targetvae_tpu_torch.kernels.decoder_pose import (
        TILE_PX, wgrad_schedule)
    (gx, gy, splits), (tm, tn), chunk = wgrad_schedule(rows, m, n, sms,
                                                       rebuilt)
    assert chunk % TILE_PX == 0
    seen = np.zeros(rows, np.int64)
    for z in range(splits):
        lo, hi = z * chunk, min(rows, (z + 1) * chunk)
        assert hi > lo
        seen[lo:hi] += 1
    assert (seen == 1).all()
    cover = np.zeros((m, n), np.int64)
    for x in range(gx):
        for y in range(gy):
            cover[x * tm:min(m, (x + 1) * tm), y * tn:(y + 1) * tn] += 1
    assert (cover == 1).all()
    assert gx * gy * splits <= max(sms, gx * gy)


SCHEDULES = [(152_100, 8, 132), (76_050, 8, 132), (700, 4, 132),
             (1, 16, 132), (65, 1, 132), (700, 16, 7), (64 * 132 + 1, 1, 132),
             (8_192, 8, 1)]


@pytest.mark.parametrize("n, R, sms, tile", [
    pytest.param(*c, tile, id="-".join(map(str, c)) + ("" if tile == 64
                                                         else "-fwd"))
    for tile in (64, 128) for c in SCHEDULES])
def test_chain_schedule_visits_each_item_once(n, R, sms, tile):
    """The chain kernels' persistent grid, over the backward's 64-position
    and the forward's 128-position tiles: every (tile, rotation) item in
    exactly one block, no block empty, at most one block an SM, and no
    block holding more than its even share, rounded up."""
    from targetvae_tpu_torch.kernels.mix_heads import chain_schedule
    blocks, chunk = chain_schedule(n, R, sms, tile=tile)
    total = -(-n // tile) * R
    seen = np.zeros(total, np.int64)
    for b in range(blocks):
        lo, hi = b * chunk, min(total, (b + 1) * chunk)
        assert hi > lo
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert blocks <= min(sms, total)
    assert chunk <= -(-total // min(sms, total))


# ---- on the card: the patch encoder (K11, K12) and the decoder at arbitrary
# coordinates (K9, K10) against their plain versions ----
#
# Same reasoning as above: the outputs within K1's 5e-3 (K11) and K7's 1e-2
# (K9) absolute, a saved bf16 h1 within one bf16 step, K12's gradients within
# 1e-3 relative L2, reruns bitwise equal. K10 recomputes its forward, as the
# TPU kernel does, so unlike K8 it does not share the h tiles with the plain
# version: where an f32 sum lands near a bf16 rounding boundary the two h
# sit one step (2^-8) apart and a leaky slope near zero may flip. At 324
# pixels an image the per-image dhz measured 1.05e-3; its bound is 5e-3.

def _lifted_inputs(ck, R=4, K=128, D=7, N=700):
    """Patches in [0, 1) as images give them; ck = 75 (C = 3, k = 5) is no
    multiple of 8 and takes the padded-column path."""
    rng = np.random.default_rng(8)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    p = torch.from_numpy(rng.uniform(size=(N, ck)).astype(np.float32))
    return (p.to(torch.bfloat16), f(ck, R * K) * 0.05, f(R * K) * 0.1,
            f(K, K) * 0.05, f(K) * 0.1, f(K, D) * 0.1, f(D) * 0.1)


# K11 at shapes covering every K, R, N, act and D, and the patch widths of
# the C = 3, k = 5 test encoder (75, no multiple of 8), the flagship (784)
# and the galaxy encoder (12,675); N = 20,000 as in FWD above
LIFTED_FWD = [(128, 4, 700, "leakyrelu", 7, 784),
              (128, 4, 700, "leakyrelu", 7, 75),
              (128, 1, 65, "tanh", 16, 12675),
              (128, 8, 20_000, "tanh", 7, 784),
              (64, 1, 700, "tanh", 7, 784), (64, 8, 1, "leakyrelu", 16, 75),
              (64, 16, 700, "tanh", 16, 784),
              (32, 4, 65, "tanh", 7, 784), (32, 16, 700, "leakyrelu", 16, 75),
              (16, 4, 700, "tanh", 7, 784),
              (16, 16, 65, "leakyrelu", 7, 12675),
              (16, 8, 1, "tanh", 16, 784),
              (16, 1, 700, "leakyrelu", 7, 12675)]


@pytest.mark.parametrize("K, R, N, act, D, ck", LIFTED_FWD)
def test_lifted_encoder_kernel_on_cuda(cuda, K, R, N, act, D, ck):
    args = [t.to(cuda) for t in _lifted_inputs(ck, R=R, K=K, D=D, N=N)]
    kernels.reset_launch_counts()
    got = lifted_encoder_fwd(*args, R=R, K=K, act_kind=act)
    got_s, h1 = lifted_encoder_fwd(*args, R=R, K=K, act_kind=act,
                                   save_h1=True)
    again = lifted_encoder_fwd(*args, R=R, K=K, act_kind=act)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["lifted_encoder_fwd"] == 3
    ref, h1_p = lifted_encoder_plain(*args, R=R, K=K, act_kind=act,
                                     save_h1=True)
    assert got.shape == ref.shape == (N, R * D)
    assert float((got - ref).abs().max()) < 5e-3
    assert torch.equal(got, got_s) and torch.equal(got, again)
    assert float((h1.float() - h1_p.float()).abs().max()) <= float(
        h1_p.float().abs().max()) / 128


# K12 at shapes covering every K, R, N, act, D and the patch widths of the
# C = 3, k = 5 test encoder (75, no multiple of 8), the flagship (784) and
# the galaxy encoder (12,675), within the wrapper's R*K % 64 == 0
LIFTED_BWD = [(128, 4, 700, "leakyrelu", 7, 784),
              (128, 4, 700, "leakyrelu", 7, 75),
              (128, 1, 65, "tanh", 16, 12675), (64, 1, 700, "tanh", 7, 784),
              (64, 8, 1, "leakyrelu", 16, 75), (32, 4, 65, "tanh", 7, 784),
              (32, 16, 700, "leakyrelu", 16, 75),
              (16, 4, 700, "tanh", 7, 784),
              (16, 16, 65, "leakyrelu", 7, 12675),
              (16, 8, 1, "tanh", 16, 784)]


@pytest.mark.parametrize("K, R, N, act, D, ck", LIFTED_BWD)
def test_lifted_encoder_backward_kernel_on_cuda(cuda, K, R, N, act, D, ck):
    p, wc, bc, w2, b2, wh, bh = (t.to(cuda) for t in _lifted_inputs(
        ck, R=R, K=K, D=D, N=N))
    _, h1 = lifted_encoder_plain(p, wc, bc, w2, b2, wh, bh, R=R, K=K,
                                 act_kind=act, save_h1=True)
    g = torch.randn(N, R * D, generator=torch.Generator().manual_seed(9)).to(cuda)
    kernels.reset_launch_counts()
    got = lifted_encoder_bwd(p, h1, w2, b2, wh, g, R=R, K=K, act_kind=act)
    again = lifted_encoder_bwd(p, h1, w2, b2, wh, g, R=R, K=K, act_kind=act)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["lifted_encoder_bwd"] == 2
    ref = lifted_encoder_bwd_plain(p, h1, w2, b2, wh, g, R=R, K=K,
                                   act_kind=act)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        assert _rel(a, b) < 1e-3, (i, _rel(a, b))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _mlp_args(cuda, n=18):
    """The decoder's inputs at three images' posed n x n grids."""
    cfg = _pose_config(2)
    tp = generator_init(torch.Generator().manual_seed(0), cfg, device=cuda)
    th, d, zz = (torch.from_numpy(a).to(cuda) for a in _pose_inputs())
    x = transform_coords(torch.from_numpy(image_grid(n)).to(cuda), d, th)
    return (x.contiguous(), tp["fourier"]["w"] / cfg.fourier_sigma,
            tp["fourier"]["b"], zz @ tp["latent_linear"]["w"],
            tp["coord_linear"]["w"], tp["coord_linear"]["b"],
            torch.stack([h["w"] for h in tp["hidden"]]),
            torch.stack([h["b"] for h in tp["hidden"]]),
            tp["out"]["w"], tp["out"]["b"])


def test_decoder_mlp_kernel_on_cuda(cuda):
    args = _mlp_args(cuda)
    kernels.reset_launch_counts()
    got = decoder_mlp_fwd(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decoder_mlp_fwd"] == 1
    ref = decoder_mlp_plain(*args)
    assert got.shape == ref.shape == (3, 18 * 18, 1)
    assert float((got - ref).abs().max()) < 1e-2


def test_decoder_mlp_backward_kernel_on_cuda(cuda):
    args = _mlp_args(cuda)
    g = torch.randn(3, 18 * 18, 1,
                    generator=torch.Generator().manual_seed(10)).to(cuda)
    kernels.reset_launch_counts()
    got = decoder_mlp_bwd(*args, g)
    again = decoder_mlp_bwd(*args, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decoder_mlp_bwd"] == 2
    ref = decoder_mlp_bwd_plain(*args, g)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        assert _rel(a, b) < 5e-3, (i, _rel(a, b))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# K9's and K10's edges on the wgmma kernels, as WIDE's for the pose decoder:
# pixel counts that leave a ragged tail in the 64-pixel tile (n = 13: 169,
# n = 18: 324, n = 30: 900), each hidden width's consumer layout (64, 128:
# one warpgroup; 256, 512: two), L = 2 and 3, both activations, n_out 1 to
# 8 (the chain pass's limit), F = 64 (one feature slice; dW1 a single
# 128-row tile) and 1,024.
MLP_WIDE = [  # (layers, n, hidden, act, n_out, F)
    (2, 18, 512, "leakyrelu", 1, 1024),
    (3, 30, 256, "tanh", 3, 64),
    (3, 18, 64, "tanh", 8, 1024),
    (2, 30, 128, "leakyrelu", 8, 64),
    (2, 13, 256, "leakyrelu", 3, 1024),
    (3, 13, 512, "tanh", 1, 64),
    (2, 18, 64, "leakyrelu", 1, 64),
    (2, 30, 128, "tanh", 3, 1024),
]


def _mlp_wide_args(dev, layers, n, hidden, act, n_out, F):
    """K9's inputs for three images' posed n x n grids of a generator of
    the given widths."""
    cfg = GeneratorConfig(z_dim=2, hidden_dim=hidden, num_layers=layers,
                          n_out=n_out, activation=act, fourier_expansion=True,
                          fourier_sigma=2 / (n - 1), embedding_dim=F)
    tp = generator_init(torch.Generator().manual_seed(0), cfg, device=dev)
    th, d, zz = (torch.from_numpy(a).to(dev) for a in _pose_inputs())
    x = transform_coords(torch.from_numpy(image_grid(n)).to(dev), d, th)
    return (x.contiguous(), tp["fourier"]["w"] / cfg.fourier_sigma,
            tp["fourier"]["b"], zz @ tp["latent_linear"]["w"],
            tp["coord_linear"]["w"], tp["coord_linear"]["b"],
            torch.stack([h["w"] for h in tp["hidden"]]),
            torch.stack([h["b"] for h in tp["hidden"]]),
            tp["out"]["w"], tp["out"]["b"])


# the forward forms the heads 16 at a time, so it takes any n_out (17: two
# chunks)
@pytest.mark.parametrize("layers, n, hidden, act, n_out, F",
                         MLP_WIDE + [(2, 18, 128, "leakyrelu", 11, 64),
                                     (3, 13, 512, "tanh", 17, 1024)])
def test_decoder_mlp_kernel_shapes_on_cuda(cuda, layers, n, hidden, act,
                                           n_out, F):
    """K9 against its plain version (1e-2 absolute, as K7), its saved h
    tiles within one bf16 step of the largest magnitude, saving leaving
    the output bitwise as serving gives it, reruns bitwise equal."""
    args = _mlp_wide_args(cuda, layers, n, hidden, act, n_out, F)
    got = decoder_mlp_fwd(*args, act_kind=act)
    again = decoder_mlp_fwd(*args, act_kind=act)
    y, hs = decoder_mlp_fwd(*args, act_kind=act, save_res=True)
    ref, hs_p = decoder_mlp_plain(*args, act_kind=act, save_res=True)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (3, n * n, n_out)
    assert float((got - ref).abs().max()) < 1e-2
    assert torch.equal(got, again) and torch.equal(y, got)
    assert float((hs.float() - hs_p.float()).abs().max()) <= float(
        hs_p.float().abs().max()) / 128


@pytest.mark.parametrize("layers, n, hidden, act, n_out, F", MLP_WIDE)
def test_decoder_mlp_backward_kernel_shapes_on_cuda(cuda, layers, n, hidden,
                                                    act, n_out, F):
    """K10 against its plain version, 5e-3 relative L2 per output
    (chip_smoke.py's TOL_K10_REL: the recomputed h may sit one bf16 step
    from the plain one), reruns bitwise equal."""
    args = _mlp_wide_args(cuda, layers, n, hidden, act, n_out, F)
    g = torch.randn((3, n * n, n_out),
                    generator=torch.Generator().manual_seed(7)).to(cuda)
    got = decoder_mlp_bwd(*args, g, act_kind=act)
    again = decoder_mlp_bwd(*args, g, act_kind=act)
    ref = decoder_mlp_bwd_plain(*args, g, act_kind=act)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        assert _rel(a, b) < 5e-3, (i, _rel(a, b))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# ---- the grid-sharded posterior partials (K5, K6) ----
#
# On the card against their plain versions. As K3/K4: the same float32
# formulas summed in another order, so 1e-4 per unit of max(1, |value|),
# and each per-cell cotangent within 1e-2 of its own magnitude
# (_scaled_err); reruns bitwise equal; a -1e30 pad gets exactly zero d_q,
# theta and z gradients (and so a zero d_attn).

@pytest.mark.parametrize("c", [1, 7, 1000, 1536, 1537, 5000, 6144, 12289,
                               30000])
def test_shard_schedule_covers_each_cell_once(c):
    """K5/K6's grid: every cell of the shard in exactly one CTA's chunk, the
    chunks multiples of 4 (16-byte loads), at most SHARD_CELLS cells while
    a cluster of 16 holds the shard, the grid a function of the shard's
    cells alone (the flagship's two-rank shard: 4 CTAs of 1,536)."""
    cs, chunk = shard_schedule(c)
    assert cs in (1, 2, 4, 8, 16) and chunk % 4 == 0
    assert (cs - 1) * chunk < c <= cs * chunk
    assert chunk <= SHARD_CELLS or cs == 16
    if c == 6144:
        assert (cs, chunk) == (4, 1536)
    if c == 12289:
        assert (cs, chunk) == (16, 772)


def _shard_case(noise: bool, pad: int, B=3, C=1000, zd=2, seed=11):
    """One shard (C cells) of a 2C-cell grid whose normalisers are computed
    over the whole grid; its last `pad` cells are -1e30 pads. Returns the
    JAX package's arguments (norms, attn, noise, th, z, p, gx, gy, offs)
    and a cotangent g."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    attn = f(B, 2 * C) * 2
    attn[:, C - pad:C] = -1e30
    g_noise = (-torch.log(-torch.log(torch.from_numpy(rng.uniform(
        1e-6, 1 - 1e-6, (B, 2 * C)).astype(np.float32))))
               if noise else torch.zeros(B, 2 * C))
    lse = lambda x: [x.amax(1, keepdim=True), torch.log(torch.exp(
        x - x.amax(1, keepdim=True)).sum(1, keepdim=True))]
    norms = torch.cat(lse(attn) + lse(attn + g_noise), dim=1)
    p = torch.log_softmax(f(C), dim=0)
    p[C - pad:] = -1e30
    return [norms, attn[:, :C].contiguous(), g_noise[:, :C].contiguous(),
            f(B, 2, C) * 0.5, f(B, 2, zd, C) * 0.5, p, f(C), f(C),
            f(C) * 0.3], f(B, 2 * zd + 5)


def _close_per_unit(a, b):
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def _check_shard_kernels(args, g, sig_r, pad=0):
    """K5 and K6 (through posterior_shard_partials) against their plain
    versions; reruns bitwise; the pads exactly 0."""
    kw = {"sig_r": sig_r, "zd": args[4].shape[2]}
    kernels.reset_launch_counts()
    out = posterior_shard_partials(*args, **kw)
    grads = posterior_shard_partials(*args, want_grads=True, g=g, **kw)
    again = posterior_shard_partials(*args, want_grads=True, g=g, **kw)
    out2 = posterior_shard_partials(*args, **kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["posterior_shard_fwd"] == 2
    assert counts["posterior_shard_bwd"] == 2
    assert _close_per_unit(out, posterior_shard_plain(*args, sig_r)) < 1e-4
    assert torch.equal(out, out2)
    ref = posterior_shard_bwd_plain(*args, sig_r, g)
    for a, b in zip(grads, ref):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert _close_per_unit(a, b) < 1e-4
    for a, b in zip(grads[:4], ref[:4]):
        assert _scaled_err(a, b, (-1,)) < 1e-2
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    if pad:
        dead = slice(args[1].shape[1] - pad, None)
        for t in grads[1:4]:
            assert not bool(t[..., dead].any())


@pytest.mark.parametrize("noise, pad", [(False, 0), (True, 0), (True, 300)])
def test_posterior_shard_kernels_on_cuda(cuda, noise, pad):
    args, g = _shard_case(noise, pad)
    _check_shard_kernels([t.to(cuda) for t in args], g.to(cuda),
                         float(np.pi / 8), pad)


# (B, C, zd, pad, unaligned): the flagship's two-rank shard, first and
# padded last (zd 2, 8 and 10: K5/K6 take any z_dim, past 8 at run time);
# clusters of 1 (C = 1,000), 2 (1,537), 8 (7,000) and 16 CTAs (12,289,
# past the portable 8); C = 5,000, 1,537 and 12,289, no multiple of the
# CTA's chunk (1,252; 772; 772); C = 1,001 no multiple of 4 (cell by
# cell); planes whose rows are not 16-byte aligned (cell by cell)
SHARD_SHAPES = [(100, 6144, 2, 0, False), (100, 6144, 2, 120, False),
                (100, 6144, 8, 120, False), (100, 6144, 10, 120, False),
                (5, 5000, 2, 300, False), (3, 1537, 10, 0, False),
                (4, 7000, 2, 100, False), (4, 12289, 2, 100, False),
                (3, 1001, 3, 200, False), (3, 1000, 9, 0, True)]


@pytest.mark.parametrize("B, C, zd, pad, unaligned", SHARD_SHAPES)
def test_posterior_shard_kernels_over_shapes_on_cuda(cuda, B, C, zd, pad,
                                                     unaligned):
    args, g = _shard_case(True, pad, B=B, C=C, zd=zd, seed=12)
    args = [t.to(cuda) for t in args]
    if unaligned:
        # the planes as a view into a buffer whose rows start one float in
        planes = pack_planes(args[1], args[3], args[4])
        buf = torch.zeros((B, planes.shape[1], C + 1), device=cuda)
        buf[..., 1:] = planes
        view = buf[..., 1:]
        out = posterior_shard_fwd(args[0], view, *args[2:3], *args[5:],
                                  float(np.pi / 4))
        ref = posterior_shard_plain(*args, float(np.pi / 4))
        assert _close_per_unit(out, ref) < 1e-4
    _check_shard_kernels(args, g.to(cuda), float(np.pi / 4), pad)


def test_posterior_shard_rows_do_not_depend_on_the_batch_on_cuda(cuda):
    """B = 100 at the flagship's shard equals two calls of 50, row for row,
    bitwise: the grid is one cluster an image."""
    args, g = _shard_case(True, 120, B=100, C=6144, zd=2, seed=14)
    args = [t.to(cuda) for t in args]
    g = g.to(cuda)
    kw = {"sig_r": float(np.pi / 8), "zd": 2}
    whole = posterior_shard_partials(*args, **kw)
    whole_b = posterior_shard_partials(*args, want_grads=True, g=g, **kw)
    for half in (slice(0, 50), slice(50, 100)):
        part = [a[half] if a.dim() > 1 else a for a in args]
        assert torch.equal(posterior_shard_partials(*part, **kw), whole[half])
        got = posterior_shard_partials(*part, want_grads=True, g=g[half],
                                       **kw)
        assert all(torch.equal(a, b[half]) for a, b in zip(got, whole_b))


@pytest.mark.parametrize("hidden", [128, 512])
def test_decoder_mlp_far_phases_on_cuda(cuda, hidden):
    """K9 and K10 where many phases lie past the kernels' straight-line
    cosine (|phase| > 105,615, the coordinates scaled up): those features
    and sines come from the library's functions, so the kernels still agree
    with their plain versions (1e-2 absolute forward, 5e-3 relative L2 per
    output backward) and reruns are bitwise equal. Hidden 512 takes dW1's
    shared-A tiles, whose consumers build part of each tile."""
    args = list(_mlp_wide_args(cuda, 2, 18, hidden, "leakyrelu", 3, 1024))
    args[0] = args[0] * 3e4
    from targetvae_tpu_torch.kernels.decoder_mlp import _phase
    assert float((_phase(*args[:3]).abs() > 105_615).float().mean()) > 0.1
    got = decoder_mlp_fwd(*args)
    ref = decoder_mlp_plain(*args)
    assert float((got - ref).abs().max()) < 1e-2
    g = torch.randn((3, 18 * 18, 3),
                    generator=torch.Generator().manual_seed(8)).to(cuda)
    got = decoder_mlp_bwd(*args, g)
    again = decoder_mlp_bwd(*args, g)
    ref = decoder_mlp_bwd_plain(*args, g)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, ref)):
        assert _rel(a, b) < 5e-3, (i, _rel(a, b))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
