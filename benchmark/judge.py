"""What decides `correct`: the port's outputs held against the plain float32
reference (reference/model.py, TF32 off), number by number, each against
its limit in limits/<cell>.json. A cell compares the numbers its limits
file names; calibrate.py reads them all.

Train cells. The window's Trainer drove its first three steps on rows that
all differ, sampled as the window samples, from a host generator seeded
with the run's seed; the reference follows them from the same weights,
images and generator (reference/noise.py draws the rows' order, the Gumbel
noise and the normal noise as the epoch loop does) and works the CTF
kernels out again from the table. Read: each step's loss and its KL term;
each leaf's first gradient as Adam got it (its first moment after one step
over 1 - beta1); each leaf's change after three steps. A norm's gap is
|program's norm - reference's norm| over the larger of the reference's norm
of that leaf and of the median leaf; a leaf whose reference gradient is
under a thousandth of the median leaf's moves under Adam by round-off alone
and is left out. The numbers: loss_gap and kl_gap (worst step, relative),
grad_gap (worst leaf), update_gap (the median leaf: a small leaf's change
under Adam's sign-like first steps swings with round-off), and the norm of
the first gradients' difference over the same denominator, at the
decoder's median leaf (decoder_diff) and at its worst (decoder_worst): the
norms alone do not tell the bfloat16 program from the float8 control at
EMPIAR-10025, the encoder's first gradients are cancellations that swing on
both sides from seed to seed, and half a batch left out moves the
flagship's decoder gradient at its worst leaf only (PERF.md).

Embed cells. Every request of the window embedded the configuration's
whole stack; every answer of every request is judged. For each image the
reference computes the heads of every cell once; the program's answer
(z_content, theta at its most probable cell) is matched to the cell whose
reference values it is nearest (the max-norm gap of z_content plus
theta's), and judged there: cell_gap (how far that cell's attention logit
lies below the reference's best), z_gap (z_content's gap there, over the
stack's median z_content size), theta_gap (radians) and dx_gap (the
expected translation, in pixels), each the worst answer's.

The control: the same reference computed as float8 training computes
(Fp8: every product's and convolution's operands in e4m3, its incoming
gradient in e5m2, per-tensor scales), the precision below the
configuration's bfloat16, in the program's place; it has to fail one of a
cell's numbers (calibrate.py reads it).
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from .reference import model as ref
from .reference import noise as ref_noise
from .reference.ctf import ctf_kernels

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def _round8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to an 8-bit float at a per-tensor scale (its largest
    magnitude to the format's largest)."""
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8Grad(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to e5m2 backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """x's value rounded to e4m3, its gradient passed straight through."""
    return x + (_round8(x.detach(), torch.float8_e4m3fn) - x.detach())


class Fp8:
    """Products and convolutions as float8 training computes them (the
    precision below the configuration's bfloat16): both operands rounded to
    e4m3, the product's incoming gradient to e5m2, each at a per-tensor
    scale, the arithmetic in float32."""

    @staticmethod
    def mm(a, b):
        return _Fp8Grad.apply(_e4m3(a) @ _e4m3(b))

    @staticmethod
    def conv(x, w, padding):
        return _Fp8Grad.apply(torch.nn.functional.conv2d(
            _e4m3(x), _e4m3(w), padding=padding))


FP8 = Fp8()


def exact_float32() -> None:
    """float32 matrix products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def leaves(params: dict) -> dict:
    """{dotted path: tensor} of the trained leaves (the Fourier features
    are fixed)."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k != "fourier":
                    walk(f"{prefix}{k}.", v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = node
    walk("", params)
    return out


def to_device(tree, device):
    """A copy of a parameter tree on `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.detach().to(device, copy=True)


# ------------------------------------------------------------------ train

def reference_ctf(table, micrograph, k, device):
    """Each particle's CTF kernel, worked out again from the table."""
    if table is None:
        return None
    return ctf_kernels({c: table[c] for c in table}, k, device)[micrograph]


def reference_steps(params: dict, model: dict, batches, lr: float,
                    noise_seed=None, prec=ref.EXACT,
                    drop_half: bool = False) -> dict:
    """Adam steps of the reference over `batches` [(y, ctf)], each step one
    epoch of the port's loop over that batch, sampled from a host generator
    seeded noise_seed (None: no noise): each step's loss and KL term, the
    first step's gradient a leaf (its norm, and the tensor on the host),
    each leaf's change's norm. With drop_half each step sees the first half
    of its batch only (a planted fault, for the limits)."""
    params = to_device(params, batches[0][0].device)
    named = leaves(params)
    for t in named.values():
        t.requires_grad_(True)
    start = {k: v.detach().clone() for k, v in named.items()}
    m = {k: torch.zeros_like(v) for k, v in named.items()}
    v2 = {k: torch.zeros_like(v) for k, v in named.items()}
    gen = (None if noise_seed is None
           else torch.Generator().manual_seed(noise_seed))
    losses, kls, grads, first = [], [], None, None
    for t, (y, ctf) in enumerate(batches, 1):
        noise = None
        if gen is not None:
            noise = ref_noise.step_noise(gen, y.shape[0], model["encoder"],
                                         y.device)
            y = y[noise["perm"]]
            ctf = None if ctf is None else ctf[noise["perm"]]
        if drop_half:
            h = y.shape[0] // 2
            y, ctf = y[:h], None if ctf is None else ctf[:h]
            noise = None if noise is None else ref_noise.rows(noise, h)
        elbo, _, kl = ref.elbo(params, model, y, ctf, prec, noise)
        g = torch.autograd.grad(-elbo, list(named.values()))
        losses.append(-float(elbo.detach()))
        kls.append(float(kl.detach()))
        if t == 1:
            grads = {k: float(gi.norm()) for k, gi in zip(named, g)}
            first = {k: gi.detach().cpu() for k, gi in zip(named, g)}
        with torch.no_grad():
            for (k, p), gi in zip(named.items(), g):
                m[k].mul_(BETA1).add_(gi, alpha=1 - BETA1)
                v2[k].mul_(BETA2).addcmul_(gi, gi, value=1 - BETA2)
                mh = m[k] / (1 - BETA1 ** t)
                vh = v2[k] / (1 - BETA2 ** t)
                p.sub_(lr * mh / (vh.sqrt() + EPS))
    return {"losses": losses, "kls": kls, "grads": grads, "first": first,
            "updates": {k: float((p.detach() - start[k]).norm())
                        for k, p in named.items()}}


def leaf_gaps(prog: dict, refd: dict) -> dict:
    """{reading: {leaf: gap}} for the leaves whose reference gradient is at
    least 1e-3 of the median leaf's (the rest move under Adam by round-off
    alone): "grads" and "updates", |program's norm - reference's| over the
    larger of the reference's norm of that leaf and of the median leaf's;
    "first", the norm of the first gradients' difference over the same."""
    med_g = statistics.median(refd["grads"].values())
    keep = [k for k, g in refd["grads"].items() if g >= 1e-3 * med_g]
    out = {}
    for reading in ("grads", "updates"):
        med = statistics.median(refd[reading][k] for k in keep)
        out[reading] = {k: abs(prog[reading][k] - refd[reading][k])
                        / max(refd[reading][k], med) for k in keep}
    med = statistics.median(refd["grads"][k] for k in keep)
    out["first"] = {k: float((prog["first"][k] - refd["first"][k]).norm())
                    / max(refd["grads"][k], med) for k in keep}
    return out


def train_numbers(prog: dict, refd: dict) -> dict:
    """The train cell's numbers, the program's readings against the
    reference's (both as reference_steps returns them): loss_gap and
    kl_gap, the worst step's relative gap of the loss and of its KL term;
    grad_gap, the worst leaf's gap of the first gradient's norm;
    update_gap, the median leaf's gap of the change after the steps;
    decoder_diff and decoder_worst, the first-gradient difference at the
    decoder's median and worst leaf."""
    gaps = leaf_gaps(prog, refd)
    decoder = [v for k, v in gaps["first"].items()
               if k.startswith("generator.")]
    worst_step = lambda a, b: max(abs(p - r) / abs(r) for p, r in zip(a, b))
    return {"loss_gap": worst_step(prog["losses"], refd["losses"]),
            "kl_gap": worst_step(prog["kls"], refd["kls"]),
            "grad_gap": max(gaps["grads"].values()),
            "update_gap": statistics.median(gaps["updates"].values()),
            "decoder_diff": statistics.median(decoder),
            "decoder_worst": max(decoder)}


# ------------------------------------------------------------------ embed

def reference_answers(params: dict, enc: dict, images: np.ndarray, device,
                      prec=ref.EXACT, block: int = 100):
    """The reference's embedding of images (N, n, n, 1), in blocks: (z
    (N, 2 zd), theta (N, 1), dx (N, 2)) as numpy."""
    params = to_device(params, device)
    out = []
    with torch.no_grad():
        for i in range(0, len(images), block):
            y = torch.as_tensor(images[i:i + block], device=device)
            out.append([a.cpu().numpy() for a in
                        ref.embed(params, enc, y, prec)[:3]])
    return tuple(np.concatenate(parts) for parts in zip(*out))


def embed_numbers(params: dict, enc: dict, images: np.ndarray, answers,
                  device, block: int = 100) -> dict:
    """The embed cell's numbers for the answers to images (N, n, n, 1): a
    list of (z (N, 2 zd), theta (N, 1), dx (N, 2)), one a request of the
    whole stack, all judged against one reference pass run in blocks. An
    answer's cell is the one whose reference (z_content, theta) lies
    nearest it (the max-norm gap of z_content plus theta's)."""
    params = to_device(params, device)
    zd, pitch = enc["z_dim"], 2.0 / (enc["image_dim"] - 1)
    cols = {k: [] for k in ("cell", "z", "theta", "dx", "size")}
    with torch.no_grad():
        for i in range(0, len(images), block):
            y = torch.as_tensor(images[i:i + block], device=device)
            z_r, _, dx_r, c = ref.embed(params, enc, y)
            b = y.shape[0]
            zc = torch.cat([c["z_mu"], c["z_logstd"].exp()], -1
                           ).reshape(b, -1, 2 * zd)
            th_c = c["theta_mu"].reshape(b, -1)
            attn = c["attn"].reshape(b, -1)
            rows = torch.arange(b, device=device)
            cols["size"].append(z_r.abs().amax(1))
            for answer in answers:
                z, th, dx = (torch.as_tensor(
                    np.asarray(a[i:i + block], np.float32), device=device)
                    for a in answer)
                err_z = (z[:, None] - zc).abs().amax(-1)          # (b, C)
                err_t = (th.reshape(b, 1) - th_c).abs()
                best = (err_z + err_t).argmin(1)
                cols["cell"].append(attn.amax(1) - attn[rows, best])
                cols["z"].append(err_z[rows, best])
                cols["theta"].append(err_t[rows, best])
                cols["dx"].append((dx - dx_r).abs().amax(1) / pitch)
    col = {k: torch.cat(v) for k, v in cols.items()}
    s_z = float(col["size"].median())
    return {"cell_gap": float(col["cell"].max()),
            "z_gap": float(col["z"].max()) / s_z,
            "theta_gap": float(col["theta"].max()),
            "dx_gap": float(col["dx"].max())}


# ----------------------------------------------------------------- verdict

def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: each finite and at most its limit. A limit on a number
    the judge does not read fails; a number read without a limit is not
    compared (calibrate.py reads it)."""
    checks = {k: {"value": numbers.get(k, math.nan),
                  "limit": entry["limit"]} for k, entry in limits.items()}
    ok = bool(checks) and all(math.isfinite(c["value"])
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
