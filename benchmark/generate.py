"""The benchmark's one generator: a cell's inputs and weights from its seed.

Everything is drawn on the run's device from one torch.Generator there, in a
few large calls, so that one seed gives the same inputs on every run of a
cell. The sizes come from the configuration's and the traffic mix's files;
the seed changes the values and the order, never the amount of work.

- images: "shapes" (the MNIST-U stand-in of the repo's
  tools/make_synthetic_shapes.py: one of seven 28 x 28 stamps, thickened at
  random, rotated uniformly and shifted up to max_shift pixels on the
  canvas, at uint8 levels in [0, 1]); "particles" (the EMPIAR-10025
  stand-in of tools/make_synthetic_particles_torch.py: three classes of
  Gaussian-blob densities posed the same way, filtered by each particle's
  CTF, white noise at the given SNR, each image standardised);
- the CTF table: one row a micrograph (defocus uniform in the configured
  range), and each particle's micrograph;
- the weights, in the port's parameter layout, at the reference's init
  bounds (torch's nn.Linear / nn.Conv2d defaults), and the Fourier
  features.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .reference.ctf import ctf_kernels

# the seed is any whole number up to a little over 2**31; torch's
# generators take any 64-bit value
SEED_MOD = 2 ** 63


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` for one stream of draws of the run."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + stream) % SEED_MOD)


def _uniform(g, n, device) -> torch.Tensor:
    return torch.rand(n, generator=g, device=device)


# ------------------------------------------------------------------ shapes

def shape_stamps() -> np.ndarray:
    """The seven 28 x 28 stamps of make_synthetic_shapes.py, 0 or 255."""
    out = np.zeros((7, 28, 28), np.float32)
    c = 14
    yy, xx = np.mgrid[:28, :28]
    out[0, c - 6:c + 6, c - 6:c + 6] = 1                       # square
    out[1, c - 9:c + 9, c - 2:c + 2] = 1                       # cross
    out[1, c - 2:c + 2, c - 9:c + 9] = 1
    r = np.sqrt((yy - c) ** 2 + (xx - c) ** 2)
    out[2][(r > 5) & (r < 9)] = 1                              # ring
    out[3, c - 9:c + 9, c - 7:c - 2] = 1                       # L
    out[3, c + 4:c + 9, c - 7:c + 8] = 1
    out[4, c - 8:c - 2, c - 8:c - 2] = 1                       # two dots
    out[4, c + 2:c + 8, c + 2:c + 8] = 1
    for i in range(12):                                        # triangle
        out[5, c - 6 + i, c - i // 2 - 1:c + i // 2 + 1] = 1
    out[6, c - 2:c + 2, c - 10:c + 10] = 1                     # bar
    return out * 255.0


def _pose(canvas: torch.Tensor, theta: torch.Tensor, shift: torch.Tensor
          ) -> torch.Tensor:
    """Each canvas (N, 1, d, d) rotated by theta about its centre, then
    shifted by shift (x right, y up; pixels), bilinear with zeros outside:
    ndimage.rotate(order=1) then ndimage.shift's motion, as one resampling
    in which an output point samples R(-theta) (point - shift)."""
    n, _, d, _ = canvas.shape
    c, s = torch.cos(theta), torch.sin(theta)
    # in affine_grid's units: x right, y down, the canvas spanning [-1, 1]
    sx, sy = shift[:, 0] * (2.0 / d), -shift[:, 1] * (2.0 / d)
    mat = torch.stack([torch.stack([c, s, -(c * sx + s * sy)], 1),
                       torch.stack([-s, c, -(-s * sx + c * sy)], 1)], 1)
    grid = F.affine_grid(mat, (n, 1, d, d), align_corners=False)
    return F.grid_sample(canvas, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def shapes(n: int, d: int, classes: int, max_shift: float, seed: int,
           device) -> torch.Tensor:
    """(n, d, d, 1) float32 posed shapes in [0, 1] at uint8 levels (on a
    canvas under 50 pixels the stamps shrink in proportion)."""
    g = generator(seed, device, stream=1)
    stamps = torch.as_tensor(shape_stamps()[:classes], device=device)
    k = min(28, d * 28 // 50)         # the stamp's share of a 50 canvas
    if k < 28:
        stamps = F.interpolate(stamps[:, None], size=(k, k), mode="area")[:, 0]
    thick = F.max_pool2d(F.pad(stamps[:, None], (0, 1, 0, 1)), 2, stride=1)
    u = _uniform(g, (n, 5), device)
    label = (u[:, 0] * classes).long().clamp_max(classes - 1)
    stamp = torch.where((u[:, 1] < 0.5)[:, None, None],
                        thick[label, 0], stamps[label])
    theta = (u[:, 2] * 2 - 1) * math.pi
    shift = (u[:, 3:5] * 2 - 1) * max_shift
    off = (d - k) // 2
    out = torch.empty((n, d, d, 1), device=device)
    for i in range(0, n, 2048):
        j = slice(i, min(i + 2048, n))
        canvas = torch.zeros((j.stop - j.start, 1, d, d), device=device)
        canvas[:, 0, off:off + k, off:off + k] = stamp[j]
        posed = _pose(canvas, theta[j], shift[j])
        out[j] = (posed.clamp(0, 255).round() / 255.0).permute(0, 2, 3, 1)
    return out


# --------------------------------------------------------------- particles

def _blob_layouts(g, n: int, classes: int, device):
    """(n, 7, 4) blob placements (cy, cx, sigma, amp; amp 0 pads) of
    make_synthetic_particles_torch.py's three classes, jittered."""
    base = torch.zeros((3, 7, 4), device=device)
    base[0, :4] = torch.tensor([[-20, 0, 13.0, 1.0], [22, 0, 8.0, 0.75],
                                [0, 1, 5.5, 0.55], [8, 16, 6.0, 0.6]])
    for k in range(3):
        a = 2 * math.pi * k / 3
        base[1, k] = torch.tensor([24 * math.cos(a), 24 * math.sin(a),
                                   10.0, 0.9])
    base[1, 3] = torch.tensor([0, 0, 6.0, 0.5])
    for k in range(6):
        a = 2 * math.pi * k / 6
        base[2, k] = torch.tensor([26 * math.cos(a), 26 * math.sin(a),
                                   7.0, 0.8])
    base[2, 6] = torch.tensor([0, 0, 9.0, 0.7])
    jit_pos = torch.tensor([1.5, 1.5, 1.2], device=device)       # a class
    jit_amp = torch.tensor([0.05, 0.05, 0.04], device=device)
    label = (_uniform(g, n, device) * classes).long().clamp_max(classes - 1)
    noise = torch.randn((n, 7, 3), generator=g, device=device)
    blobs = base[label].clone()
    blobs[..., :2] += noise[..., :2] * jit_pos[label][:, None, None]
    blobs[..., 3] = torch.where(blobs[..., 3] > 0, blobs[..., 3]
                                + noise[..., 2] * jit_amp[label][:, None], 0)
    return blobs


def correlate_fft(images: torch.Tensor, kernels: torch.Tensor
                  ) -> torch.Tensor:
    """'same' correlation of each image (N, d, d) with its own kernel (N, k,
    k), k odd, by zero-padded FFT in float64."""
    d, k = images.shape[-1], kernels.shape[-1]
    s = (d + k - 1,) * 2
    out = torch.fft.irfft2(
        torch.fft.rfft2(images.double(), s=s)
        * torch.fft.rfft2(kernels.double().flip(-2, -1), s=s), s=s)
    p = k // 2
    return out[:, p:p + d, p:p + d].float()


def particles(n: int, d: int, data: dict, seed: int, device):
    """(images (n, d, d, 1) float32, micrograph (n,) long, table): posed,
    CTF-filtered, noisy, standardised particles; `table` holds the CTF rows
    of the micrographs (parse_ctf's columns)."""
    g = generator(seed, device, stream=2)
    ctf = data["ctf"]
    m = data["micrographs"]
    lo, hi = ctf["defocus_um"]
    defocus = lo + (hi - lo) * _uniform(g, m, device).double()
    full = lambda v: torch.full((m,), float(v), dtype=torch.float64,
                                device=device)
    table = {"defocus": defocus, "cs": full(ctf["cs_mm"]),
             "voltage": full(ctf["voltage_kv"]), "apix": full(ctf["apix"]),
             "bfactor": full(ctf["bfactor"]),
             "ampcont": full(ctf["ampcont_pct"]), "dfdiff": full(0.0),
             "dfang": full(0.0)}
    k = d - 1 if d % 2 == 0 else d
    kernels = ctf_kernels(table, k, device)
    micrograph = (_uniform(g, n, device) * m).long().clamp_max(m - 1)
    blobs = _blob_layouts(g, n, data["classes"], device)
    u = _uniform(g, (n, 3), device)
    theta = (u[:, 0] * 2 - 1) * math.pi
    shift = (u[:, 1:3] * 2 - 1) * data["max_shift"]
    noise_g = generator(seed, device, stream=3)
    yy, xx = torch.meshgrid(torch.arange(d, device=device, dtype=torch.float32),
                            torch.arange(d, device=device, dtype=torch.float32),
                            indexing="ij")
    c0 = (d - 1) / 2.0
    out = torch.empty((n, d, d, 1), device=device)
    for i in range(0, n, 256):
        j = slice(i, min(i + 256, n))
        b = blobs[j]
        ct, st = torch.cos(theta[j])[:, None], torch.sin(theta[j])[:, None]
        ry = ct * b[..., 0] - st * b[..., 1] + c0 + shift[j, 1:2]
        rx = st * b[..., 0] + ct * b[..., 1] + c0 + shift[j, 0:1]
        sig2 = 2.0 * b[..., 2] ** 2
        dist = ((yy - ry[..., None, None]) ** 2
                + (xx - rx[..., None, None]) ** 2)
        clean = (b[..., 3, None, None] * torch.exp(-dist
                                                   / sig2[..., None, None])
                 ).sum(1)
        sig = correlate_fft(clean, kernels[micrograph[j]])
        pw = sig.var(dim=(1, 2), keepdim=True)
        img = sig + torch.randn(sig.shape, generator=noise_g, device=device
                                ) * torch.sqrt(pw / data["snr"])
        img = (img - img.mean(dim=(1, 2), keepdim=True)) / img.std(
            dim=(1, 2), keepdim=True, correction=0)
        out[j] = img[..., None]
    return out, micrograph, table


def images(config: dict, n: int, seed: int, device):
    """The configuration's images: (images, micrograph or None, table or
    None)."""
    data = config["data"]
    d = config["model"]["encoder"]["image_dim"]
    if data["kind"] == "shapes":
        return (shapes(n, d, data["classes"], data["max_shift"], seed,
                       device), None, None)
    if data["kind"] == "particles":
        return particles(n, d, data, seed, device)
    raise ValueError(f"unknown data kind {data['kind']!r}")


# ----------------------------------------------------------------- weights

def _leaves(model: dict):
    """[(path, shape, bound)] of the uniform draws, in a fixed order, and
    the Fourier features' shapes."""
    enc, gen = model["encoder"], model["generator"]
    K, C, k, zd = (enc["kernels_num"], enc["in_channels"],
                   enc["kernels_size"], enc["z_dim"])
    H, E = gen["hidden_dim"], gen["embedding_dim"]
    b_lift, b_k = 1 / math.sqrt(C * k * k), 1 / math.sqrt(K)
    out = [(("encoder", "conv1", "w"), (K, C, 1, k, k), b_lift),
           (("encoder", "conv1", "b"), (K,), b_lift)]
    for name, width in [("conv2", K), ("conv_a", 1), ("conv_r", 2),
                        ("conv_z", 2 * zd)]:
        out += [(("encoder", name, "w"), (K, width), b_k),
                (("encoder", name, "b"), (width,), b_k)]
    b_e, b_h = 1 / math.sqrt(E), 1 / math.sqrt(H)
    out += [(("generator", "coord_linear", "w"), (E, H), b_e),
            (("generator", "coord_linear", "b"), (H,), b_e),
            (("generator", "latent_linear", "w"), (gen["z_dim"], H),
             1 / math.sqrt(gen["z_dim"]))]
    for i in range(gen["num_layers"] - 1):
        out += [(("generator", "hidden", i, "w"), (H, H), b_h),
                (("generator", "hidden", i, "b"), (H,), b_h)]
    out += [(("generator", "out", "w"), (H, gen["n_out"]), b_h),
            (("generator", "out", "b"), (gen["n_out"],), b_h)]
    return out


def _put(tree: dict, path, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def weights(model: dict, seed: int, device) -> dict:
    """The model's parameters in the port's layout (mode C, a Fourier
    generator), float32 on `device`: one uniform draw for every weight and
    bias, one normal and one uniform draw for the Fourier features."""
    if model["encoder"]["t_inf"] != "attention" or \
            model["encoder"]["r_inf"] != "attention+offsets" or \
            not model["generator"]["fourier_expansion"]:
        raise ValueError("the benchmark's cells run mode C with a Fourier "
                         "generator")
    g = generator(seed, device, stream=4)
    leaves = _leaves(model)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = _uniform(g, sum(sizes), device) * 2 - 1
    tree: dict = {"encoder": {}, "generator": {}}
    for (path, shape, bound), part in zip(leaves, flat.split(sizes)):
        _put(tree, path, (part * bound).reshape(shape))
    E = model["generator"]["embedding_dim"]
    tree["generator"]["fourier"] = {
        "w": torch.randn((2, E), generator=g, device=device),
        "b": _uniform(g, E, device) * (2 * math.pi)}
    return tree


def clone(tree):
    """A deep copy of a parameter tree (the program updates its own in
    place)."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.detach().clone()
