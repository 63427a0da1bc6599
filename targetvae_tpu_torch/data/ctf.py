"""Contrast-transfer-function synthesis for cryo-EM particles (mirror of
targetvae_tpu/data/ctf.py, numpy only: no pandas).

Same physics as reference src/ctf.py:6-55 (astigmatic defocus, phase
gamma = 2*pi*(-df*lam*s^2/2 + cs*lam^3*s^4/4), amplitude-contrast mixing,
optional B-factor envelope), vectorised over the particles: all N are
evaluated in one broadcast expression and one batched ifft2.

parse_ctf returns the eight columns as a dict of float64 arrays where the
JAX package returns a DataFrame; ctf_filter reads its parameters by column
name, from such a dict or from anything indexed the same way.
"""

from __future__ import annotations

import numpy as np

CTF_COLUMNS = ["defocus", "cs", "voltage", "apix", "bfactor", "ampcont",
               "dfdiff", "dfang"]


def parse_ctf(path) -> dict:
    """Whitespace-separated CTF parameter file (src/ctf.py:26-29) ->
    {column: (N,) float64} over CTF_COLUMNS."""
    table = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if table.shape[1] != len(CTF_COLUMNS):
        raise ValueError(f"{path}: {table.shape[1]} columns, expected "
                         f"{len(CTF_COLUMNS)} ({' '.join(CTF_COLUMNS)})")
    return {name: np.ascontiguousarray(table[:, i])
            for i, name in enumerate(CTF_COLUMNS)}


def compute_2d_ctf(freqs: np.ndarray, dfu, dfv, dfang, volt, cs, w,
                   bfactor=None) -> np.ndarray:
    """CTF over frequency pairs. freqs: (..., M, 2); scalar or (N,1) params,
    broadcast over a leading particle axis."""
    volt = np.asarray(volt, dtype=np.float64) * 1000.0
    cs = np.asarray(cs, dtype=np.float64) * 1e7
    lam = 12.2639 / np.sqrt(volt + 0.97845e-6 * volt ** 2)
    x = freqs[..., 0]
    y = freqs[..., 1]
    ang = np.arctan2(y, x)
    s2 = x ** 2 + y ** 2
    df = 0.5 * (dfu + dfv + (dfu - dfv) * np.cos(2 * (ang - dfang)))
    gamma = 2 * np.pi * (-0.5 * df * lam * s2 + 0.25 * cs * lam ** 3 * s2 ** 2)
    ctf = np.sqrt(1 - w ** 2) * np.sin(gamma) - w * np.cos(gamma)
    if bfactor is not None:
        ctf = ctf * np.exp(-np.asarray(bfactor, dtype=np.float64) / 4 * s2)
    return ctf.astype(freqs.dtype)


def ctf_filter(ctf_params, n: int, m: int, scale: float = 1.0) -> np.ndarray:
    """Real-space CTF kernels (N, n, m) = -fftshift(ifft2(CTF)).real, the
    per-particle convolution kernels of the Gaussian likelihood
    (train_particles.py:298-302). ctf_params: parse_ctf's columns.

    As the JAX package's, the defocus is dfu in both axes (dfdiff is read
    by no one), and a CTF is even in frequency, so every kernel is
    symmetric under a half turn about its centre."""
    col = lambda name: np.asarray(ctf_params[name], dtype=np.float64)
    theta = np.fft.fftfreq(n)
    gamma = np.fft.fftfreq(m)
    tg, gg = np.meshgrid(theta, gamma, indexing="ij")
    freqs = np.stack([tg.ravel(), gg.ravel()], axis=1)  # float64: the CTF
    # phase is evaluated in double precision (a float32 phase moves the
    # kernels by ~1e-3 relative)

    apix = (col("apix") * scale)[:, None]                             # (N,1)
    f = freqs[None] / apix[..., None]                                 # (N, nm, 2)
    dfu = (col("defocus") * 10000.0)[:, None]
    dfang = (2 * np.pi * col("dfang") / 360.0)[:, None]
    volt = col("voltage")[:, None]
    cs = col("cs")[:, None]
    w = (col("ampcont") / 100.0)[:, None]
    bf = col("bfactor")[:, None]

    c = compute_2d_ctf(f, dfu, dfu, dfang, volt, cs, w, bf)           # (N, nm)
    c = c.reshape(-1, n, m)
    kern = -np.fft.fftshift(np.fft.ifft2(c), axes=(-2, -1)).real
    return kern.astype(np.float32)
