"""Move parameters between the JAX package's pytree and this package.

Both packages keep one layout: linear weights (n_in, n_out) for x @ w, the
group-conv weight (out, in, rot_in, k, k), the Fourier buffers (2, F) and
(F,), hidden layers as a list. So the conversion is array by array:
params_from_jax takes TargetVAE.init's pytree with numpy leaves
(e.g. jax.tree.map(np.asarray, params)) and returns the nested dict of float32
tensors that TargetVAE.load_params and every apply function take;
params_to_jax is its inverse, with numpy leaves that are copies: a later
in-place update of the parameters (Adam's) does not reach them.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device=None):
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)


def params_to_jax(tree):
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_jax(v) for v in tree]
    return tree.detach().to("cpu", copy=True).numpy()
