"""Read the reference's pickled-module checkpoints (mirror of
targetvae_tpu/utils/torch_import.py).

The PyTorch reference saves whole pickled modules, `torch.save(model)` of
`generator.sav` and `inference.sav` (reference src/utils.py:37-48), and
its clustering CLIs `torch.load` them. This module turns such files into
(config, params): the config this package's dataclasses hold, the params in
the JAX package's pytree layout with numpy leaves, as
train/checkpoint.py::load_checkpoint returns them
(utils/jax_params.py::params_from_jax makes them tensors).

The reference's classes are never imported. The unpickler resolves every
class of `src.models`, `models` and `src.utils` to a synthetic nn.Module
subclass, whether or not a module of that name is importable or already in
sys.modules, and registers no module: pickle restores each module's
parameters, buffers, submodules and plain attributes through
nn.Module.__setstate__ without running reference code, and the
hyperparameters the reference keeps as attributes (src/models.py:276-344)
give the exact Encoder/GeneratorConfig. A pickle can still run code of any
module it names: read only files from a source you trust, as the
reference's own torch.load does.

Weight layout (models/encoders.py::encoder_init,
models/generator.py::generator_init):
- nn.Linear and 1x1(x1) convs -> {"w": (in, out), "b": (out,)}, transposed;
- the group conv's and the full Conv2d's weights stay in torch's layout;
- the RandomFourierEmbedding2d buffers -> {"w": (2, F), "b": (F,)}, and its
  float32 sigma -> GeneratorConfig.fourier_sigma as a Python float of that
  float32 (0.01 reads 0.009999999776...), as the JAX package reads it.
"""

from __future__ import annotations

import pickle
import types
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .config import EncoderConfig, GeneratorConfig, LikelihoodConfig, ModelConfig

_REF_MODULES = ("src.models", "models", "src.utils")
_placeholder_cache: dict = {}


def _placeholder_class(name: str) -> type:
    cls = _placeholder_cache.get(name)
    if cls is None:
        cls = type(name, (nn.Module,),
                   {"__module__": __name__ + "._reference_placeholders"})
        _placeholder_cache[name] = cls
    return cls


class _RefUnpickler(pickle.Unpickler):
    """Resolves the reference's classes to synthetic nn.Module subclasses."""

    def find_class(self, module, name):
        if module in _REF_MODULES:
            return _placeholder_class(name)
        return super().find_class(module, name)


def _load_torch_module(path: str):
    # torch.load takes a module-like pickle_module with Unpickler and load
    shim = types.ModuleType(__name__ + "._pickle_shim")
    shim.Unpickler = _RefUnpickler
    shim.load = lambda f, **kw: _RefUnpickler(f, **kw).load()
    return torch.load(path, map_location="cpu", pickle_module=shim,
                      weights_only=False)


def is_torch_checkpoint(path: str) -> bool:
    """True for a torch.save file (zip or legacy pickle format)."""
    with open(path, "rb") as f:
        head = f.read(2)
    return head in (b"PK", b"\x80")


# ---- weight mapping ----

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _linear(mod) -> dict:
    p = {"w": np.ascontiguousarray(_np(mod.weight).T)}
    if getattr(mod, "bias", None) is not None:
        p["b"] = _np(mod.bias).copy()
    return p


def _conv1x1(mod) -> dict:
    w = _np(mod.weight)
    w = w.reshape(w.shape[0], w.shape[1])
    return {"w": np.ascontiguousarray(w.T), "b": _np(mod.bias).copy()}


def _conv_full(mod) -> dict:
    return {"w": _np(mod.weight).copy(), "b": _np(mod.bias).copy()}


def _act_name(act_instance) -> str:
    name = type(act_instance).__name__.lower()
    if name in ("leakyrelu", "tanh"):
        return name
    raise ValueError(f"unsupported reference activation {name!r} "
                     "(expected LeakyReLU or Tanh)")


def _mlp_stack(seq) -> Tuple[list, bool, Optional[str]]:
    """(linears in order, resid?, activation name) of a reference
    Sequential of Linear, ResidLinear and activation modules."""
    linears, resid, act = [], False, None
    for m in seq:
        if isinstance(m, nn.Linear):
            linears.append(_linear(m))
        elif hasattr(m, "linear"):          # ResidLinear: a Linear + act
            linears.append(_linear(m.linear))
            resid = True
            if act is None and hasattr(m, "act"):
                act = _act_name(m.act)
        elif act is None and type(m).__name__.lower() in ("leakyrelu", "tanh"):
            act = _act_name(m)
    return linears, resid, act


# ---- generator ----

def generator_from_sav(path: str) -> Tuple[GeneratorConfig, dict]:
    """A reference generator.sav -> (GeneratorConfig, params)."""
    gen = _load_torch_module(path)
    if type(gen).__name__ != "SpatialGenerator":
        raise ValueError(f"{path} holds {type(gen).__name__}, "
                         "expected SpatialGenerator")
    params: dict = {}
    fourier = bool(getattr(gen, "fourier_expansion", False))
    sigma, emb_dim = 0.01, 1024
    if fourier:
        emb = gen.embed_latent
        params["fourier"] = {"w": np.ascontiguousarray(_np(emb.weight).T),
                             "b": _np(emb.bias).copy()}
        sigma = float(_np(torch.as_tensor(emb.sigma)))
        emb_dim = int(emb.embedding_dim)
    params["coord_linear"] = _linear(gen.coord_linear)
    z_dim = int(gen.latent_dim)
    if z_dim > 0:
        params["latent_linear"] = {
            "w": np.ascontiguousarray(_np(gen.latent_linear.weight).T)}
    body = list(gen.layers)
    hidden, resid, act = _mlp_stack(body[:-1])
    params["hidden"] = hidden
    params["out"] = _linear(body[-1])
    cfg = GeneratorConfig(
        z_dim=z_dim, hidden_dim=int(gen.coord_linear.out_features),
        n_out=int(body[-1].out_features), num_layers=len(hidden) + 1,
        activation=act or "leakyrelu", resid=resid,
        fourier_expansion=fourier, fourier_sigma=sigma,
        embedding_dim=emb_dim)
    return cfg, params


# ---- encoders ----

def _image_dim_channels(n_flat: int) -> Tuple[int, int]:
    for c in (1, 3):
        side = int(round((n_flat / c) ** 0.5))
        if side * side * c == n_flat:
            return side, c
    raise ValueError(f"cannot factor flattened input size {n_flat} "
                     "into image_dim^2 * channels")


def encoder_from_sav(path: str) -> Tuple[EncoderConfig, dict]:
    """A reference inference.sav -> (EncoderConfig, params), modes A, B
    (groupconv 0 and > 0) and C (with and without rot_refinement)."""
    enc = _load_torch_module(path)
    name = type(enc).__name__

    if name == "InferenceNetwork_UnimodalTranslation_UnimodalRotation":
        layers, resid, act = _mlp_stack(list(enc.layers))
        image_dim, in_ch = _image_dim_channels(int(enc.n))
        cfg = EncoderConfig(
            t_inf="unimodal", r_inf="unimodal", image_dim=image_dim,
            in_channels=in_ch, z_dim=int(enc.latent_dim) - 3,
            kernels_num=int(layers[0]["w"].shape[1]),    # the hidden width
            num_layers=len(layers) - 1, activation=act or "leakyrelu",
            resid=resid)
        return cfg, {"layers": layers}

    if name == "InferenceNetwork_AttentionTranslation_UnimodalRotation":
        groupconv = int(enc.groupconv)
        p = {"conv1": _conv_full(enc.conv1)}
        if groupconv > 0:
            p["fc_r"] = _linear(enc.fc_r)
        for head in ("conv2", "conv_a", "conv_r", "conv_z"):
            p[head] = _conv1x1(getattr(enc, head))
        cfg = EncoderConfig(
            t_inf="attention", r_inf="unimodal",
            image_dim=int(enc.input_size),
            in_channels=int(enc.conv1.in_channels),
            z_dim=int(enc.latent_dim), kernels_num=int(enc.kernels_num),
            groupconv=groupconv, activation=_act_name(enc.activation))
        return cfg, p

    if name == "InferenceNetwork_AttentionTranslation_AttentionRotation":
        p = {"conv1": _conv_full(enc.conv1)}
        for head in ("conv2", "conv_a", "conv_r", "conv_z"):
            p[head] = _conv1x1(getattr(enc, head))
        cfg = EncoderConfig(
            t_inf="attention",
            r_inf=("attention+offsets" if bool(enc.rot_refinement)
                   else "attention"),
            image_dim=int(enc.input_size),
            in_channels=int(enc.conv1.in_channels),
            z_dim=int(enc.latent_dim), kernels_num=int(enc.kernels_num),
            kernels_size=int(enc.kernels_size), padding=int(enc.padding),
            groupconv=int(enc.groupconv),
            activation=_act_name(enc.activation),
            theta_prior=float(enc.theta_prior),
            normal_prior_over_r=bool(enc.normal_prior_over_r))
        return cfg, p

    raise ValueError(f"{path} holds {name}, not a reference inference network")


# ---- the whole model ----

def model_from_savs(inference_sav: str,
                    generator_sav: Optional[str] = None,
                    likelihood: Optional[LikelihoodConfig] = None
                    ) -> Tuple[ModelConfig, dict]:
    """(ModelConfig, params) from reference .sav files. Without a generator
    file the decoder is initialised from torch.Generator().manual_seed(0)
    (embedding and clustering read only the encoder)."""
    enc_cfg, enc_params = encoder_from_sav(inference_sav)
    if generator_sav is not None:
        gen_cfg, gen_params = generator_from_sav(generator_sav)
    else:
        from ..models.generator import generator_init
        from .jax_params import params_to_jax

        gen_cfg = GeneratorConfig(z_dim=max(enc_cfg.z_dim, 0))
        gen_params = params_to_jax(generator_init(
            torch.Generator().manual_seed(0), gen_cfg, "cpu"))
    cfg = ModelConfig(generator=gen_cfg, encoder=enc_cfg,
                      likelihood=likelihood or LikelihoodConfig())
    return cfg, {"generator": gen_params, "encoder": enc_params}
