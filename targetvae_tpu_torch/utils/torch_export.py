"""Write (config, params) as the reference's pickled-module .sav files
(mirror of targetvae_tpu/utils/torch_export.py), the inverse of
utils/torch_import.py: `inference.sav` / `generator.sav` that the PyTorch
reference's own tools `torch.load` and run unchanged, so that a model
trained here goes back to the reference stack.

The pickle names the classes `src.models.<Name>` without importing the
reference: the modules are built from synthetic nn.Module subclasses whose
`__module__` is "src.models", and a pure-Python pickler writes those
classes by name (the standard pickler would look each class up and find it
missing). The attributes are those the reference constructors set
(src/models.py:37-46, 70-93, 137-157, 236-251, 276-296, 335-351), so the
reference's forward methods bind on load. No module is registered in
sys.modules.

params: this package's nested dict of tensors (TargetVAE.params(), on any
device) or the JAX pytree layout with numpy leaves (load_checkpoint's).
"""

from __future__ import annotations

import os
import pickle
import types
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from .config import EncoderConfig, GeneratorConfig

_export_cache: dict = {}


def _ref_class(name: str) -> type:
    cls = _export_cache.get(name)
    if cls is None:
        cls = type(name, (nn.Module,), {"__module__": "src.models"})
        _export_cache[name] = cls
    return cls


class _RefPickler(pickle._Pickler):      # pure Python: save_global overrides
    def save_global(self, obj, name=None):
        if getattr(obj, "__module__", None) == "src.models":
            self.write(pickle.GLOBAL + b"src.models\n"
                       + obj.__name__.encode("ascii") + b"\n")
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _torch_save(obj, path: str) -> None:
    shim = types.ModuleType(__name__ + "._pickle_shim")
    shim.Pickler = _RefPickler
    shim.dump = lambda o, f, protocol=2: _RefPickler(f, protocol).dump(o)
    torch.save(obj, path, pickle_module=shim)


# ---- the reference modules, from params ----

def _t(x) -> torch.Tensor:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True,
                                     order="C"))


def _act_instance(name: str) -> nn.Module:
    return {"leakyrelu": nn.LeakyReLU, "tanh": nn.Tanh}[name]()


def _linear(p: dict, bias: bool = True) -> nn.Linear:
    w = _t(p["w"])                                  # (in, out)
    mod = nn.Linear(w.shape[0], w.shape[1], bias=bias and "b" in p)
    with torch.no_grad():
        mod.weight.copy_(w.T)
        if mod.bias is not None:
            mod.bias.copy_(_t(p["b"]))
    return mod


def _conv1x1(p: dict, dims: int) -> nn.Module:
    w = _t(p["w"])                                  # (in, out)
    cls = nn.Conv3d if dims == 3 else nn.Conv2d
    mod = cls(w.shape[0], w.shape[1], 1)
    with torch.no_grad():
        mod.weight.copy_(w.T.reshape(w.shape[1], w.shape[0], *([1] * dims)))
        mod.bias.copy_(_t(p["b"]))
    return mod


def _new_module(name: str) -> nn.Module:
    cls = _ref_class(name)
    m = cls.__new__(cls)
    nn.Module.__init__(m)
    return m


def _resid_linear(p: dict, act: str) -> nn.Module:
    m = _new_module("ResidLinear")
    m.linear = _linear(p)
    m.act = _act_instance(act)
    return m


def _mlp_body(hidden: list, out: dict, act: str, resid: bool,
              lead_act: bool) -> nn.Sequential:
    """The reference's Sequential body: [act] + hidden blocks + the final
    Linear (src/models.py:83-93 generator, :239-249 unimodal encoder)."""
    layers = [_act_instance(act)] if lead_act else []
    for p in hidden:
        if resid:
            layers.append(_resid_linear(p, act))
        else:
            layers += [_linear(p), _act_instance(act)]
    layers.append(_linear(out))
    return nn.Sequential(*layers)


def _group_conv(p: dict, kernel_size: int, padding: int,
                groupconv: int) -> nn.Module:
    w = _t(p["w"])                       # (out, in, 1, k, k), torch's layout
    m = _new_module("GroupConv")
    m.ksize = kernel_size
    m.kernel_size = (kernel_size, kernel_size)
    m.stride = (1, 1)
    m.padding = (padding, padding)
    m.in_channels = int(w.shape[1])
    m.out_channels = int(w.shape[0])
    m.input_rot_dim = 1
    m.output_rot_dim = groupconv
    m.weight = nn.Parameter(w)
    m.bias = nn.Parameter(_t(p["b"]))
    return m


# ---- exporters ----

def export_generator_sav(path: str, cfg: GeneratorConfig,
                         params: dict) -> None:
    g = _new_module("SpatialGenerator")
    g.fourier_expansion = bool(cfg.fourier_expansion)
    if cfg.fourier_expansion:
        emb = _new_module("RandomFourierEmbedding2d")
        emb.in_dim = 2
        emb.embedding_dim = int(cfg.embedding_dim)
        emb.sigma = torch.tensor(float(cfg.fourier_sigma),
                                 dtype=torch.float32)
        emb.register_buffer("weight", _t(params["fourier"]["w"]).T.contiguous())
        emb.register_buffer("bias", _t(params["fourier"]["b"]))
        g.embed_latent = emb
    g.coord_linear = _linear(params["coord_linear"])
    g.latent_dim = int(cfg.z_dim)
    if cfg.z_dim > 0:
        g.latent_linear = _linear(params["latent_linear"], bias=False)
    g.layers = _mlp_body(params["hidden"], params["out"], cfg.activation,
                         cfg.resid, lead_act=True)
    _torch_save(g.eval(), path)


def export_encoder_sav(path: str, cfg: EncoderConfig, params: dict) -> None:
    if cfg.mode == "A":
        m = _new_module("InferenceNetwork_UnimodalTranslation_UnimodalRotation")
        m.latent_dim = int(cfg.z_dim) + 3
        m.n = cfg.image_dim * cfg.image_dim * cfg.in_channels
        layers = params["layers"]
        body = _mlp_body(layers[1:-1], layers[-1], cfg.activation, cfg.resid,
                         lead_act=False)
        m.layers = nn.Sequential(_linear(layers[0]),
                                 _act_instance(cfg.activation), *list(body))
        _torch_save(m.eval(), path)
        return

    if cfg.mode == "B":
        m = _new_module("InferenceNetwork_AttentionTranslation_UnimodalRotation")
        m.activation = _act_instance(cfg.activation)
        m.latent_dim = int(cfg.z_dim)
        m.input_size = int(cfg.image_dim)
        m.kernels_num = int(cfg.kernels_num)
        m.groupconv = int(cfg.groupconv)
        if cfg.groupconv == 0:
            w = _t(params["conv1"]["w"])            # (out, in, k, k)
            conv1 = nn.Conv2d(w.shape[1], w.shape[0], w.shape[-1],
                              padding=cfg.image_dim // 2)
            with torch.no_grad():
                conv1.weight.copy_(w)
                conv1.bias.copy_(_t(params["conv1"]["b"]))
            m.conv1 = conv1
        else:
            m.conv1 = _group_conv(params["conv1"], cfg.image_dim,
                                  cfg.image_dim // 2, cfg.groupconv)
            m.fc_r = _linear(params["fc_r"])
        for head in ("conv2", "conv_a", "conv_r", "conv_z"):
            setattr(m, head, _conv1x1(params[head], 2))
        _torch_save(m.eval(), path)
        return

    m = _new_module("InferenceNetwork_AttentionTranslation_AttentionRotation")
    m.activation = _act_instance(cfg.activation)
    m.latent_dim = int(cfg.z_dim)
    m.input_size = int(cfg.image_dim)
    m.kernels_num = int(cfg.kernels_num)
    m.kernels_size = int(cfg.kernels_size)
    m.padding = int(cfg.padding)
    m.groupconv = int(cfg.groupconv)
    m.rot_refinement = bool(cfg.rot_refinement)
    m.theta_prior = float(cfg.theta_prior)
    m.normal_prior_over_r = bool(cfg.normal_prior_over_r)
    m.conv1 = _group_conv(params["conv1"], cfg.kernels_size, cfg.padding,
                          cfg.groupconv)
    for head in ("conv2", "conv_a", "conv_r", "conv_z"):
        setattr(m, head, _conv1x1(params[head], 3))
    _torch_save(m.eval(), path)


def export_checkpoint(run_dir_or_ckpt: str,
                      out_dir: Optional[str] = None) -> list:
    """A run directory (inference.sav and, where present, generator.sav) or
    one checkpoint file of this package -> `inference_torch.sav` [and
    `generator_torch.sav`] in out_dir (default: beside the inputs).
    Returns the paths written."""
    from ..train.checkpoint import load_checkpoint

    if os.path.isdir(run_dir_or_ckpt):
        enc_path = os.path.join(run_dir_or_ckpt, "inference.sav")
        gen_path = os.path.join(run_dir_or_ckpt, "generator.sav")
    else:
        enc_path, gen_path = run_dir_or_ckpt, None
    out_dir = out_dir or os.path.dirname(os.path.abspath(enc_path))
    os.makedirs(out_dir, exist_ok=True)
    params, cfg, _ = load_checkpoint(enc_path)
    out = os.path.join(out_dir, "inference_torch.sav")
    export_encoder_sav(out, cfg.encoder, params["encoder"])
    written = [out]
    if gen_path and os.path.exists(gen_path):
        gparams, gcfg, _ = load_checkpoint(gen_path)
        out = os.path.join(out_dir, "generator_torch.sav")
        export_generator_sav(out, gcfg.generator, gparams["generator"])
        written.append(out)
    return written
