"""RRDBNet checkpoints: load, save, convert from the JAX layout, synthesise;
SegFormer and SwinIR parameters carried over from the JAX layout; and the
JAX member ensemble's stacked params as one state dict a member.

State dicts use the basicsr RRDBNet layout (``conv_first.weight`` OIHW,
``body.{i}.rdb{k}.conv{c}.weight`` ...), which is what the published
Real-ESRGAN ``.pth`` files hold under ``params_ema``/``params``.
"""

from __future__ import annotations

import logging
from typing import Any, Mapping

import numpy as np
import torch

logger = logging.getLogger("nesr.weights")

__all__ = ["load_state_dict", "save_state_dict", "params_from_jax",
           "int8_rrdbnet_params_from_jax", "segformer_params_from_jax",
           "swinir_params_from_jax", "members_from_jax", "init_rrdbnet",
           "HEAD_CONVS"]

HEAD_CONVS = ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr",
              "conv_last")


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Load a ``.pth``/``.pt`` or ``.safetensors`` file as CPU tensors,
    unwrapping ``params_ema`` / ``params`` / ``state_dict`` containers."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return dict(load_file(path))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for key in ("params_ema", "params", "state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def save_state_dict(sd: Mapping[str, Any], path: str) -> str:
    """Save a state dict as ``.safetensors`` or as a basicsr ``.pth``
    (under ``params_ema``)."""
    tensors = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                  else v).detach().cpu().contiguous()
               for k, v in sd.items()}
    if path.endswith(".safetensors"):
        from safetensors.torch import save_file
        save_file(tensors, path)
    else:
        torch.save({"params_ema": tensors}, path)
    return path


def params_from_jax(np_params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's RRDBNet pytree (HWIO, body stacked on a leading
    num_block axis, as numpy) -> a basicsr state dict (OIHW, per block).

    The inverse of ``rrdbnet_params_from_state_dict`` in the JAX package's
    ``models/weights.py``; takes the stock (unfused) layout."""
    sd: dict[str, torch.Tensor] = {}
    for name in HEAD_CONVS:
        p = np_params[name]
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["w"], np.float32)
                                 .transpose(3, 2, 0, 1)))
        sd[f"{name}.bias"] = torch.tensor(np.asarray(p["b"], np.float32))
    body = np_params["body"]
    if "conv1" not in body["rdb1"]:
        raise ValueError("params_from_jax takes the stock layout, not a fused "
                         "one")
    nb = np.asarray(body["rdb1"]["conv1"]["w"]).shape[0]
    for i in range(nb):
        for rdb in ("rdb1", "rdb2", "rdb3"):
            for ci in range(1, 6):
                p = body[rdb][f"conv{ci}"]
                key = f"body.{i}.{rdb}.conv{ci}"
                sd[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(p["w"][i], np.float32).transpose(3, 2, 0, 1)))
                sd[f"{key}.bias"] = torch.tensor(
                    np.asarray(p["b"][i], np.float32))
    return sd


def int8_rrdbnet_params_from_jax(np_params: Mapping[str, Any]
                                 ) -> dict[str, dict[str, Any]]:
    """The JAX package's ``fuse_rrdbnet_params_int8`` trunk (body stacked on
    a leading num_block axis, as numpy) -> per RDB ``body.{i}.rdb{k}`` the
    arguments of ``models/rrdbnet.Int8RDB``: ``wq`` (w0..w4 int8 HWIO),
    ``ws`` (their float32 scales), ``b`` (the biases)."""
    out: dict[str, dict[str, Any]] = {}
    for rdb, p in np_params["body"].items():
        nb = np.asarray(p["w0_q"]).shape[0]
        for i in range(nb):
            out[f"body.{i}.{rdb}"] = {
                "wq": [torch.from_numpy(np.array(p[f"w{k}_q"][i], np.int8))
                       for k in range(5)],
                "ws": [torch.from_numpy(np.array(p[f"w{k}_s"][i],
                                                 np.float32))
                       for k in range(5)],
                "b": torch.from_numpy(np.array(p["b"][i], np.float32))}
    return out


def segformer_params_from_jax(np_params: Mapping[str, Any]
                              ) -> dict[str, torch.Tensor]:
    """The JAX package's flat SegFormer params (HF key names; convs HWIO,
    depthwise (3, 3, 1, C), linears (in, out), as numpy) -> the HF state
    dict ``models/segformer.SegFormer`` loads (OIHW, (C, 1, 3, 3),
    (out, in)), float32: the diffusion params' layout rules."""
    from neural_enhanced_super_resolution_torch.models.diffusion.convert \
        import diffusion_params_from_jax
    return diffusion_params_from_jax(np_params)


def swinir_params_from_jax(np_params: Mapping[str, Any]
                           ) -> dict[str, torch.Tensor]:
    """The JAX package's flat SwinIR params (official names; convs HWIO,
    linears (in, out), as numpy) -> the official state dict (OIHW, (out,
    in)) that ``models/swinir.load_swinir`` reads, float32. The inverse of
    ``swinir_params_from_state_dict``; the bias tables keep their shape."""
    sd = {}
    for name, val in np_params.items():
        a = np.array(val, np.float32)
        if name.endswith(".weight") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif name.endswith(".weight") and a.ndim == 2:
            a = a.T
        sd[name] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def _tree_index(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def members_from_jax(stacked: Mapping[str, Any],
                     convert=params_from_jax) -> list:
    """The JAX package's member-ensemble params (a pytree whose leaves
    carry a leading member axis, ``parallel/ensemble.py``) -> one port
    state dict a member: member i's slice of every leaf, through
    ``convert`` (default: the RRDBNet layout, ``params_from_jax``)."""
    first = stacked
    while isinstance(first, Mapping):
        first = next(iter(first.values()))
    return [convert(_tree_index(stacked, i))
            for i in range(np.asarray(first).shape[0])]


def init_rrdbnet(cfg, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Synthetic weights in the basicsr layout, made from ``generator``.

    Head and tail convs use PyTorch's Conv2d default init; the RDB convs use
    basicsr's ``default_init_weights(scale=0.1)`` shape (Kaiming-normal
    scaled by 0.1, small biases), so a full-depth random network keeps its
    activations in range the way a trained one does.
    """
    nf, gc = cfg.num_feat, cfg.num_grow_ch
    sd: dict[str, torch.Tensor] = {}

    def conv(key, cin, cout, body=False):
        fan_in = cin * 9
        if body:
            std = 0.1 * (2.0 / fan_in) ** 0.5
            w = torch.randn((cout, cin, 3, 3), generator=generator) * std
            b = (torch.rand((cout,), generator=generator) - 0.5) * 0.02
        else:
            bound = fan_in ** -0.5
            w = (torch.rand((cout, cin, 3, 3), generator=generator) * 2 - 1
                 ) * bound
            b = (torch.rand((cout,), generator=generator) * 2 - 1) * bound
        sd[f"{key}.weight"] = w
        sd[f"{key}.bias"] = b

    conv("conv_first", cfg.conv_first_in_ch, nf)
    for i in range(cfg.num_block):
        for rdb in ("rdb1", "rdb2", "rdb3"):
            for ci in range(1, 6):
                conv(f"body.{i}.{rdb}.conv{ci}", nf + (ci - 1) * gc,
                     gc if ci < 5 else nf, body=True)
    conv("conv_body", nf, nf)
    conv("conv_up1", nf, nf)
    conv("conv_up2", nf, nf)
    conv("conv_hr", nf, nf)
    conv("conv_last", nf, cfg.num_out_ch)
    return sd
