"""diffusers / transformers component checkpoints -> state dicts.

Counterpart of the JAX package's ``models/diffusion/convert.py``. The port
keeps the torch layouts (conv OIHW, linear (out, in)), so loading a
component is reading its tensors, renaming the deprecated attention keys
and dropping buffers; the modules then load them strictly
(``layers.materialize``). ``diffusion_params_from_jax`` goes the other way
from the JAX package's flat params, for the parity tests.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["canonicalize_state_dict", "diffusion_params_from_jax",
           "load_component", "read_json"]

_EMBEDDING_MARKERS = ("token_embedding", "position_embedding",
                      "class_embedding", "position_ids")

# Deprecated diffusers AttentionBlock names (pre-0.15 checkpoints, e.g. the
# published stable-diffusion-x4-upscaler VAE) -> to_q/to_k/to_v/to_out.0.
_DEPRECATED_ATTN = {".query.": ".to_q.", ".key.": ".to_k.",
                    ".value.": ".to_v.", ".proj_attn.": ".to_out.0."}


def _canonicalize_attn(name: str, t: torch.Tensor
                       ) -> tuple[str, torch.Tensor]:
    if ".attentions." not in name:
        return name, t
    for old, new in _DEPRECATED_ATTN.items():
        if old in name:
            name = name.replace(old, new)
            # The oldest checkpoints store these projections as 1x1 convs.
            if t.dim() == 4 and t.shape[2] == t.shape[3] == 1:
                t = t[:, :, 0, 0]
            break
    return name, t


def canonicalize_state_dict(sd: Mapping[str, Any]) -> dict:
    """Rename deprecated attention keys, drop ``position_ids`` buffers."""
    out = {}
    for name, val in sd.items():
        if name.endswith("position_ids"):
            continue  # buffer, not a parameter
        name, t = _canonicalize_attn(name, torch.as_tensor(val))
        out[name] = t
    return out


def diffusion_params_from_jax(np_params: Mapping[str, Any]) -> dict:
    """The JAX package's flat diffusion params (conv HWIO, linear (in, out),
    as numpy) -> a torch state dict (OIHW, (out, in)), float32. The inverse
    of the JAX ``convert_state_dict``, with the same embedding exemptions."""
    sd = {}
    for name, val in np_params.items():
        arr = np.asarray(val, np.float32)
        if name.endswith(".weight") and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif (name.endswith(".weight") and arr.ndim == 2
              and not any(m in name for m in _EMBEDDING_MARKERS)):
            arr = arr.T  # (in, out) -> (out, in)
        sd[name] = torch.from_numpy(np.array(arr, order="C"))
    return sd


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _read_tensors(dirpath: str) -> dict:
    for fname in ("diffusion_pytorch_model.safetensors",
                  "diffusion_pytorch_model.bin", "model.safetensors",
                  "pytorch_model.bin"):
        full = os.path.join(dirpath, fname)
        if not os.path.exists(full):
            continue
        if fname.endswith(".safetensors"):
            from safetensors.torch import load_file
            return dict(load_file(full))
        return dict(torch.load(full, map_location="cpu", weights_only=True,
                               mmap=True))
    raise FileNotFoundError(f"no weights found in {dirpath}")


def load_component(component_dir: str) -> tuple[dict, dict]:
    """(config, state dict of CPU tensors) for one pipeline component."""
    config = read_json(os.path.join(component_dir, "config.json"))
    return config, canonicalize_state_dict(_read_tensors(component_dir))
