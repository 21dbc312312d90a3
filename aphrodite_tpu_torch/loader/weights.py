"""Checkpoint loading (counterpart of aphrodite_tpu/loader/weights.py,
dense Llama path).

The model declares (hf_name -> our_path, transpose) mappings; per-layer
tensors are stacked on a leading [L] axis and kept in the JAX package's
[in, out] matmul layout, so ``params_from_jax`` carries a JAX parameter
tree over by copying values, with no transposes.

Formats: safetensors (single file or indexed shards) and ``dummy``
(random weights generated on the device from the model seed, in the
magnitudes of the JAX package's dummy weights).
"""

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.common.config import LoadConfig, ModelConfig
from aphrodite_tpu_torch.common.logger import init_logger

logger = init_logger(__name__)


def safetensors_weight_iterator(
        model_dir: str) -> Iterable[Tuple[str, torch.Tensor]]:
    """Yield (name, CPU tensor) for every tensor in the checkpoint."""
    from safetensors import safe_open

    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(fn for fn in os.listdir(model_dir)
                       if fn.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(
            f"no .safetensors files found under {model_dir}")
    for fn in files:
        with safe_open(os.path.join(model_dir, fn), framework="pt") as f:
            for name in f.keys():
                yield name, f.get_tensor(name)


def _set_path(tree: Dict[str, Any], path: str, value) -> None:
    keys = path.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _check_shapes(expected: Dict[str, Any], got: Dict[str, Any],
                  prefix: str = "") -> None:
    for k, v in expected.items():
        path = f"{prefix}{k}"
        if k not in got:
            raise ValueError(f"missing param {path}")
        if isinstance(v, dict):
            _check_shapes(v, got[k], prefix=path + ".")
        elif tuple(got[k].shape) != tuple(v):
            raise ValueError(f"param {path}: checkpoint shape "
                             f"{tuple(got[k].shape)} != expected {v}")


def load_hf_params_to_host(model, model_dir: str) -> Dict[str, Any]:
    """The model's params tree from an HF checkpoint, as CPU tensors."""
    lookup: Dict[str, Tuple[str, str, bool, Optional[int]]] = {}
    for template, our_path, transpose in model.hf_param_mappings():
        for i in range(model.num_layers):
            lookup[template.format(i=i)] = ("layer", our_path, transpose, i)
    for hf_name, our_path, transpose in model.hf_global_mappings():
        lookup[hf_name] = ("global", our_path, transpose, None)
    pieces: Dict[str, List[Optional[torch.Tensor]]] = {
        our_path: [None] * model.num_layers
        for _, our_path, _ in model.hf_param_mappings()
    }
    params: Dict[str, Any] = {}
    for name, arr in safetensors_weight_iterator(model_dir):
        info = lookup.get(name)
        if info is None:
            if "rotary_emb" not in name:
                logger.debug("skipping unmapped weight %s", name)
            continue
        kind, target, transpose, idx = info
        if transpose:
            arr = arr.t()
        if kind == "global":
            _set_path(params, target, arr.contiguous())
        else:
            pieces[target][idx] = arr
    for our_path, layer_list in pieces.items():
        missing = [i for i, a in enumerate(layer_list) if a is None]
        if missing:
            raise ValueError(f"checkpoint is missing layers {missing[:4]}"
                             f"... for {our_path}")
        _set_path(params, our_path, torch.stack(layer_list, dim=0))
    _check_shapes(model.param_shapes(), params)
    return params


def dummy_params(model, seed: int, device: torch.device,
                 dtype: torch.dtype) -> Dict[str, Any]:
    """Random weights generated on the device: norms are ones, every other
    weight is normal with std 1/sqrt(last dim), the magnitudes of the JAX
    package's LlamaForCausalLM.random_params."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def walk(shapes):
        out = {}
        for k, shape in shapes.items():
            if isinstance(shape, dict):
                out[k] = walk(shape)
            elif "norm" in k:
                out[k] = torch.ones(shape, dtype=dtype, device=device)
            else:
                w = torch.empty(shape, dtype=dtype, device=device)
                out[k] = w.normal_(0.0, shape[-1]**-0.5, generator=gen)
        return out

    return walk(model.param_shapes())


def params_from_jax(np_params: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's parameter tree (nested dicts of numpy arrays,
    after fuse_projections) as the port's parameters: the same nesting,
    the same [in, out] layout and [L] stacking, values copied into f32
    CPU tensors."""
    return {k: (params_from_jax(v) if isinstance(v, dict) else
                torch.from_numpy(np.array(v, dtype=np.float32, copy=True)))
            for k, v in np_params.items()}


def _to_device(tree: Dict[str, Any], device: torch.device,
               dtype: torch.dtype) -> Dict[str, Any]:
    return {k: (_to_device(v, device, dtype) if isinstance(v, dict)
                else v.to(device=device, dtype=dtype))
            for k, v in tree.items()}


def load_model_params(model, model_config: ModelConfig,
                      load_config: LoadConfig,
                      device: torch.device) -> Dict[str, Any]:
    dtype = model.dtype
    fmt = load_config.load_format
    if fmt == "auto":
        has_st = any(fn.endswith(".safetensors")
                     for fn in os.listdir(model_config.model))
        fmt = "safetensors" if has_st else "dummy"
    if fmt == "dummy":
        logger.info("using dummy (random) weights")
        return dummy_params(model, model_config.seed, device, dtype)
    logger.info("loading weights from %s", model_config.model)
    host = load_hf_params_to_host(model, model_config.model)
    return _to_device(host, device, dtype)
