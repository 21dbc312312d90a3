"""Checkpoint loading (counterpart of aphrodite_tpu/loader/weights.py,
dense and int4 Llama paths, KV-cache scales).

The model declares (hf_name -> our_path, transpose) mappings; per-layer
tensors are stacked on a leading [L] axis and kept in the JAX package's
[in, out] matmul layout, so ``params_from_jax`` carries a JAX parameter
tree over by copying values, with no transposes.

Formats: safetensors (single file or indexed shards), GGUF (one ``.gguf``
file, loader/gguf.py: quantized tensors become int4 containers) and
``dummy`` (random weights generated on the device from the model seed, in
the magnitudes of the JAX package's dummy weights).

With a GPTQ/AWQ quantization method, a checkpoint that carries packed
``qweight`` tensors is parsed into int4 containers
(quantization/int4.py); a dense or dummy one is quantized at load.
Container members keep their own dtypes (int8 nibbles, f32 scale and
zero); only dense float leaves take the model dtype.

``load_kv_cache_scales`` reads the per-layer scales of a quantized KV
cache (a JSON file, else checkpoint tensors, else ones).
"""

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.common.config import LoadConfig, ModelConfig
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.ops.quant_matmul import unpack_int4_rows
from aphrodite_tpu_torch.quantization import get_quantization_method
from aphrodite_tpu_torch.quantization import int4 as int4_mod

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


def _get_path(tree: Dict[str, Any], path: str):
    node = tree
    for k in path.split("."):
        node = node[k]
    return node


def _is_container(v) -> bool:
    """A quantized weight: a dict of tensors in place of one tensor."""
    return isinstance(v, dict) and "scale" in v and (
        "q4p" in v or "q4" in v)


def _logical_shape(w) -> Tuple[int, ...]:
    """The [.., K, N] shape of the weight a tensor or container stands
    for."""
    if not isinstance(w, dict):
        return tuple(w.shape)
    if "q4p" in w:
        *lead, kh, n = w["q4p"].shape
        return (*lead, 2 * kh, n)
    return tuple(w["q4"].shape)


def _check_shapes(expected: Dict[str, Any], got: Dict[str, Any],
                  prefix: str = "") -> None:
    for k, v in expected.items():
        path = f"{prefix}{k}"
        if k not in got:
            raise ValueError(f"missing param {path}")
        if isinstance(v, dict):
            _check_shapes(v, got[k], prefix=path + ".")
        elif _logical_shape(got[k]) != tuple(v):
            raise ValueError(f"param {path}: checkpoint shape "
                             f"{_logical_shape(got[k])} != expected {v}")


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


def _checkpoint_has_packed_tensors(model_dir: str) -> bool:
    """True when the safetensors files carry GPTQ/AWQ packed tensors."""
    from safetensors import safe_open

    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            names = json.load(f)["weight_map"].keys()
        return any(n.endswith(".qweight") for n in names)
    for fn in os.listdir(model_dir):
        if fn.endswith(".safetensors"):
            with safe_open(os.path.join(model_dir, fn),
                           framework="pt") as f:
                if any(n.endswith(".qweight") for n in f.keys()):
                    return True
    return False


def load_quantized_hf_params_to_host(model, model_dir: str,
                                     quant_method: str) -> Dict[str, Any]:
    """Load a GPTQ/AWQ checkpoint: packed int32 tensors -> containers.

    GPTQ/AWQ store Linear tensors as `<prefix>.qweight/.qzeros/.scales`
    (+ optional `g_idx`) already laid out [in, out]: no transpose, unlike
    dense HF Linear weights. Per-layer containers are unpacked, then
    stacked on the leading layer axis.
    """
    is_awq = quant_method.startswith("awq")
    num_layers = model.num_layers
    per_layer_maps = model.hf_param_mappings()
    quantizable = set(model.quantizable_weights())

    linear_prefix: Dict[str, str] = {}  # our_path -> hf prefix template
    dense_lookup: Dict[str, Tuple[str, bool, Optional[int]]] = {}
    for template, our_path, transpose in per_layer_maps:
        if our_path in quantizable:
            if not template.endswith(".weight"):
                raise ValueError(f"quantizable weight {our_path} maps to "
                                 f"{template}, not a Linear weight")
            linear_prefix[our_path] = template[:-len(".weight")]
        else:
            for i in range(num_layers):
                dense_lookup[template.format(i=i)] = (our_path, transpose, i)
    for hf_name, our_path, transpose in model.hf_global_mappings():
        dense_lookup[hf_name] = (our_path, transpose, None)

    raw: Dict[str, np.ndarray] = {}
    params: Dict[str, Any] = {}
    pieces: Dict[str, List[Optional[torch.Tensor]]] = {
        our_path: [None] * num_layers
        for _, our_path, _ in per_layer_maps if our_path not in quantizable
    }
    for name, arr in safetensors_weight_iterator(model_dir):
        info = dense_lookup.get(name)
        if info is None:
            if name.endswith((".qweight", ".qzeros", ".scales", ".g_idx")):
                raw[name] = arr.numpy()
            continue
        our_path, transpose, layer_idx = info
        if transpose:
            arr = arr.t()
        if layer_idx is None:
            _set_path(params, our_path, arr.contiguous())
        else:
            pieces[our_path][layer_idx] = arr
    for our_path, layer_list in pieces.items():
        missing = [i for i, a in enumerate(layer_list) if a is None]
        if missing:
            raise ValueError(f"missing layers {missing[:4]} for {our_path}")
        _set_path(params, our_path, torch.stack(layer_list, dim=0))

    for our_path, prefix_t in linear_prefix.items():
        containers = []
        for i in range(num_layers):
            prefix = prefix_t.format(i=i)
            try:
                qweight = raw[f"{prefix}.qweight"]
                qzeros = raw[f"{prefix}.qzeros"]
                scales = raw[f"{prefix}.scales"]
            except KeyError as e:
                raise ValueError(
                    f"quantized checkpoint is missing {e} for {prefix}")
            if is_awq:
                c = int4_mod.load_awq_tensors(qweight, qzeros, scales)
            else:
                c = int4_mod.load_gptq_tensors(
                    qweight, qzeros, scales, raw.get(f"{prefix}.g_idx"))
            containers.append(c)
        if len({frozenset(c) for c in containers}) > 1:
            # Mixed packed/unpacked layers (e.g. one desc_act layer):
            # normalize to the unpacked q4 form so stacking is uniform.
            containers = [
                {"q4": unpack_int4_rows(c.pop("q4p")), **c}
                if "q4p" in c else c for c in containers
            ]
        _set_path(params, our_path, {
            k: torch.from_numpy(np.stack([c[k] for c in containers], axis=0))
            for k in containers[0]
        })
    _check_shapes(model.param_shapes(), params)
    return params


def quantize_params_int4(model, params: Dict[str, Any]) -> Dict[str, Any]:
    """4-bit group quantization of a full-precision params tree, where
    its tensors lie (int4 asked for on a dense checkpoint)."""
    for path in model.quantizable_weights():
        _set_path(params, path,
                  int4_mod.quantize_from_float(_get_path(params, path)))
    return params


def load_kv_cache_scales(
    model_dir: str,
    num_layers: int,
    quantization_param_path: Optional[str] = None,
    tp_rank: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-layer (k_scale[L], v_scale[L]), f32, for a quantized KV cache.

    Sources, in this order:
    1. the JSON file ``quantization_param_path``: {"kv_cache":
       {"scaling_factor": {tp_rank: {layer: scale}}}}, one scale per
       layer for both K and V;
    2. checkpoint tensors ``model.layers.{i}.self_attn.{k,v}_scale``
       (fp8 checkpoints);
    3. ones (right for fp8_e5m2; e4m3 gains from calibrated scales, and
       int8 needs them).
    """
    k_scales = np.ones((num_layers,), np.float32)
    v_scales = np.ones((num_layers,), np.float32)
    if quantization_param_path:
        with open(quantization_param_path) as f:
            schema = json.load(f)
        factors = schema["kv_cache"]["scaling_factor"]
        layer_map = factors.get(str(tp_rank), factors.get(tp_rank, {}))
        for layer_str, scale in layer_map.items():
            idx = int(layer_str)
            if 0 <= idx < num_layers:
                k_scales[idx] = float(scale)
                v_scales[idx] = float(scale)
        return k_scales, v_scales
    if not os.path.isdir(model_dir):
        return k_scales, v_scales  # a single-file checkpoint carries none
    try:
        for name, arr in safetensors_weight_iterator(model_dir):
            if name.endswith(".k_scale") or name.endswith(".v_scale"):
                parts = name.split(".")
                try:
                    idx = int(parts[parts.index("layers") + 1])
                except (ValueError, IndexError):
                    continue
                target = k_scales if name.endswith(".k_scale") else v_scales
                target[idx] = float(arr.reshape(()))
    except FileNotFoundError:
        pass
    return k_scales, v_scales


def dummy_params(model, seed: int, device: torch.device, dtype: torch.dtype,
                 quantize: bool = False) -> Dict[str, Any]:
    """Random weights generated on the device: norms are ones, every other
    weight is normal with std 1/sqrt(last dim), the magnitudes of the JAX
    package's LlamaForCausalLM.random_params.

    With ``quantize`` the model's quantizable weights are drawn in f32 and
    quantized to int4 containers one layer of one matrix at a time, so the
    peak stays near the size of the packed model."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    quantizable = set(model.quantizable_weights()) if quantize else set()

    def quantized(shape):
        layers = []
        for _ in range(shape[0]):
            w = torch.empty(shape[1:], dtype=torch.float32, device=device)
            w.normal_(0.0, shape[-1]**-0.5, generator=gen)
            layers.append(int4_mod.quantize_from_float(w))
        return {k: torch.stack([c[k] for c in layers]) for k in layers[0]}

    def walk(shapes, prefix=""):
        out = {}
        for k, shape in shapes.items():
            if isinstance(shape, dict):
                out[k] = walk(shape, f"{prefix}{k}.")
            elif "norm" in k:
                out[k] = torch.ones(shape, dtype=dtype, device=device)
            elif prefix + k in quantizable:
                out[k] = quantized(shape)
            else:
                w = torch.empty(shape, dtype=dtype, device=device)
                out[k] = w.normal_(0.0, shape[-1]**-0.5, generator=gen)
        return out

    return walk(model.param_shapes())


def params_from_jax(np_params: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's parameter tree (nested dicts of numpy arrays,
    after fuse_projections) as the port's parameters: the same nesting,
    the same [in, out] layout and [L] stacking, values copied into CPU
    tensors: float leaves as f32, the integer members of quantized
    containers (int8 nibbles) in their own dtype."""
    def leaf(v):
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.integer):
            return torch.from_numpy(v.copy())
        return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))

    return {k: (params_from_jax(v) if isinstance(v, dict) else leaf(v))
            for k, v in np_params.items()}


def kv_scales_from_jax(
        np_scales: Tuple[Any, Any],
        device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (k_scale[L], v_scale[L]) pair as the JAX runner and
    ``load_kv_cache_scales`` hold it (numpy) as the port's: two f32
    tensors on the device, which the forward indexes by layer."""
    k, v = (torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
            .to(device) for a in np_scales)
    return k, v


def _to_device(tree: Dict[str, Any], device: torch.device,
               dtype: torch.dtype) -> Dict[str, Any]:
    """Move the tree to the device. Dense float leaves take the model
    dtype; the members of a quantized container keep theirs."""
    out = {}
    for k, v in tree.items():
        if _is_container(v):
            out[k] = {ck: cv.to(device=device) for ck, cv in v.items()}
        elif isinstance(v, dict):
            out[k] = _to_device(v, device, dtype)
        else:
            out[k] = v.to(device=device, dtype=dtype)
    return out


def load_model_params(model, model_config: ModelConfig,
                      load_config: LoadConfig,
                      device: torch.device) -> Dict[str, Any]:
    dtype = model.dtype
    fmt = load_config.load_format
    quant = model_config.quantization
    # Only the int4 family is registered; any other method raises there.
    int4 = get_quantization_method(quant) is not None
    if fmt == "auto":
        if model_config.model.endswith(".gguf"):
            fmt = "gguf"
        else:
            has_st = any(fn.endswith(".safetensors")
                         for fn in os.listdir(model_config.model))
            fmt = "safetensors" if has_st else "dummy"
    if fmt == "dummy":
        logger.info("using dummy (random) weights")
        return dummy_params(model, model_config.seed, device, dtype,
                            quantize=int4)
    if fmt == "gguf":
        from aphrodite_tpu_torch.loader.gguf import load_gguf_params_to_host

        logger.info("loading GGUF weights from %s", model_config.model)
        return _to_device(
            load_gguf_params_to_host(model, model_config.model), device,
            dtype)
    logger.info("loading weights from %s", model_config.model)
    if int4 and _checkpoint_has_packed_tensors(model_config.model):
        host = load_quantized_hf_params_to_host(model, model_config.model,
                                                quant)
    else:
        host = load_hf_params_to_host(model, model_config.model)
        if int4:
            # int4 asked for on a dense checkpoint: quantize at load.
            host = quantize_params_int4(model, host)
    return _to_device(host, device, dtype)
