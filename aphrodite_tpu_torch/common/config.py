"""Engine configuration dataclasses (counterpart of
aphrodite_tpu/common/config.py, trimmed to what the offline Llama path
reads). Parallelism, LoRA, prompt adapters and speculative decoding come
with the slices that port them.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from aphrodite_tpu_torch.common.logger import init_logger

logger = init_logger(__name__)

_SUPPORTED_DTYPES = ("bfloat16", "float32")
# KV-cache dtypes, by the JAX package's names: "auto" is the model dtype,
# "fp8" is E4M3.
_SUPPORTED_KV_DTYPES = ("auto", "bfloat16", "fp8", "fp8_e4m3", "fp8_e5m2",
                        "int8")


def _read_hf_config(model: str) -> Dict[str, Any]:
    """The checkpoint's config.json, or, for a .gguf file, an HF-style
    config made from its metadata."""
    if model.endswith(".gguf"):
        from aphrodite_tpu_torch.loader.gguf import gguf_to_hf_config

        return gguf_to_hf_config(model)
    path = os.path.join(model, "config.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"Could not find config.json under {model!r}. Only local model "
            "directories are supported (no network).")
    with open(path) as f:
        return json.load(f)


def fill_family_keys(hf: Dict[str, Any]) -> None:
    """Fill, in place and only where missing, the keys a family's config
    names its own way, under the names the accessors below and the Llama
    body read: the JAX package's model classes set the same defaults
    (``hf.setdefault``) in their __init__. Here they are set when the
    config is read, so that every accessor gives the JAX ModelConfig's
    answer (after its model is built) before any model is built: the KV
    cache is sized before the model."""
    arch = (hf.get("architectures") or [""])[0]
    if arch == "GPTJForCausalLM":
        hf.setdefault("hidden_size", hf.get("n_embd"))
        hf.setdefault("intermediate_size",
                      hf.get("n_inner") or 4 * int(hf["hidden_size"]))
        hf.setdefault("rms_norm_eps", hf.get("layer_norm_epsilon", 1e-5))
    elif arch in ("ChatGLMModel", "ChatGLMForConditionalGeneration"):
        hf.setdefault("num_hidden_layers", hf.get("num_layers"))
        hf.setdefault("intermediate_size", hf.get("ffn_hidden_size"))
        hf.setdefault("rms_norm_eps", hf.get("layernorm_epsilon", 1e-5))
        hf.setdefault("vocab_size", hf.get("padded_vocab_size"))
        if hf.get("multi_query_attention"):
            hf.setdefault("num_key_value_heads",
                          hf["multi_query_group_num"])
        hf.setdefault("max_position_embeddings",
                      hf.get("seq_length", 2048))
        # Rotary over half of each head, its base scaled by rope_ratio
        # (ChatGLM3's long-context variants).
        hf.setdefault("partial_rotary_factor", 0.5)
        hf.setdefault("rope_theta",
                      10000.0 * float(hf.get("rope_ratio", 1.0)))
        hf.setdefault("attention_bias",
                      bool(hf.get("add_qkv_bias", False)
                           or hf.get("add_bias_linear", False)))
    elif arch in ("StableLmForCausalLM", "StableLMEpochForCausalLM",
                  "StablelmForCausalLM"):
        # StableLM-Epoch configs (stablelm-3b-4e1t) name norm_eps and
        # rope_pct, and the q|k|v bias use_qkv_bias.
        hf.setdefault("rms_norm_eps",
                      hf.get("layer_norm_eps", hf.get("norm_eps", 1e-5)))
        if hf.get("rope_pct") and not hf.get("partial_rotary_factor"):
            hf["partial_rotary_factor"] = hf["rope_pct"]
        hf.setdefault("attention_bias", bool(hf.get("use_qkv_bias")))
    elif arch == "NemotronForCausalLM":
        hf.setdefault("rms_norm_eps", hf.get("norm_eps", 1e-5))
    elif arch in ("GPTNeoXForCausalLM", "PhiForCausalLM",
                  "PersimmonForCausalLM", "CohereForCausalLM"):
        hf.setdefault("rms_norm_eps", hf.get("layer_norm_eps", 1e-5))
        if arch == "PhiForCausalLM":
            hf.setdefault("partial_rotary_factor", 0.5)
    elif arch in ("GPT2LMHeadModel", "GPTBigCodeForCausalLM"):
        hf.setdefault("hidden_size", hf.get("n_embd"))
        if arch == "GPTBigCodeForCausalLM":
            # Multi-query (the default): one kv head.
            hf.setdefault("num_key_value_heads",
                          1 if hf.get("multi_query", True)
                          else int(hf.get("num_attention_heads")
                                   or hf.get("n_head")))
        hf.setdefault("intermediate_size",
                      hf.get("n_inner") or 4 * int(hf["hidden_size"]))
        hf.setdefault("rms_norm_eps", hf.get("layer_norm_epsilon", 1e-5))
    elif arch == "OPTForCausalLM":
        hf.setdefault("intermediate_size", hf.get("ffn_dim"))
        hf.setdefault("rms_norm_eps", 1e-5)
    elif arch == "OlmoForCausalLM":
        hf.setdefault("rms_norm_eps", 1e-5)
    elif arch == "ExaoneForCausalLM":
        hf.setdefault("rms_norm_eps", hf.get("layer_norm_epsilon", 1e-5))
        if hf.get("num_layers") and not hf.get("num_hidden_layers"):
            hf["num_hidden_layers"] = hf["num_layers"]
    elif arch == "DeciLMForCausalLM":
        # Every layer is served at the largest of its kv head counts (the
        # JAX class sets it, over any count the config names).
        if hf.get("num_key_value_heads_per_layer"):
            hf["num_key_value_heads"] = max(
                int(n) for n in hf["num_key_value_heads_per_layer"])


@dataclass
class ModelConfig:
    """Model architecture + checkpoint description."""

    model: str
    tokenizer: Optional[str] = None
    dtype: str = "bfloat16"
    seed: int = 0
    max_model_len: Optional[int] = None
    trust_remote_code: bool = False
    # Skip tokenizer loading; requests must pass prompt_token_ids.
    skip_tokenizer_init: bool = False
    # Weight quantization method; None = read the checkpoint's
    # quantization_config (dense when it has none).
    quantization: Optional[str] = None
    # Populated from config.json:
    hf_config: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.tokenizer is None:
            self.tokenizer = self.model
        if not self.hf_config:
            self.hf_config = _read_hf_config(self.model)
        fill_family_keys(self.hf_config)
        if self.dtype == "auto":
            self.dtype = str(self.hf_config.get("torch_dtype", "bfloat16"))
            if self.dtype.startswith("torch."):
                self.dtype = self.dtype[len("torch."):]
            if self.dtype == "float16":
                # As in the JAX package: fp16 checkpoints run as bf16.
                self.dtype = "bfloat16"
        if self.dtype not in _SUPPORTED_DTYPES:
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        derived_max = int(
            self.hf_config.get("max_position_embeddings")
            or self.hf_config.get("n_positions")
            or self.hf_config.get("max_seq_len")
            or self.hf_config.get("seq_length") or 2048)
        if self.max_model_len is None:
            self.max_model_len = derived_max
        elif (self.max_model_len > derived_max
              and not self.hf_config.get("rope_scaling")):
            logger.warning(
                "max_model_len %d exceeds the model's "
                "max_position_embeddings %d", self.max_model_len,
                derived_max)
        qcfg = self.hf_config.get("quantization_config") or {}
        # A GGUF file names no method: its tensors carry their own block
        # types and the loader makes containers of them.
        if (self.quantization is None and qcfg
                and not self.model.endswith(".gguf")):
            self.quantization = str(qcfg.get("quant_method", "")) or None
        if self.quantization is not None:
            from aphrodite_tpu_torch.quantization import \
                get_quantization_method

            self.quantization = self.quantization.lower()
            if (qcfg.get("checkpoint_format") in ("marlin", "marlin_24")
                    or qcfg.get("is_marlin_format", False)):
                raise NotImplementedError(
                    "checkpoints serialized in Marlin's own tile format "
                    "are not ported yet (ROADMAP.md, module queue: the "
                    "other loaders)")
            # Raises for a method that is unknown or not ported.
            get_quantization_method(self.quantization)

    @property
    def architecture(self) -> str:
        archs = self.hf_config.get("architectures") or ["LlamaForCausalLM"]
        return archs[0]

    # The HF names first, then the aliases other config classes use
    # (MPT's d_model, n_layers, n_heads; Bloom's, Falcon's and GPT-2's
    # n_layer, n_head), in the JAX package's order; a config that names no
    # head count reports 1, as there.
    def get_hidden_size(self) -> int:
        return int(self.hf_config.get("hidden_size")
                   or self.hf_config.get("d_model"))

    def get_num_layers(self) -> int:
        return int(self.hf_config.get("num_hidden_layers")
                   or self.hf_config.get("n_layer")
                   or self.hf_config.get("n_layers")
                   or self.hf_config.get("num_layers"))

    def get_num_attention_heads(self) -> int:
        return int(self.hf_config.get("num_attention_heads")
                   or self.hf_config.get("n_head")
                   or self.hf_config.get("n_heads")
                   or self.hf_config.get("decoder_attention_heads")
                   or self.hf_config.get("num_heads") or 1)

    # Encoder-decoder depths (T5's num_layers and num_decoder_layers,
    # BART's encoder_layers and decoder_layers), read where the JAX
    # models read them; the accessors above answer as the JAX ModelConfig
    # does for these configs too.
    def get_num_encoder_layers(self) -> int:
        hf = self.hf_config
        if "encoder_layers" in hf:
            return int(hf["encoder_layers"])
        return int(hf.get("num_layers", 6))

    def get_num_decoder_layers(self) -> int:
        hf = self.hf_config
        if "decoder_layers" in hf:
            return int(hf["decoder_layers"])
        return int(hf.get("num_decoder_layers")
                   or self.get_num_encoder_layers())

    def get_total_num_kv_heads(self) -> int:
        return int(
            self.hf_config.get("num_key_value_heads",
                               self.get_num_attention_heads()))

    def get_head_size(self) -> int:
        if self.hf_config.get("head_dim"):
            return int(self.hf_config["head_dim"])
        return self.get_hidden_size() // self.get_num_attention_heads()

    def get_vocab_size(self) -> int:
        return int(self.hf_config.get("vocab_size")
                   or self.hf_config.get("padded_vocab_size"))

    def get_sliding_window(self) -> Optional[int]:
        if self.hf_config.get("use_sliding_window") is False:
            return None
        return self.hf_config.get("sliding_window")


@dataclass
class CacheConfig:
    """Paged KV cache configuration."""

    block_size: int = 16
    # Share of the card's memory the weights, activations and KV cache
    # may take together.
    hbm_utilization: float = 0.9
    cache_dtype: str = "auto"
    num_device_blocks: Optional[int] = None  # set after memory profiling
    enable_prefix_caching: bool = False
    # JSON file of per-layer KV scales for a narrow cache dtype
    # ({"kv_cache": {"scaling_factor": {tp_rank: {layer: scale}}}}).
    quantization_param_path: Optional[str] = None
    # Override the profiled block count (tests / CPU runs).
    num_device_blocks_override: Optional[int] = None

    def __post_init__(self) -> None:
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")
        if not 0.0 < self.hbm_utilization <= 1.0:
            raise ValueError("hbm_utilization must be in (0, 1]")
        if self.cache_dtype not in _SUPPORTED_KV_DTYPES:
            raise ValueError(
                f"unsupported kv cache dtype {self.cache_dtype!r}; choose "
                f"from {_SUPPORTED_KV_DTYPES}")


@dataclass
class SchedulerConfig:
    """Continuous-batching policy knobs (same fields as the JAX package;
    the scheduler is a copy)."""

    max_num_batched_tokens: Optional[int] = None
    max_num_seqs: int = 256
    max_model_len: int = 2048
    enable_chunked_prefill: bool = True
    # Upper bound of scheduler steps executed per schedule() call
    # (multi-step decoding). 1 = classic per-token scheduling.
    num_scheduler_steps: int = 1
    preemption_mode: str = "recompute"
    # Prefill admission hold-off: a waiting prompt is admitted only once
    # its age exceeds delay_factor x the last prompt iteration's latency.
    delay_factor: float = 0.0

    def __post_init__(self) -> None:
        if self.max_num_batched_tokens is None:
            if self.enable_chunked_prefill:
                self.max_num_batched_tokens = max(512, self.max_num_seqs)
            else:
                self.max_num_batched_tokens = max(self.max_model_len, 2048)
        if not self.enable_chunked_prefill:
            # Without chunked prefill, a whole prompt must fit in a step.
            self.max_num_batched_tokens = max(self.max_num_batched_tokens,
                                              self.max_model_len)
        if self.max_num_batched_tokens < self.max_num_seqs:
            logger.warning(
                "max_num_batched_tokens (%d) < max_num_seqs (%d); decode "
                "batches will be capped by the token budget",
                self.max_num_batched_tokens, self.max_num_seqs)
        if self.preemption_mode != "recompute":
            raise ValueError("only preemption_mode='recompute' is supported")


def chain_windows_enabled() -> bool:
    """Whether the runner chains decode windows across engine steps and the
    scheduler reserves a chained window's KV: APHRODITE_CHAIN_WINDOWS, the
    JAX package's switch, with its meaning (on unless "0"). Off, no request
    reserves KV slots for a second window, for a deployment short of KV
    pages."""
    return os.environ.get("APHRODITE_CHAIN_WINDOWS", "1") != "0"


@dataclass
class DeviceConfig:
    """Target device: "cuda" (the card) or "cpu" (tests). Never probed:
    the caller names it, and "cuda" without a card raises."""

    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.device not in ("cuda", "cpu"):
            raise ValueError(
                f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if self.device == "cuda":
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device='cuda' but no CUDA device is available; pass "
                    "device='cpu' to run on the CPU")


@dataclass
class LoadConfig:
    """Weight-loading strategy."""

    load_format: str = "auto"  # auto|safetensors|gguf|dummy

    def __post_init__(self) -> None:
        if self.load_format not in ("auto", "safetensors", "gguf", "dummy"):
            raise ValueError(f"unknown load_format {self.load_format!r}")


@dataclass
class EngineConfig:
    model_config: ModelConfig
    cache_config: CacheConfig
    scheduler_config: SchedulerConfig
    device_config: DeviceConfig
    load_config: LoadConfig

    def __post_init__(self) -> None:
        self.scheduler_config.max_model_len = min(
            self.scheduler_config.max_model_len,
            self.model_config.max_model_len)
