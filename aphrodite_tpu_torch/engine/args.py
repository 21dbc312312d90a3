"""EngineArgs: flat user-facing knobs -> typed config objects
(counterpart of aphrodite_tpu/engine/args.py), with the CLI flags of the
same names (``add_cli_args`` / ``from_cli_args``).

The JAX package's knobs for features the port has not taken yet (LoRA,
prompt adapters, speculative decoding, parallelism) are not fields here;
a CLI flag or YAML key that names one raises (``UNPORTED_ARGS``).
"""

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional

from aphrodite_tpu_torch.common.config import (CacheConfig, DeviceConfig,
                                               EngineConfig, LoadConfig,
                                               ModelConfig, SchedulerConfig)

# The JAX package's EngineArgs fields the port does not serve, by the
# ROADMAP queue item each waits for.
UNPORTED_ARGS = {
    "tensor_parallel_size": "parallelism",
    "data_parallel_size": "parallelism",
    "pipeline_parallel_size": "parallelism",
    "context_parallel_size": "parallelism",
    "enable_lora": "LoRA",
    "max_loras": "LoRA",
    "max_lora_rank": "LoRA",
    "long_lora_scaling_factors": "LoRA",
    "enable_prompt_adapter": "prompt adapters",
    "max_prompt_adapters": "prompt adapters",
    "max_prompt_adapter_token": "prompt adapters",
    "speculative_model": "speculative decoding",
    "num_speculative_tokens": "speculative decoding",
    "ngram_prompt_lookup_max": "speculative decoding",
    "ngram_prompt_lookup_min": "speculative decoding",
}


@dataclass
class EngineArgs:
    model: str
    tokenizer: Optional[str] = None
    dtype: str = "auto"
    seed: int = 0
    max_model_len: Optional[int] = None
    trust_remote_code: bool = False
    skip_tokenizer_init: bool = False
    load_format: str = "auto"
    quantization: Optional[str] = None
    # KV cache.
    kv_cache_dtype: str = "auto"
    quantization_param_path: Optional[str] = None
    block_size: int = 16
    hbm_utilization: float = 0.9
    num_device_blocks_override: Optional[int] = None
    enable_prefix_caching: bool = False
    # Scheduling.
    max_num_batched_tokens: Optional[int] = None
    max_num_seqs: int = 256
    enable_chunked_prefill: bool = True
    num_scheduler_steps: int = 1
    scheduler_delay_factor: float = 0.0
    # Device: "cuda" (the card) or "cpu".
    device: str = "cuda"

    def create_model_config(self) -> ModelConfig:
        """The model's description alone: what a frontend needs (limits,
        tokenizer path) without touching a device."""
        return ModelConfig(
            model=self.model,
            tokenizer=self.tokenizer,
            dtype=self.dtype,
            seed=self.seed,
            max_model_len=self.max_model_len,
            trust_remote_code=self.trust_remote_code,
            skip_tokenizer_init=self.skip_tokenizer_init,
            quantization=self.quantization,
        )

    def create_engine_config(self) -> EngineConfig:
        model_config = self.create_model_config()
        return EngineConfig(
            model_config=model_config,
            cache_config=CacheConfig(
                block_size=self.block_size,
                hbm_utilization=self.hbm_utilization,
                cache_dtype=self.kv_cache_dtype,
                quantization_param_path=self.quantization_param_path,
                enable_prefix_caching=self.enable_prefix_caching,
                num_device_blocks_override=self.num_device_blocks_override,
            ),
            scheduler_config=SchedulerConfig(
                max_num_batched_tokens=self.max_num_batched_tokens,
                max_num_seqs=self.max_num_seqs,
                max_model_len=model_config.max_model_len,
                enable_chunked_prefill=self.enable_chunked_prefill,
                num_scheduler_steps=self.num_scheduler_steps,
                delay_factor=self.scheduler_delay_factor,
            ),
            device_config=DeviceConfig(device=self.device),
            load_config=LoadConfig(load_format=self.load_format),
        )

    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser
                     ) -> argparse.ArgumentParser:
        """One flag per field (``--block-size`` for block_size; booleans
        are switches), and one per unported JAX field, which ends the
        parse with an error that names the feature."""
        for f in dataclasses.fields(EngineArgs):
            if f.name == "model":
                continue  # the CLI provides `model` as a positional
            name = "--" + f.name.replace("_", "-")
            ftype = str(f.type)
            if "bool" in ftype:
                parser.add_argument(name, action="store_true",
                                    default=f.default)
            elif "int" in ftype:
                parser.add_argument(name, type=int, default=f.default)
            elif "float" in ftype:
                parser.add_argument(name, type=float, default=f.default)
            else:
                parser.add_argument(name, type=str, default=f.default)
        for field_name, feature in UNPORTED_ARGS.items():
            parser.add_argument("--" + field_name.replace("_", "-"),
                                action=_Unported, feature=feature,
                                nargs="?", help=argparse.SUPPRESS)
        return parser

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "EngineArgs":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{
            k: v for k, v in vars(args).items() if k in fields})


class _Unported(argparse.Action):
    """A flag of the JAX package whose feature the port lacks."""

    def __init__(self, *args, feature: str, **kwargs) -> None:
        self.feature = feature
        super().__init__(*args, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string}: {self.feature} is not ported to the "
                     "PyTorch package yet")
