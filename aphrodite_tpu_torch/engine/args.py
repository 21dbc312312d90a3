"""EngineArgs: flat user-facing knobs -> typed config objects
(counterpart of aphrodite_tpu/engine/args.py, trimmed to the knobs the
offline path reads)."""

from dataclasses import dataclass
from typing import Optional

from aphrodite_tpu_torch.common.config import (CacheConfig, DeviceConfig,
                                               EngineConfig, LoadConfig,
                                               ModelConfig, SchedulerConfig)


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

    def create_engine_config(self) -> EngineConfig:
        model_config = ModelConfig(
            model=self.model,
            tokenizer=self.tokenizer,
            dtype=self.dtype,
            seed=self.seed,
            max_model_len=self.max_model_len,
            trust_remote_code=self.trust_remote_code,
            skip_tokenizer_init=self.skip_tokenizer_init,
            quantization=self.quantization,
        )
        return EngineConfig(
            model_config=model_config,
            cache_config=CacheConfig(
                block_size=self.block_size,
                hbm_utilization=self.hbm_utilization,
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
