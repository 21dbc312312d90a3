"""Tokenizer loading (counterpart of
aphrodite_tpu/transformers_utils/tokenizer.py without the Mistral tekken
format, which a later slice brings).

Thin wrapper over HF AutoTokenizer; local directories only (no network).
"""

from typing import Optional

from aphrodite_tpu_torch.common.logger import init_logger

logger = init_logger(__name__)


def get_tokenizer(
    tokenizer_name: str,
    trust_remote_code: bool = False,
    revision: Optional[str] = None,
):
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(
        tokenizer_name,
        trust_remote_code=trust_remote_code,
        revision=revision,
        use_fast=True,
    )
    if tokenizer.eos_token_id is None:
        logger.warning("tokenizer has no eos_token_id; generation will only "
                       "stop on max_tokens/stop strings")
    return tokenizer
