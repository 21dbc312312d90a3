"""Tokenizer loading (counterpart of
aphrodite_tpu/transformers_utils/tokenizer.py without the Mistral tekken
format, which a later slice brings), and the chat template the server and
``LLM.chat`` apply.

Thin wrapper over HF AutoTokenizer; local directories only (no network).
"""

from typing import Dict, List, Optional

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


def apply_chat_template(tokenizer, conversation: List[Dict[str, str]],
                        add_generation_prompt: bool = True,
                        chat_template: Optional[str] = None,
                        tools: Optional[List[dict]] = None) -> str:
    """A conversation of {role, content} as prompt text: the tokenizer's
    chat template (or the one given), else the JAX server's fallback
    template, ``<|role|>\\ncontent\\n`` a message and ``<|assistant|>\\n``
    to prompt the reply."""
    if getattr(tokenizer, "chat_template", None) or chat_template:
        return tokenizer.apply_chat_template(
            conversation,
            tokenize=False,
            add_generation_prompt=add_generation_prompt,
            chat_template=chat_template,
            tools=tools,
        )
    text = "".join(f"<|{m['role']}|>\n{m['content']}\n"
                   for m in conversation)
    if add_generation_prompt:
        text += "<|assistant|>\n"
    return text
