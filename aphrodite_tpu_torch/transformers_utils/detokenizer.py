"""Incremental detokenization.

Re-implementation of the reference's streaming detokenizer
(aphrodite/transformers_utils/detokenizer.py:14, detokenize_incrementally):
token-by-token decoding must not emit partial UTF-8/byte-fallback artifacts,
and sentencepiece-style tokenizers need a prefix window so " word" keeps its
leading space. State per sequence: `tokens` (string pieces), `prefix_offset`
and `read_offset` into that list.

`tokens` holds one piece per token id, special tokens included (they are
dropped when the pieces become text), so that the ids not yet converted
are always those past len(tokens). The JAX package's copy drops them
from the list too, and then converts ids again after a prompt or output
that holds one: its streamed text repeats tokens.
"""

from typing import List, Optional, Tuple

# Number of tokens to look back when converting tokens -> text so that
# tokenizers with context-dependent piece merging produce stable output.
INITIAL_INCREMENTAL_DETOKENIZATION_OFFSET = 5


def _special_sets(tokenizer) -> Tuple[set, set]:
    """Cached (all_special_tokens, added_vocab) sets — the transformers
    properties recompute on every access and dominated the host loop
    (~0.5ms per sequence per step at S=128)."""
    cached = getattr(tokenizer, "_aph_special_sets", None)
    if cached is None:
        cached = (set(tokenizer.all_special_tokens),
                  set(tokenizer.get_added_vocab().keys()))
        try:
            tokenizer._aph_special_sets = cached
        except AttributeError:
            pass
    return cached


def _convert_tokens_to_string(tokenizer, tokens: List[str],
                              skip_special_tokens: bool,
                              spaces_between_special_tokens: bool) -> str:
    """Tokens -> text honoring special-token handling (reference
    tokenizer.py _convert_tokens_to_string_with_added_encoders)."""
    sub_texts: List[str] = []
    current_sub: List[str] = []
    all_special, added = _special_sets(tokenizer)
    for token in tokens:
        if skip_special_tokens and token in all_special:
            continue
        if token in added:
            if current_sub:
                sub_texts.append(
                    tokenizer.convert_tokens_to_string(current_sub))
                current_sub = []
            sub_texts.append(token)
        else:
            current_sub.append(token)
    if current_sub:
        sub_texts.append(tokenizer.convert_tokens_to_string(current_sub))
    sep = " " if spaces_between_special_tokens else ""
    return sep.join(sub_texts)


def detokenize_incrementally(
    tokenizer,
    all_token_ids: List[int],
    prev_tokens: Optional[List[str]],
    prefix_offset: int,
    read_offset: int,
    skip_special_tokens: bool = True,
    spaces_between_special_tokens: bool = True,
) -> Tuple[List[str], str, int, int]:
    """Returns (new_tokens, new_text_delta, prefix_offset, read_offset)."""
    if prev_tokens is None:
        # First call: convert everything, position the window at the tail.
        new_tokens = tokenizer.convert_ids_to_tokens(all_token_ids)
        output_tokens = new_tokens
        prefix_offset = max(
            len(output_tokens) - INITIAL_INCREMENTAL_DETOKENIZATION_OFFSET,
            0)
        read_offset = max(len(output_tokens) - 1, 0)
    else:
        new_ids = all_token_ids[len(prev_tokens):]
        new_tokens = tokenizer.convert_ids_to_tokens(new_ids)
        output_tokens = prev_tokens + new_tokens

    prefix_text = _convert_tokens_to_string(
        tokenizer, output_tokens[prefix_offset:read_offset],
        skip_special_tokens, spaces_between_special_tokens)
    new_text = _convert_tokens_to_string(
        tokenizer, output_tokens[prefix_offset:], skip_special_tokens,
        spaces_between_special_tokens)

    if len(new_text) > len(prefix_text) and not new_text.endswith("�"):
        # Complete characters materialized: emit the delta and advance.
        delta = new_text[len(prefix_text):]
        return new_tokens, delta, read_offset, len(output_tokens)
    # Still inside a partial multi-byte character: emit nothing.
    return new_tokens, "", prefix_offset, read_offset
