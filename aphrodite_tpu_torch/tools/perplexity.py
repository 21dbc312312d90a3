"""Perplexity of texts through the engine's prompt-logprobs path
(counterpart of aphrodite_tpu/tools/perplexity.py): the same code path
that serves requests scores each text teacher-forced, so the number
includes what the served configuration does to accuracy (quantized
products, a narrow KV cache).

Usage:
    from aphrodite_tpu_torch.tools.perplexity import evaluate_perplexity
    ppl = evaluate_perplexity(llm, texts)
"""

import math
from typing import Optional, Sequence

from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.sampling_params import SamplingParams

logger = init_logger(__name__)


def evaluate_perplexity(
    llm,
    texts: Sequence[str],
    max_tokens_per_chunk: Optional[int] = None,
) -> float:
    """Mean perplexity over `texts` (teacher-forced, full prompts)."""
    tok = llm.get_tokenizer()
    engine = llm.engine
    limit = max_tokens_per_chunk or engine.model_config.max_model_len
    total_nll = 0.0
    total_tokens = 0
    for text in texts:
        ids = tok.encode(text)[:limit]
        if len(ids) < 2:
            continue
        sp = SamplingParams(temperature=0.0, max_tokens=1,
                            prompt_logprobs=1, detokenize=False)
        out = llm.generate(prompt_token_ids=[ids],
                           sampling_params=sp)[0]
        plp = out.prompt_logprobs
        assert plp is not None and len(plp) == len(ids)
        for pos in range(1, len(ids)):
            total_nll -= plp[pos][ids[pos]].logprob
            total_tokens += 1
    if total_tokens == 0:
        raise ValueError("no tokens scored")
    ppl = math.exp(total_nll / total_tokens)
    logger.info("perplexity: %.4f over %d tokens", ppl, total_tokens)
    return ppl
