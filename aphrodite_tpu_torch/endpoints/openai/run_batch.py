"""OpenAI batch-file runner (counterpart of
aphrodite_tpu/endpoints/openai/run_batch.py).

Input: JSONL of {"custom_id", "method", "url", "body"} where url is
/v1/chat/completions or /v1/completions; output: JSONL of
{"id", "custom_id", "response", "error"}.
"""

import asyncio
import json
from typing import List

from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.engine.args import EngineArgs
from aphrodite_tpu_torch.engine.async_engine import AsyncAphrodite
from aphrodite_tpu_torch.endpoints.openai.protocol import (
    ChatCompletionRequest, CompletionRequest, random_uuid)

logger = init_logger(__name__)


async def run_batch(engine_args: EngineArgs, input_path: str,
                    output_path: str) -> int:
    """Process every line; returns the number of failed requests. The
    engine runs in this process, on its own thread."""
    from aphrodite_tpu_torch.endpoints.openai.api_server import OpenAIServer

    async_engine = AsyncAphrodite.from_engine_args(engine_args)
    server = OpenAIServer(async_engine)
    failures = 0
    results: List[str] = []
    with open(input_path) as f:
        lines = [json.loads(l) for l in f if l.strip()]

    async def one(item):
        nonlocal failures
        custom_id = item.get("custom_id")
        url = item.get("url", "")
        body = item.get("body", {})
        try:
            if url.endswith("/chat/completions"):
                req = ChatCompletionRequest(**body)
                prompt_text = server._apply_chat_template(req.messages)
                prompt_ids = server.tokenizer.encode(prompt_text)
                sp = req.to_sampling_params(
                    server.model_config.max_model_len - len(prompt_ids))
                stream = await async_engine.add_request(
                    f"batch-{random_uuid()}", prompt=prompt_text,
                    sampling_params=sp, prompt_token_ids=prompt_ids)
                final = await server._collect(stream)
                response = {
                    "status_code": 200,
                    "body": {
                        "id": f"chatcmpl-{random_uuid()}",
                        "object": "chat.completion",
                        "choices": [{
                            "index": i,
                            "message": {"role": "assistant",
                                        "content": c.text},
                            "finish_reason": c.finish_reason,
                        } for i, c in enumerate(final.outputs)],
                    },
                }
            elif url.endswith("/completions"):
                req = CompletionRequest(**body)
                prompt = req.prompt if isinstance(req.prompt, str) else \
                    req.prompt[0]
                prompt_ids = server.tokenizer.encode(prompt)
                sp = req.to_sampling_params(
                    server.model_config.max_model_len - len(prompt_ids))
                stream = await async_engine.add_request(
                    f"batch-{random_uuid()}", prompt=prompt,
                    sampling_params=sp, prompt_token_ids=prompt_ids)
                final = await server._collect(stream)
                response = {
                    "status_code": 200,
                    "body": {
                        "id": f"cmpl-{random_uuid()}",
                        "object": "text_completion",
                        "choices": [{
                            "index": i,
                            "text": c.text,
                            "finish_reason": c.finish_reason,
                        } for i, c in enumerate(final.outputs)],
                    },
                }
            else:
                raise ValueError(f"unsupported url {url!r}")
            return json.dumps({
                "id": f"batch-{random_uuid()}",
                "custom_id": custom_id,
                "response": response,
                "error": None,
            })
        except Exception as e:
            failures += 1
            return json.dumps({
                "id": f"batch-{random_uuid()}",
                "custom_id": custom_id,
                "response": None,
                "error": {"message": str(e)},
            })

    try:
        results = await asyncio.gather(*[one(item) for item in lines])
    finally:
        async_engine.shutdown()
    with open(output_path, "w") as f:
        for line in results:
            f.write(line + "\n")
    logger.info("batch complete: %d requests, %d failures", len(lines),
                failures)
    return failures
