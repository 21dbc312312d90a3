"""The port's OpenAI server against the JAX package's, side by side.

Both ``OpenAIServer``s serve the same tiny checkpoint (float32; the port's
engine in this process on the CPU) through aiohttp's test client. Greedy
text and chat text must be equal, token logprobs within 1e-4, streamed
chunks joined equal to the non-streamed text, tokenize/detokenize equal,
and the invalid requests, key and admin gates answer as the JAX server's.
The routes and fields whose engine feature the port lacks answer an error
that names it.
"""

import json

import pytest

pytest_plugins = "aiohttp.pytest_plugin"

from aphrodite_tpu.engine.args import EngineArgs as JaxEngineArgs
from aphrodite_tpu.engine.async_engine import \
    AsyncAphrodite as JaxAsyncAphrodite
from aphrodite_tpu.endpoints.openai.api_server import \
    OpenAIServer as JaxOpenAIServer
from aphrodite_tpu_torch.engine.args import EngineArgs
from aphrodite_tpu_torch.engine.async_engine import AsyncAphrodite
from aphrodite_tpu_torch.endpoints.openai.api_server import OpenAIServer
from aphrodite_tpu_torch.endpoints.openai.protocol import (
    ChatCompletionResponse, ChatCompletionStreamResponse, CompletionResponse)

ENGINE_KW = dict(dtype="float32", max_num_seqs=8,
                 num_device_blocks_override=128, block_size=8,
                 num_scheduler_steps=4)
LOGPROB_TOL = 1e-4


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    from tests.utils import make_tiny_llama_checkpoint

    path = tmp_path_factory.mktemp("tiny_llama_api_torch")
    make_tiny_llama_checkpoint(str(path))
    return str(path)


def port_server(tiny_dir, **kw):
    args = EngineArgs(model=tiny_dir, device="cpu", **ENGINE_KW)
    return OpenAIServer(AsyncAphrodite.from_engine_args(args),
                        served_model_names=["tiny"], engine_args=args, **kw)


@pytest.fixture()
async def clients(tiny_dir, aiohttp_client):
    """(JAX client, port client) on the same checkpoint."""
    jax_engine = JaxAsyncAphrodite.from_engine_args(
        JaxEngineArgs(model=tiny_dir, **ENGINE_KW))
    jax = JaxOpenAIServer(jax_engine, served_model_names=["tiny"])
    return (await aiohttp_client(jax.build_app()),
            await aiohttp_client(port_server(tiny_dir).build_app()))


@pytest.fixture()
async def client(tiny_dir, aiohttp_client):
    return await aiohttp_client(port_server(tiny_dir).build_app())


async def _post_both(clients, route, body):
    out = []
    for c in clients:
        resp = await c.post(route, json=body)
        assert resp.status == 200, await resp.text()
        out.append(await resp.json())
    return out


async def _sse(client, route, body):
    resp = await client.post(route, json=body)
    assert resp.status == 200, await resp.text()
    text = await resp.text()
    lines = [line[len("data: "):] for line in text.splitlines()
             if line.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    return [json.loads(line) for line in lines[:-1]]


GREEDY = dict(model="tiny", max_tokens=10, temperature=0, ignore_eos=True)


async def test_greedy_completion_matches_jax(clients):
    body = dict(GREEDY, prompt="the quick brown fox", logprobs=2)
    want, got = await _post_both(clients, "/v1/completions", body)
    CompletionResponse(**got)
    w, g = want["choices"][0], got["choices"][0]
    assert g["text"] == w["text"] and g["finish_reason"] == "length"
    assert got["usage"] == want["usage"]
    assert g["logprobs"]["tokens"] == w["logprobs"]["tokens"]
    for a, b in zip(g["logprobs"]["token_logprobs"],
                    w["logprobs"]["token_logprobs"]):
        assert abs(a - b) <= LOGPROB_TOL
    for a, b in zip(g["logprobs"]["top_logprobs"],
                    w["logprobs"]["top_logprobs"]):
        assert a.keys() == b.keys()
        assert all(abs(a[k] - b[k]) <= LOGPROB_TOL for k in a)
    # Streamed, the same request's chunks join to the same text.
    for c in clients:
        chunks = await _sse(c, "/v1/completions",
                            dict(body, stream=True, logprobs=None))
        for ch in chunks:
            CompletionResponse(**ch)
        assert "".join(ch["choices"][0]["text"] for ch in chunks) == \
            w["text"]
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"


async def test_batch_and_token_prompts_match_jax(clients):
    for prompt in (["hello", "world"], [5, 6, 7]):
        want, got = await _post_both(clients, "/v1/completions",
                                     dict(GREEDY, prompt=prompt))
        assert [c["text"] for c in got["choices"]] == \
            [c["text"] for c in want["choices"]]


async def test_chat_fallback_template_matches_jax(clients):
    body = dict(GREEDY, messages=[
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": [{"type": "text", "text": "hello "},
                                     {"type": "text", "text": "world"}]}])
    want, got = await _post_both(clients, "/v1/chat/completions", body)
    ChatCompletionResponse(**got)
    assert got["choices"][0]["message"] == want["choices"][0]["message"]
    assert got["usage"] == want["usage"]
    text = want["choices"][0]["message"]["content"]
    for c in clients:
        chunks = await _sse(c, "/v1/chat/completions",
                            dict(body, stream=True))
        for ch in chunks:
            ChatCompletionStreamResponse(**ch)
        assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
        assert "".join(ch["choices"][0]["delta"]["content"] or ""
                       for ch in chunks) == text


async def test_tokenize_detokenize_match_jax(clients):
    for body in ({"prompt": "hello world"},
                 {"messages": [{"role": "user", "content": "hi"}]}):
        want, got = await _post_both(clients, "/v1/tokenize", body)
        assert got == want
        want, got = await _post_both(clients, "/v1/detokenize",
                                     {"tokens": got["tokens"]})
        assert got == want


@pytest.mark.parametrize("route,body", [
    ("/v1/completions", {"prompt": "x", "temperature": -3}),
    ("/v1/completions", {"prompt": [], "max_tokens": 2}),
    ("/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 4,
                         "logit_bias": {"not_an_int": 5}}),
    ("/v1/completions", {"prompt": "x", "top_p": 0.0}),
    ("/v1/chat/completions", {"messages": "not a list"}),
])
async def test_invalid_requests_400(clients, route, body):
    for c in clients:
        resp = await c.post(route, json=body)
        assert resp.status == 400, (c, await resp.text())
        assert (await resp.json())["error"]["code"] == 400


async def test_key_and_admin_gates(tiny_dir, aiohttp_client):
    jax = JaxOpenAIServer(
        JaxAsyncAphrodite.from_engine_args(
            JaxEngineArgs(model=tiny_dir, **ENGINE_KW)),
        served_model_names=["tiny"], api_keys=["sekrit"],
        admin_key="root-key")
    port = port_server(tiny_dir, api_keys=["sekrit"], admin_key="root-key")
    key = {"Authorization": "Bearer sekrit"}
    for server in (jax, port):
        c = await aiohttp_client(server.build_app())
        assert (await c.post("/v1/completions", json={
            "prompt": "hi", "max_tokens": 1})).status == 401
        assert (await c.post("/api/v1/generate", json={
            "prompt": "hi", "max_length": 1})).status == 401
        assert (await c.get("/health")).status == 200
        assert (await c.post("/v1/completions", json={
            "prompt": "hi", "max_tokens": 1, "ignore_eos": True},
            headers=key)).status == 200
        for route in ("/v1/lora/load", "/v1/lora/unload",
                      "/v1/soft_prompt/load", "/v1/model/unload",
                      "/v1/profile/start"):
            resp = await c.post(route, json={}, headers=key)
            assert resp.status == 401, route
    # Keyed without an admin key: admin routes are disabled.
    c = await aiohttp_client(
        port_server(tiny_dir, api_keys=["sekrit"]).build_app())
    assert (await c.post("/v1/model/unload", json={},
                         headers=key)).status == 401


async def test_engine_stats(client):
    resp = await client.post("/v1/completions", json=dict(
        GREEDY, prompt="hi there"))
    assert resp.status == 200
    data = await (await client.get("/v1/internal/engine_stats")).json()
    assert data["iterations"] >= 1 and data["execute_s"] > 0
    assert data["decode_tokens"] + data["prefill_tokens"] > 0
    for key in ("avg_schedule_ms", "avg_execute_ms", "avg_postprocess_ms",
                "graph_replays", "graph_captures"):
        assert key in data
    # No card, no graphs.
    assert data["graph_replays"] == 0


async def test_meta_routes(client):
    assert (await client.get("/health")).status == 200
    models = await (await client.get("/v1/models")).json()
    assert models["data"][0]["id"] == "tiny"
    assert "version" in await (await client.get("/version")).json()
    assert (await client.get("/")).status == 200
    info = await (await client.get("/.well-known/serviceinfo")).json()
    assert info["api"]["openai"]["rel_url"] == "/v1"
    await client.post("/v1/completions", json=dict(GREEDY, prompt="hi"))
    metrics = await (await client.get("/metrics")).text()
    assert "aphrodite:generation_tokens_total" in metrics


IMAGE = {"type": "image_url", "image_url": {"url": "data:image/png;base64,"}}
AUDIO = {"type": "input_audio", "input_audio": {"data": ""}}


@pytest.mark.parametrize("route,body,named", [
    ("/v1/embeddings", {"input": "hello"}, "pooling"),
    ("/v1/lora/load", {"lora_name": "x", "lora_path": "/p"}, "LoRA"),
    ("/v1/lora/unload", {"lora_name": "x"}, "LoRA"),
    ("/v1/soft_prompt/load", {"soft_prompt_name": "x",
                              "soft_prompt_path": "/p"}, "soft prompts"),
    ("/v1/soft_prompt/unload", {"soft_prompt_name": "x"}, "soft prompts"),
    ("/v1/chat/completions", {"messages": [
        {"role": "user", "content": [{"type": "text", "text": "see"},
                                     IMAGE]}]}, "image_url"),
    ("/v1/chat/completions", {"messages": [
        {"role": "user", "content": [AUDIO]}]}, "input_audio"),
    ("/v1/model/load", {"enable_lora": True}, "LoRA"),
])
async def test_unported_routes_and_fields_answer_an_error(client, route,
                                                          body, named):
    resp = await client.post(route, json=body)
    assert resp.status == 400
    message = (await resp.json())["error"]["message"]
    assert named in message and "not ported" in message


async def test_beam_search_over_http_matches_engine(tiny_dir, client):
    """use_beam_search reaches the engine: the hypotheses equal the port
    LLM's (which tests/test_torch_beam_search.py holds to JAX)."""
    from aphrodite_tpu_torch import LLM, SamplingParams

    body = dict(model="tiny", prompt="the quick brown", max_tokens=6,
                temperature=0, use_beam_search=True, best_of=4, n=2,
                ignore_eos=True)
    resp = await client.post("/v1/completions", json=body)
    assert resp.status == 200, await resp.text()
    got = [c["text"] for c in (await resp.json())["choices"]]
    want = LLM(model=tiny_dir, device="cpu", **ENGINE_KW).generate(
        ["the quick brown"], SamplingParams(
            use_beam_search=True, best_of=4, n=2, temperature=0.0,
            max_tokens=6, ignore_eos=True))[0]
    assert got == [c.text for c in want.outputs]


async def test_profile_routes_write_a_trace(client, tmp_path):
    d = tmp_path / "trace"
    resp = await client.post("/v1/profile/start", json={"dir": str(d)})
    assert resp.status == 200, await resp.text()
    assert (await client.post("/v1/completions", json=dict(
        GREEDY, prompt="trace me"))).status == 200
    resp = await client.post("/v1/profile/stop", json={})
    assert resp.status == 200, await resp.text()
    assert (d / "trace.json").stat().st_size > 0


async def test_model_unload_and_load(client):
    assert (await client.post("/v1/model/unload", json={})).status == 200
    assert (await client.get("/health")).status == 503
    assert (await client.post("/v1/completions", json={
        "prompt": "x", "max_tokens": 2})).status == 503
    resp = await client.post("/v1/model/load", json={"max_num_seqs": 4})
    assert resp.status == 200, await resp.text()
    resp = await client.post("/v1/completions", json=dict(GREEDY,
                                                          prompt="hello"))
    assert resp.status == 200, await resp.text()
