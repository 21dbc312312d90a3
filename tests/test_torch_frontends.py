"""The port's other frontends against the JAX package's, on the CPU: the
KoboldAI routes, the OpenAI batch runner, the CLI, the async engine's
concurrent and aborted streams, and ``python -m aphrodite_tpu_torch run``
with its engine in a child process."""

import argparse
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

pytest_plugins = "aiohttp.pytest_plugin"

from aphrodite_tpu.engine.args import EngineArgs as JaxEngineArgs
from aphrodite_tpu.engine.async_engine import \
    AsyncAphrodite as JaxAsyncAphrodite
from aphrodite_tpu.endpoints.openai.api_server import \
    OpenAIServer as JaxOpenAIServer
from aphrodite_tpu_torch import SamplingParams
from aphrodite_tpu_torch.endpoints import cli
from aphrodite_tpu_torch.engine.args import EngineArgs
from aphrodite_tpu_torch.engine.async_engine import AsyncAphrodite
from aphrodite_tpu_torch.endpoints.openai.api_server import OpenAIServer

ENGINE_KW = dict(dtype="float32", max_num_seqs=8,
                 num_device_blocks_override=128, block_size=8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    from tests.utils import make_tiny_llama_checkpoint

    path = str(tmp_path_factory.mktemp("tiny_llama_fe_torch"))
    make_tiny_llama_checkpoint(path)
    return path


@pytest.fixture()
async def clients(tiny_dir, aiohttp_client):
    jax = JaxOpenAIServer(JaxAsyncAphrodite.from_engine_args(
        JaxEngineArgs(model=tiny_dir, **ENGINE_KW)),
        served_model_names=["tiny"])
    port = OpenAIServer(AsyncAphrodite.from_engine_args(
        EngineArgs(model=tiny_dir, device="cpu", **ENGINE_KW)),
        served_model_names=["tiny"])
    return (await aiohttp_client(jax.build_app()),
            await aiohttp_client(port.build_app()))


KOBOLD = {"prompt": "hello world", "max_length": 8, "temperature": 0,
          "use_default_badwordsids": True}


async def test_kobold_generate_and_stream_match_jax(clients):
    texts = []
    for c in clients:
        resp = await c.post("/api/v1/generate", json=KOBOLD)
        assert resp.status == 200, await resp.text()
        texts.append((await resp.json())["results"][0]["text"])
        resp = await c.post("/api/extra/generate/stream", json=KOBOLD)
        body = await resp.text()
        tokens = [json.loads(line[len("data: "):])["token"]
                  for line in body.splitlines() if line.startswith("data: ")]
        assert "event: message" in body
        assert "".join(tokens) == texts[-1]
    assert texts[0] == texts[1]
    for route in ("/api/v1/model", "/api/v1/config/max_context_length",
                  "/api/v1/config/max_length", "/api/v1/info/version"):
        got = [await (await c.get(route)).json() for c in clients]
        assert got[0] == got[1], route
    got = [await (await c.post("/api/extra/tokencount",
                               json={"prompt": "hello world"})).json()
           for c in clients]
    assert got[0] == got[1]


def test_run_batch_matches_jax(tiny_dir, tmp_path):
    from aphrodite_tpu.endpoints.openai.run_batch import \
        run_batch as jax_run_batch
    from aphrodite_tpu_torch.endpoints.openai.run_batch import run_batch

    lines = [
        {"custom_id": "a", "method": "POST", "url": "/v1/completions",
         "body": {"prompt": "hello", "max_tokens": 4, "temperature": 0,
                  "ignore_eos": True}},
        {"custom_id": "b", "method": "POST", "url": "/v1/chat/completions",
         "body": {"messages": [{"role": "user", "content": "hi"}],
                  "max_tokens": 4, "temperature": 0, "ignore_eos": True}},
        {"custom_id": "c", "method": "POST", "url": "/v1/nope", "body": {}},
    ]
    src = tmp_path / "in.jsonl"
    src.write_text("\n".join(json.dumps(line) for line in lines))
    results = []
    for fn, args in (
            (jax_run_batch, JaxEngineArgs(model=tiny_dir, **ENGINE_KW)),
            (run_batch, EngineArgs(model=tiny_dir, device="cpu",
                                   **ENGINE_KW))):
        out = tmp_path / f"out_{len(results)}.jsonl"
        assert asyncio.run(fn(args, str(src), str(out))) == 1
        by_id = {}
        for line in out.read_text().splitlines():
            r = json.loads(line)
            by_id[r["custom_id"]] = r
        results.append(by_id)
    jax, port = results
    assert port["c"]["error"] is not None and port["c"]["response"] is None
    a = [r["response"]["body"]["choices"][0]["text"]
         for r in (jax["a"], port["a"])]
    b = [r["response"]["body"]["choices"][0]["message"]["content"]
         for r in (jax["b"], port["b"])]
    assert a[0] == a[1] and b[0] == b[1]


def test_engine_args_cli_types():
    parser = argparse.ArgumentParser()
    parser.add_argument("model")
    EngineArgs.add_cli_args(parser)
    args = parser.parse_args([
        "/m", "--block-size", "32", "--hbm-utilization", "0.8",
        "--enable-prefix-caching", "--max-num-seqs", "64",
        "--kv-cache-dtype", "fp8", "--num-scheduler-steps", "8",
        "--device", "cpu", "--max-model-len", "512",
    ])
    ea = EngineArgs.from_cli_args(args)
    ea.model = args.model
    assert (ea.block_size, ea.max_num_seqs, ea.num_scheduler_steps,
            ea.max_model_len) == (32, 64, 8, 512)
    assert abs(ea.hbm_utilization - 0.8) < 1e-9
    assert ea.enable_prefix_caching is True
    assert (ea.kv_cache_dtype, ea.device) == ("fp8", "cpu")
    assert EngineArgs.from_cli_args(parser.parse_args(["/m"])).device == \
        "cuda"


@pytest.mark.parametrize("argv", [
    ["/m", "--enable-lora"],
    ["/m", "--tensor-parallel-size", "2"],
    ["/m", "--speculative-model", "[ngram]"],
])
def test_unported_engine_flags_raise(argv, capsys):
    parser = argparse.ArgumentParser()
    parser.add_argument("model")
    EngineArgs.add_cli_args(parser)
    with pytest.raises(SystemExit):
        parser.parse_args(argv)
    assert "not ported" in capsys.readouterr().err


def test_cli_subcommands():
    for argv in (["run"], []):
        with pytest.raises(SystemExit):
            cli.main(argv)  # missing model / missing subcommand
    with pytest.raises(NotImplementedError, match="save-sharded-state"):
        cli.main(["save-sharded-state"])


def test_yaml_config_translation(tmp_path, monkeypatch):
    import yaml

    cfg = {"model": "/some/model", "block_size": 32,
           "enable_prefix_caching": True, "max_num_seqs": 16,
           "device": "cpu"}
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    captured = {}
    monkeypatch.setattr(cli, "_run", lambda args: captured.update(vars(args)))
    cli.main(["yaml", str(path)])
    assert captured["model"] == "/some/model"
    assert captured["block_size"] == 32
    assert captured["enable_prefix_caching"] is True
    assert captured["max_num_seqs"] == 16
    assert captured["device"] == "cpu"
    path.write_text(yaml.safe_dump(dict(cfg, enable_lora=True)))
    with pytest.raises(SystemExit):
        cli.main(["yaml", str(path)])


async def _stream_tokens(engine, rid, prompt, sp, abort_after=None):
    """The request's token ids as its stream ends; with abort_after, the
    stream is aborted once that many tokens have arrived."""
    toks = []
    async for out in engine.generate(rid, prompt=prompt, sampling_params=sp):
        toks = out.outputs[0].token_ids
        if abort_after is not None and len(toks) >= abort_after:
            await engine.abort(rid)
            break
    return toks


def test_async_streams_match_alone_and_survive_an_abort(tiny_dir):
    """Concurrent greedy streams equal the same requests run alone; one
    stream aborted after its first window (while the engine chains
    windows) leaves the others' tokens unchanged."""
    prompts = ["the quick brown fox", "hello world, this is",
               "one two three four five", "six seven"]
    sp = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    engine = AsyncAphrodite.from_engine_args(EngineArgs(
        model=tiny_dir, device="cpu", num_scheduler_steps=4, **ENGINE_KW))

    async def run():
        alone = [await _stream_tokens(engine, f"alone{i}", p, sp)
                 for i, p in enumerate(prompts)]
        together = await asyncio.gather(*[
            _stream_tokens(engine, f"all{i}", p, sp)
            for i, p in enumerate(prompts)])
        aborted = await asyncio.gather(*[
            _stream_tokens(engine, f"ab{i}", p, sp,
                           abort_after=4 if i == 1 else None)
            for i, p in enumerate(prompts)])
        # The engine holds nothing of the aborted request afterwards.
        assert not await engine.utility("has_unfinished_requests")
        return alone, together, aborted

    hits0 = engine.engine.runner.chained_window_hits
    alone, together, aborted = asyncio.run(run())
    engine.shutdown()
    assert together == alone
    assert all(len(t) == 24 for t in alone)
    assert 4 <= len(aborted[1]) < 24
    assert aborted[1] == alone[1][:len(aborted[1])]
    for i in (0, 2, 3):
        assert aborted[i] == alone[i]
    assert engine.engine.runner.chained_window_hits > hits0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _status(url: str) -> int:
    try:
        return urllib.request.urlopen(url, timeout=2).status
    except urllib.error.HTTPError as e:
        return e.code


def _run_cmd(tiny_dir, port, log, *extra, **env):
    return subprocess.Popen(
        [sys.executable, "-m", "aphrodite_tpu_torch", "run", tiny_dir,
         "--port", str(port), "--dtype", "float32",
         "--num-device-blocks-override", "64", "--block-size", "8",
         *extra],
        env=dict(os.environ, PYTHONPATH=REPO, **env),
        stdout=subprocess.DEVNULL, stderr=log)


def test_cli_serve_isolates_engine(tiny_dir, tmp_path):
    """`run --device cpu` with default flags puts the engine in a child
    process, whose metrics /metrics serves: killing it turns /health into
    5xx while /v1/models stays up; SIGINT then stops the frontend."""
    port = _free_port()
    log = tmp_path / "serve.log"
    proc = _run_cmd(tiny_dir, port, log.open("w"), "--device", "cpu")
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if _status(base + "/health") == 200:
                    break
            except (urllib.error.URLError, OSError):
                pass
            assert time.monotonic() < deadline, "server never came up"
            assert proc.poll() is None, log.read_text()[-2000:]
            time.sleep(0.5)
        # The engine's metrics, read in its process.
        req = urllib.request.Request(
            base + "/v1/completions", data=json.dumps({
                "prompt": "hello", "max_tokens": 2, "ignore_eos": True,
                "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"})
        assert urllib.request.urlopen(req, timeout=30).status == 200
        metrics = urllib.request.urlopen(base + "/metrics", timeout=10)
        assert b"aphrodite:generation_tokens_total" in metrics.read()
        out = subprocess.run(["ps", "-o", "pid=", "--ppid", str(proc.pid)],
                             capture_output=True, text=True)
        children = [int(p) for p in out.stdout.split()]
        assert children, "no engine child under default flags"
        for pid in children:
            os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 15
        while _status(base + "/health") < 500:
            assert time.monotonic() < deadline, "health never turned 5xx"
            time.sleep(0.2)
        assert _status(base + "/v1/models") == 200
        assert proc.poll() is None
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_cli_serve_without_card_exits_nonzero(tiny_dir, tmp_path):
    """Without --device cpu the engine child asks for the card; with none
    (none is visible), `run` exits non-zero and serves nothing."""
    log = tmp_path / "serve.log"
    proc = _run_cmd(tiny_dir, _free_port(), log.open("w"),
                    CUDA_VISIBLE_DEVICES="")
    try:
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc != 0
    assert "no CUDA device" in log.read_text()


def test_incremental_text_with_special_tokens(tiny_dir):
    """Streamed text over a prompt and an output that hold special tokens
    (<s> 0, </s> 1) equals the whole output decoded at once: each id is
    converted once (the JAX package's copy converts ids again after a
    special token and repeats them)."""
    from aphrodite_tpu_torch.transformers_utils.detokenizer import \
        detokenize_incrementally
    from aphrodite_tpu_torch.transformers_utils.tokenizer import \
        get_tokenizer

    tok = get_tokenizer(tiny_dir)
    prompt = [0, *tok.encode("hello world"), 1]
    output = [40, 0, 41, 42, 1, 43]
    ids, pieces, offsets, text = list(prompt), None, (0, 0), ""
    for step in (output[:1], output[1:3], output[3:4], output[4:]):
        ids += step
        new, delta, *offsets = detokenize_incrementally(
            tok, ids, pieces, *offsets)
        pieces = new if pieces is None else pieces + new
        text += delta
    assert len(pieces) == len(ids)
    assert text == tok.decode(output, skip_special_tokens=True)
