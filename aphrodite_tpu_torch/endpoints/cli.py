"""CLI (counterpart of aphrodite_tpu/endpoints/cli.py):
`python -m aphrodite_tpu_torch run <model>` starts the OpenAI server on
port 2242, its engine in a child process on the card (`--device cpu`
for the CPU); `complete` and `chat` talk to a running server, `yaml`
serves from a config file, `run-batch` runs an OpenAI batch file.
Multi-host serving and `save-sharded-state` are not ported yet.
"""

import argparse
import asyncio
import os
import sys

from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.engine.args import EngineArgs

logger = init_logger(__name__)


def _add_serve_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("model", type=str, help="model directory")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=2242)
    parser.add_argument("--served-model-name", type=str, default=None)
    parser.add_argument("--engine-replicas", type=int, default=1,
                        help="data-parallel engine replicas; above 1 is "
                             "not ported yet")
    parser.add_argument("--engine-subprocess", action="store_true",
                        default=None,
                        help="run the engine (and every CUDA context) in "
                             "a child process, so that an engine crash "
                             "cannot kill the HTTP frontend; the default")
    parser.add_argument("--no-engine-subprocess", dest="engine_subprocess",
                        action="store_false",
                        help="run the engine in-process with the HTTP "
                             "server (single process; an engine crash "
                             "kills serving)")
    parser.add_argument("--warmup", action="store_true",
                        help="capture every sequence bucket's decode-"
                             "window graphs before serving: a slower "
                             "start, no capture under live load")
    parser.add_argument("--api-keys", type=str, default=None,
                        help="comma-separated list of accepted API keys")
    parser.add_argument("--admin-key", type=str, default=None,
                        help="key required by admin routes (model/lora/"
                             "soft-prompt load-unload); falls back to "
                             "APHRODITE_ADMIN_KEY. When --api-keys is set "
                             "without an admin key, admin routes are "
                             "disabled.")
    EngineArgs.add_cli_args(parser)


def _run(args: argparse.Namespace) -> None:
    from aphrodite_tpu_torch.endpoints.openai.api_server import run_server

    engine_args = EngineArgs.from_cli_args(args)
    engine_args.model = args.model
    if int(os.environ.get("APHRODITE_NUM_HOSTS", "1")) > 1:
        raise NotImplementedError(
            "multi-host serving is not ported to the PyTorch package yet "
            "(ROADMAP.md, module queue: parallelism)")
    served = [args.served_model_name] if args.served_model_name else None
    api_keys = args.api_keys.split(",") if args.api_keys else None
    try:
        asyncio.run(
            run_server(engine_args, host=args.host, port=args.port,
                       served_model_names=served, api_keys=api_keys,
                       admin_key=args.admin_key,
                       engine_in_subprocess=getattr(
                           args, "engine_subprocess", None),
                       engine_replicas=getattr(args, "engine_replicas", 1),
                       warmup=getattr(args, "warmup", False)))
    except KeyboardInterrupt:
        logger.info("server stopped")


def _complete(args: argparse.Namespace) -> None:
    """One-shot completion against a running server (reference
    `aphrodite complete`, endpoints/cli.py)."""
    import json
    import urllib.request

    body = json.dumps({
        "prompt": args.prompt,
        "max_tokens": args.max_tokens,
        "temperature": args.temperature,
    }).encode()
    req = urllib.request.Request(
        f"{args.url}/v1/completions", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as resp:
        data = json.loads(resp.read())
    print(data["choices"][0]["text"])


def _chat(args: argparse.Namespace) -> None:
    """Interactive chat against a running server (reference
    `aphrodite chat`)."""
    import json
    import urllib.request

    messages = []
    print("(interactive chat; ctrl-d to exit)")
    while True:
        try:
            user = input("> ")
        except EOFError:
            break
        messages.append({"role": "user", "content": user})
        body = json.dumps({
            "messages": messages,
            "max_tokens": args.max_tokens,
            "temperature": args.temperature,
        }).encode()
        req = urllib.request.Request(
            f"{args.url}/v1/chat/completions", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            data = json.loads(resp.read())
        reply = data["choices"][0]["message"]["content"]
        messages.append({"role": "assistant", "content": reply})
        print(reply)


def _yaml(args: argparse.Namespace) -> None:
    """Start the server from a YAML config file (reference
    `aphrodite yaml`, cli.py:92-128)."""
    import yaml

    with open(args.config) as f:
        cfg = yaml.safe_load(f) or {}
    argv = [str(cfg.pop("model"))]
    for key, value in cfg.items():
        flag = "--" + str(key).replace("_", "-")
        if isinstance(value, bool):
            if value:
                argv.append(flag)
        else:
            argv += [flag, str(value)]
    parser = argparse.ArgumentParser()
    _add_serve_args(parser)
    _run(parser.parse_args(argv))


def _run_batch_cmd(args: argparse.Namespace) -> None:
    from aphrodite_tpu_torch.endpoints.openai.run_batch import run_batch

    engine_args = EngineArgs.from_cli_args(args)
    engine_args.model = args.model
    failures = asyncio.run(
        run_batch(engine_args, args.input_file, args.output_file))
    raise SystemExit(1 if failures else 0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="aphrodite-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("run", help="start the OpenAI-compatible server")
    _add_serve_args(serve)

    complete = sub.add_parser("complete", help="one-shot completion")
    complete.add_argument("prompt")
    complete.add_argument("--url", default="http://localhost:2242")
    complete.add_argument("--max-tokens", type=int, default=128)
    complete.add_argument("--temperature", type=float, default=0.0)

    chat = sub.add_parser("chat", help="interactive chat")
    chat.add_argument("--url", default="http://localhost:2242")
    chat.add_argument("--max-tokens", type=int, default=256)
    chat.add_argument("--temperature", type=float, default=0.7)

    yaml_cmd = sub.add_parser("yaml", help="serve from a YAML config")
    yaml_cmd.add_argument("config")

    batch = sub.add_parser("run-batch", help="OpenAI batch-file runner")
    batch.add_argument("model")
    batch.add_argument("--input-file", required=True)
    batch.add_argument("--output-file", required=True)
    EngineArgs.add_cli_args(batch)

    sub.add_parser("save-sharded-state",
                   help="not ported yet (ROADMAP.md, module queue: other "
                        "loaders and methods)", add_help=False)

    args = parser.parse_args(argv)
    if args.command == "run":
        _run(args)
    elif args.command == "complete":
        _complete(args)
    elif args.command == "chat":
        _chat(args)
    elif args.command == "yaml":
        _yaml(args)
    elif args.command == "run-batch":
        _run_batch_cmd(args)
    elif args.command == "save-sharded-state":
        raise NotImplementedError(
            "save-sharded-state is not ported to the PyTorch package yet "
            "(ROADMAP.md, module queue: other loaders and methods)")
    else:
        parser.print_help()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
