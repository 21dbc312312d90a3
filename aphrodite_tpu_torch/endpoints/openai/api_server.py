"""OpenAI-compatible HTTP server (counterpart of
aphrodite_tpu/endpoints/openai/api_server.py, default port 2242).

Built on aiohttp. Every route of the JAX server: /health, /v1/models,
/v1/completions and /v1/chat/completions (both with SSE streaming),
/v1/tokenize, /v1/detokenize, /metrics (Prometheus), /version, /,
/.well-known/serviceinfo, /v1/internal/engine_stats, the admin routes
(model load/unload, profile start/stop with torch.profiler) behind the
API-key and admin gates, and the KoboldAI routes. The routes and request
fields whose engine feature the port lacks (LoRA and soft-prompt
load/unload, /v1/embeddings, image and audio chat parts) answer an error
that names it.

The engine runs in a spawned child process by default
(engine/multiproc.py), or in this process on its own thread
(engine/async_engine.py); every engine call goes through the async
engine's ``utility``, so the event loop's thread never touches the card.
"""

import asyncio
import json
import os
from typing import List, Optional, Union

from aiohttp import web

import aphrodite_tpu_torch
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.outputs import RequestOutput
from aphrodite_tpu_torch.engine.args import UNPORTED_ARGS, EngineArgs
from aphrodite_tpu_torch.engine.async_engine import (AsyncAphrodite,
                                                     AsyncEngineDeadError)
from aphrodite_tpu_torch.endpoints.openai.protocol import (
    ChatCompletionChoice, ChatCompletionRequest, ChatCompletionResponse,
    ChatCompletionResponseMessage, ChatCompletionStreamChoice,
    ChatCompletionStreamResponse, ChatMessage, CompletionChoice,
    CompletionRequest, CompletionResponse, DeltaMessage, DetokenizeRequest,
    DetokenizeResponse, ErrorResponse, LogProbsPart, ModelCard, ModelList,
    TokenizeRequest, TokenizeResponse, UsageInfo, random_uuid)
from aphrodite_tpu_torch.endpoints.openai.tool_parsers import \
    parse_tool_calls
from aphrodite_tpu_torch.transformers_utils.tokenizer import \
    apply_chat_template

logger = init_logger(__name__)

DEFAULT_PORT = 2242


def _request_error(e: BaseException) -> web.Response:
    """Map an add_request failure: a dead engine is a 503 (the server
    stays up), any other admission failure a 400."""
    if isinstance(e, AsyncEngineDeadError):
        return _error(f"engine is dead: {e}", status=503,
                      err_type="internal_error")
    return _error(str(e))


def _sse_error(message: str) -> bytes:
    """Mid-stream error event (OpenAI stream error framing)."""
    return (b"data: " + json.dumps({"error": {
        "message": message, "type": "invalid_request_error"}}).encode()
        + b"\n\n")


class RequestFailedError(Exception):
    """A request finished with a request-level error (RequestOutput
    .error, e.g. async guided-FSM compilation failure) — a client
    problem, surfaced as 400 rather than 500."""


def _error(message: str, status: int = 400,
           err_type: str = "invalid_request_error") -> web.Response:
    body = ErrorResponse(message=message, type=err_type,
                         code=status).model_dump()
    return web.json_response({"error": body}, status=status)


def _not_ported(feature: str, waits_for: str) -> str:
    return (f"{feature} is not ported to the PyTorch package yet "
            f"(ROADMAP.md, module queue: {waits_for})")


class OpenAIServer:
    def __init__(self, async_engine,
                 served_model_names: Optional[List[str]] = None,
                 api_keys: Optional[List[str]] = None,
                 launch_kobold_api: bool = True,
                 log_requests: bool = True,
                 engine_args=None, admin_key: Optional[str] = None) -> None:
        self.async_engine = async_engine
        self.engine = async_engine.engine
        self.tokenizer = self.engine.tokenizer
        self.model_config = self.engine.model_config
        self._engine_cls = type(async_engine)
        names = served_model_names or [self.model_config.model]
        self.served_model_names = names
        self.api_keys = api_keys
        self.launch_kobold_api = launch_kobold_api
        self.log_requests = log_requests
        self.engine_args = engine_args
        self.admin_key = admin_key

    # ------------------------------------------------------------------
    # App wiring
    # ------------------------------------------------------------------

    def build_app(self) -> web.Application:
        app = web.Application(
            middlewares=[self._auth_middleware, self._log_middleware])
        app.router.add_get("/health", self.health)
        app.router.add_get("/v1/models", self.show_models)
        app.router.add_post("/v1/completions", self.create_completion)
        app.router.add_post("/v1/chat/completions",
                            self.create_chat_completion)
        app.router.add_post("/v1/embeddings", self.create_embeddings)
        app.router.add_post("/v1/tokenize", self.tokenize)
        app.router.add_post("/v1/detokenize", self.detokenize)
        app.router.add_get("/metrics", self.metrics)
        app.router.add_get("/version", self.version)
        app.router.add_get("/", self.root)
        app.router.add_get("/.well-known/serviceinfo", self.serviceinfo)
        app.router.add_post("/v1/soft_prompt/load", self.load_soft_prompt)
        app.router.add_post("/v1/soft_prompt/unload",
                            self.unload_soft_prompt)
        app.router.add_post("/v1/lora/load", self.load_lora)
        app.router.add_post("/v1/lora/unload", self.unload_lora)
        app.router.add_post("/v1/model/load", self.load_model)
        app.router.add_post("/v1/model/unload", self.unload_model)
        app.router.add_post("/v1/profile/start", self.profile_start)
        app.router.add_post("/v1/profile/stop", self.profile_stop)
        app.router.add_get("/v1/internal/engine_stats", self.engine_stats)
        if self.launch_kobold_api and self.tokenizer is not None:
            from aphrodite_tpu_torch.endpoints.kobold.api_server import \
                KoboldServer

            KoboldServer(self.async_engine,
                         self.served_model_names[0]).add_routes(app)
        return app

    @web.middleware
    async def _log_middleware(self, request: web.Request, handler):
        """Request logging (reference api_server request logger
        middleware; disable with log_requests=False)."""
        import time as _time

        t0 = _time.monotonic()
        try:
            response = await handler(request)
            status = getattr(response, "status", "?")
            return response
        except Exception:
            status = 500
            raise
        finally:
            if self.log_requests and request.path != "/health":
                logger.info("%s %s -> %s (%.1f ms)", request.method,
                            request.path, status,
                            (_time.monotonic() - t0) * 1e3)

    @web.middleware
    async def _auth_middleware(self, request: web.Request, handler):
        """API-key gate over both the OpenAI (/v1) and KoboldAI (/api)
        surfaces (the reference middleware covers both; OPTIONS preflight
        is exempt, matching reference api_server auth)."""
        if (self.api_keys and request.method != "OPTIONS"
                and request.path.startswith(("/v1", "/api"))):
            auth = request.headers.get("Authorization", "")
            token = auth.removeprefix("Bearer ").strip()
            if token not in self.api_keys:
                return _error("invalid API key", status=401,
                              err_type="authentication_error")
        return await handler(request)

    # ------------------------------------------------------------------
    # Simple routes
    # ------------------------------------------------------------------

    async def _eng(self, name, *args, **kwargs):
        """Call an engine method on the engine's own thread (in-process)
        or in its child process: both async engines' ``utility``."""
        return await self.async_engine.utility(name, *args, **kwargs)

    async def health(self, request: web.Request) -> web.Response:
        if self.async_engine is None:
            return web.json_response({"status": "no model loaded"},
                                     status=503)
        try:
            await self.async_engine.check_health()
        except Exception as e:
            return web.json_response({"status": "dead", "error": str(e)},
                                     status=500)
        return web.Response(status=200)

    async def version(self, request: web.Request) -> web.Response:
        return web.json_response(
            {"version": aphrodite_tpu_torch.__version__})

    async def show_models(self, request: web.Request) -> web.Response:
        cards = [ModelCard(id=n, root=self.model_config.model)
                 for n in self.served_model_names]
        return web.json_response(ModelList(data=cards).model_dump())

    async def metrics(self, request: web.Request) -> web.Response:
        """The engine's Prometheus metrics, read in the engine's process
        (the JAX server reads its own process's registry, which is empty
        when the engine runs in a child)."""
        data = b"" if self.engine is None else \
            await self._eng("prometheus_metrics")
        return web.Response(body=data, content_type="text/plain",
                            charset="utf-8")

    async def create_embeddings(self, request: web.Request) -> web.Response:
        return _error(_not_ported("/v1/embeddings (the pooling runner)",
                                  "the rest of the zoo"))

    def _check_admin(self, request: web.Request) -> Optional[web.Response]:
        """Gate for admin routes (model/lora/soft-prompt load-unload).

        Reference semantics (api_server.py:315): admin routes require the
        admin key; when the server is key-protected but no admin key was
        configured, admin operations are DISABLED rather than open.
        Only a completely unauthenticated dev server (no api_keys, no
        admin_key) allows them without a key.
        """
        if self.admin_key is None:
            if self.api_keys:
                return _error(
                    "admin operations disabled (no --admin-key set)",
                    status=401, err_type="authentication_error")
            return None
        key = request.headers.get("x-admin-key") or \
            request.headers.get("Authorization", "").removeprefix(
                "Bearer ").strip()
        if key != self.admin_key:
            return _error("admin key required", status=401,
                          err_type="authentication_error")
        return None

    async def load_model(self, request: web.Request) -> web.Response:
        """Hot-swap the served model (reference /v1/model/load,
        api_server.py:315: admin-gated engine rebuild)."""
        denied = self._check_admin(request)
        if denied is not None:
            return denied
        if self.engine_args is None:
            return _error("server started without reloadable engine args",
                          status=400)
        try:
            body = await request.json()
        except Exception as e:
            return _error(str(e))
        if (self.engine is not None
                and self.engine.has_unfinished_requests()):
            return _error("requests in flight; drain before reloading",
                          status=409)
        import copy
        import gc

        unported = sorted(k for k in body if k in UNPORTED_ARGS)
        if unported:
            return _error(_not_ported(
                f"engine arguments {unported}",
                ", ".join(sorted({UNPORTED_ARGS[k] for k in unported}))))
        new_args = copy.deepcopy(self.engine_args)
        for k, v in body.items():
            if hasattr(new_args, k):
                setattr(new_args, k, v)
        loop = asyncio.get_event_loop()
        # Free the old engine's device memory first.
        if self.async_engine is not None:
            self.async_engine.shutdown()
        self.async_engine = None
        self.engine = None
        gc.collect()
        try:
            new_engine = await loop.run_in_executor(
                None, lambda: self._engine_cls.from_engine_args(new_args))
        except Exception as e:
            return _error(f"model load failed: {e}", status=500,
                          err_type="internal_error")
        self.async_engine = new_engine
        self.engine = new_engine.engine
        self.tokenizer = self.engine.tokenizer
        self.model_config = self.engine.model_config
        self.engine_args = new_args
        self.served_model_names = [body.get("served_model_name")
                                   or new_args.model]
        return web.json_response({"status": "ok",
                                  "model": new_args.model})

    async def unload_model(self, request: web.Request) -> web.Response:
        denied = self._check_admin(request)
        if denied is not None:
            return denied
        import gc

        if self.async_engine is not None:
            self.async_engine.shutdown()
        self.async_engine = None
        self.engine = None
        gc.collect()
        return web.json_response({"status": "ok", "unloaded": True})

    async def profile_start(self, request: web.Request) -> web.Response:
        """Admin route: begin a torch.profiler trace of the engine. Body:
        {"dir": <directory>} (optional; defaults to a temporary one);
        /v1/profile/stop writes trace.json there (Chrome trace format)."""
        denied = self._check_admin(request)
        if denied is not None:
            return denied
        import tempfile

        try:
            body = await request.json()
        except Exception:
            body = {}
        trace_dir = body.get("dir") or tempfile.mkdtemp(
            prefix="aphrodite_trace_")
        try:
            await self._eng("profile_start", trace_dir)
        except Exception as e:
            return _error(f"trace start failed: {e}", status=409)
        self._trace_dir = trace_dir
        return web.json_response({"status": "ok", "dir": trace_dir})

    async def profile_stop(self, request: web.Request) -> web.Response:
        denied = self._check_admin(request)
        if denied is not None:
            return denied
        try:
            await self._eng("profile_stop")
        except Exception as e:
            return _error(f"trace stop failed: {e}", status=409)
        return web.json_response({
            "status": "ok", "dir": getattr(self, "_trace_dir", None)})

    async def engine_stats(self, request: web.Request) -> web.Response:
        """Per-phase engine iteration timings (cumulative + last): the
        schedule / execute / postprocess split that identifies host-side
        bottlenecks. Prometheus exposes the same as histograms; this
        route is the zero-dependency JSON view."""
        if self.engine is None:
            return _error("no engine loaded", status=409)
        pt = dict(await self._eng("get_phase_timings"))
        it = max(pt["iterations"], 1)
        pt["avg_schedule_ms"] = pt["schedule_s"] / it * 1e3
        pt["avg_execute_ms"] = pt["execute_s"] / it * 1e3
        pt["avg_postprocess_ms"] = pt["postprocess_s"] / it * 1e3
        return web.json_response(pt)

    async def root(self, request: web.Request) -> web.Response:
        return web.json_response(
            {"name": "aphrodite-tpu", "health": "/health",
             "openai_api": "/v1"})

    async def serviceinfo(self, request: web.Request) -> web.Response:
        """Service discovery document."""
        api = {"openai": {"name": "OpenAI API", "rel_url": "/v1",
                          "version": 1}}
        if self.launch_kobold_api:
            api["koboldai"] = {"name": "KoboldAI API", "rel_url": "/api",
                               "version": 1}
        return web.json_response({
            "version": 0.2,
            "software": {"name": "aphrodite-tpu",
                         "version": aphrodite_tpu_torch.__version__},
            "api": api,
        })

    async def load_soft_prompt(self, request: web.Request) -> web.Response:
        return self._admin_not_ported(request, "soft prompts",
                                      "LoRA and soft prompts")

    async def unload_soft_prompt(self,
                                 request: web.Request) -> web.Response:
        return self._admin_not_ported(request, "soft prompts",
                                      "LoRA and soft prompts")

    async def load_lora(self, request: web.Request) -> web.Response:
        return self._admin_not_ported(request, "LoRA",
                                      "LoRA and soft prompts")

    async def unload_lora(self, request: web.Request) -> web.Response:
        return self._admin_not_ported(request, "LoRA",
                                      "LoRA and soft prompts")

    def _admin_not_ported(self, request: web.Request, feature: str,
                          waits_for: str) -> web.Response:
        """An admin route of a feature the port lacks: the admin gate,
        then the error that names the feature."""
        denied = self._check_admin(request)
        if denied is not None:
            return denied
        return _error(_not_ported(feature, waits_for))

    async def tokenize(self, request: web.Request) -> web.Response:
        if self.engine is None:
            return _error("no model loaded", status=503,
                          err_type="service_unavailable")
        try:
            req = TokenizeRequest(**await request.json())
        except Exception as e:
            return _error(str(e))
        if req.messages is not None:
            text = self._apply_chat_template(req.messages,
                                             req.add_generation_prompt)
            ids = self.tokenizer.encode(text, add_special_tokens=False)
        else:
            ids = self.tokenizer.encode(
                req.prompt or "", add_special_tokens=req.add_special_tokens)
        resp = TokenizeResponse(tokens=ids, count=len(ids),
                                max_model_len=self.model_config.max_model_len)
        return web.json_response(resp.model_dump())

    async def detokenize(self, request: web.Request) -> web.Response:
        if self.engine is None:
            return _error("no model loaded", status=503,
                          err_type="service_unavailable")
        try:
            req = DetokenizeRequest(**await request.json())
        except Exception as e:
            return _error(str(e))
        text = self.tokenizer.decode(req.tokens)
        return web.json_response(DetokenizeResponse(prompt=text).model_dump())

    # ------------------------------------------------------------------
    # Completions
    # ------------------------------------------------------------------

    def _normalize_prompts(self, prompt) -> List[Union[str, List[int]]]:
        if isinstance(prompt, str):
            return [prompt]
        if isinstance(prompt, list):
            if not prompt:
                raise ValueError("empty prompt")
            if isinstance(prompt[0], int):
                return [prompt]
            return list(prompt)
        raise ValueError("invalid prompt type")

    async def create_completion(self, request: web.Request) -> web.Response:
        if self.engine is None:
            return _error("no model loaded", status=503,
                          err_type="service_unavailable")
        try:
            req = CompletionRequest(**await request.json())
            prompts = self._normalize_prompts(req.prompt)
        except Exception as e:
            return _error(str(e))
        model_name = req.model or self.served_model_names[0]

        streams = []
        request_id = f"cmpl-{random_uuid()}"
        try:
            for i, p in enumerate(prompts):
                if isinstance(p, str):
                    prompt_ids = self.tokenizer.encode(p)
                    prompt_text: Optional[str] = p
                else:
                    prompt_ids = list(p)
                    prompt_text = None
                sp = req.to_sampling_params(
                    self.model_config.max_model_len - len(prompt_ids))
                stream = await self.async_engine.add_request(
                    f"{request_id}-{i}", prompt=prompt_text,
                    sampling_params=sp, prompt_token_ids=prompt_ids)
                streams.append((f"{request_id}-{i}", stream, prompt_ids, sp))
        except Exception as e:
            return _request_error(e)

        if req.stream:
            return await self._stream_completion(request, req, request_id,
                                                 model_name, streams)

        try:
            finals = await asyncio.gather(
                *[self._collect(stream) for _, stream, _, _ in streams])
        except RequestFailedError as e:
            return _error(str(e))
        except Exception as e:
            return _error(str(e), status=500, err_type="internal_error")
        choices = []
        usage = UsageInfo()
        for gi, out in enumerate(finals):
            prompt_ids = streams[gi][2]
            usage.prompt_tokens += len(prompt_ids)
            for comp in out.outputs:
                text = comp.text
                if req.echo:
                    prefix = (out.prompt if out.prompt is not None else
                              self.tokenizer.decode(prompt_ids))
                    text = prefix + text
                choices.append(
                    CompletionChoice(
                        index=len(choices),
                        text=text,
                        finish_reason=comp.finish_reason,
                        stop_reason=comp.stop_reason,
                        logprobs=self._format_logprobs(comp, req.logprobs),
                    ))
                usage.completion_tokens += len(comp.token_ids)
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        resp = CompletionResponse(id=request_id, model=model_name,
                                  choices=choices, usage=usage)
        return web.json_response(resp.model_dump())

    def _format_logprobs(self, comp, num_logprobs) -> Optional[LogProbsPart]:
        if num_logprobs is None or comp.logprobs is None:
            return None
        part = LogProbsPart(top_logprobs=[])
        offset = 0
        for tid, entry in zip(comp.token_ids, comp.logprobs):
            tok_text = self.tokenizer.decode([tid])
            part.tokens.append(tok_text)
            lp = entry.get(tid)
            part.token_logprobs.append(lp.logprob if lp else None)
            part.text_offset.append(offset)
            offset += len(tok_text)
            part.top_logprobs.append({
                self.tokenizer.decode([t]): e.logprob
                for t, e in entry.items()
            })
        return part

    async def _collect(self, stream) -> RequestOutput:
        final = None
        async for out in stream:
            final = out
        assert final is not None
        if final.error:
            raise RequestFailedError(final.error)
        return final

    async def _stream_completion(self, request, req, request_id, model_name,
                                 streams) -> web.StreamResponse:
        response = web.StreamResponse(
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache"})
        await response.prepare(request)

        async def pump(gi, rid, stream, prompt_ids):
            sent_len = [0] * (streams[gi][3].n or 1)
            async for out in stream:
                if out.error:
                    await response.write(_sse_error(out.error))
                    return
                for ci, comp in enumerate(out.outputs):
                    delta = comp.text[sent_len[ci]:]
                    sent_len[ci] = len(comp.text)
                    if not delta and not comp.finish_reason:
                        continue
                    chunk = CompletionResponse(
                        id=request_id,
                        model=model_name,
                        choices=[
                            CompletionChoice(
                                index=gi * (streams[gi][3].n or 1) + ci,
                                text=delta,
                                finish_reason=comp.finish_reason,
                                stop_reason=comp.stop_reason,
                            )
                        ],
                    ).model_dump(exclude_unset=False)
                    await response.write(
                        f"data: {json.dumps(chunk)}\n\n".encode())

        try:
            for gi, (rid, stream, prompt_ids, _) in enumerate(streams):
                await pump(gi, rid, stream, prompt_ids)
            await response.write(b"data: [DONE]\n\n")
            await response.write_eof()
        except (ConnectionResetError, asyncio.CancelledError):
            # Client went away: free the engine work (reference aborts
            # on disconnect, api_server request lifecycle).
            for rid, _, _, _ in streams:
                await self.async_engine.abort(rid)
            raise
        return response

    # ------------------------------------------------------------------
    # Chat completions
    # ------------------------------------------------------------------

    def _apply_chat_template(self, messages: List[ChatMessage],
                             add_generation_prompt: bool = True,
                             chat_template: Optional[str] = None,
                             tools: Optional[List[dict]] = None) -> str:
        """The conversation as prompt text. Text content parts are joined;
        an image or audio part raises (no multimodal model is ported)."""
        conversation = []
        for m in messages:
            content = m.content
            if isinstance(content, list):
                for part in content:
                    if (isinstance(part, dict) and part.get("type")
                            in ("image_url", "input_audio")):
                        raise ValueError(_not_ported(
                            f"{part['type']} content (image and audio "
                            "input)", "the rest of the zoo"))
                content = "".join(
                    part.get("text", "") for part in content
                    if isinstance(part, dict))
            conversation.append({"role": m.role, "content": content or ""})
        return apply_chat_template(self.tokenizer, conversation,
                                   add_generation_prompt, chat_template,
                                   tools)

    async def create_chat_completion(self,
                                     request: web.Request) -> web.Response:
        if self.engine is None:
            return _error("no model loaded", status=503,
                          err_type="service_unavailable")
        try:
            req = ChatCompletionRequest(**await request.json())
            prompt_text = self._apply_chat_template(
                req.messages, req.add_generation_prompt or True,
                req.chat_template, tools=req.tools)
            prompt_ids = self.tokenizer.encode(prompt_text)
            sp = req.to_sampling_params(
                self.model_config.max_model_len - len(prompt_ids))
        except Exception as e:
            return _error(str(e))
        model_name = req.model or self.served_model_names[0]
        request_id = f"chatcmpl-{random_uuid()}"
        try:
            stream = await self.async_engine.add_request(
                request_id, prompt=prompt_text, sampling_params=sp,
                prompt_token_ids=prompt_ids)
        except Exception as e:
            return _request_error(e)

        if req.stream:
            return await self._stream_chat(request, request_id, model_name,
                                           stream, sp)

        try:
            final = await self._collect(stream)
        except RequestFailedError as e:
            return _error(str(e))
        except Exception as e:
            return _error(str(e), status=500, err_type="internal_error")
        choices = []
        for i, comp in enumerate(final.outputs):
            content: Optional[str] = comp.text
            tool_calls = None
            finish = comp.finish_reason
            if req.tools:
                content, calls = parse_tool_calls(comp.text)
                if calls:
                    tool_calls = calls
                    finish = "tool_calls"
            choices.append(
                ChatCompletionChoice(
                    index=i,
                    message=ChatCompletionResponseMessage(
                        content=content, tool_calls=tool_calls),
                    finish_reason=finish,
                    stop_reason=comp.stop_reason,
                ))
        usage = UsageInfo(
            prompt_tokens=len(prompt_ids),
            completion_tokens=sum(
                len(c.token_ids) for c in final.outputs),
        )
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        resp = ChatCompletionResponse(id=request_id, model=model_name,
                                      choices=choices, usage=usage)
        return web.json_response(resp.model_dump())

    async def _stream_chat(self, request, request_id, model_name, stream,
                           sp) -> web.StreamResponse:
        response = web.StreamResponse(
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache"})
        await response.prepare(request)
        first = ChatCompletionStreamResponse(
            id=request_id, model=model_name,
            choices=[ChatCompletionStreamChoice(
                index=0, delta=DeltaMessage(role="assistant", content=""))])
        await response.write(
            f"data: {json.dumps(first.model_dump())}\n\n".encode())
        sent_len = [0] * (sp.n or 1)
        try:
            async for out in stream:
                if out.error:
                    await response.write(_sse_error(out.error))
                    break
                for ci, comp in enumerate(out.outputs):
                    delta = comp.text[sent_len[ci]:]
                    sent_len[ci] = len(comp.text)
                    if not delta and not comp.finish_reason:
                        continue
                    chunk = ChatCompletionStreamResponse(
                        id=request_id, model=model_name,
                        choices=[
                            ChatCompletionStreamChoice(
                                index=ci,
                                delta=DeltaMessage(content=delta),
                                finish_reason=comp.finish_reason,
                            )
                        ])
                    await response.write(
                        f"data: {json.dumps(chunk.model_dump())}\n\n"
                        .encode())
            await response.write(b"data: [DONE]\n\n")
            await response.write_eof()
        except (ConnectionResetError, asyncio.CancelledError):
            await self.async_engine.abort(request_id)
            raise
        return response


async def run_server(engine_args: EngineArgs, host: str = "0.0.0.0",
                     port: int = DEFAULT_PORT,
                     served_model_names: Optional[List[str]] = None,
                     api_keys: Optional[List[str]] = None,
                     admin_key: Optional[str] = None,
                     engine_in_subprocess: Optional[bool] = None,
                     engine_replicas: int = 1,
                     warmup: bool = False) -> None:
    """Serve until cancelled (SIGINT), then stop the engine. The engine
    runs in a spawned child process unless engine_in_subprocess is False
    (or APHRODITE_ENGINE_SUBPROCESS=0); with ``warmup`` it captures every
    sequence bucket's decode-window graphs before the port opens."""
    if admin_key is None:
        admin_key = os.environ.get("APHRODITE_ADMIN_KEY") or None
    engine_replicas = int(os.environ.get("APHRODITE_ENGINE_REPLICAS",
                                         engine_replicas))
    if engine_replicas > 1:
        raise NotImplementedError(_not_ported(
            "data-parallel engine replicas (--engine-replicas above 1)",
            "parallelism"))
    env_sub = os.environ.get("APHRODITE_ENGINE_SUBPROCESS")
    if env_sub is not None:
        engine_in_subprocess = env_sub == "1"
    if engine_in_subprocess is None:
        engine_in_subprocess = True
    loop = asyncio.get_running_loop()
    if engine_in_subprocess:
        from aphrodite_tpu_torch.engine.multiproc import MPAsyncEngine

        async_engine = await loop.run_in_executor(
            None, MPAsyncEngine.from_engine_args, engine_args)
    else:
        async_engine = await loop.run_in_executor(
            None, AsyncAphrodite.from_engine_args, engine_args)
    runner = None
    try:
        if warmup:
            await async_engine.utility("warmup")
        server = OpenAIServer(async_engine, served_model_names, api_keys,
                              engine_args=engine_args, admin_key=admin_key)
        runner = web.AppRunner(server.build_app())
        await runner.setup()
        site = web.TCPSite(runner, host, port)
        await site.start()
        logger.info("aphrodite-tpu API server listening on %s:%d", host,
                    port)
        while True:
            await asyncio.sleep(3600)
    finally:
        if runner is not None:
            await runner.cleanup()
        # The engine the server holds last (a reload replaces it).
        current = server.async_engine if runner is not None else \
            async_engine
        if current is not None:
            current.shutdown()
