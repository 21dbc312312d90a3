"""KoboldAI-compatible API (counterpart of
aphrodite_tpu/endpoints/kobold/api_server.py): the KoboldAI United /api/v1
surface plus the /api/extra streaming route, mounted beside the OpenAI
routes so one server speaks both protocols.
"""

import json
from typing import Any, Dict

from aiohttp import web

import aphrodite_tpu_torch
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.endpoints.openai.protocol import random_uuid

logger = init_logger(__name__)


def kobold_params_to_sampling(body: Dict[str, Any],
                              max_model_len: int) -> SamplingParams:
    """Map KoboldAI generation fields onto SamplingParams (reference
    kobold/protocol.py KAIGenerationInputSchema)."""
    max_length = int(body.get("max_length", 80))
    return SamplingParams(
        n=int(body.get("n", 1)),
        temperature=float(body.get("temperature", 1.0)),
        dynatemp_min=float(body.get("dynatemp_min", 0.0) or 0.0),
        dynatemp_max=float(body.get("dynatemp_max", 0.0) or 0.0),
        dynatemp_exponent=float(body.get("dynatemp_exponent", 1.0) or 1.0),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)) or -1,
        top_a=float(body.get("top_a", 0.0)),
        min_p=float(body.get("min_p", 0.0)),
        tfs=float(body.get("tfs", 1.0)),
        eta_cutoff=float(body.get("eta_cutoff", 0.0)),
        epsilon_cutoff=float(body.get("eps_cutoff", 0.0)),
        typical_p=float(body.get("typical", 1.0)),
        repetition_penalty=float(body.get("rep_pen", 1.0)),
        smoothing_factor=float(body.get("smoothing_factor", 0.0) or 0.0),
        smoothing_curve=float(body.get("smoothing_curve", 1.0) or 1.0),
        xtc_threshold=float(body.get("xtc_threshold", 0.1) or 0.1),
        xtc_probability=float(body.get("xtc_probability", 0.0) or 0.0),
        max_tokens=max_length,
        ignore_eos=bool(body.get("use_default_badwordsids", False)),
        stop=body.get("stop_sequence") or [],
        seed=body.get("sampler_seed"),
    )


class KoboldServer:
    def __init__(self, async_engine, served_model_name: str) -> None:
        self.async_engine = async_engine
        self.engine = async_engine.engine
        self.tokenizer = self.engine.tokenizer
        self.model_name = served_model_name

    def add_routes(self, app: web.Application) -> None:
        self._gen_cache = {}
        app.router.add_post("/api/v1/generate", self.generate)
        app.router.add_get("/api/v1/model", self.model)
        app.router.add_get("/api/v1/info/version", self.version)
        app.router.add_get("/api/v1/config/max_context_length",
                           self.max_context_length)
        app.router.add_get("/api/v1/config/max_length", self.max_length)
        app.router.add_get("/api/extra/version", self.extra_version)
        app.router.add_post("/api/extra/generate/stream",
                            self.generate_stream)
        app.router.add_post("/api/extra/tokencount", self.tokencount)
        app.router.add_post("/api/extra/abort", self.abort)
        app.router.add_post("/api/extra/generate/check",
                            self.generate_check)
        app.router.add_get("/api/extra/generate/check",
                           self.generate_check)

    async def model(self, request: web.Request) -> web.Response:
        return web.json_response({"result": f"aphrodite/{self.model_name}"})

    async def version(self, request: web.Request) -> web.Response:
        return web.json_response({"result": "1.2.4"})

    async def extra_version(self, request: web.Request) -> web.Response:
        return web.json_response({
            "result": "KoboldCpp",
            "version": aphrodite_tpu_torch.__version__,
        })

    async def max_context_length(self, request) -> web.Response:
        return web.json_response(
            {"value": self.engine.model_config.max_model_len})

    async def max_length(self, request) -> web.Response:
        return web.json_response({"value": 512})

    async def tokencount(self, request: web.Request) -> web.Response:
        body = await request.json()
        ids = self.tokenizer.encode(body.get("prompt", ""))
        return web.json_response({"value": len(ids), "ids": ids})

    async def generate_check(self,
                             request: web.Request) -> web.Response:
        """Poll in-progress output for a genkey (reference
        kobold /generate/check: clients poll while a non-stream
        generate runs)."""
        text = ""
        try:
            body = await request.json()
            text = self._gen_cache.get(body.get("genkey", ""), "")
        except Exception:
            pass
        return web.json_response({"results": [{"text": text}]})

    async def abort(self, request: web.Request) -> web.Response:
        body = await request.json()
        genkey = body.get("genkey")
        if genkey:
            await self.async_engine.abort(f"kai-{genkey}")
        return web.json_response({"success": True})

    async def generate(self, request: web.Request) -> web.Response:
        body = await request.json()
        prompt = body.get("prompt", "")
        sp = kobold_params_to_sampling(
            body, self.engine.model_config.max_model_len)
        rid = f"kai-{body.get('genkey') or random_uuid()}"
        try:
            stream = await self.async_engine.add_request(
                rid, prompt=prompt, sampling_params=sp)
            final = None
            genkey = body.get("genkey")
            async for out in stream:
                final = out
                if genkey and out.outputs:
                    self._gen_cache[genkey] = out.outputs[0].text
            if genkey:
                self._gen_cache.pop(genkey, None)
            if final is not None and final.error:
                return web.json_response({"detail": final.error},
                                         status=400)
        except Exception as e:
            return web.json_response({"detail": str(e)}, status=400)
        results = [{"text": c.text} for c in final.outputs]
        return web.json_response({"results": results})

    async def generate_stream(self,
                              request: web.Request) -> web.StreamResponse:
        body = await request.json()
        prompt = body.get("prompt", "")
        sp = kobold_params_to_sampling(
            body, self.engine.model_config.max_model_len)
        rid = f"kai-{body.get('genkey') or random_uuid()}"
        response = web.StreamResponse(
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache"})
        await response.prepare(request)
        stream = await self.async_engine.add_request(
            rid, prompt=prompt, sampling_params=sp)
        sent = 0
        genkey = body.get("genkey")
        async for out in stream:
            text = out.outputs[0].text
            if genkey:
                self._gen_cache[genkey] = text
            delta = text[sent:]
            sent = len(text)
            if delta:
                payload = json.dumps({"token": delta})
                await response.write(
                    f"event: message\ndata: {payload}\n\n".encode())
        if genkey:
            self._gen_cache.pop(genkey, None)
        await response.write_eof()
        return response
