"""Async engine wrapper: background step loop + per-request streams
(counterpart of aphrodite_tpu/engine/async_engine.py).

An asyncio task drives ``engine.step()`` while requests are in flight;
each request gets an ``AsyncStream`` that yields ``RequestOutput``s as
tokens arrive. The engine is built, stepped and called (``utility``) on
one dedicated worker thread: PyTorch's current CUDA stream is per thread,
and a CUDA graph capture in the default capture mode fails if another
thread touches the card meanwhile, so the event loop's thread never
does. New requests and aborts are handed to the engine between steps,
on the event loop, while no step runs. If the loop dies, every open
stream receives the error.
"""

import asyncio
import concurrent.futures
import time
from typing import AsyncIterator, Dict, List, Optional

from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.outputs import RequestOutput
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.engine.args import EngineArgs
from aphrodite_tpu_torch.engine.engine import AphroditeEngine

logger = init_logger(__name__)

ENGINE_ITERATION_TIMEOUT_S = 60


class AsyncEngineDeadError(RuntimeError):
    pass


class AsyncStream:
    """One request's output stream."""

    def __init__(self, request_id: str) -> None:
        self.request_id = request_id
        self._queue: asyncio.Queue = asyncio.Queue()
        self._finished = False

    def put(self, item) -> None:
        if self._finished:
            return
        self._queue.put_nowait(item)

    def finish(self) -> None:
        self._finished = True
        self._queue.put_nowait(StopAsyncIteration())

    @property
    def finished(self) -> bool:
        return self._finished

    def __aiter__(self):
        return self

    async def __anext__(self) -> RequestOutput:
        item = await self._queue.get()
        if isinstance(item, StopAsyncIteration):
            raise StopAsyncIteration
        if isinstance(item, BaseException):
            raise item
        return item


class AsyncAphrodite:
    """Asyncio front half over the synchronous engine."""

    def __init__(self, engine: AphroditeEngine,
                 executor: Optional[concurrent.futures.Executor] = None
                 ) -> None:
        self.engine = engine
        # The engine's thread: every step and utility call runs here.
        self._executor = executor or concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="aphrodite-engine")
        self._streams: Dict[str, AsyncStream] = {}
        self._new_requests: List[tuple] = []
        self._aborts: List[str] = []
        self._loop_task: Optional[asyncio.Task] = None
        self._wakeup: Optional[asyncio.Event] = None
        self._errored: Optional[BaseException] = None

    @classmethod
    def from_engine_args(cls, engine_args: EngineArgs) -> "AsyncAphrodite":
        """Builds the engine on the thread that will step it."""
        executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="aphrodite-engine")
        engine = executor.submit(AphroditeEngine.from_engine_args,
                                 engine_args).result()
        return cls(engine, executor)

    @property
    def errored(self) -> bool:
        return self._errored is not None

    async def check_health(self) -> None:
        if self._errored:
            raise AsyncEngineDeadError(
                "engine loop has died") from self._errored

    async def utility(self, name: str, *args, **kwargs):
        """Call an engine method on the engine's thread. It runs between
        steps (the thread runs one thing at a time)."""
        await self.check_health()
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, lambda: getattr(self.engine, name)(*args,
                                                               **kwargs))

    def shutdown(self) -> None:
        if self._loop_task is not None:
            self._loop_task.cancel()
        self._executor.shutdown(wait=True)

    # ------------------------------------------------------------------

    async def add_request(
        self,
        request_id: str,
        prompt: Optional[str] = None,
        sampling_params: Optional[SamplingParams] = None,
        prompt_token_ids: Optional[List[int]] = None,
    ) -> AsyncStream:
        await self.check_health()
        stream = AsyncStream(request_id)
        self._streams[request_id] = stream
        self._new_requests.append(
            (request_id, prompt, sampling_params, prompt_token_ids,
             time.monotonic()))
        self._ensure_loop()
        self._wakeup.set()
        return stream

    async def generate(
        self,
        request_id: str,
        prompt: Optional[str] = None,
        sampling_params: Optional[SamplingParams] = None,
        prompt_token_ids: Optional[List[int]] = None,
    ) -> AsyncIterator[RequestOutput]:
        stream = await self.add_request(request_id, prompt, sampling_params,
                                        prompt_token_ids)
        try:
            async for output in stream:
                yield output
        finally:
            if not stream.finished:
                await self.abort(request_id)

    async def abort(self, request_id: str) -> None:
        """End a request's stream now; the engine drops the request
        before its next step."""
        stream = self._streams.pop(request_id, None)
        if stream is not None:
            stream.finish()
        self._aborts.append(request_id)
        if self._loop_task is not None and not self._loop_task.done():
            self._wakeup.set()

    # ------------------------------------------------------------------

    def _ensure_loop(self) -> None:
        running = asyncio.get_running_loop()
        if (self._loop_task is None or self._loop_task.done()
                or self._loop_task.get_loop() is not running):
            self._wakeup = asyncio.Event()
            self._loop_task = running.create_task(self._run_loop())

    def _drain_new_requests(self) -> None:
        """Hand the aborts and new requests to the engine (no step runs
        while the loop is here)."""
        aborts, self._aborts = self._aborts, []
        if aborts:
            self.engine.abort_request(aborts)
        new, self._new_requests = self._new_requests, []
        for rid, prompt, sp, ids, arrival in new:
            if rid not in self._streams:
                continue  # aborted before it reached the engine
            try:
                self.engine.add_request(rid, prompt=prompt,
                                        sampling_params=sp,
                                        prompt_token_ids=ids,
                                        arrival_time=arrival)
            except Exception as e:  # bad request: fail just this stream
                stream = self._streams.pop(rid, None)
                if stream is not None:
                    stream.put(e)
                    stream.finish()

    async def _run_loop(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                self._drain_new_requests()
                if not self.engine.has_unfinished_requests():
                    if not self._new_requests and not self._aborts:
                        self._wakeup.clear()
                        await self._wakeup.wait()
                    continue
                outputs = await asyncio.wait_for(
                    loop.run_in_executor(self._executor, self.engine.step),
                    timeout=ENGINE_ITERATION_TIMEOUT_S * 10)
                for out in outputs:
                    stream = self._streams.get(out.request_id)
                    if stream is None:
                        continue
                    stream.put(out)
                    if out.finished:
                        stream.finish()
                        self._streams.pop(out.request_id, None)
                await asyncio.sleep(0)
        except Exception as e:  # engine dead: fail all open streams
            logger.error("engine loop died: %s", e)
            self._errored = e
            for stream in self._streams.values():
                stream.put(AsyncEngineDeadError(str(e)))
                stream.finish()
            self._streams.clear()
            raise
