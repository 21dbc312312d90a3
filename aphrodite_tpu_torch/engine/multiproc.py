"""Frontend/engine process isolation (counterpart of
aphrodite_tpu/engine/multiproc.py).

The engine, and with it every CUDA context of the server, lives in a
spawned child process; the frontend (HTTP server, tokenizer) never
touches the card. They talk over a Unix-domain socket in Linux's
abstract namespace (no file) with 4-byte-length-prefixed pickle frames:
both ends are processes of one server on one host.

Protocol (parent -> child):
    ("add_request", kwargs)           failures come back as
                                      ("request_failed", rid, e)
    ("abort", request_id)
    ("utility", call_id, name, args, kwargs)
    ("shutdown",)
Child -> parent:
    ("ready",)                        engine built, loop running
    ("outputs", [RequestOutput, ...]) one engine.step()'s outputs
    ("request_failed", rid, exc)      admission error for one request
    ("reply", call_id, ok, value)     utility result (value=tb str if !ok)
    ("fatal", tb_str)                 engine loop died

``MPAsyncEngine`` mirrors AsyncAphrodite's surface (add_request,
generate, abort, check_health, errored, utility, and an ``.engine`` proxy
with the frontend-local tokenizer and model config), so the OpenAI server
runs unchanged against either. If the child dies before it is ready, the
constructor raises; if it dies later, open streams fail with
AsyncEngineDeadError, new requests are refused, /health turns 5xx and the
HTTP server keeps serving. Data-parallel replicas (the JAX package's
``DPAsyncEngine``) wait for the parallelism slice.
"""

import asyncio
import os
import pickle
import select
import socket
import struct
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.engine.args import EngineArgs
from aphrodite_tpu_torch.engine.async_engine import (AsyncEngineDeadError,
                                                     AsyncStream)

logger = init_logger(__name__)

_LEN = struct.Struct(">I")


def _send_frame(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Optional[Any]:
    hdr = _recv_exact(sock, _LEN.size)
    if hdr is None:
        return None
    body = _recv_exact(sock, _LEN.unpack(hdr)[0])
    if body is None:
        return None
    return pickle.loads(body)


# ---------------------------------------------------------------------------
# Child process
# ---------------------------------------------------------------------------


def engine_proc_main(address: str, engine_args: EngineArgs) -> None:
    """Child entry: build the engine, serve the socket protocol: drain
    the commands (without blocking while work is queued, blocking when
    idle), step, push the outputs. Everything runs on this process's main
    thread."""
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(address)
    try:
        from aphrodite_tpu_torch.engine.engine import AphroditeEngine

        engine = AphroditeEngine.from_engine_args(engine_args)
        _send_frame(sock, ("ready",))
    except BaseException:
        _send_frame(sock, ("fatal", traceback.format_exc()))
        return

    def drain(block: bool) -> bool:
        """Process pending commands; returns False on shutdown or EOF.

        select() tells whether a frame has started; the frame itself is
        always read in blocking mode. A non-blocking read could stop in
        the middle of a frame larger than the socket buffer, and a frame
        read half would desynchronize the protocol for good. The parent
        writes whole frames with sendall, so once a header is there its
        body follows."""
        while True:
            if not block:
                readable, _, _ = select.select([sock], [], [], 0)
                if not readable:
                    return True
            try:
                msg = _recv_frame(sock)
            except OSError:
                return False
            if msg is None:
                return False
            op = msg[0]
            if op == "shutdown":
                return False
            if op == "add_request":
                kwargs = msg[1]
                try:
                    engine.add_request(**kwargs)
                except Exception as e:  # admission error: just this req
                    _send_frame(sock, ("request_failed",
                                       kwargs.get("request_id"), e))
            elif op == "abort":
                engine.abort_request(msg[1])
            elif op == "utility":
                _, call_id, name, args, kwargs = msg
                try:
                    value = getattr(engine, name)(*args, **kwargs)
                    _send_frame(sock, ("reply", call_id, True, value))
                except Exception:
                    _send_frame(sock, ("reply", call_id, False,
                                       traceback.format_exc()))
            block = False  # after one blocking read, drain the rest

    try:
        while True:
            if not drain(block=not engine.has_unfinished_requests()):
                break
            if engine.has_unfinished_requests():
                outputs = engine.step()
                if outputs:
                    _send_frame(sock, ("outputs", outputs))
    except Exception:
        try:
            _send_frame(sock, ("fatal", traceback.format_exc()))
        except OSError:
            pass
    finally:
        sock.close()


# ---------------------------------------------------------------------------
# Parent client
# ---------------------------------------------------------------------------


class _EngineProxy:
    """The ``.engine`` attribute of MPAsyncEngine: the frontend-local
    tokenizer and model config, and awaitable passthroughs to the engine's
    methods (the server awaits them through ``_eng``)."""

    def __init__(self, client: "MPAsyncEngine", model_config,
                 tokenizer) -> None:
        self._client = client
        self.model_config = model_config
        self.tokenizer = tokenizer
        self.eos_token_id = (tokenizer.eos_token_id
                             if tokenizer is not None else None)

    def has_unfinished_requests(self) -> bool:
        return bool(self._client._streams)

    def __getattr__(self, name: str):
        # Any engine method becomes an awaitable passthrough.
        if name.startswith("_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            return self._client.utility(name, *args, **kwargs)

        return call


class MPAsyncEngine:
    """AsyncAphrodite-compatible client for a child-process engine."""

    def __init__(self, engine_args: EngineArgs,
                 start_timeout_s: float = 1800.0) -> None:
        self.engine_args = engine_args
        self._streams: Dict[str, AsyncStream] = {}
        self._pending: Dict[int, asyncio.Future] = {}
        self._next_call_id = 0
        self._errored: Optional[BaseException] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._ready = threading.Event()
        self._fatal_at_start: Optional[str] = None

        # An abstract-namespace address: nothing on the file system.
        address = f"\0aphrodite-torch-engine-{os.getpid()}-{id(self)}"
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(address)
        listener.listen(1)

        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.proc = ctx.Process(target=engine_proc_main,
                                args=(address, engine_args), daemon=True)
        self.proc.start()
        # The child may die before it connects (an import error): poll.
        listener.settimeout(1.0)
        deadline = time.monotonic() + start_timeout_s
        try:
            while True:
                try:
                    self._sock, _ = listener.accept()
                    break
                except socket.timeout:
                    if not self.proc.is_alive():
                        raise RuntimeError(
                            "engine process exited with code "
                            f"{self.proc.exitcode} before it connected")
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            "engine process did not connect in time")
        finally:
            listener.close()
        self._sock.settimeout(None)

        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        while not self._ready.wait(1.0):
            if time.monotonic() > deadline:
                raise RuntimeError("engine process failed to start in time")
        if self._fatal_at_start:
            self.proc.join(timeout=10)
            raise RuntimeError(
                f"engine process failed to start:\n{self._fatal_at_start}")

        # The frontend's own tokenizer and model config: no device here
        # (the model config reads config.json only).
        model_config = engine_args.create_model_config()
        tokenizer = None
        if not model_config.skip_tokenizer_init:
            from aphrodite_tpu_torch.transformers_utils.tokenizer import \
                get_tokenizer

            tokenizer = get_tokenizer(
                model_config.tokenizer,
                trust_remote_code=model_config.trust_remote_code)
        self.engine = _EngineProxy(self, model_config, tokenizer)

    # -- reader ---------------------------------------------------------

    def _read_loop(self) -> None:
        while True:
            try:
                msg = _recv_frame(self._sock)
            except OSError:
                msg = None
            if msg is None:
                if not self._ready.is_set():
                    self._fatal_at_start = "engine process exited"
                    self._ready.set()
                self._on_dead("engine process exited")
                return
            op = msg[0]
            if op == "ready":
                self._ready.set()
            elif op == "fatal":
                if not self._ready.is_set():
                    self._fatal_at_start = msg[1]
                    self._ready.set()
                self._on_dead(f"engine process died:\n{msg[1]}")
                return
            else:
                self._post(lambda m=msg: self._handle(m))

    def _post(self, fn) -> None:
        loop = self._loop
        if loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(fn)

    def _handle(self, msg) -> None:
        op = msg[0]
        if op == "outputs":
            for out in msg[1]:
                stream = self._streams.get(out.request_id)
                if stream is None:
                    continue
                stream.put(out)
                if out.finished:
                    stream.finish()
                    self._streams.pop(out.request_id, None)
        elif op == "request_failed":
            _, rid, exc = msg
            stream = self._streams.pop(rid, None)
            if stream is not None:
                stream.put(exc if isinstance(exc, BaseException)
                           else RuntimeError(str(exc)))
                stream.finish()
        elif op == "reply":
            _, call_id, ok, value = msg
            fut = self._pending.pop(call_id, None)
            if fut is not None and not fut.done():
                if ok:
                    fut.set_result(value)
                else:
                    fut.set_exception(RuntimeError(value))

    def _on_dead(self, reason: str) -> None:
        err = AsyncEngineDeadError(reason)
        self._errored = err
        logger.error("%s", reason)

        def fail_all():
            for stream in self._streams.values():
                stream.put(err)
                stream.finish()
            self._streams.clear()
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()

        self._post(fail_all)

    # -- AsyncAphrodite surface ------------------------------------------

    @classmethod
    def from_engine_args(cls, engine_args: EngineArgs) -> "MPAsyncEngine":
        return cls(engine_args)

    @property
    def errored(self) -> bool:
        return self._errored is not None

    async def check_health(self) -> None:
        if self._errored:
            raise AsyncEngineDeadError(
                "engine process has died") from self._errored

    def _send(self, obj) -> None:
        if self._errored:
            raise AsyncEngineDeadError(
                "engine process has died") from self._errored
        try:
            _send_frame(self._sock, obj)
        except OSError as e:
            self._on_dead(f"engine socket write failed: {e}")
            raise AsyncEngineDeadError(str(e)) from e

    async def add_request(
        self,
        request_id: str,
        prompt: Optional[str] = None,
        sampling_params: Optional[SamplingParams] = None,
        prompt_token_ids: Optional[List[int]] = None,
    ) -> AsyncStream:
        await self.check_health()
        self._loop = asyncio.get_running_loop()
        stream = AsyncStream(request_id)
        self._streams[request_id] = stream
        self._send(("add_request", dict(
            request_id=request_id, prompt=prompt,
            sampling_params=sampling_params,
            prompt_token_ids=prompt_token_ids,
            arrival_time=time.monotonic())))
        return stream

    async def generate(self, request_id: str, prompt=None,
                       sampling_params=None, prompt_token_ids=None):
        stream = await self.add_request(request_id, prompt, sampling_params,
                                        prompt_token_ids)
        try:
            async for output in stream:
                yield output
        finally:
            if not stream.finished:
                await self.abort(request_id)

    async def abort(self, request_id: str) -> None:
        stream = self._streams.pop(request_id, None)
        if stream is not None:
            stream.finish()
        if not self._errored:
            try:
                self._send(("abort", request_id))
            except AsyncEngineDeadError:
                pass

    # -- utilities --------------------------------------------------------

    def utility(self, name: str, *args, **kwargs) -> "asyncio.Future":
        self._loop = asyncio.get_running_loop()
        fut = self._loop.create_future()
        if self._errored:
            fut.set_exception(AsyncEngineDeadError(
                "engine process has died"))
            return fut
        call_id = self._next_call_id
        self._next_call_id += 1
        self._pending[call_id] = fut
        try:
            self._send(("utility", call_id, name, args, kwargs))
        except AsyncEngineDeadError as e:
            self._pending.pop(call_id, None)
            if not fut.done():
                fut.set_exception(e)
        return fut

    def shutdown(self) -> None:
        try:
            _send_frame(self._sock, ("shutdown",))
        except OSError:
            pass
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)
        try:
            self._sock.close()
        except OSError:
            pass
