"""A runner's fused decode window on inputs made from a seed, run through
its CUDA graph and through the eager function (``decode_window``) on the
same cache, carry and sampling tensors: the outputs and carries of both,
and the milliseconds of a window each way; and the kernels a replay of a
window's graph launches, traced (``trace_launches``). ``chip_smoke.py``
and tests/test_torch_cuda.py use it on the card; on the CPU the runner
has no graphs and both ways run the eager function.

A window writes the KV of the positions it decodes before it attends to
them, so going back to the first window only needs the carry put back:
every later run rewrites the same slots with the same values.
"""

import collections
import difflib
import functools
import pathlib
import re
import statistics
import time
from typing import (Any, Callable, Dict, FrozenSet, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.utils import cdiv
from aphrodite_tpu_torch.sampling.metadata import (SamplerInputRow,
                                                   build_sampling_tensors)
from aphrodite_tpu_torch.sampling.sampler import tensors_to_device
from aphrodite_tpu_torch.worker.model_runner import WindowFetch


class WindowCase:
    """len(kv_lens) live rows of bucket S, row i with kv_lens[i] keys of
    random cache values on pages drawn from the seed (room for
    ``windows`` windows of W more), a random last token, and the
    sampling tensors of ``temperature`` (top_k with it, if given), or of
    ``params``, one SamplingParams a row; row i's key is seed + i's."""

    def __init__(self, runner, S: int, kv_lens: Sequence[int], W: int,
                 seed: int, temperature: float = 0.0, top_k: int = -1,
                 windows: int = 4,
                 params: Optional[Sequence[SamplingParams]] = None) -> None:
        self.runner, self.S, self.W = runner, S, W
        rng = np.random.default_rng(seed)
        bs, pps, n = runner.block_size, runner.pages_per_seq, len(kv_lens)
        need = [cdiv(int(k) + windows * W + 1, bs) for k in kv_lens]
        if n > S or max(need) > pps or sum(need) > runner.num_pages:
            raise ValueError(f"{n} rows of {list(kv_lens)} keys do not fit "
                             f"S {S}, {pps} pages a row and "
                             f"{runner.num_pages} pages")
        pages = rng.permutation(runner.num_pages)[:sum(need)]
        sched = np.zeros((S * pps + S + 1,), np.int32)
        carry = np.zeros((2 * S + 1,), np.int32)
        vocab = runner.model.vocab_size
        first = 0
        for i, k in enumerate(kv_lens):
            sched[i * pps:i * pps + need[i]] = pages[first:first + need[i]]
            sched[S * pps + i] = need[i] * bs
            first += need[i]
        sched[-1] = n
        carry[:n] = rng.integers(0, vocab, n)
        carry[S:S + n] = kv_lens
        params = params or [SamplingParams(
            temperature=temperature, top_k=top_k,
            max_tokens=windows * W)] * n
        rows = [SamplerInputRow(params=sp, token_ids=[0], prompt_len=1,
                                generated_len=0, seed=seed + i)
                for i, sp in enumerate(params)]
        tensors, self.flags, _, _ = build_sampling_tensors(rows, S, vocab)
        cache = runner.kv_cache
        gen = torch.Generator(device=cache.device)
        gen.manual_seed(seed)
        index = torch.from_numpy(pages.astype(np.int64)).to(cache.device)
        with torch.inference_mode():
            for layer in range(cache.shape[0]):
                shape = (len(pages), *cache.shape[2:])
                if cache.dtype == torch.int8:
                    vals = torch.randint(-127, 128, shape, generator=gen,
                                         device=cache.device,
                                         dtype=torch.int8)
                else:
                    vals = (torch.randn(shape, generator=gen,
                                        device=cache.device) * 0.5
                            ).to(cache.dtype)
                # index_copy_ has no fp8 kernel on every device: bytes.
                if cache.dtype.itemsize == 1:
                    cache[layer].view(torch.uint8).index_copy_(
                        0, index, vals.view(torch.uint8))
                else:
                    cache[layer].index_copy_(0, index, vals)
            runner.invalidate_windows()
            self.buf = runner.window_buffers(S)
            self.buf.sched.copy_(torch.from_numpy(sched))
            self.buf.carry.copy_(torch.from_numpy(carry))
            runner.load_window_tensors(
                self.buf, tensors_to_device(tensors, cache.device))
            self.carry0 = self.buf.carry.clone()

    def restore(self) -> None:
        """Put back the carry of the first window."""
        with torch.inference_mode():
            self.buf.carry.copy_(self.carry0)

    def eager(self) -> WindowFetch:
        return WindowFetch(self.runner.decode_window(self.buf, self.flags,
                                                     self.W))

    def graphed(self) -> WindowFetch:
        return self.runner.run_window(self.buf, self.flags, self.W)

    def capture(self) -> None:
        """Warm the key up and capture it, if the runner has not, and put
        the carry back. The CPU has no graphs."""
        while (self.runner.device.type == "cuda"
               and not self.runner.has_window_graph(self.buf, self.flags,
                                                    self.W)):
            self.restore()
            self.graphed().numpy()
        self.restore()

    def windows(self, way: str, n: int) -> List[Tuple[np.ndarray,
                                                      np.ndarray]]:
        """n windows in a row from the first one, each way ("eager" or
        "graphed"): (packed outputs, carry after) of each."""
        if way == "graphed":
            self.capture()
        self.restore()
        run = self.eager if way == "eager" else self.graphed
        out = []
        for _ in range(n):
            packed = run().numpy().copy()
            out.append((packed, self.buf.carry.cpu().numpy().copy()))
        return out

    def time_ms(self, way: str, iters: int = 10, warmup: int = 2) -> float:
        """Median milliseconds of a window from the first one (its fetch
        to the host included), each way, after `warmup` windows."""
        if way == "graphed":
            self.capture()
        run = self.eager if way == "eager" else self.graphed
        times = []
        for i in range(warmup + iters):
            self.restore()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run().numpy()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[warmup:])


def profile_windows(case: WindowCase, n: int = 3, top: int = 8) -> dict:
    """n graphed windows from the first one under torch.profiler: the
    device time a window by kernel name (the `top` largest, and the
    rest), the device time of all of them and the wall time a window.
    ``device_ms`` is 0 where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    case.capture()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            case.restore()
            case.graphed().numpy()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3 / n
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    device_ms = sum(by_kernel.values())
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                kernels={k[:80]: round(v, 4) for k, v in ranked[:top]},
                rest_ms=device_ms - sum(v for _, v in ranked[:top]))


def profile_ops(case: WindowCase, n: int = 1) -> Dict[Tuple[str, str],
                                                    float]:
    """n eager windows from the first one under torch.profiler with the
    ops' input shapes recorded: the device milliseconds a window by (op
    name, input shapes), each op's own kernels (self device time); a
    kernel launched outside any op (the port's, through ctypes) under its
    own name. An eager window runs the kernels its graph replays, so the
    shares hold for a graphed window too."""
    from torch.profiler import ProfilerActivity, profile

    case.restore()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n):
            case.restore()
            case.eager().numpy()
    out: Dict[Tuple[str, str], float] = {}
    for e in prof.key_averages(group_by_input_shape=True):
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            key = (e.key, str(e.input_shapes))
            out[key] = out.get(key, 0.0) + us / 1e3 / n
    return out


def equal_windows(a, b) -> bool:
    """Whether two lists of ``WindowCase.windows`` are equal bit for bit."""
    return len(a) == len(b) and all(
        np.array_equal(pa, pb) and np.array_equal(ca, cb)
        for (pa, ca), (pb, cb) in zip(a, b))


_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"


@functools.lru_cache(maxsize=None)
def port_kernel_names() -> FrozenSet[str]:
    """The name of every ``__global__`` function in the port's CUDA
    sources (csrc/*.cu, *.cuh)."""
    names = set()
    for path in sorted(_CSRC.glob("*.cu*")):
        names.update(re.findall(
            r"__global__\s+void\s+"
            r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            path.read_text()))
    return frozenset(names)


def kernel_base(name: str) -> str:
    """A traced kernel's function name without its namespace, template
    arguments and parameters: "void (anonymous namespace)::
    paged_decode_kernel<kv_page::Bf16, 128, false>(...)" ->
    "paged_decode_kernel"."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""),
                    maxsplit=1)[0]
    return head.split()[-1].split("::")[-1] if head.split() else head


# PyTorch kernels launched before and after the traced work, inside the
# trace (``kernel_counts``).
TRACE_PADDING = 64


def _padding() -> None:
    """TRACE_PADDING small PyTorch kernels, then a synchronize."""
    x = torch.zeros(1, device="cuda")
    for _ in range(TRACE_PADDING):
        x += 1
    torch.cuda.synchronize()


def kernel_records(run: Callable[[], None]) -> List[str]:
    """The port's kernels that ``run`` launches on the card, by their full
    traced name (template arguments included), in the order of their
    start on the card, as torch.profiler records them with host and device
    activity (with device activity alone a card lost kernel records of a
    replay). Library kernels (PyTorch's, cuBLAS's) are left out. The work
    is traced between two runs of ``_padding``: a card's trace of a window
    whose port kernels are its attention launches alone (Falcon-RW-1B,
    MPT-7B on bf16 weights) came out one launch short in every pair
    traced, as if the records at an end of the trace were lost, and the
    padding's records are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ours = port_kernel_names()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _padding()
        run()
        torch.cuda.synchronize()
        _padding()
    # The profiler's raw records: prof.events() would first build the tree
    # of every host event, seconds for an eager window of tens of
    # thousands of them.
    found = [(e.start_ns(), e.name())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA
             and kernel_base(e.name()) in ours]
    return [name for _, name in sorted(found)]


def kernel_counts(run: Callable[[], None]) -> Dict[str, int]:
    """``kernel_records`` counted by name."""
    return dict(collections.Counter(kernel_records(run)))


def _most(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    """Per kernel, the larger of two traces' counts of the same work."""
    return {name: max(a.get(name, 0), b.get(name, 0))
            for name in sorted(set(a) | set(b))}


def missing_records(short: List[str], full: List[str]) -> List[List[int]]:
    """Where the records a trace lacks lay in the order of the other
    trace of the same window: [position in `full`, records lost] for each
    run of records `short` lacks (difflib's alignment of the two name
    sequences)."""
    out = []
    ops = difflib.SequenceMatcher(None, short, full,
                                  autojunk=False).get_opcodes()
    for tag, i1, i2, j1, j2 in ops:
        lost = (j2 - j1) - (i2 - i1)
        if tag in ("insert", "replace") and lost > 0:
            out.append([j1, lost])
    return out


def trace_launches(runner, key: str, attempts: int = 3,
                   reset: Optional[Callable[[], None]] = None,
                   accept: Optional[Callable[[Dict[str, int]], bool]] = None,
                   wrapper_count: Optional[Callable[[], int]] = None
                   ) -> Dict[str, Any]:
    """The port's kernels one window of the captured key ``key`` (a
    ``runner.window_keys()`` name) launches run eagerly (through the
    wrappers, which count their launches) and as a replay of its graph,
    each traced (``kernel_counts``). Both run on the key's own buffers
    with their row count set to 0, so every row is padding: each KV write
    goes to the trash page and nothing the engine holds changes. The
    buffers are put back and the runner forgets what they held
    (``invalidate_windows``). A replay launches every kernel of its graph,
    whatever the buffers hold, so the replay's counts are those of every
    replay of the key.

    The profiler on a card now and then drops the records of whole
    launches (both kernels of one decode call, its split and its combine;
    once one int4p_matmul_kernel launch and its split-K reduce of an
    eager window), which only ever lowers a count: it never records a
    kernel that did not run. A dropped record came from one trace alone:
    a second trace of the same run holds it. So where a pair's two traces
    differ, or ``accept`` (given the replay's counts) refuses them, each
    side is traced once more and keeps, per kernel, the larger of its two
    traces' counts (``_most``); a side that launched fewer kernels shows
    fewer in both of its traces, so the comparison is as strict as on one
    trace a side. ``missing`` holds, for each such pair, where the records
    one side's first trace lacked lay in the other side's order
    (``missing_records``: [side, position, records lost, records in all]).
    A pair that still differs is traced again from the same buffers, up to
    ``attempts`` pairs in all. The first pair that agrees (and that
    ``accept`` takes) is returned, else the last, whose difference the
    caller reports. ``tries`` is the number of pairs traced,
    ``retraced`` the number of pairs whose sides were traced twice, and
    ``mismatches`` holds, for each pair that differed after that, each
    kernel's replay count less its eager count where they differ.
    ``reset`` (the wrappers' counts set to 0) runs before each eager
    window, so the counts after the call are those of one window.
    ``pairs`` holds every pair's two traces and, with ``wrapper_count``,
    what that returned right after the pair's eager window (the wrappers'
    own count of the launches the traces should hold), and ``padding``
    the padding kernels traced before and after each run
    (TRACE_PADDING)."""
    S, W, flags = runner.window_keys()[key]
    buf = runner.window_buffers(S)
    if not runner.has_window_graph(buf, flags, W):
        raise ValueError(f"the window key {key} has no graph")
    with torch.inference_mode():
        saved = buf.sched.clone(), buf.carry.clone()
    mismatches: List[Dict[str, int]] = []
    pairs: List[Dict[str, Any]] = []
    missing: List[List[Any]] = []
    retraced = 0

    def eager_run():
        with torch.inference_mode():
            buf.sched.copy_(saved[0])
            buf.carry.copy_(saved[1])
            buf.sched[-1] = 0
        WindowFetch(runner.decode_window(buf, flags, W)).numpy()

    def replay_run():
        runner.run_window(buf, flags, W).numpy()

    try:
        for tries in range(1, attempts + 1):
            if reset is not None:
                reset()
            eager_seq = kernel_records(eager_run)
            wrapper = wrapper_count() if wrapper_count is not None else None
            replay_seq = kernel_records(replay_run)
            eager = dict(collections.Counter(eager_seq))
            replay = dict(collections.Counter(replay_seq))
            if eager != replay or (accept is not None and not accept(replay)):
                retraced += 1
                for side, a, b in (("eager", eager_seq, replay_seq),
                                   ("replay", replay_seq, eager_seq)):
                    for at, lost in missing_records(a, b):
                        missing.append([side, at, lost, len(b)])
                if reset is not None:
                    reset()
                eager = _most(eager, kernel_counts(eager_run))
                replay = _most(replay, kernel_counts(replay_run))
            pairs.append(dict(eager=eager, replay=replay, wrapper=wrapper))
            if eager == replay and (accept is None or accept(replay)):
                break
            mismatches.append({
                name: replay.get(name, 0) - eager.get(name, 0)
                for name in sorted(set(eager) | set(replay))
                if replay.get(name, 0) != eager.get(name, 0)})
    finally:
        with torch.inference_mode():
            buf.sched.copy_(saved[0])
            buf.carry.copy_(saved[1])
        runner.invalidate_windows()
    return dict(eager=eager, replay=replay, tries=tries,
                retraced=retraced, missing=missing, mismatches=mismatches,
                pairs=pairs, padding=TRACE_PADDING)
