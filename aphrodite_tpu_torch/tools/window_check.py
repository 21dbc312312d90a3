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


def kernel_counts(run: Callable[[], None]) -> Dict[str, int]:
    """The port's kernels that ``run`` launches on the card, by their full
    traced name (template arguments included), counted by torch.profiler
    with host and device activity (with device activity alone a card
    lost kernel records of a replay). Library kernels (PyTorch's,
    cuBLAS's) are left out. The work is traced between two runs of
    ``_padding``: a card's trace of a window whose port kernels are its
    attention launches alone (Falcon-RW-1B, MPT-7B on bf16 weights) came
    out one launch short in every pair traced, as if the records at an end
    of the trace were lost, and the padding's records are not counted."""
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
    counts: Dict[str, int] = {}
    # The profiler's raw records: prof.events() would first build the tree
    # of every host event, seconds for an eager window of tens of
    # thousands of them.
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA
                and kernel_base(e.name()) in ours):
            counts[e.name()] = counts.get(e.name(), 0) + 1
    return counts


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

    The profiler on a card now and then drops a kernel record (once one
    of the 512 int4p_matmul_kernel launches of an 8B window run eagerly),
    which only ever lowers a count. So a pair whose two traces differ, or
    whose traces ``accept`` (given the replay's counts) refuses, is traced
    again from the same buffers, up to ``attempts`` pairs in all: the
    caller's count of a kernel it knows the window launches is then lower
    in both traces alike, one record dropped from each. The first pair
    that agrees (and that ``accept`` takes) is returned, else the last,
    whose difference the caller reports. ``tries`` is the number of pairs
    traced, and ``mismatches`` holds, for each pair that differed, each
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
    try:
        for tries in range(1, attempts + 1):
            with torch.inference_mode():
                buf.sched.copy_(saved[0])
                buf.carry.copy_(saved[1])
                buf.sched[-1] = 0
            if reset is not None:
                reset()
            eager = kernel_counts(lambda: WindowFetch(
                runner.decode_window(buf, flags, W)).numpy())
            wrapper = wrapper_count() if wrapper_count is not None else None
            replay = kernel_counts(
                lambda: runner.run_window(buf, flags, W).numpy())
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
                mismatches=mismatches, pairs=pairs, padding=TRACE_PADDING)
