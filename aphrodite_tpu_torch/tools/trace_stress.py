"""How many of a known number of the port's kernel launches a
torch.profiler trace records, run eagerly and as a CUDA graph's replay.

    python -m aphrodite_tpu_torch.tools.trace_stress [--launches N ...]
        [--glue P] [--traces K] [--kernel quantizer|decode]

chip_smoke.py counts the kernels of a replayed decode window by tracing it
(tools/window_check.py ``kernel_counts``), and a trace has now and then
held fewer of the port's kernels than the window launched. This tool
makes N calls of one port wrapper: the activation quantizer
(csrc/int4p_matmul_w4a8.cu, one bf16 row of 64 values: one kernel a
call) or decode attention (4 rows of 600 keys at 32/8 heads of 128 on
bf16 pages: a split kernel and its combine kernel a call, as on the main
paths), each call followed by P small PyTorch kernels
(as a window's glue surrounds the port's launches), and traces that K
times eagerly and K times as the replay of one captured graph of it, each
trace through ``kernel_counts``'s own profiler settings and padding. For
each trace it prints the port's kernels recorded out of those the N
calls launched, the device
records of the whole trace, and where the missing ones lay: runs of
missing records, found as gaps in the recorded kernels' start times
(each gap of about k + 1 median intervals is k records lost), by the
index of the record before the gap. Needs a card.
"""

import argparse
import statistics
import subprocess
from typing import Callable, Dict, List

import torch

from aphrodite_tpu_torch.ops.decode_attention import paged_decode_attention
from aphrodite_tpu_torch.ops.quant_matmul import quantize_activations
from aphrodite_tpu_torch.tools.window_check import (_padding, kernel_base,
                                                    port_kernel_names)


def trace_records(run: Callable[[], None]) -> Dict[str, object]:
    """``run`` traced as ``kernel_counts`` traces it: the start times of
    the port's kernel records, in order, and the count of every device
    record in the trace."""
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
    starts: List[int] = []
    device = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        device += 1
        if kernel_base(e.name()) in ours:
            starts.append(e.start_ns())
    return dict(starts=sorted(starts), device_records=device)


def missing_runs(starts: List[int]) -> List[List[int]]:
    """[record index before the gap, records missing] for each gap in
    the recorded start times wider than 1.5 median intervals."""
    gaps = [b - a for a, b in zip(starts, starts[1:])]
    if not gaps:
        return []
    step = statistics.median(gaps)
    out, index = [], 0
    for i, g in enumerate(gaps):
        if g > 1.5 * step:
            lost = round(g / step) - 1
            out.append([index + i, lost])
            index += lost
    return out


def _call(kernel: str):
    """(one call of the named wrapper on fixed inputs on the card, the
    port kernels a call launches)."""
    if kernel == "quantizer":
        x = torch.randn((1, 64), device="cuda").to(torch.bfloat16)
        return (lambda: quantize_activations(x, "int8")), 1
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows, pages_a_row, page = 4, 38, 16
    q = torch.randn((rows, 32, 128), generator=gen).to(
        torch.bfloat16).cuda()
    kv = (torch.randn((rows * pages_a_row, page, 16, 128), generator=gen)
          * 0.5).to(torch.bfloat16).cuda()
    kv_lens = torch.full((rows,), 600, dtype=torch.int32, device="cuda")
    table = torch.arange(rows * pages_a_row, dtype=torch.int32,
                         device="cuda").view(rows, pages_a_row)
    paged_decode_attention(q, kv, kv_lens, table, sm_scale=0.09)
    if paged_decode_attention.last_plan["slots"] < 2:
        raise SystemExit("the decode case runs no combine kernel")
    return (lambda: paged_decode_attention(q, kv, kv_lens, table,
                                           sm_scale=0.09)), 2


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--launches", type=int, nargs="+",
                        default=[1000, 4000, 16000])
    parser.add_argument("--glue", type=int, default=8)
    parser.add_argument("--traces", type=int, default=6)
    parser.add_argument("--kernel", choices=("quantizer", "decode"),
                        default="quantizer")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_stress needs a card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    call, per_call = _call(args.kernel)
    y = torch.zeros(1, device="cuda")
    for n in args.launches:
        def work():
            for _ in range(n):
                call()
                for _ in range(args.glue):
                    y.add_(1)

        work()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            work()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            work()
        for way, run in (("eager", work), ("replay", graph.replay)):
            for k in range(args.traces):
                got = trace_records(run)
                recorded = len(got["starts"])
                want = n * per_call
                print(f"{args.kernel} N {n}, glue {args.glue}, {way} trace "
                      f"{k}: {recorded} of {want} kernels recorded, "
                      f"{got['device_records']} device records; missing "
                      f"runs [after record, lost] "
                      f"{missing_runs(got['starts']) if recorded < want else []}",
                      flush=True)
        del graph


if __name__ == "__main__":
    main()
