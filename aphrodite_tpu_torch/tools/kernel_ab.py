"""Hold this checkout's CUDA kernels against another checkout's, on one card.

Runs a fixed set of seeded calls through the public kernel wrappers
(``paged_decode_attention`` and ``ragged_paged_attention`` on every page
type, QH / KV 1, 2, 4 and 8 at head_dim 128, with window and soft cap,
with ALiBi and with blocksparse, and the shapes slice 8 brought in: QH / KV
3, 5, 6, 7 and 16 at head_dim 128 and 1 to 16 at head_dim 64;
``int4p_matmul`` at groups 32, 64 and 128 and ``int4p_matmul_w4a8`` at
groups 16, 32, 64 and 128 at the Llama-3.1-8B sites; the page-gather
probe), records a SHA-256 of each output's bytes and times a few
main-path shapes. A call that the checkout does not take (a shape or a
group it raises for, a module it lacks) is left out of its run. Each run
imports the package of the checkout it is started from, so to compare two
checkouts, copy this file into the other one's
``aphrodite_tpu_torch/tools/`` and run, in turns:

    python -m aphrodite_tpu_torch.tools.kernel_ab run --out DIR_A   # here
    (cd OTHER && python -m aphrodite_tpu_torch.tools.kernel_ab run --out DIR_B)
    python -m aphrodite_tpu_torch.tools.kernel_ab compare DIR_A DIR_B ...

``compare`` fails unless every output that all runs have is equal bit for
bit across them (it counts those only some runs have), and prints each
timed shape's mean time per run directory. Needs a card; nothing falls
back to the CPU.
"""

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

PAGE_SIZE = 16
PAGE_TYPES = {"bf16": torch.bfloat16, "e4m3": torch.float8_e4m3fn,
              "e5m2": torch.float8_e5m2, "int8": torch.int8}
INT4_SITES = {"wqkv": (4096, 6144), "wo": (4096, 4096),
              "w13": (4096, 28672), "down": (14336, 4096)}


def time_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call (CUDA events), after warm-up,
    with the launches queued behind a spin kernel that outlasts their
    enqueueing (as chip_smoke.py times)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(host_s * iters * 1.5 * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_case(seqs, qh, kvh, page_type, seed, padded_seqs,
                   padded_tokens, layers=1, head_dim=128):
    """q, pages (K/V at std 0.5, narrow types holding value / 0.02), the
    index tensors, on the card; unwritten slots hold NaN or 0x7f."""
    from aphrodite_tpu_torch.ops.kv_cache import quantize_kv

    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    pps = max(-(-kv // PAGE_SIZE) for _, kv in seqs) + 1
    num_pages = sum(-(-kv // PAGE_SIZE) for _, kv in seqs) + 4
    perm = rng.permutation(num_pages)
    pages = np.zeros((padded_seqs, pps), np.int32)
    kv_lens = np.zeros((padded_seqs,), np.int32)
    cu = np.zeros((padded_seqs + 1,), np.int32)
    live = np.zeros((num_pages, PAGE_SIZE), bool)
    j = 0
    for i, (q_len, kv_len) in enumerate(seqs):
        npg = -(-kv_len // PAGE_SIZE)
        pages[i, :npg] = perm[j:j + npg]
        for p in range(npg):
            live[perm[j + p], :min(PAGE_SIZE, kv_len - p * PAGE_SIZE)] = True
        j += npg
        kv_lens[i] = kv_len
        cu[i + 1] = cu[i] + q_len
    cu[len(seqs) + 1:] = cu[len(seqs)]
    kv = torch.randn((layers, num_pages, PAGE_SIZE, 2 * kvh, head_dim),
                     generator=gen) * 0.5
    dead = torch.from_numpy(~live)
    scale = 1.0
    if page_type == "bf16":
        kv = kv.to(torch.bfloat16)
        kv[:, dead] = float("nan")
    else:
        scale = 0.02
        kv = quantize_kv(kv, torch.tensor(scale), PAGE_TYPES[page_type])
        kv.view(torch.uint8)[:, dead] = 0x7F
    q = (torch.randn((padded_tokens, qh, head_dim), generator=gen)
         * 3.0).to(torch.bfloat16)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return dict(q=q.cuda(), kv=kv.cuda(), kv_lens=t(kv_lens),
                pages=t(pages), cu=t(cu),
                ns=t(np.asarray([len(seqs)], np.int32)), scale=scale)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def attention_outputs() -> Dict[str, str]:
    from aphrodite_tpu_torch.models.layers import get_alibi_slopes
    from aphrodite_tpu_torch.ops.attention import ragged_paged_attention
    from aphrodite_tpu_torch.ops.decode_attention import \
        paged_decode_attention

    out = {}
    ragged_seqs = [(1, 300), (200, 200), (1, 17), (77, 77), (1, 1100),
                   (90, 1250)]
    lens = np.random.default_rng(3).integers(1, 1100, size=12)
    lens[:2] = (1500, 1025)
    decode_seqs = [(1, int(n)) for n in lens]
    # (QG, head_dim, variants): the shapes before slice 8 with every
    # option, then the new ones without ALiBi or blocksparse.
    shapes = [(qg, 128, ("plain", "window_cap", "alibi", "blocksparse"))
              for qg in (1, 2, 4, 8)]
    shapes += [(qg, 128, ("plain", "window_cap")) for qg in (3, 5, 6, 7, 16)]
    shapes += [(qg, 64, ("plain", "window_cap"))
               for qg in (1, 2, 3, 4, 5, 6, 7, 8, 16)]
    for page_type in PAGE_TYPES:
        for qg, head_dim, names in shapes:
            kvh = 32 // qg if qg > 1 else 16
            qh = qg * kvh
            slopes = torch.from_numpy(get_alibi_slopes(qh)).cuda()
            phases = (torch.arange(qh, dtype=torch.int32, device="cuda")
                      * max(1, 8 // qh))
            for op, seqs, padded in (
                    ("ragged", ragged_seqs, (8, 660)),
                    ("decode", decode_seqs, (16, 16))):
                c = attention_case(seqs, qh, kvh, page_type, qg + 7,
                                   *padded, head_dim=head_dim)
                variants = {"plain": {},
                            "window_cap": dict(sliding_window=100,
                                               soft_cap=30.0),
                            "alibi": dict(alibi_slopes=slopes),
                            "blocksparse": dict(blocksparse=(64, 4, 8),
                                                bs_head_offsets=phases)}
                for name in names:
                    kw = dict(variants[name],
                              sm_scale=head_dim**-0.5 * c["scale"])
                    try:
                        if op == "ragged":
                            got = ragged_paged_attention(
                                c["q"], c["kv"][0], c["kv_lens"], c["pages"],
                                c["cu"], c["ns"], **kw)
                        else:
                            got = paged_decode_attention(
                                c["q"], c["kv"][0], c["kv_lens"], c["pages"],
                                c["ns"], **kw)
                    except ValueError:  # a shape this checkout raises for
                        continue
                    key = f"{op} {page_type} qg{qg} {name}"
                    if head_dim != 128:
                        key += f" d{head_dim}"
                    out[key] = digest(got)
    return out


def int4_case(K, N, group, layers, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q4p = torch.randint(0, 256, (layers, K // 2, N), generator=gen,
                        device="cuda", dtype=torch.uint8).view(torch.int8)
    scale = torch.rand((layers, K // group, N), generator=gen,
                       device="cuda") * 0.02 + 0.001
    zero = torch.randint(-3, 20, (layers, K // group, N), generator=gen,
                         device="cuda").float()
    return q4p, scale, zero


def int4_outputs() -> Dict[str, str]:
    """The packed product at groups 32-128 (W4A16) and 16-128 (W4A8) at
    the four sites and every T; the W4A8 product at group 16 only where
    the checkout takes it."""
    from aphrodite_tpu_torch.ops.quant_matmul import (int4p_matmul,
                                                      int4p_matmul_w4a8)

    out = {}
    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        for group in (16, 32, 64, 128):
            q4p, scale, zero = int4_case(K, N, group, 1, 40 + i)
            for T in (1, 8, 32, 64, 100, 2048):
                gen = torch.Generator(device="cuda").manual_seed(T)
                x = torch.randn((T, K), generator=gen, device="cuda").to(
                    torch.bfloat16)
                if group != 16:
                    got = int4p_matmul(x, q4p, scale, zero, group,
                                       layer_idx=0)
                    out[f"int4p {site} group{group} T{T}"] = digest(got)
                try:
                    got = int4p_matmul_w4a8(x, q4p, scale, zero, group,
                                            layer_idx=0)
                except ValueError:  # a group this checkout raises for
                    continue
                out[f"w4a8 {site} group{group} T{T}"] = digest(got)
    return out


def probe_outputs() -> Dict[str, str]:
    """The page-gather probe at its defaults, random and sequential page
    ids, where the checkout has it."""
    try:
        from aphrodite_tpu_torch.tools import probe_gather_bw as probe
    except ImportError:
        return {}
    out = {}
    saved = os.environ.get("PROBE_SEQ")
    for sequential in ("0", "1"):
        os.environ["PROBE_SEQ"] = sequential
        kv_lens, pages, kv, _ = probe.make_inputs("cuda", 0)
        out[f"gather_probe seq{sequential}"] = digest(
            probe.gather(kv_lens, pages, kv))
    if saved is None:
        del os.environ["PROBE_SEQ"]
    else:
        os.environ["PROBE_SEQ"] = saved
    return out


def timings() -> Dict[str, float]:
    """Main-path shapes: decode of 16 rows and a 2048-token prefill step
    at 32 / 8 heads on bf16 and E4M3 pages, and (where the checkout takes
    them) at Qwen2.5-7B's 28 / 4 and Qwen2.5-0.5B's 14 / 2 at head_dim 64,
    each launch on the next of 16 cache layers; the packed int4 product
    at w13, group 128."""
    from aphrodite_tpu_torch.ops.attention import ragged_paged_attention
    from aphrodite_tpu_torch.ops.decode_attention import \
        paged_decode_attention
    from aphrodite_tpu_torch.ops.quant_matmul import int4p_matmul

    lens = np.random.default_rng(0).integers(16, 1025, size=16)
    prefill, budget = [], 2048
    for n in lens:
        take = min(int(n), budget)
        prefill.append((take, take))
        budget -= take
        if budget == 0:
            break
    decode = [(1, int(n) + 32) for n in lens]
    out = {}
    geometries = (("32/8", 32, 8, 128), ("28/4", 28, 4, 128),
                  ("14/2 d64", 14, 2, 64))
    for (label, qh, kvh, head_dim), page_type in (
            (g, p) for g in geometries for p in ("bf16", "e4m3")):
        for op, seqs, padded in (("decode", decode, (32, 32)),
                                 ("ragged", prefill, (32, 2048))):
            c = attention_case(seqs, qh, kvh, page_type, 20, *padded,
                               layers=16, head_dim=head_dim)
            state = {"layer": 0}

            def call():
                state["layer"] = (state["layer"] + 1) % 16
                kv = c["kv"][state["layer"]]
                if op == "decode":
                    return paged_decode_attention(
                        c["q"], kv, c["kv_lens"], c["pages"], c["ns"],
                        sm_scale=0.088 * c["scale"])
                return ragged_paged_attention(
                    c["q"], kv, c["kv_lens"], c["pages"], c["cu"], c["ns"],
                    sm_scale=0.088 * c["scale"])

            try:
                call()
            except ValueError:  # a shape this checkout raises for
                continue
            out[f"{op} {page_type} {label}"] = time_ms(call, 200)
            del c
    K, N = INT4_SITES["w13"]
    layers = 10
    q4p, scale, zero = int4_case(K, N, 128, layers, 60)
    for T in (32, 2048):
        x = torch.randn((T, K), device="cuda").to(torch.bfloat16)
        state = {"layer": 0}

        def mm():
            state["layer"] = (state["layer"] + 1) % layers
            return int4p_matmul(x, q4p, scale, zero, 128,
                                layer_idx=state["layer"])

        out[f"int4p w13 T{T}"] = time_ms(mm, 200 if T <= 64 else 20)
    return out


def run(out_dir: str) -> None:
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a card")
    os.makedirs(out_dir, exist_ok=True)
    result = {"digests": {**attention_outputs(), **int4_outputs(),
                          **probe_outputs()},
              "ms": timings(), "device": torch.cuda.get_device_name(0)}
    with open(os.path.join(out_dir, "kernel_ab.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"kernel_ab: {len(result['digests'])} outputs, "
          f"{len(result['ms'])} timed shapes -> {out_dir}", flush=True)


def compare(dirs: List[str]) -> None:
    runs = []
    for d in dirs:
        with open(os.path.join(d, "kernel_ab.json")) as f:
            runs.append(json.load(f))
    keys = [set(r["digests"]) for r in runs]
    common = sorted(set.intersection(*keys))
    some = sorted(set.union(*keys) - set(common))
    first = runs[0]["digests"]
    differ = [k for k in common
              if any(r["digests"][k] != first[k] for r in runs[1:])]
    for key in sorted(set.union(*(set(r["ms"]) for r in runs))):
        print(f"time {key}: " + ", ".join(
            f"{d} {r['ms'][key]:.4f} ms" if key in r["ms"] else f"{d} -"
            for d, r in zip(dirs, runs)), flush=True)
    if some:
        print(f"kernel_ab: {len(some)} outputs only some runs have (a "
              f"shape, group or module the others lack), e.g. {some[:3]}",
              flush=True)
    if differ:
        sys.exit(f"kernel_ab: {len(differ)} of {len(common)} outputs "
                 f"differ, first {differ[:5]}")
    print(f"kernel_ab: all {len(common)} outputs that every run has are "
          f"equal, bit for bit, across {len(dirs)} runs", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run")
    p_run.add_argument("--out", required=True)
    p_cmp = sub.add_parser("compare")
    p_cmp.add_argument("dirs", nargs="+")
    args = parser.parse_args()
    if args.cmd == "run":
        run(args.out)
    else:
        compare(args.dirs)


if __name__ == "__main__":
    main()
