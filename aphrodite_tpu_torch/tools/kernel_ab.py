"""Hold this checkout's CUDA kernels against another checkout's, on one card.

Runs a fixed set of seeded calls through the public kernel wrappers
(``paged_decode_attention`` and ``ragged_paged_attention`` on every page
type, QH / KV 1, 2, 4 and 8 at head_dim 128, with window and soft cap,
with ALiBi and with blocksparse, and the shapes slice 8 brought in: QH / KV
3, 5, 6, 7 and 16 at head_dim 128 and 1 to 16 at head_dim 64; at the
Llama-3.1-8B sites and every T of MATMUL_T ``int4p_matmul`` at groups 32,
64 and 128, ``int4p_matmul_w4a8`` at groups 16, 32, 64 and 128,
``int4_matmul`` on four containers through each body it takes,
``int8_matmul`` and ``fp8_w8a8_matmul``; the page-gather probe), records a
SHA-256 of each output's bytes (and keeps the attention outputs and rows
of the prefill body's outputs, ``outputs.pt``) and times a few main-path
shapes. A matmul output is filed under the body the call goes to (its
key's first word, ``route``), so T < 64 and T >= 64 outputs of one wrapper
count as two kernels. A call that the checkout does not take (a shape or a
group it raises for, a module it lacks) is left out of its run. Each run
imports the package of the checkout it is started from, so to compare two
checkouts, copy this file into the other one's
``aphrodite_tpu_torch/tools/`` and run, in turns:

    python -m aphrodite_tpu_torch.tools.kernel_ab run --out DIR_A   # here
    (cd OTHER && python -m aphrodite_tpu_torch.tools.kernel_ab run --out DIR_B)
    python -m aphrodite_tpu_torch.tools.kernel_ab compare DIR_A DIR_B ... \
        [--changed int4p_matmul,int4_matmul]

``compare`` fails unless every output that all runs have is equal bit for
bit across them (it counts those only some runs have), except the outputs
of the kernels ``--changed`` names: those must be finite and lie, row by
row (the D values of one token and query head, or the N outputs of one
token), within ROW_TOL of the largest element of the first run's row. It
prints each timed shape's mean time per run directory.

``--tol`` sets that bound (default ROW_TOL).

    python -m aphrodite_tpu_torch.tools.kernel_ab sweep [--only int4|fp8|decode]

times the prefill body (csrc/dequant_gemm.cuh) by token rows per block
and split of K beside the plan's choice: on int4 weights ("int4") and in
its e4m3 form, the FP8 W8A8 product's, beside that product's mma.sync
body and torch._scaled_mm ("fp8"); and the decode body (csrc/
decode_gemm.cuh) by token tile, split of K and ring depth beside the
plan's choice and torch.matmul on bf16 weights ("decode"). Needs a card;
nothing falls back to the CPU.
"""

import argparse
import functools
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
# The kernel behind each output, by the first word of its key. The matmul
# keys name the body the call is routed to, by the rule of this tool
# (``route``), so that two checkouts file the same call under the same key:
# "int4p_matmul" and "int4_matmul" are the prefill body (csrc/
# dequant_gemm.cuh) of each kernel, from 64 tokens on; the other bodies
# have names of their own.
KERNELS = {"ragged": "ragged_paged_attention",
           "decode": "paged_decode_attention",
           "int4p_groupwise": "int4p_matmul_groupwise",
           "int4p_dense": "int4p_matmul",
           "q4_groupwise": "int4_matmul_groupwise",
           "q4_dense": "int4_matmul_dense",
           "q4_dense_wgmma": "int4_matmul",
           "int8_groupwise": "int4_matmul_groupwise",
           "int8_per_column": "int4_matmul",
           "fp8": "fp8_w8a8_matmul",
           "w4a8": "int4p_matmul_w4a8", "gather_probe": "gather_probe"}
# Outputs filed under these kernels also keep rows (MATMUL_ROWS of them,
# spread over T) in outputs.pt, for ``compare --changed``.
KEPT_MATMULS = ("int4p_matmul", "int4_matmul", "fp8_w8a8_matmul",
                "int4p_matmul_groupwise", "int4_matmul_groupwise",
                "int4_matmul_dense")
MATMUL_ROWS = 48
MATMUL_T = (1, 8, 32, 63, 64, 100, 257, 2048)
# The unpacked containers: levels [low, high), zero [low, high), group,
# signed scales, the bodies named.
Q4_CONTAINERS = {
    "q6_k": ((0, 64), (32, 33), 16, True, ("groupwise", "dense")),
    "q8_0": ((-128, 128), (0, 1), 32, False, ("groupwise", "dense")),
    "act_order": ((0, 16), (0, 17), 1, False, ("dense",)),
    "gptq_g128": ((0, 16), (0, 17), 128, False, ("groupwise", "dense")),
}
# A changed kernel's outputs against each other, row by row: |a - b| <=
# ROW_TOL * max|b row| (two bf16 ulps of the row's largest element, as
# chip_smoke.py and tests/test_torch_cuda.py hold each kernel to its plain
# version).
ROW_TOL = 2.0**-6


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


def attention_outputs(tensors: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """Digests of the attention outputs; the outputs themselves (the rows
    of live tokens) go into `tensors`."""
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
                    rows = (sum(q for q, _ in seqs) if op == "ragged"
                            else got.shape[0])
                    tensors[key] = got[:rows].cpu()
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


def q4_case(K, N, kind, layers, seed):
    levels, zeros, group, signed, _ = Q4_CONTAINERS[kind]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q4 = torch.randint(*levels, (layers, K, N), generator=gen,
                       device="cuda", dtype=torch.int8)
    scale = torch.rand((layers, K // group, N), generator=gen,
                       device="cuda") * 0.02 + 0.001
    if signed:
        scale *= torch.randint(0, 2, scale.shape, generator=gen,
                               device="cuda").float() * 2 - 1
    zero = torch.randint(*zeros, (layers, K // group, N), generator=gen,
                         device="cuda").float()
    return q4, scale, zero


def route(kind: str, T: int, body: str = "dense") -> str:
    """The first word of a matmul output's key: the body a call of `kind`
    ("int4p", "q4" with its named body, "int8") goes to at T tokens."""
    prefill = T >= 64
    if kind == "int4p":
        return "int4p_dense" if prefill else "int4p_groupwise"
    if kind == "int8":
        return "int8_per_column" if prefill else "int8_groupwise"
    if body == "groupwise":
        return "q4_groupwise"
    return "q4_dense_wgmma" if prefill else "q4_dense"


def keep(key: str, got: torch.Tensor, out: Dict[str, str],
         tensors: Dict[str, torch.Tensor]) -> None:
    out[key] = digest(got)
    if KERNELS[key.split()[0]] in KEPT_MATMULS:
        rows = torch.linspace(0, got.shape[0] - 1,
                              min(got.shape[0], MATMUL_ROWS)).long().unique()
        tensors[key] = got[rows.to(got.device)].cpu()


def int4_outputs(tensors: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """The packed product at groups 32-128 (W4A16) and 16-128 (W4A8), the
    unpacked product on its four containers through each body it takes,
    int8 per-channel and FP8 W8A8 products, at the four sites and every T
    of MATMUL_T; the W4A8 product at group 16 only where the checkout
    takes it."""
    from aphrodite_tpu_torch.ops.quant_matmul import (fp8_w8a8_matmul,
                                                      int4_matmul,
                                                      int4p_matmul,
                                                      int4p_matmul_w4a8,
                                                      int8_matmul)
    from aphrodite_tpu_torch.quantization import fp8, int8

    out = {}

    def xs(K):
        for T in MATMUL_T:
            gen = torch.Generator(device="cuda").manual_seed(T)
            yield T, torch.randn((T, K), generator=gen, device="cuda").to(
                torch.bfloat16)

    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        for group in (16, 32, 64, 128):
            q4p, scale, zero = int4_case(K, N, group, 1, 40 + i)
            for T, x in xs(K):
                if group != 16:
                    got = int4p_matmul(x, q4p, scale, zero, group,
                                       layer_idx=0)
                    keep(f"{route('int4p', T)} {site} group{group} T{T}",
                         got, out, tensors)
                try:
                    got = int4p_matmul_w4a8(x, q4p, scale, zero, group,
                                            layer_idx=0)
                except ValueError:  # a group this checkout raises for
                    continue
                out[f"w4a8 {site} group{group} T{T}"] = digest(got)
            del q4p, scale, zero
        for c, (kind, spec) in enumerate(Q4_CONTAINERS.items()):
            group, bodies = spec[2], spec[4]
            q4, scale, zero = q4_case(K, N, kind, 1, 140 + 10 * i + c)
            for T, x in xs(K):
                for body in bodies:
                    got = int4_matmul(x, q4, scale, zero, group, layer_idx=0,
                                      body=body)
                    keep(f"{route('q4', T, body)} {site} {kind} T{T}", got,
                         out, tensors)
            del q4, scale, zero
        w = torch.randn((1, K, N), generator=torch.Generator().manual_seed(
            240 + i))
        c8 = {k: v.cuda() for k, v in int8.quantize_from_float(w).items()}
        cf = fp8.quantize_from_float(w.cuda())
        for T, x in xs(K):
            keep(f"{route('int8', T)} {site} T{T}",
                 int8_matmul(x, c8["q"], c8["scale"], layer_idx=0), out,
                 tensors)
            keep(f"fp8 {site} T{T}",
                 fp8_w8a8_matmul(x, cf["q"], cf["scale"], layer_idx=0), out,
                 tensors)
        del w, c8, cf
        torch.cuda.empty_cache()
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
    out.update(matmul_timings())
    return out


def rotation(layers):
    state = {"layer": 0}

    def nxt():
        state["layer"] = (state["layer"] + 1) % layers
        return state["layer"]

    return nxt


MATMUL_TIME_T = (1, 16, 32, 128, 512, 2048)


def matmul_timings() -> Dict[str, float]:
    """The packed product at groups 128 and 16, the unpacked one on a
    Q6_K-like container (the wrapper's body) and, under 64 tokens, on a
    Q8_0-like one (group-wise body), the int8 per-channel product and the
    FP8 W8A8 product (the wrapper's body, quantizer included) at the four
    sites and every T of MATMUL_TIME_T, each launch on the next layer of a
    stack larger than the 50 MB L2."""
    from aphrodite_tpu_torch.ops.quant_matmul import (fp8_w8a8_matmul,
                                                      int4_matmul,
                                                      int4p_matmul,
                                                      int8_matmul)
    from aphrodite_tpu_torch.quantization import fp8, int8

    out = {}
    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        cases = []
        for group in (128, 16):
            layer_bytes = K * N // 2 + 8 * (K // group) * N
            layers = -(-100_000_000 // layer_bytes) + 1
            cases.append((f"int4p g{group}", int4p_matmul, layers,
                          (*int4_case(K, N, group, layers, 60 + i), group)))
        layer_bytes = K * N + 8 * (K // 16) * N
        layers = -(-100_000_000 // layer_bytes) + 1
        cases.append(("q4 q6_k", int4_matmul, layers,
                      (*q4_case(K, N, "q6_k", layers, 160 + i), 16)))
        layers = -(-100_000_000 // (K * N + 8 * (K // 32) * N)) + 1
        cases.append(("q4 q8_0 groupwise", functools.partial(
            int4_matmul, body="groupwise"), layers,
            (*q4_case(K, N, "q8_0", layers, 170 + i), 32)))
        layers = -(-100_000_000 // (K * N)) + 1
        c8 = int8.quantize_from_float(torch.randn((layers, K, N),
                                                  device="cuda") * K**-0.5)
        cases.append(("int8", lambda x, q, s, z, g, layer_idx: int8_matmul(
            x, q, s, layer_idx=layer_idx), layers,
            (c8["q"], c8["scale"], None, K)))
        for name, fn, layers, (q, scale, zero, group) in cases:
            nxt = rotation(layers)
            for T in MATMUL_TIME_T:
                if T >= 64 and name in ("q4 q8_0 groupwise", "int8"):
                    continue
                x = torch.randn((T, K), device="cuda").to(torch.bfloat16)
                out[f"{name} {site} T{T}"] = time_ms(
                    lambda: fn(x, q, scale, zero, group, layer_idx=nxt()),
                    200 if T <= 64 else 20)
        del cases, c8
        layers = -(-100_000_000 // (K * N)) + 1
        cf = fp8.quantize_from_float(torch.randn((layers, K, N),
                                                 device="cuda") * K**-0.5)
        nxt = rotation(layers)
        for T in MATMUL_TIME_T:
            x = torch.randn((T, K), device="cuda").to(torch.bfloat16)
            out[f"fp8 {site} T{T}"] = time_ms(
                lambda: fp8_w8a8_matmul(x, cf["q"], cf["scale"],
                                        layer_idx=nxt()),
                200 if T <= 64 else 20)
        del cf
        torch.cuda.empty_cache()
    return out


def sweep() -> None:
    """The prefill body's times by token rows per block (block_t) and
    split of K at the four sites, packed at groups 128 and 16 and
    unpacked on a Q6_K-like container, beside the plan's choice, the
    group-wise body and torch.matmul on bf16 weights. dequant_gemm_plan's
    choices come from these times."""
    from aphrodite_tpu_torch.ops import quant_matmul as qm

    print(f"sweep on {torch.cuda.get_device_name(0)}", flush=True)
    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        for fmt, group in (("packed", 128), ("packed", 16),
                           ("unpacked", 16)):
            if fmt == "packed":
                layer_bytes = K * N // 2 + 8 * (K // group) * N
                layers = -(-100_000_000 // layer_bytes) + 1
                q, scale, zero = int4_case(K, N, group, layers, 60 + i)
                wrapper = qm.int4p_matmul
                plain_w = lambda l: qm.dequantize_int4(  # noqa: E731
                    qm.unpack_int4_rows(q[l]), scale[l], zero[l], group)
            else:
                layer_bytes = K * N + 8 * (K // group) * N
                layers = -(-100_000_000 // layer_bytes) + 1
                q, scale, zero = q4_case(K, N, "q6_k", layers, 160 + i)
                wrapper = qm.int4_matmul
                plain_w = lambda l: qm.dequantize_int4(  # noqa: E731
                    q[l], scale[l], zero[l], group)
            dense = torch.stack([plain_w(l).to(torch.bfloat16)
                                 for l in range(min(layers, 3))])
            nxt = rotation(layers)
            for T in (64, 128, 256, 512, 2048):
                x = torch.randn((T, K), device="cuda").to(torch.bfloat16)
                n = 100 if T <= 128 else 20
                plan = qm.dequant_gemm_plan(T, K, N, group, fmt)

                def dense_body(bt, sp):
                    l = nxt()
                    return qm._dense_product(wrapper, x, q[l], scale[l],
                                             zero[l], group, fmt, bt, sp)

                line = [f"plan (block_t {plan['block_t']}, splits "
                        f"{plan['splits']}, stages {plan['stages']}) "
                        f"{time_ms(lambda: dense_body(None, None), n):.4f}"]
                for bt in (64, 128):
                    for sp in (1, 2, 4, 8, 16):
                        if plan["k_stages"] % sp == 0:
                            ms = time_ms(lambda: dense_body(bt, sp), n)
                            line.append(f"{bt}/{sp} {ms:.4f}")
                groupwise = time_ms(lambda: wrapper(
                    x, q, scale, zero, group, layer_idx=nxt(),
                    body="groupwise"), n)
                library = time_ms(
                    lambda: torch.matmul(x, dense[nxt() % len(dense)]), n)
                print(f"sweep {site} {K}x{N} {fmt} g{group} T={T}: ms by "
                      f"block_t/splits: {', '.join(line)}; group-wise body "
                      f"{groupwise:.4f}; torch.matmul on bf16 weights "
                      f"{library:.4f}", flush=True)
            del q, scale, zero, dense
            torch.cuda.empty_cache()


SWEEP_FP8_T = (1, 16, 32, 64, 128, 512, 2048)


def sweep_fp8() -> None:
    """The FP8 W8A8 product's times at the four sites and every T of
    SWEEP_FP8_T: the prefill body's e4m3 form (f16 wgmma) by token rows per
    block and split of K (up to 4) beside the plan's choice, the e4m3
    mma.sync body and torch._scaled_mm on the same e4m3 operands; each call
    takes the next layer of a stack larger than the 50 MB L2, the wrapper's
    times include the quantizer. fp8_route's threshold comes from these
    times."""
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    from aphrodite_tpu_torch.quantization import fp8

    print(f"sweep fp8 on {torch.cuda.get_device_name(0)}", flush=True)
    one = torch.ones((), device="cuda")
    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        layers = -(-100_000_000 // (K * N)) + 1
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        c = fp8.quantize_from_float(torch.randn(
            (layers, K, N), generator=gen, device="cuda") * K**-0.5)
        col_major = c["q"].mT.contiguous().mT
        nxt = rotation(layers)
        for T in SWEEP_FP8_T:
            x = torch.randn((T, K), device="cuda").to(torch.bfloat16)
            xq, _ = qm.quantize_activations_e4m3(x)
            n = 100 if T <= 128 else 20
            plan = qm.dequant_gemm_plan(T, K, N, K, "e4m3")

            def fp8_call(**kw):
                return qm.fp8_w8a8_matmul(x, c["q"], c["scale"],
                                          layer_idx=nxt(), **kw)

            line = [f"plan (block_t {plan['block_t']}, splits "
                    f"{plan['splits']}, stages {plan['stages']}) "
                    f"{time_ms(lambda: fp8_call(body='f16_wgmma'), n):.4f}"]
            for bt in (64, 128):
                for sp in (1, 2, 4):
                    if plan["k_stages"] % sp == 0:
                        ms = time_ms(lambda: fp8_call(
                            body="f16_wgmma", block_t=bt, splits=sp), n)
                        line.append(f"{bt}/{sp} {ms:.4f}")
            mma = time_ms(lambda: fp8_call(body="e4m3_mma"), n)
            library = time_ms(lambda: torch._scaled_mm(
                xq, col_major[nxt()], scale_a=one, scale_b=one,
                out_dtype=torch.float32), n)
            print(f"sweep fp8 {site} {K}x{N} T={T}: f16 wgmma body ms by "
                  f"block_t/splits: {', '.join(line)}; e4m3 mma.sync body "
                  f"{mma:.4f}; _scaled_mm {library:.4f}", flush=True)
        del c, col_major
        torch.cuda.empty_cache()


DECODE_SWEEP_T = (1, 16, 32, 48)


def sweep_decode() -> None:
    """The decode body's times at the four sites and every T of
    DECODE_SWEEP_T: packed at groups 128 and 16, unpacked on a Q6_K-like
    container (dense form) and a Q8_0-like one (group-wise form), and int8
    per-channel (group-wise form, G = K); each by token tile (t_tile),
    split of K and ring depth (stages) beside the plan's choice, the
    mma.sync kernel of the same body and torch.matmul on bf16 weights,
    each call on the next layer of a stack larger than the 50 MB L2.
    decode_plan's choices, and decode_route's, come from these times."""
    from aphrodite_tpu_torch.ops import quant_matmul as qm

    print(f"sweep decode on {torch.cuda.get_device_name(0)}", flush=True)
    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        cases = []
        for group in (128, 16):
            layers = -(-100_000_000 // (K * N // 2 + 8 * (K // group) * N)) + 1
            cases.append((f"packed g{group}", qm.int4p_matmul, "packed", group,
                          layers, int4_case(K, N, group, layers, 60 + i), {}))
        for kind, body in (("q6_k", "dense"), ("q8_0", "groupwise")):
            group = Q4_CONTAINERS[kind][2]
            layers = -(-100_000_000 // (K * N + 8 * (K // group) * N)) + 1
            cases.append((f"{kind} {body}", qm.int4_matmul, body, group, layers,
                           q4_case(K, N, kind, layers, 160 + i), {"body": body}))
        layers = -(-100_000_000 // (K * N)) + 1
        gen = torch.Generator(device="cuda").manual_seed(260 + i)
        q8 = torch.randint(-127, 128, (layers, K, N), generator=gen,
                           device="cuda", dtype=torch.int8)
        s8 = torch.rand((layers, 1, N), generator=gen, device="cuda") * 0.01
        cases.append(("int8", qm.int4_matmul, "groupwise", K, layers,
                      (q8, s8, torch.zeros_like(s8)), {"body": "groupwise"}))
        dense = torch.randn((3, K, N), device="cuda").to(torch.bfloat16)
        for T in DECODE_SWEEP_T:
            x = torch.randn((T, K), device="cuda").to(torch.bfloat16)
            library = time_ms(lambda: torch.matmul(x, dense[T % 3]), 100)
            for label, wrapper, fmt, group, layers, (q, sc, z), kw in cases:
                nxt = rotation(layers)

                def call(decode=True, **over):
                    return wrapper(x, q, sc, z, group, layer_idx=nxt(),
                                   decode=decode, **kw, **over)

                plan = qm.decode_plan(T, K, N, group, fmt)
                line = [f"plan (t_tile {plan['t_tile']}, splits "
                        f"{plan['splits']}, stages {plan['stages']}, blocks "
                        f"{plan['blocks']}) {time_ms(call, 100):.4f}"]
                for tt in (8, 16, 32):
                    if tt < plan["t_tile"] and T > 16:
                        continue
                    for sp in (1, 2, 4, 8, 16):
                        if plan["k_stages"] % sp or plan["strips"] * sp > 264:
                            continue
                        ms = time_ms(lambda: call(t_tile=tt, splits=sp), 100)
                        line.append(f"{tt}/{sp} {ms:.4f}")
                for st in (3, 4, 6):
                    if st < plan["stages"]:
                        ms = time_ms(lambda: call(stages=st), 100)
                        line.append(f"stages {st} {ms:.4f}")
                mma = time_ms(lambda: call(decode=False), 100)
                print(f"sweep decode {site} {K}x{N} {label} T={T}: decode "
                      f"body ms by t_tile/splits: {', '.join(line)}; mma.sync "
                      f"kernel {mma:.4f} (decode_route: "
                      f"{qm.decode_route(T, K, N, group, fmt)}); "
                      f"torch.matmul on bf16 weights {library:.4f}",
                      flush=True)
        del cases, dense, q8, s8
        torch.cuda.empty_cache()


def run(out_dir: str) -> None:
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a card")
    os.makedirs(out_dir, exist_ok=True)
    tensors: Dict[str, torch.Tensor] = {}
    result = {"digests": {**attention_outputs(tensors),
                          **int4_outputs(tensors), **probe_outputs()},
              "ms": timings(), "device": torch.cuda.get_device_name(0)}
    with open(os.path.join(out_dir, "kernel_ab.json"), "w") as f:
        json.dump(result, f, indent=1)
    torch.save(tensors, os.path.join(out_dir, "outputs.pt"))
    print(f"kernel_ab: {len(result['digests'])} outputs, "
          f"{len(result['ms'])} timed shapes -> {out_dir}", flush=True)


def rows_within(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's |got - want| over max|want row| (inf where got is
    not finite)."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        return float("inf")
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1)
    return float((err / scale.clamp_min(1e-30)).max()) if err.numel() else 0.0


def compare(dirs: List[str], changed: List[str], tol: float = ROW_TOL) -> None:
    unknown = set(changed) - set(KERNELS.values())
    if unknown:
        sys.exit(f"kernel_ab: --changed names no kernel of {sorted(KERNELS.values())}: "
                 f"{sorted(unknown)}")
    runs = []
    for d in dirs:
        with open(os.path.join(d, "kernel_ab.json")) as f:
            runs.append(json.load(f))
    keys = [set(r["digests"]) for r in runs]
    common = sorted(set.intersection(*keys))
    some = sorted(set.union(*keys) - set(common))
    first = runs[0]["digests"]
    is_changed = [k for k in common if KERNELS[k.split()[0]] in changed]
    differ = [k for k in common if k not in is_changed
              and any(r["digests"][k] != first[k] for r in runs[1:])]
    if is_changed:
        outs = [torch.load(os.path.join(d, "outputs.pt")) for d in dirs]
        worst, far, same = 0.0, [], 0
        for k in is_changed:
            if all(r["digests"][k] == first[k] for r in runs[1:]):
                same += 1
            for o in outs[1:]:
                ratio = rows_within(o[k], outs[0][k])
                worst = max(worst, ratio)
                if not ratio <= tol:
                    far.append(k)
        print(f"kernel_ab: {len(is_changed)} outputs of {sorted(changed)}: "
              f"worst row |diff| / max|row| {worst:.3e} (tolerance "
              f"{tol:.3e}); {same} equal bit for bit across all runs",
              flush=True)
        if far:
            sys.exit(f"kernel_ab: {len(set(far))} outputs of the changed "
                     f"kernels lie outside {tol:.3e}, first "
                     f"{sorted(set(far))[:5]}")
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
    print(f"kernel_ab: all {len(common) - len(is_changed)} outputs of the "
          f"other kernels that every run has are equal, bit for bit, across "
          f"{len(dirs)} runs", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run")
    p_run.add_argument("--out", required=True)
    p_cmp = sub.add_parser("compare")
    p_cmp.add_argument("dirs", nargs="+")
    p_cmp.add_argument("--changed", default="",
                       help="comma-separated kernels whose outputs are held "
                            "at --tol of a row instead of bit for bit")
    p_cmp.add_argument("--tol", type=float, default=ROW_TOL,
                       help="the changed kernels' bound, of a row's largest "
                            "element (default ROW_TOL)")
    p_sweep = sub.add_parser("sweep")
    p_sweep.add_argument("--only", choices=("int4", "fp8", "decode"),
                         default=None, help="sweep one product only")
    args = parser.parse_args()
    if args.cmd == "run":
        run(args.out)
    elif args.cmd == "sweep":
        if not torch.cuda.is_available():
            sys.exit("kernel_ab: needs a card")
        if args.only in (None, "int4"):
            sweep()
        if args.only in (None, "fp8"):
            sweep_fp8()
        if args.only in (None, "decode"):
            sweep_decode()
    else:
        compare(args.dirs, [k for k in args.changed.split(",") if k],
                args.tol)


if __name__ == "__main__":
    main()
