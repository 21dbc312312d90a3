#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (aphrodite_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. Build every CUDA kernel of the main path from aphrodite_tpu_torch/csrc
   (one nvcc per source, in parallel) and print the build seconds.
2. Print the card's name and power limit as nvidia-smi reports them.
3. Hold each kernel against its plain PyTorch version. Attention, on
   bf16 pages and on each narrow page type (float8_e4m3fn, float8_e5m2,
   int8: pages that hold value / 0.02, read raw by that type's variant of
   the kernel, which must also equal, bit for bit, the bf16 variant on
   the same pages widened to bf16), at the Llama-3.1-8B attention
   geometry (32 query heads, 8 kv heads, head_dim 128, 16-token pages):
   a mixed prefill and decode batch, a chunked prefill on a cached
   prefix, a decode batch with dead padded rows, and sliding window with
   soft cap. Cache slots past each sequence's length hold NaN (bf16, and
   byte 0x7f in the fp8 types) or 127 (int8), so a kernel that reads past
   kv_len fails the check. The packed-int4 matmul, at the four projection
   sites of a Llama-3.1-8B layer (wqkv, wo, w13, down; group 128) on
   layer-stacked weights with a layer index, for T in (1, 8, 32, 64, 100,
   2048), against its plain version and against the exact f32
   dequantized product.
4. Time each kernel, on every page type, at the main path's shapes
   beside its plain version, one PyTorch library call on pre-gathered
   contiguous K/V (scaled_dot_product_attention; the gather is not timed,
   and the port never calls it) and the bound: the larger of the bytes
   the call must move (K/V rows at the page type's size) over 3.35 TB/s
   and its FLOPs over 989 TFLOP/s (H100 SXM bf16). The int4 matmul is
   timed at T = 32 and T = 2048 at each site; its library call is one
   torch.matmul of x with the pre-dequantized bf16 weight (four times the
   weight bytes; the port never calls it).
5. Run the main paths, each with the engine before it freed. First the
   bf16 one, ``LLM.generate`` on a Llama-3.1-8B-geometry model (full
   width, 32 layers, random bf16 weights from a seed) for 16 greedy
   requests with prompts of 16-1024 tokens and 64 new tokens each, so
   chunked prefill mixes with fused 8-step decode windows. Every output
   must be 64 tokens long. Forwards are counted at ``model.forward``:
   the attention launches must be one per layer and forward, all on the
   cache's page type (the ragged kernel in prefill and mixed steps, the
   decode kernel in the fused window), so no forward can have taken a
   plain version. Then one prefill and one decode forward are run with
   kernel attention and with plain attention on the same inputs, and
   their logits compared.
   Then the int4 one: the same model and requests with
   ``quantization="gptq"`` (random weights quantized to packed int4 at
   load). The int4 matmul must have been launched 4 times per layer and
   forward, and the logits of a prefill and a decode forward with the
   int4 kernel must agree with those of the plain int4 product.
   Then the int4 + fp8 one, the JAX package's north-star configuration:
   ``quantization="gptq"`` and ``kv_cache_dtype="fp8_e4m3"`` (32 layers,
   scales of ones). It gets twice the KV pages of a bf16 cache; every
   attention launch must be of the E4M3 variant, and the logits with the
   attention kernels must agree with those of the plain attention
   versions on the same narrow cache. Then the other two narrow types,
   cut to 4 layers: fp8_e5m2, and int8 with scales of 0.05 from a JSON
   file.
6. Print {"kernels": [...]} with each kernel's launches on the main path,
   its error against the plain version and its times (each attention
   kernel once per page type); the last line is
   {"ok": true, "device": {...}}.
"""

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
# Llama-3.1-8B geometry (bench.py, APHRODITE_BENCH_SHAPE=8b).
LLAMA_8B = {
    "architectures": ["LlamaForCausalLM"],
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "head_dim": 128,
    "vocab_size": 128256,
    "max_position_embeddings": 4096,
    "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
PAGE_SIZE = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# Attention outputs are compared row by row, a row being the D values of
# one (token, query head): |kernel - plain| <= ATTN_TOL * max|plain row|.
# Both accumulate in f32 from the same bf16 inputs and round to bf16, whose
# ulp is at most 2^-7 of the value, so they may differ by about one ulp of
# the row's largest element; ATTN_TOL allows two. q is drawn at std 3
# against K at std 0.5, so each softmax is peaked (about 100 effective keys
# out of 1000): a kernel that skips the online-softmax rescale or drops one
# 32-key tile of a long row misses by several times this bound.
ATTN_TOL = 2.0**-6
Q_STD = 3.0
KV_STD = 0.5
# Narrow pages hold value / KV_SCALE (K/V at std 25: int8 uses its range,
# the fp8 types their mantissas), and the checks fold the scale into
# sm_scale, as the model folds k_scale into q. Unwritten slots hold the
# byte 0x7f: NaN in both fp8 types, 127 in int8.
KV_SCALE = 0.02
NARROW_POISON = 0x7f
PAGE_TYPES = ("bf16", "e4m3", "e5m2", "int8")
# Logits of one forward with a kernel (attention, or the int4 matmul)
# against the same forward with its plain version, row by row: |diff| <= LOGIT_TOL * max|plain row|, and the argmax of
# every row must agree. One-ulp bf16 differences in each layer's attention
# output propagate through 32 layers of bf16 matmuls.
LOGIT_TOL = 5e-2
NUM_REQUESTS = 16
MAX_TOKENS = 64
# The int4 projections of one Llama-3.1-8B layer: name -> (K, N).
INT4_SITES = {"wqkv": (4096, 6144), "wo": (4096, 4096),
              "w13": (4096, 28672), "down": (14336, 4096)}
INT4_GROUP = 128
INT4_CHECK_T = (1, 8, 32, 64, 100, 2048)
INT4_TIME_T = (32, 2048)
# int4 matmul outputs are compared row by row (the N outputs of one
# token): |kernel - other| <= tol * max|other row|, x at std 1, against
# two products. The exact one, with f32 weights: the kernel multiplies raw
# nibbles and scales f32 partial sums per group, so it differs only in the
# order of its f32 sums (tensor-core fragments and split K against one
# cuBLAS f32 product), about sqrt(K) * 2^-24 of the row's largest element:
# INT4_TOL_SAME. And the plain version, which rounds the dequantized weight
# to bf16, up to 2^-9 relative per term, adding up as a random walk over K:
# INT4_TOL_ROUNDED, which also holds the plain version to the exact one.
INT4_TOL_SAME = 2.0**-14
INT4_TOL_ROUNDED = 2.0**-6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over `iters` calls, after warm-up
    calls, from CUDA events. The timed launches are queued behind a spin
    kernel that outlasts their enqueueing, so a call that the host enqueues
    more slowly than the card runs it is still timed on the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Cycles at up to 2 GHz for 1.5 times the expected enqueue time.
    torch.cuda._sleep(int(host_s * iters * 1.5 * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------------
# Attention inputs
# ----------------------------------------------------------------------


def make_attention_case(seqs, num_q_heads, num_kv_heads, head_dim, *,
                        padded_seqs, padded_tokens, device, seed,
                        num_layers=1, page_type="bf16"):
    """A ragged batch over a paged cache of the given page type.

    seqs: (q_len, kv_len) per live sequence. Each sequence's pages are a
    random permutation of the cache's pages; slots past kv_len, and every
    page nobody owns, hold NaN (127 in int8 pages). A narrow cache holds
    the same values as the bf16 one, divided by KV_SCALE and rounded to
    its type; case["kv_scale"] is the factor to fold into sm_scale. With
    num_layers > 1 the cache holds that
    many independent layers ([L, P, ...]) so timed launches can rotate
    through more bytes than the L2 cache holds.
    """
    import torch

    from aphrodite_tpu_torch.ops.decode_attention import KERNEL_PAGE_TYPES
    from aphrodite_tpu_torch.ops.kv_cache import quantize_kv

    rng = np.random.default_rng(seed)
    pps = max(-(-kv // PAGE_SIZE) for _, kv in seqs) + 1
    need = sum(-(-kv // PAGE_SIZE) for _, kv in seqs)
    num_pages = need + 4
    perm = rng.permutation(num_pages)
    page_indices = np.zeros((padded_seqs, pps), np.int32)
    kv_lens = np.zeros((padded_seqs,), np.int32)
    cu = np.zeros((padded_seqs + 1,), np.int32)
    live = np.zeros((num_pages, PAGE_SIZE), bool)
    j = 0
    for i, (q_len, kv_len) in enumerate(seqs):
        npg = -(-kv_len // PAGE_SIZE)
        page_indices[i, :npg] = perm[j:j + npg]
        for p in range(npg):
            n = min(PAGE_SIZE, kv_len - p * PAGE_SIZE)
            live[perm[j + p], :n] = True
        j += npg
        kv_lens[i] = kv_len
        cu[i + 1] = cu[i] + q_len
    cu[len(seqs) + 1:] = cu[len(seqs)]
    if cu[-1] > padded_tokens:
        raise ValueError("padded_tokens is smaller than the tokens")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (num_layers, num_pages, PAGE_SIZE, 2 * num_kv_heads, head_dim)
    kv = torch.randn(shape, generator=gen) * KV_STD
    dead = torch.from_numpy(~live)
    if page_type == "bf16":
        kv = kv.to(torch.bfloat16)
        kv[:, dead] = float("nan")
        kv_scale = 1.0
    else:
        dtype = {v: k for k, v in KERNEL_PAGE_TYPES.items()}[page_type]
        kv = quantize_kv(kv, torch.tensor(KV_SCALE), dtype)
        kv.view(torch.uint8)[:, dead] = NARROW_POISON
        kv_scale = KV_SCALE
    q = (torch.randn((padded_tokens, num_q_heads, head_dim), generator=gen)
         * Q_STD).to(torch.bfloat16)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    case = dict(q=q.to(device), kv=kv.to(device), kv_lens=t(kv_lens),
                page_indices=t(page_indices), cu_q_lens=t(cu),
                num_seqs=t(np.asarray([len(seqs)], np.int32)))
    case["seqs"] = list(seqs)
    case["kv_scale"] = kv_scale
    return case


def attention_work(case, num_q_heads, num_kv_heads, head_dim, decode):
    """(bytes, flops) the call needs on this data: q and out of the live
    tokens once (bf16), each live K/V row once at the page type's size,
    the index tensors the kernel takes; 4 * D FLOPs per visible (query
    head, key) pair."""
    itemsize = 2
    kv_itemsize = case["kv"].dtype.itemsize
    tokens = sum(q for q, _ in case["seqs"])
    kv_rows = sum(kv for _, kv in case["seqs"])
    pairs = 0
    for q_len, kv_len in case["seqs"]:
        first = kv_len - q_len  # position of the first query token
        pairs += sum(first + i + 1 for i in range(q_len))
    index = [case["kv_lens"], case["page_indices"]]
    if not decode:
        index.append(case["cu_q_lens"])
    nbytes = (2 * tokens * num_q_heads * head_dim * itemsize
              + kv_rows * 2 * num_kv_heads * head_dim * kv_itemsize
              + sum(t.numel() * 4 for t in index))
    flops = 4 * pairs * num_q_heads * head_dim
    return nbytes, flops


def sdpa_inputs(case, layer, num_q_heads, num_kv_heads, head_dim,
                decode):
    """Pre-gathered contiguous inputs for one scaled_dot_product_attention
    call computing the same function over the live sequences."""
    import torch

    from aphrodite_tpu_torch.ops.decode_attention import gather_kv

    kv = case["kv"][layer]
    cu = case["cu_q_lens"].tolist()
    ks, vs = [], []
    for s, (_, kv_len) in enumerate(case["seqs"]):
        k, v = gather_kv(kv, case["page_indices"][s], kv_len)
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    rep = num_q_heads // num_kv_heads
    dev = case["q"].device
    if decode:
        n = len(case["seqs"])
        lmax = max(k.shape[0] for k in ks)
        kk = torch.zeros((n, num_q_heads, lmax, head_dim), dtype=torch.bfloat16,
                         device=dev)
        vv = torch.zeros_like(kk)
        mask = torch.zeros((n, 1, 1, lmax), dtype=torch.bool, device=dev)
        for s, (k, v) in enumerate(zip(ks, vs)):
            kk[s, :, :k.shape[0]] = k.repeat_interleave(rep, 1).transpose(0, 1)
            vv[s, :, :v.shape[0]] = v.repeat_interleave(rep, 1).transpose(0, 1)
            mask[s, ..., :k.shape[0]] = True
        qq = case["q"][:n, :, None, :]
        return qq, kk, vv, mask
    k = torch.cat(ks).repeat_interleave(rep, 1).transpose(0, 1)[None]
    v = torch.cat(vs).repeat_interleave(rep, 1).transpose(0, 1)[None]
    tokens = cu[len(case["seqs"])]
    mask = torch.zeros((tokens, k.shape[2]), dtype=torch.bool, device=dev)
    key0 = 0
    for s, (q_len, kv_len) in enumerate(case["seqs"]):
        pos = torch.arange(kv_len - q_len, kv_len, device=dev)
        mask[cu[s]:cu[s + 1], key0:key0 + kv_len] = (
            torch.arange(kv_len, device=dev)[None, :] <= pos[:, None])
        key0 += kv_len
    qq = case["q"][:tokens].transpose(0, 1)[None]
    return qq, k, v, mask


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------


def build_kernels():
    from aphrodite_tpu_torch.ops import cuda_build

    t0 = time.monotonic()
    per_source = cuda_build.build()
    total = time.monotonic() - t0
    print(f"build: {total:.1f} s wall, per source "
          + ", ".join(f"{k}.cu {v:.1f} s" for k, v in per_source.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def check_close(errs, name, label, got, want, rows):
    """Fail unless the kernel output `got` is finite and, row by row on
    the first `rows` tokens, within ATTN_TOL of the plain version's
    `want`; keep the largest error per kernel in `errs`."""
    got = got[:rows].float()
    want = want[:rows].float()
    if not bool(got.isfinite().all()):
        fail(f"{name} [{label}]: non-finite output")
    err = (got - want).abs().amax(-1)  # [rows, QH]
    scale = want.abs().amax(-1)
    worst = float((err / scale.clamp_min(1e-30)).max())
    print(f"check {name} [{label}]: max_abs_err {float(err.max()):.3e}, "
          f"worst row err / max|row| {worst:.3e} (tolerance {ATTN_TOL:.3e})",
          flush=True)
    if not bool((err <= ATTN_TOL * scale).all()):
        fail(f"{name} [{label}] disagrees with its plain version")
    errs[name] = max(errs[name], float(err.max()))


def variant_name(kernel: str, page_type: str) -> str:
    """The name a kernel's variant for one page type goes by in this
    script's output: the bf16 one keeps the kernel's name."""
    return kernel if page_type == "bf16" else f"{kernel}_{page_type}"


def check_equals_bf16_kernel(name, label, got, fn, case, args, kw):
    """Fail unless the narrow-page result `got` equals, bit for bit, the
    bf16 variant's on the same pages widened to bf16 beforehand."""
    import torch

    widened = case["kv"][0].to(torch.bfloat16)
    if not torch.equal(widened.float().nan_to_num(),
                       case["kv"][0].float().nan_to_num()):
        fail(f"{name} [{label}]: pages are not exact in bf16")
    same = fn(case["q"], widened, *args, **kw)
    if not torch.equal(got, same):
        diff = float((got.float() - same.float()).abs().max())
        fail(f"{name} [{label}]: differs from the bf16 kernel on the "
             f"widened pages (max abs {diff:.3e})")
    print(f"check {name} [{label}]: equal, bit for bit, to the bf16 kernel "
          "on the widened pages", flush=True)


def kernel_checks(device, geometry):
    """Each kernel, on every page type, against its plain version (and
    the narrow variants against the bf16 one); returns the max abs error
    per kernel variant."""
    from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                                   ref_ragged_paged_attention)
    from aphrodite_tpu_torch.ops.decode_attention import (
        paged_decode_attention, ref_paged_decode_attention)

    qh, kvh, d = geometry
    # Every case holds rows that see more than 1000 keys.
    ragged_cases = [
        ("mixed prefill+decode", [(1, 300), (200, 200), (1, 17), (77, 77),
                                  (1, 1100), (90, 1250)], {}),
        ("chunked prefill on cached prefix", [(128, 641), (64, 1064),
                                              (5, 1029), (1, 33)], {}),
        ("window 100 + soft cap 30", [(1, 300), (150, 150), (64, 1100),
                                      (1, 1500), (1, 17)],
         dict(sliding_window=100, soft_cap=30.0)),
    ]
    decode_cases = [
        ("decode with dead rows", 12, {}),
        ("decode window 100 + soft cap 30", 16,
         dict(sliding_window=100, soft_cap=30.0)),
    ]
    errs = {}
    for page_type in PAGE_TYPES:
        ragged = variant_name("ragged_paged_attention", page_type)
        decode = variant_name("paged_decode_attention", page_type)
        errs[ragged] = errs[decode] = 0.0
        for i, (label, seqs, kw) in enumerate(ragged_cases):
            tokens = sum(q for q, _ in seqs)
            case = make_attention_case(seqs, qh, kvh, d, padded_seqs=8,
                                       padded_tokens=tokens + 13,
                                       device=device, seed=SEED + i,
                                       page_type=page_type)
            kw = dict(kw, sm_scale=d**-0.5 * case["kv_scale"])
            args = (case["kv_lens"], case["page_indices"], case["cu_q_lens"],
                    case["num_seqs"])
            got = ragged_paged_attention(case["q"], case["kv"][0], *args,
                                         **kw)
            want = ref_ragged_paged_attention(case["q"], case["kv"][0],
                                              *args, **kw)
            check_close(errs, ragged, label, got, want, tokens)
            # Padding tokens belong to no sequence and must be zeros.
            if float(got[tokens:].float().abs().max()) != 0.0:
                fail(f"{ragged} [{label}]: padding rows not zero")
            if page_type != "bf16":
                check_equals_bf16_kernel(ragged, label, got,
                                         ragged_paged_attention, case, args,
                                         kw)
        for i, (label, live, kw) in enumerate(decode_cases):
            rng = np.random.default_rng(SEED + 10 + i)
            lens = rng.integers(1, 1100, size=live)
            lens[:2] = (1500, 1025)
            seqs = [(1, int(n)) for n in lens]
            case = make_attention_case(seqs, qh, kvh, d, padded_seqs=16,
                                       padded_tokens=16, device=device,
                                       seed=SEED + 10 + i,
                                       page_type=page_type)
            kw = dict(kw, sm_scale=d**-0.5 * case["kv_scale"])
            args = (case["kv_lens"], case["page_indices"])
            got = paged_decode_attention(case["q"], case["kv"][0], *args,
                                         case["num_seqs"], **kw)
            want = ref_paged_decode_attention(case["q"], case["kv"][0],
                                              *args, **kw)
            check_close(errs, decode, label, got, want, 16)
            if page_type != "bf16":
                check_equals_bf16_kernel(decode, label, got,
                                         paged_decode_attention, case, args,
                                         kw)
    return errs


def kernel_timings(device, geometry, prompt_lens, iters, errs):
    """Checks and times at the main path's shapes: a full 2048-token
    prefill step (prompts in arrival order, the last one chunked) and a
    decode step of all requests mid-generation in their 32-row bucket,
    on every page type in turn (the same sequences and page tables; the
    narrow caches hold the bf16 one's values over KV_SCALE). Returns, per
    kernel variant, a dict of ms, plain_ms, library_ms, bound_ms,
    bound_by."""
    import torch

    from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                                   ref_ragged_paged_attention)
    from aphrodite_tpu_torch.ops.decode_attention import (
        paged_decode_attention, ref_paged_decode_attention)

    qh, kvh, d = geometry
    layers = 16  # rotate through more K/V bytes than the 50 MB L2 holds
    prefill, budget = [], 2048
    for n in prompt_lens:
        take = min(int(n), budget)
        prefill.append((take, take))
        budget -= take
        if budget == 0:
            break
    decode = [(1, int(n) + MAX_TOKENS // 2) for n in prompt_lens]
    shapes = {
        "ragged_paged_attention": (prefill, 32, 2048),
        "paged_decode_attention": (decode, 32, 32),
    }
    out = {}
    for kernel, page_type in ((k, p) for k in shapes for p in PAGE_TYPES):
        seqs, padded_seqs, padded_tokens = shapes[kernel]
        name = variant_name(kernel, page_type)
        case = make_attention_case(seqs, qh, kvh, d, padded_seqs=padded_seqs,
                                   padded_tokens=padded_tokens, device=device,
                                   seed=SEED + 20, num_layers=layers,
                                   page_type=page_type)
        scale = d**-0.5 * case["kv_scale"]
        decode_kernel = kernel == "paged_decode_attention"
        state = {"layer": 0}

        def call(use_kernel):
            layer = state["layer"] = (state["layer"] + 1) % layers
            kv = case["kv"][layer]
            if decode_kernel:
                fn = (paged_decode_attention if use_kernel
                      else ref_paged_decode_attention)
                extra = ((case["num_seqs"],) if use_kernel else ())
                return fn(case["q"], kv, case["kv_lens"],
                          case["page_indices"], *extra, sm_scale=scale)
            fn = (ragged_paged_attention if use_kernel
                  else ref_ragged_paged_attention)
            return fn(case["q"], kv, case["kv_lens"], case["page_indices"],
                      case["cu_q_lens"], case["num_seqs"], sm_scale=scale)

        state["layer"] = layers - 1  # the next call reads layer 0
        got = call(True)
        state["layer"] = layers - 1
        rows = padded_seqs if decode_kernel else sum(q for q, _ in seqs)
        check_close(errs, name, "main-path shape", got, call(False), rows)
        ms = time_ms(lambda: call(True), iters)
        plain_ms = time_ms(lambda: call(False), max(1, iters // 20))
        qq, kk, vv, mask = sdpa_inputs(case, 0, qh, kvh, d, decode_kernel)
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask, scale=scale), iters)
        nbytes, flops = attention_work(case, qh, kvh, d, decode_kernel)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else
                         "operations")
        beside = ("" if page_type == "bf16" else
                  f" (bf16 pages, same case: {out[kernel]['ms']:.4f} ms)")
        print(f"time {name}: {len(seqs)} seqs, "
              f"{sum(q for q, _ in seqs)} query tokens, "
              f"{sum(kv for _, kv in seqs)} kv rows: kernel {ms:.4f} ms"
              f"{beside}, plain {plain_ms:.4f} ms, library (sdpa on the "
              f"rows widened to bf16, gather excluded) {library_ms:.4f} ms, "
              f"bound {out[name]['bound_ms']:.4f} ms "
              f"({out[name]['bound_by']}: {nbytes} bytes, {flops} FLOPs)",
              flush=True)
        del case, qq, kk, vv, mask
    return out


# ----------------------------------------------------------------------
# int4 matmul
# ----------------------------------------------------------------------


def make_int4_case(K, N, layers, device, seed, wide_zero=False):
    """A layer-stacked packed container [layers, K/2, N] with group
    INT4_GROUP, made on the device from a seed: nibbles uniform in 0..15,
    scale in 0.001..0.021, zero an integer in 0..15 (or -3..19 with
    wide_zero: GPTQ stores zero + 1 up to 16, and quantize_from_float
    does not clip it)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    groups = K // INT4_GROUP
    q4p = torch.randint(0, 256, (layers, K // 2, N), generator=gen,
                        device=device, dtype=torch.uint8).view(torch.int8)
    scale = torch.rand((layers, groups, N), generator=gen,
                       device=device) * 0.02 + 0.001
    lo, hi = (-3, 20) if wide_zero else (0, 16)
    zero = torch.randint(lo, hi, (layers, groups, N), generator=gen,
                         device=device).float()
    return q4p, scale, zero


def make_x(T, K, device, seed):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((T, K), generator=gen, device=device).to(
        torch.bfloat16)


def int4_checks(device):
    """The int4 kernel against its plain version and the exact f32
    product, at every site and T; returns the max abs error against the
    plain version."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (dequantize_int4,
                                                      int4p_matmul,
                                                      int4p_matmul_ref,
                                                      unpack_int4_rows)

    worst_abs = 0.0
    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        wide = site == "wo"
        q4p, scale, zero = make_int4_case(K, N, 2, device, SEED + 40 + i,
                                          wide_zero=wide)
        w_exact = dequantize_int4(unpack_int4_rows(q4p[1]), scale[1],
                                  zero[1], INT4_GROUP)
        for T in INT4_CHECK_T:
            x = make_x(T, K, device, SEED + 50 + T)
            got = int4p_matmul(x, q4p, scale, zero, INT4_GROUP, layer_idx=1)
            torch.cuda.synchronize()
            if tuple(got.shape) != (T, N) or got.dtype != torch.float32:
                fail(f"int4p_matmul [{site} T={T}]: output {got.shape} "
                     f"{got.dtype}")
            if not bool(got.isfinite().all()):
                fail(f"int4p_matmul [{site} T={T}]: non-finite output")
            plain = int4p_matmul_ref(x, q4p[1], scale[1], zero[1],
                                     INT4_GROUP)
            exact = x.float() @ w_exact
            pairs = (("kernel", got, "plain", plain, INT4_TOL_ROUNDED),
                     ("kernel", got, "exact f32", exact, INT4_TOL_SAME),
                     ("plain", plain, "exact f32", exact, INT4_TOL_ROUNDED))
            ratios = []
            for name, a, label, other, tol in pairs:
                err = (a - other).abs().amax(-1)
                bound = other.abs().amax(-1)
                ratios.append(float((err / bound).max()))
                if not bool((err <= tol * bound).all()):
                    fail(f"int4p_matmul [{site} T={T}"
                         f"{' wide zero' if wide else ''}]: {name} disagrees "
                         f"with the {label} product: worst row err / "
                         f"max|row| {ratios[-1]:.3e} (tolerance {tol:.3e})")
            abs_err = float((got - plain).abs().max())
            worst_abs = max(worst_abs, abs_err)
            print(f"check int4p_matmul [{site} {K}x{N} T={T}"
                  f"{' wide zero' if wide else ''}]: max_abs_err against plain {abs_err:.3e}; worst row err "
                  f"/ max|row|: kernel vs plain {ratios[0]:.3e} (tolerance "
                  f"{pairs[0][4]:.3e}), kernel vs exact {ratios[1]:.3e} "
                  f"(tolerance {pairs[1][4]:.3e}), plain vs exact "
                  f"{ratios[2]:.3e} (tolerance {pairs[2][4]:.3e})",
                  flush=True)
        del q4p, scale, zero, w_exact
    return worst_abs


def int4_work(T, K, N):
    """(bytes, flops) of one call: x, the packed weights, f32 scale and
    zero and the f32 output once each; 2 * T * K * N FLOPs."""
    nbytes = (T * K * 2 + K * N // 2 + 2 * (K // INT4_GROUP) * N * 4
              + T * N * 4)
    return nbytes, 2 * T * K * N


def int4_timings(device, iters):
    """Times of the int4 kernel at every (site, T) of INT4_TIME_T beside
    its plain version, the library call and the bound; each timed launch
    takes the next layer of a stack that holds more bytes than the 50 MB
    L2. Returns a list of per-point dicts."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (dequantize_int4,
                                                      int4p_matmul,
                                                      int4p_matmul_ref,
                                                      unpack_int4_rows)

    points = []
    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        layer_bytes = K * N // 2 + 2 * (K // INT4_GROUP) * N * 4
        layers = -(-100_000_000 // layer_bytes) + 1
        q4p, scale, zero = make_int4_case(K, N, layers, device,
                                          SEED + 60 + i)
        dense = torch.stack([
            dequantize_int4(unpack_int4_rows(q4p[l]), scale[l], zero[l],
                            INT4_GROUP).to(torch.bfloat16)
            for l in range(layers)])
        for T in INT4_TIME_T:
            x = make_x(T, K, device, SEED + 70 + T)
            state = {"layer": 0}

            def nxt():
                state["layer"] = (state["layer"] + 1) % layers
                return state["layer"]

            n = iters if T <= 64 else max(4, iters // 10)
            ms = time_ms(lambda: int4p_matmul(x, q4p, scale, zero,
                                              INT4_GROUP, layer_idx=nxt()),
                         n)

            def plain():
                l = nxt()
                return int4p_matmul_ref(x, q4p[l], scale[l], zero[l],
                                        INT4_GROUP)

            plain_ms = time_ms(plain, max(2, n // 20))
            library_ms = time_ms(lambda: torch.matmul(x, dense[nxt()]), n)
            nbytes, flops = int4_work(T, K, N)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS * 1e3
            pt = dict(site=site, K=K, N=N, T=T, ms=ms, plain_ms=plain_ms,
                      library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations")
            points.append(pt)
            print(f"time int4p_matmul [{site} {K}x{N} T={T}, {layers} "
                  f"layers in turn]: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library (matmul on bf16 weights) "
                  f"{library_ms:.4f} ms, bound {pt['bound_ms']:.4f} ms "
                  f"({pt['bound_by']}: {nbytes} bytes, {flops} FLOPs)",
                  flush=True)
        del q4p, scale, zero, dense
        torch.cuda.empty_cache()
    return points


def int4_block_sweep(device, iters):
    """Rows of x per block, 16 against 32, each with the split of K the
    wrapper gives it. The wrapper's choice by T (kernel_plan) comes from
    these times."""
    from aphrodite_tpu_torch.ops.quant_matmul import int4p_matmul

    for site in ("wqkv", "down"):
        K, N = INT4_SITES[site]
        layers = 8
        q4p, scale, zero = make_int4_case(K, N, layers, device, SEED + 80)
        for T in (8, 16, 32, 2048):
            x = make_x(T, K, device, SEED + 90 + T)
            state = {"layer": 0}

            def nxt():
                state["layer"] = (state["layer"] + 1) % layers
                return state["layer"]

            times = {bm: time_ms(
                lambda: int4p_matmul(x, q4p, scale, zero, INT4_GROUP,
                                     layer_idx=nxt(), block_m=bm),
                iters) for bm in (16, 32)}
            print(f"sweep int4p_matmul [{site} T={T}]: 16-row blocks "
                  f"{times[16]:.4f} ms, 32-row blocks {times[32]:.4f} ms",
                  flush=True)
        del q4p, scale, zero


def write_model_dir(path: str, config: dict) -> str:
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return path


# kv_cache_dtype -> the page type its attention launches must be of.
CACHE_PAGE_TYPES = {"auto": "bf16", "fp8_e4m3": "e4m3", "fp8_e5m2": "e5m2",
                    "int8": "int8"}


def main_path(device, model_config, prompt_lens, num_scheduler_steps=8,
              quantization=None, kv_cache_dtype="auto", kv_scale=None):
    """LLM.generate through the port's entry point, with bf16 weights or
    (quantization="gptq") packed int4 ones, and a bf16 KV cache or
    (kv_cache_dtype) a narrow one, whose per-layer scales are ones or
    (kv_scale) come from a JSON file; returns the launch counts of the
    path's kernels, by variant name, and the rates."""
    import torch

    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.attention import ragged_paged_attention
    from aphrodite_tpu_torch.ops.decode_attention import \
        paged_decode_attention
    from aphrodite_tpu_torch.ops.quant_matmul import int4p_matmul

    wrappers = {"ragged_paged_attention": ragged_paged_attention,
                "paged_decode_attention": paged_decode_attention}
    if quantization is not None:
        wrappers["int4p_matmul"] = int4p_matmul
    page_type = CACHE_PAGE_TYPES[kv_cache_dtype]
    layers = model_config["num_hidden_layers"]
    label = (f"main path ({quantization or 'bf16'} weights, "
             f"{kv_cache_dtype if page_type != 'bf16' else 'bf16'} cache, "
             f"{layers} layers)")
    vocab = model_config["vocab_size"]
    with tempfile.TemporaryDirectory() as td:
        scales_path = None
        if kv_scale is not None:
            scales_path = os.path.join(td, "kv_scales.json")
            with open(scales_path, "w") as f:
                json.dump({"kv_cache": {"scaling_factor": {"0": {
                    str(i): kv_scale for i in range(layers)}}}}, f)
        t0 = time.monotonic()
        llm = LLM(model=write_model_dir(td, model_config),
                  load_format="dummy", dtype="bfloat16", seed=SEED,
                  quantization=quantization, kv_cache_dtype=kv_cache_dtype,
                  quantization_param_path=scales_path,
                  num_scheduler_steps=num_scheduler_steps, block_size=16,
                  max_num_batched_tokens=2048, skip_tokenizer_init=True,
                  device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"{label}: engine up in {time.monotonic() - t0:.1f} s, "
              f"{llm.engine.runner.num_pages} KV pages of "
              f"{llm.engine.runner.kv_cache.dtype}, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
              flush=True)
    rng = np.random.default_rng(SEED)
    sp = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS,
                        ignore_eos=True, detokenize=False)
    # Warm-up (library initialisation, allocator growth): not counted.
    llm.generate(prompt_token_ids=[rng.integers(0, vocab, 32).tolist()] * 2,
                 sampling_params=sp)
    prompts = [rng.integers(0, vocab, int(n)).tolist() for n in prompt_lens]
    for k in llm.engine.phase_timings:
        llm.engine.phase_timings[k] = 0 if isinstance(
            llm.engine.phase_timings[k], int) else 0.0
    # Forwards are counted where the runner calls the model, so that the
    # attention launches can be held to one per layer and forward.
    model = llm.engine.runner.model
    forwards = [0]
    model_forward = model.forward

    def counted_forward(*args, **kwargs):
        forwards[0] += 1
        return model_forward(*args, **kwargs)

    model.forward = counted_forward
    for fn in wrappers.values():
        fn.launches = 0
    for fn in (ragged_paged_attention, paged_decode_attention):
        fn.launches_by_dtype = {}
    t0 = time.monotonic()
    outs = llm.generate(prompt_token_ids=prompts, sampling_params=sp)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    by_dtype = {name: dict(wrappers[name].launches_by_dtype)
                for name in ("ragged_paged_attention",
                             "paged_decode_attention")}
    model.forward = model_forward
    forwards = forwards[0]
    pt = llm.engine.get_phase_timings()
    lens = [len(o.outputs[0].token_ids) for o in outs]
    rates = dict(
        prefill_tok_s=pt["prefill_tokens"] / max(pt["prefill_s"], 1e-9),
        decode_tok_s=pt["decode_tokens"] / max(pt["decode_s"], 1e-9))
    print(f"{label}: {len(outs)} requests, {sum(prompt_lens)} prompt "
          f"tokens, {sum(lens)} generated tokens in {wall:.2f} s; "
          f"{pt['prefill_iterations']} prefill/mixed steps "
          f"({rates['prefill_tok_s']:.1f} prefill tok/s, "
          f"{pt['prefill_s'] / max(pt['prefill_iterations'], 1) * 1e3:.1f} "
          f"ms per step), {pt['decode_iterations']} decode steps "
          f"({rates['decode_tok_s']:.1f} decode tok/s, "
          f"{pt['decode_s'] / max(pt['decode_iterations'], 1) * 1e3:.1f} ms "
          f"per step); launches {launches}, attention launches by page "
          f"type {by_dtype}", flush=True)
    if any(n != MAX_TOKENS for n in lens):
        fail(f"outputs with other than {MAX_TOKENS} tokens: {lens}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was never launched on the {label}")
    # Every forward launches one attention kernel per layer, of the
    # cache's page type: the ragged one in prefill and mixed steps, the
    # decode one in the fused window. A forward that took a plain version
    # would leave the sum short.
    for name, counts in by_dtype.items():
        if counts != {page_type: launches[name]}:
            fail(f"{name} on the {label} was launched on page types "
                 f"{counts}, not only on {page_type}")
    attention = (launches["ragged_paged_attention"]
                 + launches["paged_decode_attention"])
    if attention != layers * forwards:
        fail(f"{attention} attention launches on the {label} are not "
             f"{layers} layers x {forwards} forwards")
    print(f"{label}: {forwards} forwards, each with {layers} attention "
          f"launches on {page_type} pages", flush=True)
    if quantization is not None:
        # And four int4 matmuls (wqkv, wo, w13, down) per layer.
        if launches["int4p_matmul"] != 4 * layers * forwards:
            fail(f"int4p_matmul launches {launches['int4p_matmul']} are "
                 f"not 4 x {layers} layers x {forwards} forwards")
        print(f"{label}: int4p_matmul launched {4 * layers} times in each "
              "forward", flush=True)
    for o in outs:
        if not all(0 <= t < vocab for t in o.outputs[0].token_ids):
            fail("generated token id out of the vocabulary")
    # What this path adds is compared: the attention kernels (on its page
    # type) unless the cache is bf16 and the weights int4, then the int4
    # matmul.
    what = ("int4" if quantization is not None and page_type == "bf16"
            else "attention")
    compare_logits(llm, device, rng, vocab, what)
    launches = {variant_name(name, page_type) if name in by_dtype else name: n
                for name, n in launches.items()}
    return launches, rates


def compare_logits(llm, device, rng, vocab, what):
    """One prefill forward (ragged kernel) and one decode forward (decode
    kernel) with every kernel, then the same with the plain version of one
    of them on the same inputs and the same starting cache (of the
    engine's page type, written through its scales); logits compared.
    `what` names the kernels swapped for their plain versions:
    "attention" (both attention kernels) or "int4" (the int4 matmul)."""
    import torch

    import aphrodite_tpu_torch.models.llama as llama_mod
    import aphrodite_tpu_torch.quantization.qlinear as qlinear_mod
    from aphrodite_tpu_torch.ops.quant_matmul import int4p_matmul_ref
    from aphrodite_tpu_torch.models.interface import ForwardBatch
    from aphrodite_tpu_torch.ops.attention import ref_ragged_paged_attention
    from aphrodite_tpu_torch.ops.decode_attention import \
        ref_paged_decode_attention

    runner = llm.engine.runner
    model, params = runner.model, runner.params
    lens = [300, 17, 129]
    S, T = 8, 512
    pps = runner.pages_per_seq
    ids = np.zeros((T,), np.int32)
    pos = np.zeros((T,), np.int32)
    slots = np.full((T,), runner.trash_slot_base, np.int32)
    pages = np.zeros((S, pps), np.int32)
    kv_lens = np.zeros((S,), np.int32)
    cu = np.zeros((S + 1,), np.int32)
    next_page, off = 0, 0
    for i, n in enumerate(lens):
        npg = -(-(n + 1) // PAGE_SIZE)
        pages[i, :npg] = np.arange(next_page, next_page + npg)
        next_page += npg
        p = np.arange(n)
        ids[off:off + n] = rng.integers(0, vocab, n)
        pos[off:off + n] = p
        slots[off:off + n] = pages[i, p // PAGE_SIZE] * PAGE_SIZE + p % PAGE_SIZE
        kv_lens[i] = n
        cu[i + 1] = cu[i] + n
        off += n
    cu[len(lens) + 1:] = cu[len(lens)]
    last = cu[1:len(lens) + 1] - 1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    prefill = ForwardBatch(t(ids), t(pos), t(slots), t(kv_lens), t(pages),
                           t(cu), t(np.asarray([len(lens)], np.int32)),
                           t(np.pad(last, (0, S - len(lens)))))
    dpos = np.zeros((S,), np.int32)
    dpos[:len(lens)] = lens
    dslots = runner.trash_slot_base + np.arange(S, dtype=np.int32)
    dslots[:len(lens)] = [pages[i, n // PAGE_SIZE] * PAGE_SIZE
                          + n % PAGE_SIZE for i, n in enumerate(lens)]
    dlens = np.zeros((S,), np.int32)
    dlens[:len(lens)] = np.asarray(lens) + 1
    decode = ForwardBatch(t(np.arange(S, dtype=np.int32)), t(dpos),
                          t(dslots), t(dlens), t(pages), None,
                          t(np.asarray([len(lens)], np.int32)),
                          t(np.arange(S, dtype=np.int32)))
    base = runner.kv_cache[:, :next_page].clone()

    def run():
        runner.kv_cache[:, :next_page] = base
        with torch.inference_mode():
            h = model.forward(params, runner.kv_cache, prefill,
                              runner.kv_scales)
            lp = model.compute_logits(params, h[prefill.logits_indices])
            h = model.forward(params, runner.kv_cache, decode,
                              runner.kv_scales)
            ld = model.compute_logits(params, h)
        n = len(lens)
        return lp[:n], ld[:n]

    def plain_attention(q, kv_pages, kv_lens, page_indices, cu_q_lens,
                        num_seqs, **kw):
        if cu_q_lens is None:
            return ref_paged_decode_attention(q, kv_pages, kv_lens,
                                              page_indices, **kw)
        return ref_ragged_paged_attention(q, kv_pages, kv_lens, page_indices,
                                          cu_q_lens, num_seqs, **kw)

    def plain_int4(x, q4p, scale, zero, group, layer_idx=None):
        # On f32 x the plain version keeps the dequantized weight in f32,
        # as the kernel's arithmetic does; on bf16 x it would round it to
        # bf16, which moves a logit by about 1 % of the row's largest and
        # can swap two near-equal logits of a random-weight model.
        return int4p_matmul_ref(x.float(), q4p[layer_idx], scale[layer_idx],
                                zero[layer_idx], group)

    module, attr, plain = {
        "attention": (llama_mod, "ragged_paged_attention", plain_attention),
        "int4": (qlinear_mod, "int4p_matmul", plain_int4)}[what]
    got = run()
    kernel = getattr(module, attr)
    setattr(module, attr, plain)
    try:
        want = run()
    finally:
        setattr(module, attr, kernel)
    worst = 0.0
    for label, g, w in zip((f"{what} prefill", f"{what} decode"), got, want):
        if not bool(g.isfinite().all()):
            fail(f"{label} logits are not finite")
        err = (g - w).abs().amax(-1)
        scale = w.abs().amax(-1)
        agree = float((g.argmax(-1) == w.argmax(-1)).float().mean())
        print(f"logits {label}: max_abs_err {float(err.max()):.3e}, worst "
              f"row err / max|row| {float((err / scale).max()):.3e} "
              f"(tolerance {LOGIT_TOL:.1e}), argmax agreement {agree:.2f}",
              flush=True)
        if not bool((err <= LOGIT_TOL * scale).all()):
            fail(f"{label} logits with the kernel disagree with the "
                 "plain version's")
        if agree < 1.0:
            fail(f"{label} logits with the kernel pick another token "
                 "than with the plain version")
        worst = max(worst, float(err.max()))
    return worst


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a card")
    import aphrodite_tpu_torch  # noqa: F401  (fails outside the repo)

    t_start = time.monotonic()
    build_kernels()
    card = card_line()
    print(card, flush=True)
    geometry = (LLAMA_8B["num_attention_heads"],
                LLAMA_8B["num_key_value_heads"], LLAMA_8B["head_dim"])
    errs = kernel_checks("cuda", geometry)
    errs["int4p_matmul"] = int4_checks("cuda")
    prompt_lens = np.random.default_rng(SEED).integers(
        16, 1025, size=NUM_REQUESTS)
    times = kernel_timings("cuda", geometry, prompt_lens, iters=200,
                           errs=errs)
    int4_points = int4_timings("cuda", iters=200)
    int4_block_sweep("cuda", iters=50)
    # Every engine sizes its KV cache from the free memory, so each is
    # freed (main_path holds the only reference) before the next starts.
    # The last two cover the page types the north-star path does not use,
    # cut to 4 layers.
    short = dict(LLAMA_8B, num_hidden_layers=4)
    paths = {
        "bf16": dict(model_config=LLAMA_8B),
        "gptq": dict(model_config=LLAMA_8B, quantization="gptq"),
        "gptq+fp8_e4m3": dict(model_config=LLAMA_8B, quantization="gptq",
                              kv_cache_dtype="fp8_e4m3"),
        "gptq+fp8_e5m2, 4 layers": dict(model_config=short,
                                        quantization="gptq",
                                        kv_cache_dtype="fp8_e5m2"),
        "gptq+int8, 4 layers": dict(model_config=short, quantization="gptq",
                                    kv_cache_dtype="int8", kv_scale=0.05),
    }
    launches = {}
    for path, kw in paths.items():
        gc.collect()
        torch.cuda.empty_cache()
        launches[path], _ = main_path("cuda", prompt_lens=prompt_lens, **kw)

    def on_paths(name):
        """Launches of one kernel variant on each main path that ran it:
        each was read right after its run, with the counts set to 0 just
        before it."""
        return {path: counts[name] for path, counts in launches.items()
                if name in counts}

    sources = {
        "paged_decode_attention": (
            "aphrodite_tpu_torch/csrc/paged_decode_attention.cu",
            dict.fromkeys(PAGE_TYPES,
                          "aphrodite_tpu/ops/decode_attention.py:95")),
        "ragged_paged_attention": (
            "aphrodite_tpu_torch/csrc/ragged_paged_attention.cu",
            # The JAX package sends fp8 prefill to its vendored fork and
            # bf16 and int8 prefill to the kernel bundled with JAX.
            {"bf16": "aphrodite_tpu/ops/attention.py:336",
             "e4m3": "aphrodite_tpu/ops/rpa_alibi_kernel.py:832",
             "e5m2": "aphrodite_tpu/ops/rpa_alibi_kernel.py:832",
             "int8": "aphrodite_tpu/ops/attention.py:336"}),
    }
    kernels = []
    for kernel, (src, replaces) in sources.items():
        for page_type in PAGE_TYPES:
            name = variant_name(kernel, page_type)
            by_path = on_paths(name)
            if not sum(by_path.values()):
                fail(f"{name} was launched on no main path")
            entry = dict(name=name, route="cuda", source=src,
                         replaces=replaces[page_type], page_type=page_type,
                         launches=sum(by_path.values()),
                         launches_by_path=by_path, max_abs_err=errs[name],
                         **times[name])
            if page_type != "bf16":
                entry["bf16_ms"] = times[kernel]["ms"]
            kernels.append(entry)
    # The int4 kernel's headline times are those of the largest site at
    # the decode step's size; every (site, T) point follows in "points".
    head = next(p for p in int4_points
                if p["site"] == "w13" and p["T"] == 32)
    by_path = on_paths("int4p_matmul")
    kernels.append(dict(
        name="int4p_matmul", route="cuda",
        source="aphrodite_tpu_torch/csrc/int4p_matmul.cu",
        replaces="aphrodite_tpu/ops/quant_matmul.py:528",
        launches=sum(by_path.values()), launches_by_path=by_path,
        max_abs_err=errs["int4p_matmul"],
        **{k: head[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
        shape="w13 4096x28672 T=32", points=int4_points))
    print(f"total: {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
