#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (aphrodite_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. Build every CUDA kernel of the main path from aphrodite_tpu_torch/csrc
   (one nvcc per source, in parallel) and print the build seconds.
2. Print the card's name and power limit as nvidia-smi reports them.
3. Hold each kernel against its plain PyTorch version in bf16 at the
   Llama-3.1-8B attention geometry (32 query heads, 8 kv heads, head_dim
   128, 16-token pages): a mixed prefill and decode batch, a chunked
   prefill on a cached prefix, a decode batch with dead padded rows, and
   sliding window with soft cap. Cache slots past each sequence's length
   hold NaN, so a kernel that reads past kv_len fails the check.
4. Time each kernel at the main path's shapes beside its plain version,
   one PyTorch library call on pre-gathered contiguous K/V
   (scaled_dot_product_attention; the gather is not timed, and the port
   never calls it) and the bound: the larger of the bytes the call must
   move over 3.35 TB/s and its FLOPs over 989 TFLOP/s (H100 SXM bf16).
5. Run the main path: ``LLM.generate`` on a Llama-3.1-8B-geometry model
   (full width, 32 layers, random bf16 weights from a seed) for 16
   greedy requests with prompts of 16-1024 tokens and 64 new tokens each,
   so chunked prefill mixes with fused 8-step decode windows. Both kernel
   launch counters must be > 0 and every output 64 tokens long. Then one
   prefill and one decode forward are run with kernel attention and with
   plain attention on the same inputs, and their logits compared.
6. Print {"kernels": [...]} with each kernel's launches on the main path,
   its error against the plain version and its times; the last line is
   {"ok": true, "device": {...}}.
"""

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
# Logits of one forward with kernel attention against plain attention,
# row by row: |diff| <= LOGIT_TOL * max|plain row|, and the argmax of
# every row must agree. One-ulp bf16 differences in each layer's attention
# output propagate through 32 layers of bf16 matmuls.
LOGIT_TOL = 5e-2
NUM_REQUESTS = 16
MAX_TOKENS = 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over `iters` calls, after one
    warm-up call, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
                        num_layers=1):
    """A ragged batch over a bf16 paged cache.

    seqs: (q_len, kv_len) per live sequence. Each sequence's pages are a
    random permutation of the cache's pages; slots past kv_len, and every
    page nobody owns, hold NaN. With num_layers > 1 the cache holds that
    many independent layers ([L, P, ...]) so timed launches can rotate
    through more bytes than the L2 cache holds.
    """
    import torch

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
    kv = (torch.randn(shape, generator=gen) * KV_STD).to(torch.bfloat16)
    kv[:, torch.from_numpy(~live)] = float("nan")
    q = (torch.randn((padded_tokens, num_q_heads, head_dim), generator=gen)
         * Q_STD).to(torch.bfloat16)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    case = dict(q=q.to(device), kv=kv.to(device), kv_lens=t(kv_lens),
                page_indices=t(page_indices), cu_q_lens=t(cu),
                num_seqs=t(np.asarray([len(seqs)], np.int32)))
    case["seqs"] = list(seqs)
    return case


def attention_work(case, num_q_heads, num_kv_heads, head_dim, decode):
    """(bytes, flops) the call needs on this data: q and out of the live
    tokens once, each live K/V row once, the index tensors the kernel
    takes; 4 * D FLOPs per visible (query head, key) pair."""
    itemsize = 2
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
              + kv_rows * 2 * num_kv_heads * head_dim * itemsize
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


def kernel_checks(device, geometry):
    """Each kernel against its plain version; returns the max abs error
    per kernel."""
    from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                                   ref_ragged_paged_attention)
    from aphrodite_tpu_torch.ops.decode_attention import (
        paged_decode_attention, ref_paged_decode_attention)

    qh, kvh, d = geometry
    scale = d**-0.5
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
    errs = {"ragged_paged_attention": 0.0, "paged_decode_attention": 0.0}
    for i, (label, seqs, kw) in enumerate(ragged_cases):
        tokens = sum(q for q, _ in seqs)
        case = make_attention_case(seqs, qh, kvh, d, padded_seqs=8,
                                   padded_tokens=tokens + 13, device=device,
                                   seed=SEED + i)
        args = (case["q"], case["kv"][0], case["kv_lens"],
                case["page_indices"], case["cu_q_lens"], case["num_seqs"])
        got = ragged_paged_attention(*args, sm_scale=scale, **kw)
        want = ref_ragged_paged_attention(*args, sm_scale=scale, **kw)
        check_close(errs, "ragged_paged_attention", label, got, want, tokens)
        # Padding tokens belong to no sequence and must be zeros.
        if float(got[tokens:].float().abs().max()) != 0.0:
            fail(f"ragged_paged_attention [{label}]: padding rows not zero")
    for i, (label, live, kw) in enumerate(decode_cases):
        rng = np.random.default_rng(SEED + 10 + i)
        lens = rng.integers(1, 1100, size=live)
        lens[:2] = (1500, 1025)
        seqs = [(1, int(n)) for n in lens]
        case = make_attention_case(seqs, qh, kvh, d, padded_seqs=16,
                                   padded_tokens=16, device=device,
                                   seed=SEED + 10 + i)
        args = (case["q"], case["kv"][0], case["kv_lens"],
                case["page_indices"])
        got = paged_decode_attention(*args, case["num_seqs"], sm_scale=scale,
                                     **kw)
        want = ref_paged_decode_attention(*args, sm_scale=scale, **kw)
        check_close(errs, "paged_decode_attention", label, got, want, 16)
    return errs


def kernel_timings(device, geometry, prompt_lens, iters, errs):
    """Checks and times at the main path's shapes: a full 2048-token
    prefill step (prompts in arrival order, the last one chunked) and a
    decode step of all requests mid-generation in their 32-row bucket.
    Returns per-kernel dicts of ms, plain_ms, library_ms, bound_ms,
    bound_by."""
    import torch

    from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                                   ref_ragged_paged_attention)
    from aphrodite_tpu_torch.ops.decode_attention import (
        paged_decode_attention, ref_paged_decode_attention)

    qh, kvh, d = geometry
    scale = d**-0.5
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
    for name, (seqs, padded_seqs, padded_tokens) in shapes.items():
        case = make_attention_case(seqs, qh, kvh, d, padded_seqs=padded_seqs,
                                   padded_tokens=padded_tokens, device=device,
                                   seed=SEED + 20, num_layers=layers)
        decode_kernel = name == "paged_decode_attention"
        state = {"layer": 0}

        def call(kernel):
            layer = state["layer"] = (state["layer"] + 1) % layers
            kv = case["kv"][layer]
            if decode_kernel:
                fn = (paged_decode_attention if kernel
                      else ref_paged_decode_attention)
                extra = ((case["num_seqs"],) if kernel else ())
                return fn(case["q"], kv, case["kv_lens"],
                          case["page_indices"], *extra, sm_scale=scale)
            fn = (ragged_paged_attention if kernel
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
        print(f"time {name}: {len(seqs)} seqs, "
              f"{sum(q for q, _ in seqs)} query tokens, "
              f"{sum(kv for _, kv in seqs)} kv rows: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library (sdpa, gather excluded) "
              f"{library_ms:.4f} ms, bound {out[name]['bound_ms']:.4f} ms "
              f"({out[name]['bound_by']}: {nbytes} bytes, {flops} FLOPs)",
              flush=True)
        del case, qq, kk, vv, mask
    return out


def write_model_dir(path: str, config: dict) -> str:
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return path


def main_path(device, model_config, prompt_lens, num_scheduler_steps=8):
    """LLM.generate through the port's entry point; returns the launch
    counts, tokens/s and the logits comparison."""
    import torch

    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.attention import ragged_paged_attention
    from aphrodite_tpu_torch.ops.decode_attention import \
        paged_decode_attention

    vocab = model_config["vocab_size"]
    with tempfile.TemporaryDirectory() as td:
        t0 = time.monotonic()
        llm = LLM(model=write_model_dir(td, model_config),
                  load_format="dummy", dtype="bfloat16", seed=SEED,
                  num_scheduler_steps=num_scheduler_steps, block_size=16,
                  max_num_batched_tokens=2048, skip_tokenizer_init=True,
                  device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"main path: engine up in {time.monotonic() - t0:.1f} s, "
              f"{llm.engine.runner.num_pages} KV pages", flush=True)
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
    ragged_paged_attention.launches = 0
    paged_decode_attention.launches = 0
    t0 = time.monotonic()
    outs = llm.generate(prompt_token_ids=prompts, sampling_params=sp)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                "paged_decode_attention": paged_decode_attention.launches}
    pt = llm.engine.get_phase_timings()
    lens = [len(o.outputs[0].token_ids) for o in outs]
    print(f"main path: {len(outs)} requests, {sum(prompt_lens)} prompt "
          f"tokens, {sum(lens)} generated tokens in {wall:.2f} s; "
          f"{pt['prefill_iterations']} prefill/mixed steps "
          f"({pt['prefill_tokens'] / max(pt['prefill_s'], 1e-9):.1f} "
          f"prefill tok/s), {pt['decode_iterations']} decode steps "
          f"({pt['decode_tokens'] / max(pt['decode_s'], 1e-9):.1f} "
          f"decode tok/s); launches {launches}", flush=True)
    if any(n != MAX_TOKENS for n in lens):
        fail(f"outputs with other than {MAX_TOKENS} tokens: {lens}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was never launched on the main path")
    for o in outs:
        if not all(0 <= t < vocab for t in o.outputs[0].token_ids):
            fail("generated token id out of the vocabulary")
    logit_err = compare_logits(llm, device, rng, vocab)
    return launches, logit_err


def compare_logits(llm, device, rng, vocab):
    """One prefill forward (ragged kernel) and one decode forward (decode
    kernel) with kernel attention, then the same with plain attention on
    the same inputs and the same starting cache; logits compared."""
    import torch

    import aphrodite_tpu_torch.models.llama as llama_mod
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
            h = model.forward(params, runner.kv_cache, prefill)
            lp = model.compute_logits(params, h[prefill.logits_indices])
            h = model.forward(params, runner.kv_cache, decode)
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

    got = run()
    kernel_attention = llama_mod.ragged_paged_attention
    llama_mod.ragged_paged_attention = plain_attention
    try:
        want = run()
    finally:
        llama_mod.ragged_paged_attention = kernel_attention
    worst = 0.0
    for label, g, w in zip(("prefill", "decode"), got, want):
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
            fail(f"{label} logits with kernel attention disagree with "
                 "plain attention")
        if agree < 1.0:
            fail(f"{label} logits with kernel attention pick another "
                 "token than with plain attention")
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
    prompt_lens = np.random.default_rng(SEED).integers(
        16, 1025, size=NUM_REQUESTS)
    times = kernel_timings("cuda", geometry, prompt_lens, iters=200,
                           errs=errs)
    torch.cuda.empty_cache()
    launches, _ = main_path("cuda", LLAMA_8B, prompt_lens)
    sources = {
        "paged_decode_attention": (
            "aphrodite_tpu_torch/csrc/paged_decode_attention.cu",
            "aphrodite_tpu/ops/decode_attention.py:95"),
        "ragged_paged_attention": (
            "aphrodite_tpu_torch/csrc/ragged_paged_attention.cu",
            "aphrodite_tpu/ops/attention.py:336"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=errs[name], **times[name]))
    print(f"total: {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
