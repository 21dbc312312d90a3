"""How far apart the logits of a random-weight model lie when only the
rounding of its attention changes, by depth.

    python -m aphrodite_tpu_torch.tools.logits_floor gemma2 2 6 14 42

For each depth, one prefill forward of chip_smoke.py's compare sequences
through the model of chip_smoke.py's configuration (dummy weights from
its seed, bf16, on the card) three times on the same cache: with the
attention kernels, with the plain attention (f32) and with the same
arithmetic in f64. It prints, for each sequence's last token, the largest
logit difference over the row's largest logit for kernel against f32 and
f32 against f64 (the rounding floor), and the three argmaxes. A logits
check whose tolerance lies under that floor has no power at that depth
(chip_smoke.py: COMPARE_LAYERS).
"""

import argparse
import gc
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import aphrodite_tpu_torch.models.llama as llama_mod
from aphrodite_tpu_torch import LLM
from aphrodite_tpu_torch.models.interface import ForwardBatch
from aphrodite_tpu_torch.ops.attention import ref_ragged_paged_attention
from aphrodite_tpu_torch.ops.decode_attention import (MASK_VALUE, gather_kv,
                                                      t5_relative_bucket)

REPO = Path(__file__).resolve().parents[2]
PAGE = 16


def plain_f64(q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs=None,
              *, sm_scale, sliding_window=None, soft_cap=None, rel_bias=None,
              rel_bias_meta=None, **unused):
    """ref_ragged_paged_attention's arithmetic in f64, rounded to q's dtype
    (no ALiBi or blocksparse: the models measured here have neither; T5's
    bias table, where given, in f64 too); a decode batch (cu_q_lens None)
    has one query row a sequence. Query rows go 512 at a time, so a
    5000-token prefill's scores stay near a gigabyte. chip_smoke.py's
    compare_logits and compare_encdec_logits take it as their f64
    floor."""
    if cu_q_lens is None:
        cu_q_lens = torch.arange(q.shape[0] + 1, device=q.device)
    out = torch.zeros_like(q)
    cu = cu_q_lens.tolist()
    _, qh, d = q.shape
    for s, kv_len in enumerate(kv_lens.tolist()):
        if cu[s + 1] <= cu[s] or kv_len <= 0:
            continue
        k, v = (t.double() for t in gather_kv(kv_pages, page_indices[s],
                                               kv_len))
        kvh = k.shape[1]
        keys = torch.arange(kv_len, device=q.device)
        first = kv_len - (cu[s + 1] - cu[s])
        for a in range(cu[s], cu[s + 1], 512):
            b = min(a + 512, cu[s + 1])
            qf = q[a:b].double().reshape(b - a, kvh, qh // kvh, d)
            scores = torch.einsum("ngkd,lgd->gknl", qf * sm_scale, k)
            if soft_cap is not None:
                scores = soft_cap * torch.tanh(scores / soft_cap)
            pos = first + torch.arange(a - cu[s], b - cu[s], device=q.device)
            if rel_bias is not None:
                bucket = t5_relative_bucket(keys[None, :] - pos[:, None],
                                            False, *rel_bias_meta)
                scores = scores + rel_bias.double()[:, bucket].reshape(
                    kvh, qh // kvh, *bucket.shape)
            mask = keys[None, :] <= pos[:, None]
            if sliding_window is not None:
                mask &= keys[None, :] > pos[:, None] - sliding_window
            probs = torch.softmax(torch.where(mask, scores, MASK_VALUE), -1)
            out[a:b] = torch.einsum("gknl,lgd->ngkd", probs, v).reshape(
                b - a, qh, d).to(q.dtype)
    return out


def prefill_batch(runner, lens, vocab, seed):
    """One prefill of sequences of `lens` tokens on fresh pages, as
    chip_smoke.py's compare_logits lays it out; and the pages it uses."""
    rng = np.random.default_rng(seed)
    S, T = 8, -(-sum(lens) // 512) * 512
    ids = np.zeros((T,), np.int32)
    pos = np.zeros((T,), np.int32)
    slots = np.full((T,), runner.trash_slot_base, np.int32)
    pages = np.zeros((S, runner.pages_per_seq), np.int32)
    kv_lens = np.zeros((S,), np.int32)
    cu = np.zeros((S + 1,), np.int32)
    used, off = 0, 0
    for i, n in enumerate(lens):
        npg = -(-(n + 1) // PAGE)
        pages[i, :npg] = np.arange(used, used + npg)
        used += npg
        p = np.arange(n)
        ids[off:off + n] = rng.integers(0, vocab, n)
        pos[off:off + n] = p
        slots[off:off + n] = pages[i, p // PAGE] * PAGE + p % PAGE
        kv_lens[i] = n
        cu[i + 1] = cu[i] + n
        off += n
    cu[len(lens) + 1:] = cu[len(lens)]
    last = np.pad(cu[1:len(lens) + 1] - 1, (0, S - len(lens)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    return ForwardBatch(t(ids), t(pos), t(slots), t(kv_lens), t(pages),
                        t(cu), t(np.asarray([len(lens)], np.int32)),
                        t(last)), used


def measure(config, layers, lens, seed):
    """Per-row relative differences and argmaxes at one depth."""
    cfg = dict(config, num_hidden_layers=layers)
    if "layer_types" in cfg:
        cfg["layer_types"] = cfg["layer_types"][:layers]
    with tempfile.TemporaryDirectory() as td:
        (Path(td) / "config.json").write_text(json.dumps(cfg))
        llm = LLM(model=td, load_format="dummy", dtype="bfloat16", seed=seed,
                  block_size=PAGE, skip_tokenizer_init=True, device="cuda",
                  num_device_blocks_override=1024)
    runner = llm.engine.runner
    model, params = runner.model, runner.params
    batch, used = prefill_batch(runner, lens, model.vocab_size, seed)
    base = runner.kv_cache[:, :used].clone()
    kernel = llama_mod.ragged_paged_attention

    def logits(attention):
        llama_mod.ragged_paged_attention = attention
        runner.kv_cache[:, :used] = base
        try:
            with torch.inference_mode():
                h = model.forward(params, runner.kv_cache, batch,
                                  runner.kv_scales)
                return model.compute_logits(
                    params, h[batch.logits_indices])[:len(lens)].float()
        finally:
            llama_mod.ragged_paged_attention = kernel

    got, f32, f64 = (logits(a) for a in (kernel, ref_ragged_paged_attention,
                                          plain_f64))

    def rows(a, b):
        return [round(float((a[i] - b[i]).abs().max() / b[i].abs().max()),
                      5) for i in range(len(lens))]

    out = dict(layers=layers, kernel_vs_f32=rows(got, f32),
               f32_vs_f64=rows(f32, f64),
               argmax=[x.argmax(-1).tolist() for x in (got, f32, f64)])
    del llm, runner, model, params, base
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> None:
    sys.path.insert(0, str(REPO))
    import chip_smoke

    configs = {"gemma2": (chip_smoke.GEMMA2_9B, [4500, 17, 129]),
               "gemma3": (chip_smoke.GEMMA3_1B, [300, 17, 129]),
               "phi3": (chip_smoke.PHI3_MINI_4K, [2500, 17, 129]),
               "llama": (chip_smoke.LLAMA_8B, [300, 17, 129]),
               "falcon7b": (chip_smoke.FALCON_7B, [300, 17, 129]),
               "phi2": (chip_smoke.PHI_2, [300, 17, 129])}
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model", choices=sorted(configs))
    parser.add_argument("layers", type=int, nargs="+")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("logits_floor needs a card")
    config, lens = configs[args.model]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; {args.model}, sequences {lens}", flush=True)
    for layers in args.layers:
        print(measure(config, layers, lens, chip_smoke.SEED), flush=True)


if __name__ == "__main__":
    main()
