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
   the same pages widened to bf16), at five geometries (ATTN_GEOMETRIES,
   head_dim 128, 16-token pages): Baichuan2-13B's 40 query and 40 kv
   heads with its 40 ALiBi slopes, bench.py's 1.4B 16 / 8, Llama-3.1-8B's
   32 / 8 and Llama-3-70B's 64 / 8 (and since slices 8 and 15 the
   further shapes of ATTN_GEOMETRIES: QH/KV 3 to 16, head_dim 64, 96 and
   256; since slice 18 Falcon-7B's 71 query heads on one kv head and
   Bloom-560m's ALiBi, both at head_dim 64; since slice 20 Phi-2's 32 / 32
   and 20 query heads on one kv head, both at head_dim 80): a mixed
   prefill and decode
   batch, a
   chunked prefill on a cached prefix, a decode batch with dead padded
   rows, and sliding window with soft cap, every case with rows of 1000+
   keys (where ALiBi's bias reaches hundreds); with ALiBi, all-zero
   slopes must also equal no ALiBi bit for bit. The fifth is Phi-3-Small's
   blocksparse mask at 32 / 8 heads (block 64, 16 local blocks, stride 8,
   a phase per query head) over kv lengths of 1024-6144, where the gate
   off must equal the kernel without blocksparse bit for bit. Since
   slice 19, the decode kernel with T5's relative-position bias
   (REL_BIAS_GEOMETRIES: Flan-T5-XXL's 64 heads of 64, QG 1 at head_dim
   128, QG 2 at 64 and QG 71 at 64, the wide form; a table of 32 buckets
   up to distance 128 at std 3, unscaled scores) on every page type, at
   the main paths' decode step and at the T5 paths' own rows of 64 keys,
   where an all-zero table must equal no bias bit for bit. Cache slots
   past each
   sequence's length hold NaN (bf16, and byte 0x7f in the fp8 types) or
   127 (int8), so a kernel that reads past kv_len fails the check. The
   packed-int4 matmul, at the four projection sites of a Llama-3.1-8B
   layer (wqkv, wo, w13, down; group 128, and group 16 as GGUF Q2_K and
   Q3_K pack) on
   layer-stacked weights with a layer index, for T in (1, 8, 32, 64, 100,
   2048), against its plain version and against the exact f32
   dequantized product. The unpacked int4 matmul (one int8 level per
   byte), both of its bodies, at the same sites and T on layer-stacked
   levels with a layer index, for three containers (Q4_CONTAINERS):
   Q6_K-like (levels 0..63, group 16, zero 32, signed scales; at one site
   with groups of scale 2^-20 and a large zero), Q8_0-like (signed bytes,
   group 32) and act-order GPTQ (nibbles, one scale and zero row per
   weight row: the dense body only), against the same two products.
   The W4A8 matmul (per-token int8 activations x the packed container),
   at the same sites and T on layer-stacked weights with a layer index
   (wide zeros at wo), against its plain version and, within the JAX
   package's a8 bound, the exact W4A16 product. The activation quantizer,
   int8 and e4m3, byte for byte against its plain version on rows with an
   all-zero row, one large value and exact .5 steps. int8 per-channel
   containers through the unpacked kernel's group-wise body at G = K. The
   FP8 W8A8 product (quantizer and each body: the e4m3 form of the
   prefill body on f16 wgmma, and the unpacked kernel's e4m3 mma.sync
   body; f32 sums) at the same sites and T and at K 4160 against its
   plain version at INT4_TOL_SAME. The packed kernel and W4A8 also at K
   1088 (K/2 an odd multiple of 32) where the group divides 544.
   The sampler (plain PyTorch on the card, no kernel of its own) against
   the same functions on the CPU, on f32 logits [32, 128256] with distinct
   values (sampler_checks): each distribution stage alone (temperature and
   dynatemp, top-k/top-p, min-p, top-a, TFS, eta, epsilon, typical,
   quadratic, XTC, top-nsigma, skew), the whole pipeline with every
   history-free stage on and with a sampler_priority, the history stages
   (penalties, DRY, no-repeat-ngram) on token histories of 2048 ids,
   min_tokens with bans, and a random packed guided mask: the kept sets
   equal, the values within 1e-5 of each row's largest magnitude; and the
   tokens sample() draws from the rows' keys equal the CPU's.
4. Time each kernel, on every page type, at the main path's shapes
   beside its plain version, one PyTorch library call on pre-gathered
   contiguous K/V (scaled_dot_product_attention; the gather is not timed,
   and the port never calls it) and the bound: the larger of the bytes
   the call must move (K/V rows at the page type's size) over 3.35 TB/s
   and its FLOPs over 989 TFLOP/s (H100 SXM bf16); both attention kernels
   also at the Baichuan2-13B geometry with ALiBi on bf16 and E4M3 pages
   (the library call then takes the bias as a float attn_mask), and with
   Phi-3-Small's blocksparse mask on bf16 and E4M3 pages (decode of 16
   rows of 1056-6176 keys, a prefill step of the last 2048 tokens of the
   longest prompt; the library call takes the mask as a bool attn_mask,
   the bound counts the K/V rows some query head sees); at each decode
   shape it prints the split-KV plan (keys a split, splits, blocks); and
   at the Qwen2.5, Phi-3-mini and Gemma geometries at their paths'
   prompts, and at the Falcon-7B and Bloom-560m ones on every page type,
   and at Phi-2's (head_dim 80) on bf16 and E4M3 pages.
   The int4
   matmul is timed at T = 32 and T = 2048 at each site (and at w13 at
   group 16); its library call is one
   torch.matmul of x with the pre-dequantized bf16 weight (four times the
   weight bytes; the port never calls it). Both bodies of the unpacked
   matmul are timed the same way on the Q6_K-like and Q8_0-like
   containers, beside the same library call and a bound that counts one
   byte per level and eight per group and column of scale and zero; a
   sweep of rows per block follows for each. W4A8 (quantizer and kernel)
   at the same sites and T beside its plain version, torch._int_mm on the
   unpacked int8 levels (no group fix-ups), torch.matmul on bf16 weights
   and a bound with operations over 1979 TOPS int8; the quantizer at T 32
   and 2048, K 4096 and 14336; the FP8 W8A8 product (quantizer, e4m3
   body and scaling) at the four sites, beside torch._scaled_mm on the
   same e4m3 operands (its library call, which the port never makes).
   The sampler (sampler_timings): sample() at S 8 and 32, V 128256, its
   greedy floor (argmax and logprob only), stochastic rows with no stage
   (the noise), each stage alone, every history-free stage at once and
   the history stages on 2048-id histories, printed with the card's name
   and power limit.
5. Run the main paths, each with the engine before it freed. First the
   bf16 one, ``LLM.generate`` on a Llama-3.1-8B-geometry model (full
   width, 16 of its 32 layers since slice 20, random bf16 weights from a
   seed) for 16 greedy
   requests with prompts of 16-1024 tokens and 64 new tokens each, so
   chunked prefill mixes with fused 8-step decode windows. Every output
   must be 64 tokens long. Before the timed run two warm-up batches (2
   rows, then 16) warm up and capture the decode window's CUDA graphs at
   both sequence buckets the run reaches (8 and 32 rows). The kernel
   wrappers count the launches they make (none while a window is being
   captured into a graph): the launches of the forwards the runner ran
   eagerly (``eager_forwards_by_tokens``: prefill and mixed steps, and
   a key's warm-up window) are held to those forwards, which must be
   the engine's prefill and mixed steps and the warm-ups' 8 forwards
   each, so no pure-decode step ran eagerly. Every pure-decode window
   must be its key's one warm-up or a replay of the key's one capture.
   For each key replayed in the run, one window of it runs eagerly on
   the key's buffers with every row padding, its wrapper counts held to
   its 8 forwards, and then a replay of its graph is traced with
   torch.profiler: the replay must launch the port's kernels of the
   eager window (traced too) by name and count, one decode attention
   kernel per layer and forward among them. So on every forward, eager
   or replayed, the attention launches are one per layer, all on the
   cache's page type (the ragged kernel in prefill and mixed steps, the
   decode kernel in the fused window), and no forward can have taken a
   plain version. The run's launch counts are the eager ones plus, for
   each key, its replays times one window's; the kernels line gives
   that second part as ``launches_in_graph_replays``. The path prints
   each key's captures, capture seconds, replays, the memory its
   capture reserved and a traced replay's launches by kernel, and the
   chained windows, carries and
   sampling tensors reused. On ``gptq``, ``gptq+fp8_e4m3``, ``q6_k
   gguf`` and ``qwen2.5-7b`` one window of 16 rows (random cache pages
   and tokens from the seed) runs through the graph and through the
   eager window function on the same cache, carry and tensors: outputs
   and carries equal bit for bit, two windows in a row; then the median
   ms of 10 windows each way and a torch.profiler breakdown of the
   graphed one. Then one prefill and one decode forward are run with
   kernel attention and with plain attention on the same inputs, and
   their logits compared.
   Then the int4 one: the same model at all 32 layers and the same
   requests with ``quantization="gptq"`` (random weights quantized to packed int4 at
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
   Then two GGUF paths: ``LLM(model=<file>.gguf, tokenizer=None,
   skip_tokenizer_init=True)`` on a file of the same geometry that
   ``write_gguf_llama`` writes from the seed into a temporary directory
   (deleted once the engine is up): Q6_K blocks at GGUF_Q6K_LAYERS
   layers, then Q8_0 blocks at 4 layers (every unpacked product sent to
   the group-wise body, and the runner's graphs dropped with
   ``reset_graphs`` so that its windows are captured anew with it). The
   loader decodes the blocks on the host into one-level-per-byte containers (group 16, group 32); the
   unpacked int4 matmul must count 4 launches per layer and forward and
   the packed one none, and the logits with the kernel must agree with
   those of the plain product. Between them the two paths launch both
   bodies (printed per path).
   Then slice 5's three: ``gptq w4a8, 8 layers`` (32 layers until slice
   15; APHRODITE_W4_A8=1 for this path only): forwards are counted by their tokens; every forward of
   16 tokens or more must launch the W4A8 kernel and the int8 quantizer 4
   times per layer, every other one the W4A16 kernel; its logits (a
   prefill and a 16-row decode forward, which take W4A8, and an 8-row
   decode forward, which takes W4A16, each forward's launches held to its
   route) against the plain W4A8 and W4A16 products (argmax on the rows
   that the plain products summed in another f32 order decide). ``int8`` and ``fp8`` (4 layers,
   quantized at load on the card): the group-wise body (G = K), or the
   e4m3 quantizer and the FP8 body fp8_route picks by each forward's T
   (launches by body held to it), 4 launches per layer and forward,
   logits against the plain product; on the fp8 path once with the plain
   quantizer (bit-equal) and once with the whole plain product, each
   site's product held at INT4_TOL_SAME on that run's inputs.
   Then slice 6's three: ``baichuan2-13b, 20 layers`` (BaichuanForCausalLM
   from the published Baichuan2-13B values, bf16, full width and half its
   40 layers since slice 20: MHA with ALiBi), the same with an E4M3 cache at 4 layers, and
   ``bench-1.4b gptq+fp8_e4m3`` (bench.py's default 1.4B geometry, 24
   layers, 16 q / 8 kv heads, the packed int4 kernel at its four sites).
   Then slice 7's three: ``phi-3-small, 16 layers`` (Phi3SmallForCausalLM
   from the published Phi-3-small-8k-instruct values, bf16, full width and
   half its 32 layers since slice 20, 16 requests with prompts of 1024-6144 tokens), the same with an
   E4M3 cache at 4 layers, and ``q2_k gguf, 4 layers`` (a GGUF file of
   Q2_K projections with a Q3_K down projection at the Llama-3.1-8B
   width, which loads packed at group 16: 4 int4p_matmul launches per
   layer and forward, logits against the plain product).
   Then slice 8's five: ``qwen2.5-7b`` (Qwen2ForCausalLM from the
   published Qwen2.5-7B values: QG 7, q|k|v bias, bf16, full width and
   all 28 layers, 16 requests with prompts of 1024-4096 tokens),
   ``qwen2.5-0.5b+fp8_e4m3`` (head_dim 64, QG 7, tied, all 24 layers, an
   E4M3 cache), ``qwen3-14b, 4 layers`` (QG 5, the per-head q/k
   RMSNorm), ``mistral-7b, 4 layers`` (a sliding window of 4096 keys,
   one prompt of 4500 tokens, so that the window bites in both kernels;
   its logits are compared on a prefill of 4500 tokens too) and ``q2_k
   gguf w4a8, 4 layers`` (the Q2_K file with APHRODITE_W4_A8=1: W4A8 at
   group 16, held as the gptq w4a8 path is).
   Every attention launch of every path is counted by its shape (query
   heads per kv head and head_dim) and option and must be the model's:
   QG 1 with ALiBi on the Baichuan paths, QG 2 on the 1.4B one, QG 4 on
   the Llama-3.1-8B ones, and on the Phi-3-Small ones QG 4 with
   blocksparse on the layers whose gate is on (every other one) and QG 4
   without it on the rest; QG 7 at head_dim 128 on qwen2.5-7b, QG 7 at
   head_dim 64 on qwen2.5-0.5b, QG 5 on qwen3-14b, QG 4 on mistral-7b.
   QG 1 at head_dim 96 on the Phi-3-mini ones, QG 2 at 256 on the
   Gemma-2-9B ones, QG 1 at 256 on gemma-7b and QG 4 at 256 on gemma-3-1b.
   Then slice 14's two, on gptq+fp8_e4m3 at full width and depth with
   the 16 requests of 64 tokens: ``samplers, history-free``
   (history_free_params: seeded random rows, each a different mix of
   every history-free stage, two with a sampler_priority; its warm-up
   batch captures the window key of its flags, so its decode windows are
   graph replays; window_check holds its graphed window against the eager
   one bit for bit; request 12 is re-run alone and must draw the tokens it
   drew in the batch) and ``samplers, history`` (history_params: greedy
   rows with repetition, frequency and presence penalties, DRY,
   no-repeat-ngram, min_tokens 48, bans, a two-argument logits processor
   on 2 rows and prompt_logprobs 5 on 4, every decode step on the
   single-step path; held by check_history_path against the gptq+fp8_e4m3
   path's tokens and by check_prompt_logprobs against a prefill forward's
   logits). Both print decode and prefill tok/s beside the gptq+fp8_e4m3
   path's.
   Then slice 15's six: ``gemma-2-9b, 10 layers`` (Gemma2ForCausalLM from
   the published values: head_dim 256, QG 2, sandwich norms, soft caps 50
   and 30, a 4096-key window on the even layers; bf16, full width, 10 of
   its 42 layers since slice 20 (21 in slices 18-19), prompts of
   1024-6144 tokens, logits compared on a 4500-token prefill) and
   ``phi-3-mini-4k, 16 layers`` (Phi3ForCausalLM: head_dim 96, MHA, a
   2047-key window; half its 32 layers since slice 20, prompts of
   1024-4032), both with
   window_check; ``gemma-2-9b gptq+fp8_e4m3, 4 layers`` (the int4 kernels
   at Gemma's shapes, E4M3 pages), ``gemma-7b, 4 layers`` (QG 1 at 256),
   ``gemma-3-1b`` (all 26 layers: five local layers to one global, two
   rope tables, the (1 + w) q/k norm) and ``phi-3-mini-128k, 4 layers``
   (LongRoPE with stand-in factors drawn from the seed, served at 16384
   positions: the model's rotary table must be the long factors' one,
   check_longrope; one prompt of 5000 tokens).
   Then slice 17's five, Mixture-of-Experts models on dummy weights at
   their published widths: ``qwen3-30b-a3b, 12 layers``
   (Qwen3MoeForCausalLM at full width, a quarter of its 48 layers since
   slice 20 (24 in slices 18-19): 128 experts, top 8, QH/KV 8),
   ``mixtral-8x7b experts_int8+fp8_e4m3, 4 layers`` (its experts
   quantized to int8 at load and dequantized a layer at a time, on E4M3
   pages), ``qwen1.5-moe-a2.7b, 4 layers`` (60 experts, top 4, a shared
   expert), ``olmoe-1b-7b, 8 layers`` (half its 16 layers since slice 20;
   logits compared on its first COMPARE_LAYERS) and ``phi-3.5-moe, 4 layers`` (sparsemixer, LayerNorm,
   biases, stand-in LongRoPE factors, served at 16384 with one prompt of
   5000 tokens, its logits compared on the usual lengths). On each,
   moe_checks holds both forms of the grouped product (ops/moe.py, plain
   PyTorch: no TPU kernel row) at the path's shapes against a plain
   per-token product (the capacity form at a decode bucket of 32, the
   loop form at a 2048-token step) and times them beside their byte
   bound; check_window holds the graphed window
   against the eager one and prints its ms beside the window's
   weight-byte floor and the capacity form's share of it; every decode
   window of the timed run must be a graph replay; and compare_logits
   adds a third run with the plain attention in f64, holding argmax on
   the rows whose plain top two that run's change cannot swap (a router
   turns a rounding difference into another expert now and then).
   Then slice 18's seven, from the published config.json values on
   dummy weights: ``falcon-7b, 16 layers`` (FalconForCausalLM at full
   width and half its 32 layers since slice 20: 71 query heads on one kv head at head_dim 64, a parallel
   block from one LayerNorm; check_window), ``falcon-7b+fp8_e4m3, 4
   layers``, ``falcon-40b, 4 layers`` (new decoder architecture, QH/KV
   16), ``falcon-rw-1b`` (all 24 layers: ALiBi, MHA, sequential),
   ``bloom-560m+fp8_e4m3`` (all 24 layers: ALiBi at head_dim 64 on E4M3
   pages, the embedding LayerNorm, 250880 tokens), ``mpt-7b, 4 layers``
   and ``jais-13b, 4 layers`` (ALiBi at head_dim 128, no biases / SwiGLU
   with biases and muP scales). Every attention launch of them is held
   to the model's shape ("qg71 d64", "qg16 d64", "qg1 d64 alibi", "qg1
   d128 alibi"), and a traced replay's decode kernels count the wide
   form's too.
   Then slice 20's eight, partial and interleaved rotary from the
   published config.json values on dummy weights: ``phi-2``
   (PhiForCausalLM at full width and all 32 layers: head_dim 80, rotary
   over 32 of its dims, one LayerNorm feeding a parallel block;
   check_window), ``phi-2+fp8_e4m3, 4 layers``, and at 4 layers each
   ``stablelm-3b-4e1t`` (head_dim 80, rotary over 20), ``gpt-neox-20b``
   (head_dim 96, rotary_pct 0.25), ``gpt-j-6b`` (head_dim 256, GPT-J
   pairing over 64), ``persimmon-8b`` (q/k LayerNorm), ``chatglm3-6b``
   (QH/KV 16, GPT-J pairing over half) and ``qwen2.5-7b yarn`` (the YaRN
   scaling of Qwen2.5's model card). Each compare_logits adds a third run
   with the plain attention in f64 and holds argmax on the rows it
   decides, as on the MoE paths.
   Then slice 19's four encoder-decoder paths (encdec_paths, after the
   main paths), from the published config.json
   values on dummy bf16 weights, each through encdec_path: 16 requests
   with encoder prompts of 16-512 tokens and 64 new tokens, greedy, every
   decode step a single eager step: ``flan-t5-xxl, 12 + 12 layers`` (T5
   at full width and half its 24 + 24 layers since slice 20), ``flan-t5-xxl+fp8_e4m3, 4 layers`` (E4M3 self and
   cross pages), ``t5-small`` (6 + 6, the tied head's scaling) and
   ``bart-large-cnn`` (12 + 12, post-norm). Every pure-decode step
   launches the decode kernel once a layer ("qg1 d64 rel_bias" on T5,
   "qg1 d64" on BART), every BART prefill step the ragged kernel once a
   layer (T5's prefill is plain PyTorch, as it is XLA code in the JAX
   package); each encoder pass is timed; the logits of a prefill and a
   decode step with the kernels must lie within LOGIT_TOL of the plain
   attention's, argmax held on the rows a third run in f64 decides
   (Flan-T5-XXL on its first COMPARE_LAYERS decoder layers, the floor at
   12 printed); and a traced decode step gives cross-attention's share of
   its device time.
   Then the page-gather probe's own entry point
   (aphrodite_tpu_torch/tools/probe_gather_bw.py: main) at its defaults,
   which times the probe kernel; its kernel was held beforehand against
   its plain version, which it must equal bit for bit.
   Last, slice 16's serving phase (serving_phase): the gptq+fp8_e4m3 path
   has run a greedy request (with logprobs) and a beam request (width 4,
   n 2) alone through LLM.generate before its engine was freed, with a
   word tokenizer written by write_word_tokenizer; then `python -m
   aphrodite_tpu_torch run` serves the same configuration (dummy weights
   from seed 0, --warmup), its engine in a spawned child: the child, and
   not the frontend, must map the card's memory; 16 concurrent requests
   (greedy plain and streamed, seeded random, streamed chat, a beam
   request, a Kobold generate, a stream the client closes after 8 chunks)
   must parse against the protocol and give their 64 tokens;
   /v1/internal/engine_stats must show graph replays; the greedy request
   alone (plain and streamed) and the beam request alone must equal
   LLM.generate's text and logprobs bit for bit; /metrics, /v1/tokenize,
   /v1/detokenize answer and an image chat part answers 400; SIGINT stops
   both processes. It prints time to first token and per output token
   (median, p90) of the streams, seconds to /health and of the warm-up,
   and the engine's decode and prefill tok/s beside the offline path's.
6. Print {"kernels": [...]} with each kernel's launches on the main path,
   its error against the plain version and its times (each attention
   kernel once per page type, with its launches by shape and, on bf16
   and E4M3 pages, its times at the Baichuan2-13B geometry; each kernel's
   blocksparse instantiation on bf16 and E4M3 pages, with its times at
   Phi-3-Small's geometry; the decode kernel with the T5 bias on bf16 and
   E4M3 pages, with its times at Flan-T5-XXL's geometry; the unpacked
   int4 matmul once per body, W4A8,
   the activation quantizer, the FP8 W8A8 product and the page-gather
   probe); before it, the sampler's errors and times, and each path's
   rates; the last line is
   {"ok": true, "device": {...}}.
"""

import asyncio
import functools
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
# Baichuan2-13B (BaichuanForCausalLM), the published config's values: MHA
# (no num_key_value_heads: 40 kv heads), ALiBi (hidden != 4096), no
# max_position_embeddings, so both packages derive max_model_len 2048.
BAICHUAN2_13B = {
    "architectures": ["BaichuanForCausalLM"],
    "hidden_size": 5120,
    "intermediate_size": 13696,
    "num_hidden_layers": 40,
    "num_attention_heads": 40,
    "vocab_size": 125696,
    "model_max_length": 4096,
    "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# bench.py's default geometry (bench.py:30-44), about 1.4B parameters.
BENCH_1P4B = {
    "architectures": ["LlamaForCausalLM"],
    "hidden_size": 2048,
    "intermediate_size": 5632,
    "num_hidden_layers": 24,
    "num_attention_heads": 16,
    "num_key_value_heads": 8,
    "head_dim": 128,
    "vocab_size": 32000,
    "max_position_embeddings": 2048,
    "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# Phi-3-small-8k-instruct (Phi3SmallForCausalLM), the published config's
# values, with two changes. The published file names the MLP width
# ff_intermediate_size; HF derives intermediate_size from it in the
# model's own config class, and both packages read intermediate_size
# (ROADMAP.md §3 records the gap of the reference), so it is written here.
# Its dummy_token_indices (tokens never to be sampled) are a list of ids
# at the top of the vocabulary; the list here stands in for the published
# one. Blocksparse: 64-key blocks, 16 local, vertical stride 8, a phase per
# query head (hetero), every 2nd layer dense; muP 10 / 8 / 1; tied head.
PHI3_SMALL = {
    "architectures": ["Phi3SmallForCausalLM"],
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "ff_intermediate_size": 14336,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "vocab_size": 100352,
    "max_position_embeddings": 8192,
    "layer_norm_epsilon": 1e-5,
    "rope_embedding_base": 1000000,
    "rope_position_scale": 1.0,
    "rope_scaling": None,
    "blocksparse_block_size": 64,
    "blocksparse_num_local_blocks": 16,
    "blocksparse_vert_stride": 8,
    "blocksparse_homo_head_pattern": False,
    "dense_attention_every_n_layers": 2,
    "gegelu_limit": 20.0,
    "hidden_act": "gegelu",
    "mup_use_scaling": True,
    "mup_attn_multiplier": 1.0,
    "mup_embedding_multiplier": 10.0,
    "mup_width_multiplier": 8.0,
    "dummy_token_indices": list(range(100256, 100352, 3)),
    "torch_dtype": "bfloat16",
}
# Qwen2.5-7B (Qwen2ForCausalLM), the published config's values: 28 query
# and 4 kv heads (QH/KV 7), q|k|v bias, untied, the window off.
QWEN25_7B = {
    "architectures": ["Qwen2ForCausalLM"],
    "hidden_size": 3584,
    "intermediate_size": 18944,
    "num_hidden_layers": 28,
    "num_attention_heads": 28,
    "num_key_value_heads": 4,
    "vocab_size": 152064,
    "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "sliding_window": 131072,
    "use_sliding_window": False,
    "max_window_layers": 28,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# Qwen2.5-0.5B: 14 / 2 heads of 64 (QH/KV 7, head_dim 64), tied embeddings.
QWEN25_05B = {
    "architectures": ["Qwen2ForCausalLM"],
    "hidden_size": 896,
    "intermediate_size": 4864,
    "num_hidden_layers": 24,
    "num_attention_heads": 14,
    "num_key_value_heads": 2,
    "vocab_size": 151936,
    "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "sliding_window": 32768,
    "use_sliding_window": False,
    "max_window_layers": 21,
    "tie_word_embeddings": True,
    "torch_dtype": "bfloat16",
}
# Qwen3-14B (Qwen3ForCausalLM): 40 / 8 heads (QH/KV 5) of 128, the per-head
# q/k RMSNorm, no attention bias.
QWEN3_14B = {
    "architectures": ["Qwen3ForCausalLM"],
    "hidden_size": 5120,
    "intermediate_size": 17408,
    "num_hidden_layers": 40,
    "num_attention_heads": 40,
    "num_key_value_heads": 8,
    "head_dim": 128,
    "vocab_size": 151936,
    "max_position_embeddings": 40960,
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "attention_bias": False,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# Mistral-7B-v0.1 (MistralForCausalLM): 32 / 8 heads, a sliding window of
# 4096 keys.
MISTRAL_7B = {
    "architectures": ["MistralForCausalLM"],
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "vocab_size": 32000,
    "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0,
    "sliding_window": 4096,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# Slice 15's models, each from its published config.json (values as
# published; the vocabulary, tied head and soft caps are the models' own,
# torch_dtype the path's). Gemma-2-9B (Gemma2ForCausalLM): head_dim 256,
# QH/KV 2, a 4096-key window on the even layers (the config names no
# layer_types), soft caps 50 and 30, query_pre_attn_scalar 256.
GEMMA2_9B = {
    "architectures": ["Gemma2ForCausalLM"],
    "hidden_size": 3584,
    "intermediate_size": 14336,
    "num_hidden_layers": 42,
    "num_attention_heads": 16,
    "num_key_value_heads": 8,
    "head_dim": 256,
    "vocab_size": 256000,
    "max_position_embeddings": 8192,
    "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0,
    "sliding_window": 4096,
    "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0,
    "query_pre_attn_scalar": 256,
    "hidden_activation": "gelu_pytorch_tanh",
    "torch_dtype": "bfloat16",
}
# Phi-3-mini-4k-instruct (Phi3ForCausalLM): head_dim 96 (3072 / 32), MHA, a
# 2047-key window on every layer (its checkpoints' fused qkv_proj and
# gate_up_proj play no part with dummy weights).
PHI3_MINI_4K = {
    "architectures": ["Phi3ForCausalLM"],
    "hidden_size": 3072,
    "intermediate_size": 8192,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 32,
    "vocab_size": 32064,
    "max_position_embeddings": 4096,
    "original_max_position_embeddings": 4096,
    "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0,
    "rope_scaling": None,
    "sliding_window": 2047,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# Gemma-7B (GemmaForCausalLM): head_dim 256 at QH/KV 1.
GEMMA_7B = {
    "architectures": ["GemmaForCausalLM"],
    "hidden_size": 3072,
    "intermediate_size": 24576,
    "num_hidden_layers": 28,
    "num_attention_heads": 16,
    "num_key_value_heads": 16,
    "head_dim": 256,
    "vocab_size": 256000,
    "max_position_embeddings": 8192,
    "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0,
    "torch_dtype": "bfloat16",
}
# Gemma-3-1B-it (Gemma3ForCausalLM): head_dim 256 at QH/KV 4, five local
# layers (a 512-key window, rope base 10000) to one global (base 1e6). The
# published file gives the pattern as sliding_window_pattern 6 (layer i
# global where (i + 1) % 6 == 0, as HF reads it); both packages read
# layer_types, which newer copies of the file carry and which is written
# here from the pattern.
GEMMA3_1B = {
    "architectures": ["Gemma3ForCausalLM"],
    "hidden_size": 1152,
    "intermediate_size": 6912,
    "num_hidden_layers": 26,
    "num_attention_heads": 4,
    "num_key_value_heads": 1,
    "head_dim": 256,
    "vocab_size": 262144,
    "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "rope_local_base_freq": 10000.0,
    "rope_scaling": None,
    "sliding_window": 512,
    "sliding_window_pattern": 6,
    "layer_types": ["full_attention" if (i + 1) % 6 == 0
                    else "sliding_attention" for i in range(26)],
    "query_pre_attn_scalar": 256,
    "hidden_activation": "gelu_pytorch_tanh",
    "torch_dtype": "bfloat16",
}
# Phi-3-mini-128k-instruct: Phi-3-mini-4k's geometry with LongRoPE. Its
# two 48-entry factor lists are not in the repository: phi3_128k_config
# draws stand-ins from the seed. The published file names
# original_max_position_embeddings (4096) at its top level; both packages
# read it inside rope_scaling only (ROADMAP.md §3, gaps of the reference),
# so it is written there too, and the long factors apply at the served
# length, 16384 (the published 131072 is cut to keep the page tables of
# this 4-layer path small).
PHI3_MINI_128K_LEN = 16384


def phi3_128k_config(layers: int) -> dict:
    rng = np.random.default_rng(SEED)
    scaling = {"type": "longrope", "original_max_position_embeddings": 4096,
               "short_factor": np.sort(rng.uniform(1.0, 3.0, 48)).tolist(),
               "long_factor": np.sort(rng.uniform(1.0, 64.0, 48)).tolist()}
    return dict(PHI3_MINI_4K, num_hidden_layers=layers,
                max_position_embeddings=131072, rope_scaling=scaling,
                sliding_window=262144)


# Slice 17's Mixture-of-Experts models, each from its published
# config.json (values as published; torch_dtype the path's). Qwen3-30B-A3B
# (Qwen3MoeForCausalLM): 128 experts of width 768, top 8 renormalized,
# 32 / 4 heads of 128 (QH/KV 8), the per-head q/k norm; served at full
# width and all 48 layers.
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"],
    "hidden_size": 2048,
    "intermediate_size": 6144,
    "moe_intermediate_size": 768,
    "num_experts": 128,
    "num_experts_per_tok": 8,
    "norm_topk_prob": True,
    "decoder_sparse_step": 1,
    "mlp_only_layers": [],
    "num_hidden_layers": 48,
    "num_attention_heads": 32,
    "num_key_value_heads": 4,
    "head_dim": 128,
    "vocab_size": 151936,
    "max_position_embeddings": 40960,
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "attention_bias": False,
    "use_sliding_window": False,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# Mixtral-8x7B (MixtralForCausalLM): 8 experts of width 14336, top 2
# renormalized, 32 / 8 heads.
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"],
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "num_local_experts": 8,
    "num_experts_per_tok": 2,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "vocab_size": 32000,
    "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-5,
    "rope_theta": 1000000.0,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# Qwen1.5-MoE-A2.7B (Qwen2MoeForCausalLM): 60 experts of width 1408, top 4
# not renormalized, a shared expert of 5632 behind its sigmoid gate, 16
# heads of 128 (MHA), q|k|v bias.
QWEN15_MOE_A27B = {
    "architectures": ["Qwen2MoeForCausalLM"],
    "hidden_size": 2048,
    "intermediate_size": 5632,
    "moe_intermediate_size": 1408,
    "shared_expert_intermediate_size": 5632,
    "num_experts": 60,
    "num_experts_per_tok": 4,
    "norm_topk_prob": False,
    "decoder_sparse_step": 1,
    "num_hidden_layers": 24,
    "num_attention_heads": 16,
    "num_key_value_heads": 16,
    "vocab_size": 151936,
    "max_position_embeddings": 8192,
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "use_sliding_window": False,
    "sliding_window": 32768,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# OLMoE-1B-7B-0924 (OlmoeForCausalLM): 64 experts of width 1024, top 8 not
# renormalized, 16 heads of 128 (MHA), the full-width q/k norm; served at
# full width and all 16 layers.
OLMOE_1B_7B = {
    "architectures": ["OlmoeForCausalLM"],
    "hidden_size": 2048,
    "intermediate_size": 1024,
    "num_experts": 64,
    "num_experts_per_tok": 8,
    "norm_topk_prob": False,
    "num_hidden_layers": 16,
    "num_attention_heads": 16,
    "num_key_value_heads": 16,
    "vocab_size": 50304,
    "max_position_embeddings": 4096,
    "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}


def phi35_moe_config(layers: int) -> dict:
    """Phi-3.5-MoE-instruct (PhiMoEForCausalLM): 16 experts of width 6400,
    sparsemixer top 2, 32 / 8 heads of 128, LayerNorm, q|k|v, o-proj and
    LM-head biases, LongRoPE. Its two 64-entry factor lists are not in the
    repository: stand-ins are drawn from the seed, as for Phi-3-mini-128k,
    and the long factors apply at the served length, PHI3_MINI_128K_LEN."""
    rng = np.random.default_rng(SEED)
    scaling = {"type": "longrope", "original_max_position_embeddings": 4096,
               "short_factor": np.sort(rng.uniform(1.0, 3.0, 64)).tolist(),
               "long_factor": np.sort(rng.uniform(1.0, 64.0, 64)).tolist(),
               "short_mscale": 1.243163121016122,
               "long_mscale": 1.243163121016122}
    return {
        "architectures": ["PhiMoEForCausalLM"],
        "hidden_size": 4096,
        "intermediate_size": 6400,
        "num_local_experts": 16,
        "num_experts_per_tok": 2,
        "router_jitter_noise": 0.01,
        "input_jitter_noise": 0.01,
        "num_hidden_layers": layers,
        "num_attention_heads": 32,
        "num_key_value_heads": 8,
        "vocab_size": 32064,
        "max_position_embeddings": 131072,
        "original_max_position_embeddings": 4096,
        "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0,
        "rope_scaling": scaling,
        "attention_bias": True,
        "lm_head_bias": True,
        "tie_word_embeddings": False,
        "torch_dtype": "bfloat16",
    }


# Slice 18's models, each from its published config.json (values as
# published, the HF-format Falcon files; torch_dtype the path's). Falcon-7B
# (tiiuae/falcon-7b): multi-query, 71 query heads of 64 on one kv head,
# a parallel block from one LayerNorm, no biases, tied head.
FALCON_7B = {
    "architectures": ["FalconForCausalLM"],
    "hidden_size": 4544,
    "num_attention_heads": 71,
    "num_hidden_layers": 32,
    "multi_query": True,
    "parallel_attn": True,
    "new_decoder_architecture": False,
    "alibi": False,
    "bias": False,
    "layer_norm_epsilon": 1e-5,
    "vocab_size": 65024,
    "torch_dtype": "bfloat16",
}
# Falcon-40B (tiiuae/falcon-40b): the new decoder architecture, 128 query
# heads over 8 kv heads (QH/KV 16), ln_attn and ln_mlp.
FALCON_40B = {
    "architectures": ["FalconForCausalLM"],
    "hidden_size": 8192,
    "num_attention_heads": 128,
    "num_kv_heads": 8,
    "num_hidden_layers": 60,
    "new_decoder_architecture": True,
    "parallel_attn": True,
    "alibi": False,
    "bias": False,
    "layer_norm_epsilon": 1e-5,
    "vocab_size": 65024,
    "torch_dtype": "bfloat16",
}
# Falcon-RW-1B (tiiuae/falcon-rw-1b): multi-head (32 of 64), sequential,
# ALiBi; its config sets bias, which neither package reads (models/
# falcon.py: no bias tensor has a mapping).
FALCON_RW_1B = {
    "architectures": ["FalconForCausalLM"],
    "hidden_size": 2048,
    "num_attention_heads": 32,
    "num_hidden_layers": 24,
    "multi_query": False,
    "parallel_attn": False,
    "new_decoder_architecture": False,
    "alibi": True,
    "bias": True,
    "layer_norm_epsilon": 1e-5,
    "vocab_size": 50304,
    "torch_dtype": "bfloat16",
}
# Bloom-560m (bigscience/bloom-560m): 16 heads of 64 with ALiBi, the
# embedding LayerNorm, a 250880-token vocabulary; its config names its
# sizes n_head and n_layer and gives no maximum length (2048 is derived).
BLOOM_560M = {
    "architectures": ["BloomForCausalLM"],
    "hidden_size": 1024,
    "n_head": 16,
    "n_layer": 24,
    "layer_norm_epsilon": 1e-5,
    "vocab_size": 250880,
    "torch_dtype": "bfloat16",
}
# MPT-7B (mosaicml/mpt-7b): d_model 4096, 32 heads of 128 with MPT's ALiBi
# schedule (alibi_bias_max 8), no biases, exact GELU, max_seq_len 2048.
MPT_7B = {
    "architectures": ["MPTForCausalLM"],
    "d_model": 4096,
    "n_heads": 32,
    "n_layers": 32,
    "expansion_ratio": 4,
    "max_seq_len": 2048,
    "no_bias": True,
    "attn_config": {"alibi": True, "alibi_bias_max": 8, "clip_qkv": None,
                    "qk_ln": False, "attn_type": "multihead_attention"},
    "vocab_size": 50432,
    "torch_dtype": "bfloat16",
}
# JAIS-13b (core42/jais-13b): n_embd 5120, 40 heads of 128 with ALiBi, a
# SwiGLU MLP of 13653, the muP scales (embeddings x 14.6, logits x 0.111,
# attention scale 1 / head_dim).
JAIS_13B = {
    "architectures": ["JAISLMHeadModel"],
    "n_embd": 5120,
    "n_head": 40,
    "n_layer": 40,
    "n_inner": 13653,
    "n_positions": 2048,
    "position_embedding_type": "alibi",
    "activation_function": "swiglu",
    "scale_qk_dot_by_d": True,
    "embeddings_scale": 14.6,
    "width_scale": 0.11100000000000002,
    "layer_norm_epsilon": 1e-5,
    "vocab_size": 84992,
    "torch_dtype": "bfloat16",
}
# Slice 20's partial- and interleaved-rotary models, each from its
# published config.json values (only the dtype is the path's). Phi-2
# (microsoft/phi-2, PhiForCausalLM): 32 heads of 80 on 32 kv heads, rotary
# over 0.4 of each head (32 dims), one LayerNorm feeding a parallel
# attention and MLP (gelu_new), biases everywhere, an untied head with a
# bias.
PHI_2 = {
    "architectures": ["PhiForCausalLM"],
    "hidden_size": 2560,
    "intermediate_size": 10240,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 32,
    "partial_rotary_factor": 0.4,
    "rope_theta": 10000.0,
    "rope_scaling": None,
    "qk_layernorm": False,
    "hidden_act": "gelu_new",
    "layer_norm_eps": 1e-5,
    "max_position_embeddings": 2048,
    "vocab_size": 51200,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# StableLM-3B-4e1t (stabilityai/stablelm-3b-4e1t, the Epoch config's own
# keys): head_dim 80, rotary over a quarter of it (20 dims: an odd half of
# 10), LayerNorms with bias, the gated SiLU MLP, no q|k|v bias.
STABLELM_3B = {
    "architectures": ["StableLMEpochForCausalLM"],
    "hidden_size": 2560,
    "intermediate_size": 6912,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 32,
    "rope_pct": 0.25,
    "rope_theta": 10000,
    "norm_eps": 1e-5,
    "use_qkv_bias": False,
    "hidden_act": "silu",
    "max_position_embeddings": 4096,
    "vocab_size": 50304,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# GPT-NeoX-20B (EleutherAI/gpt-neox-20b): 64 heads of 96, rotary_pct 0.25
# (24 dims), a parallel residual with two LayerNorms, the head-major fused
# q|k|v (split at load; dummy weights here).
GPT_NEOX_20B = {
    "architectures": ["GPTNeoXForCausalLM"],
    "hidden_size": 6144,
    "intermediate_size": 24576,
    "num_hidden_layers": 44,
    "num_attention_heads": 64,
    "rotary_pct": 0.25,
    "rotary_emb_base": 10000,
    "use_parallel_residual": True,
    "hidden_act": "gelu_fast",
    "layer_norm_eps": 1e-5,
    "max_position_embeddings": 2048,
    "vocab_size": 50432,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# GPT-J-6B (EleutherAI/gpt-j-6b): 16 heads of 256, the interleaved rotary
# over its absolute rotary_dim 64, one LayerNorm feeding a parallel
# attention and MLP, an LM head with a bias; the config names its sizes
# n_embd, n_head, n_layer, n_inner (null: 4 x n_embd), n_positions.
GPT_J_6B = {
    "architectures": ["GPTJForCausalLM"],
    "n_embd": 4096,
    "n_head": 16,
    "n_layer": 28,
    "n_inner": None,
    "n_positions": 2048,
    "rotary_dim": 64,
    "activation_function": "gelu_new",
    "layer_norm_epsilon": 1e-5,
    "vocab_size": 50400,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# Persimmon-8B (adept/persimmon-8b-base): 64 heads of 64, rotary over half
# of each, a LayerNorm with bias on q and k over head_dim, squared ReLU, a
# 262144-token vocabulary, 16384 positions.
PERSIMMON_8B = {
    "architectures": ["PersimmonForCausalLM"],
    "hidden_size": 4096,
    "intermediate_size": 16384,
    "num_hidden_layers": 36,
    "num_attention_heads": 64,
    "partial_rotary_factor": 0.5,
    "rope_theta": 25000.0,
    "qk_layernorm": True,
    "hidden_act": "relu2",
    "layer_norm_eps": 1e-5,
    "max_position_embeddings": 16384,
    "vocab_size": 262144,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# ChatGLM3-6B (THUDM/chatglm3-6b, ChatGLMModel): 32 heads of 128 on 2
# multi-query groups (QH/KV 16), the interleaved rotary over half of each
# head, q|k|v bias, RMSNorm; the config's own names (num_layers,
# ffn_hidden_size, padded_vocab_size, seq_length).
CHATGLM3_6B = {
    "architectures": ["ChatGLMModel"],
    "hidden_size": 4096,
    "ffn_hidden_size": 13696,
    "num_layers": 28,
    "num_attention_heads": 32,
    "kv_channels": 128,
    "multi_query_attention": True,
    "multi_query_group_num": 2,
    "add_qkv_bias": True,
    "add_bias_linear": False,
    "apply_residual_connection_post_layernorm": False,
    "rmsnorm": True,
    "post_layer_norm": True,
    "original_rope": True,
    "layernorm_epsilon": 1e-5,
    "seq_length": 8192,
    "padded_vocab_size": 65024,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# Slice 21's, from their published config.json values. StableLM-2-12B
# (stabilityai/stablelm-2-12b): 32 heads of 160 on 8 kv heads, rotary over
# a quarter of each (40 dims), a parallel residual with two LayerNorms
# (its qk_layernorm is read by neither package: ROADMAP §3).
STABLELM_2_12B = {
    "architectures": ["StableLmForCausalLM"],
    "hidden_size": 5120,
    "intermediate_size": 13824,
    "num_hidden_layers": 40,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "partial_rotary_factor": 0.25,
    "rope_theta": 10000,
    "use_parallel_residual": True,
    "qk_layernorm": True,
    "use_qkv_bias": False,
    "hidden_act": "silu",
    "layer_norm_eps": 1e-5,
    "max_position_embeddings": 4096,
    "vocab_size": 100352,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# StarCoder (bigcode/starcoder, GPTBigCode): 48 heads of 128 on one kv
# head (multi-query: the decode kernel's wide form at QH/KV 48), learned
# positions over 8192, the tanh-GELU MLP, a tied head.
STARCODER = {
    "architectures": ["GPTBigCodeForCausalLM"],
    "n_embd": 6144,
    "n_head": 48,
    "n_layer": 40,
    "n_inner": 24576,
    "n_positions": 8192,
    "multi_query": True,
    "activation_function": "gelu_pytorch_tanh",
    "layer_norm_epsilon": 1e-5,
    "vocab_size": 49152,
    "torch_dtype": "bfloat16",
}
# OPT-6.7B (facebook/opt-6.7b): MHA, 32 heads of 128, learned positions
# with OPT's offset of 2, a ReLU MLP, a tied head.
OPT_6P7B = {
    "architectures": ["OPTForCausalLM"],
    "hidden_size": 4096,
    "num_attention_heads": 32,
    "num_hidden_layers": 32,
    "ffn_dim": 16384,
    "max_position_embeddings": 2048,
    "word_embed_proj_dim": 4096,
    "do_layer_norm_before": True,
    "activation_function": "relu",
    "vocab_size": 50272,
    "torch_dtype": "bfloat16",
}
# GPT-2-XL (openai-community/gpt2-xl): 25 heads of 64 (MHA), 1024 learned
# positions, Conv1D weights, a tied head.
GPT2_XL = {
    "architectures": ["GPT2LMHeadModel"],
    "n_embd": 1600,
    "n_head": 25,
    "n_layer": 48,
    "n_inner": None,
    "n_positions": 1024,
    "n_ctx": 1024,
    "activation_function": "gelu_new",
    "layer_norm_epsilon": 1e-5,
    "vocab_size": 50257,
    "torch_dtype": "bfloat16",
}
# Granite-3.1-8B (ibm-granite/granite-3.1-8b-instruct): the Llama topology
# at QH/KV 4 with its four muP multipliers.
GRANITE_31_8B = {
    "architectures": ["GraniteForCausalLM"],
    "hidden_size": 4096,
    "intermediate_size": 12800,
    "num_hidden_layers": 40,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "embedding_multiplier": 12.0,
    "residual_multiplier": 0.22,
    "attention_multiplier": 0.0078125,
    "logits_scaling": 16.0,
    "rope_theta": 10000000.0,
    "rms_norm_eps": 1e-5,
    "max_position_embeddings": 131072,
    "attention_bias": False,
    "vocab_size": 49155,
    "tie_word_embeddings": True,
    "torch_dtype": "bfloat16",
}
# Qwen2.5-7B with the YaRN scaling its model card documents for long
# contexts (factor 4 over its 32768 positions).
QWEN25_7B_YARN = dict(QWEN25_7B, rope_scaling={
    "type": "yarn", "factor": 4.0,
    "original_max_position_embeddings": 32768})
# Slice 22's, from their published config.json values. MiniCPM3-4B
# (openbmb/MiniCPM3-4B): multi-head latent attention, a low-rank q (rank
# 768) and one shared kv latent (rank 256) with 32 rotary dims, 40 heads
# of 64 + 32 (values 64), all 62 layers dense SwiGLU, the muP scales, an
# untied head of 73448 tokens: 4.26 B parameters. Its two LongRoPE factor
# lists (16 entries each, qk_rope_head_dim / 2) are not in the repository:
# minicpm3_config draws stand-ins from the seed. Its
# original_max_position_embeddings is its 32768, so the short factors
# apply at every served length up to there (the paths serve 4096, to keep
# the page tables small).
MINICPM3_LEN = 4096


def minicpm3_config(layers: int = 62) -> dict:
    rng = np.random.default_rng(SEED + 22)
    scaling = {"type": "longrope", "original_max_position_embeddings": 32768,
               "short_factor": np.sort(rng.uniform(1.0, 3.0, 16)).tolist(),
               "long_factor": np.sort(rng.uniform(1.0, 64.0, 16)).tolist()}
    return {
        "architectures": ["MiniCPM3ForCausalLM"],
        "hidden_size": 2560,
        "intermediate_size": 6400,
        "num_hidden_layers": layers,
        "num_attention_heads": 40,
        "num_key_value_heads": 40,
        "q_lora_rank": 768,
        "kv_lora_rank": 256,
        "qk_nope_head_dim": 64,
        "qk_rope_head_dim": 32,
        "v_head_dim": 64,
        "hidden_act": "silu",
        "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0,
        "rope_scaling": scaling,
        "max_position_embeddings": 32768,
        "scale_emb": 12,
        "scale_depth": 1.4,
        "dim_model_base": 256,
        "vocab_size": 73448,
        "tie_word_embeddings": False,
        "torch_dtype": "bfloat16",
    }


MINICPM3_4B = minicpm3_config()
# MiniCPM-2B (openbmb/MiniCPM-2B-sft-bf16): the Llama topology at MHA, 36
# heads of 64, with the muP scales and a tied head of 122753 tokens.
MINICPM_2B = {
    "architectures": ["MiniCPMForCausalLM"],
    "hidden_size": 2304,
    "intermediate_size": 5760,
    "num_hidden_layers": 40,
    "num_attention_heads": 36,
    "num_key_value_heads": 36,
    "hidden_act": "silu",
    "rms_norm_eps": 1e-5,
    "max_position_embeddings": 2048,
    "scale_emb": 12,
    "scale_depth": 1.4,
    "dim_model_base": 256,
    "vocab_size": 122753,
    "tie_word_embeddings": True,
    "torch_dtype": "bfloat16",
}
# MiniCPM-MoE-8x2B (openbmb/MiniCPM-MoE-8x2B): MiniCPM-2B's attention with
# 8 experts of width 5760, top 2 renormalized (Mixtral's routing).
MINICPM_MOE_8X2B = dict(MINICPM_2B, num_experts=8, num_experts_per_tok=2,
                        max_position_embeddings=4096)
# OLMo-2-7B (allenai/OLMo-2-1124-7B): MHA, 32 heads of 128, RMSNorm on
# each block's output and over the whole q and k projections, an untied
# head of 100352 tokens.
OLMO2_7B = {
    "architectures": ["Olmo2ForCausalLM"],
    "hidden_size": 4096,
    "intermediate_size": 11008,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 32,
    "hidden_act": "silu",
    "rms_norm_eps": 1e-6,
    "rope_theta": 500000,
    "attention_bias": False,
    "max_position_embeddings": 4096,
    "vocab_size": 100352,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# Slice 19's encoder-decoders, from their published config.json values
# (google/flan-t5-xxl, google-t5/t5-small, facebook/bart-large-cnn); each
# runs at full width and all its layers, in bf16 (the dtype is passed).
FLAN_T5_XXL = {
    "architectures": ["T5ForConditionalGeneration"],
    "model_type": "t5",
    "d_model": 4096,
    "d_ff": 10240,
    "d_kv": 64,
    "num_heads": 64,
    "num_layers": 24,
    "num_decoder_layers": 24,
    "feed_forward_proj": "gated-gelu",
    "tie_word_embeddings": False,
    "relative_attention_num_buckets": 32,
    "relative_attention_max_distance": 128,
    "layer_norm_epsilon": 1e-6,
    "n_positions": 512,
    "vocab_size": 32128,
    "decoder_start_token_id": 0,
    "eos_token_id": 1,
    "pad_token_id": 0,
    "torch_dtype": "float32",
}
T5_SMALL = {
    "architectures": ["T5ForConditionalGeneration"],
    "model_type": "t5",
    "d_model": 512,
    "d_ff": 2048,
    "d_kv": 64,
    "num_heads": 8,
    "num_layers": 6,
    "num_decoder_layers": 6,
    "feed_forward_proj": "relu",
    "tie_word_embeddings": True,
    "relative_attention_num_buckets": 32,
    "relative_attention_max_distance": 128,
    "layer_norm_epsilon": 1e-6,
    "n_positions": 512,
    "vocab_size": 32128,
    "decoder_start_token_id": 0,
    "eos_token_id": 1,
    "pad_token_id": 0,
    "torch_dtype": "float32",
}
BART_LARGE_CNN = {
    "architectures": ["BartForConditionalGeneration"],
    "model_type": "bart",
    "d_model": 1024,
    "encoder_layers": 12,
    "decoder_layers": 12,
    "num_hidden_layers": 12,
    "encoder_attention_heads": 16,
    "decoder_attention_heads": 16,
    "encoder_ffn_dim": 4096,
    "decoder_ffn_dim": 4096,
    "activation_function": "gelu",
    "max_position_embeddings": 1024,
    "scale_embedding": False,
    "vocab_size": 50264,
    "bos_token_id": 0,
    "pad_token_id": 1,
    "eos_token_id": 2,
    "decoder_start_token_id": 2,
    "torch_dtype": "float32",
}
# The keys a config may name its depth by (HF, Bloom, Falcon, JAIS, GPT-J;
# MPT; ChatGLM).
LAYER_KEYS = ("num_hidden_layers", "n_layer", "n_layers", "num_layers")


def config_vocab(config: dict) -> int:
    """The vocabulary a config names (ChatGLM's padded_vocab_size)."""
    return int(config.get("vocab_size") or config["padded_vocab_size"])


def config_layers(config: dict) -> int:
    """The depth a config names, under whichever key it uses."""
    return int(next(config[k] for k in LAYER_KEYS if k in config))


def with_layers(config: dict, layers: int) -> dict:
    """The config cut (or set) to `layers` layers, under its own key."""
    key = next(k for k in LAYER_KEYS if k in config)
    return dict(config, **{key: layers})


# The attention kernels' checks: (query heads, kv heads, head_dim, ALiBi)
# of Baichuan2-13B (QH/KV 1), bench.py's 1.4B (2), Llama-3.1-8B (4) and
# Llama-3-70B (8); and the shapes slice 8 brought in: Qwen2.5-7B (QH/KV 7),
# Qwen2.5-0.5B (7 at head_dim 64), Qwen3-14B (5), Llama-3.2-3B (3),
# Qwen2.5-1.5B (6), Llama-3.2-1B (4 at head_dim 64) and QH/KV 16 at head_dim
# 64 (the largest the kernels took until slice 18); slice 15's: Phi-3-mini
# (MHA at head_dim 96), Gemma-2-9B (2 at 256), Gemma-7B (1 at 256) and
# Gemma-3-1B (4 at 256); and slice 18's: Falcon-7B (71 on one kv head at
# head_dim 64: the decode kernel's wide form, the ragged kernel's tiles
# inside a token's heads) and Bloom-560m (MHA with ALiBi at head_dim 64:
# the ragged kernel's runtime-QG instantiation with ALiBi); and slice 20's:
# Phi-2 (MHA at head_dim 80) and 20 query heads on one kv head at 80 (the
# decode kernel's wide form, whose 256 threads take a narrow tile's 640
# copies in two and a half rounds); and slice 21's: StableLM-2-12B (QH/KV 4
# at head_dim 160, whose Q fragments both kernels read from the staged
# rows at every k16 step) and 20 query heads on one kv head at 160 (the
# wide form at 160); and slice 22's: MiniCPM3-4B's latent MLA head (40
# query heads on one kv head at head_dim 384, the ragged kernel's own
# library, which a pure-decode batch reaches too: cu_q_lens None).
ATTN_GEOMETRIES = {
    "baichuan2-13b 40/40 alibi": (40, 40, 128, True),
    "bench-1.4b 16/8": (16, 8, 128, False),
    "llama-3.1-8b 32/8": (32, 8, 128, False),
    "llama-3-70b 64/8": (64, 8, 128, False),
    "qwen2.5-7b 28/4": (28, 4, 128, False),
    "qwen2.5-0.5b 14/2 d64": (14, 2, 64, False),
    "qwen3-14b 40/8": (40, 8, 128, False),
    "llama-3.2-3b 24/8": (24, 8, 128, False),
    "qwen2.5-1.5b 12/2": (12, 2, 128, False),
    "llama-3.2-1b 32/8 d64": (32, 8, 64, False),
    "qg16 32/2 d64": (32, 2, 64, False),
    "phi-3-mini 32/32 d96": (32, 32, 96, False),
    "gemma-2-9b 16/8 d256": (16, 8, 256, False),
    "gemma-7b 16/16 d256": (16, 16, 256, False),
    "gemma-3-1b 4/1 d256": (4, 1, 256, False),
    "falcon-7b 71/1 d64": (71, 1, 64, False),
    "bloom-560m 16/16 alibi d64": (16, 16, 64, True),
    "phi-2 32/32 d80": (32, 32, 80, False),
    "qg20 20/1 d80": (20, 1, 80, False),
    "stablelm-2-12b 32/8 d160": (32, 8, 160, False),
    "qg20 20/1 d160": (20, 1, 160, False),
    "minicpm3-4b 40/1 d384": (40, 1, 384, False),
}
# And with Phi-3-Small's blocksparse mask: (block size, local blocks,
# vertical stride); query head h has phase h * max(1, stride // QH).
BLOCKSPARSE_GEOMETRY = "phi-3-small 32/8 blocksparse"
PHI3_BLOCKSPARSE = (64, 16, 8)
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
# 64-key tile of a long row misses by several times this bound.
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
# The random Gemma2 and Gemma3 models (sandwich norms, whose dummy weights
# are ones, so 1 + w = 2) are chaotic with depth: the logits of plain
# attention in f32 and in f64 lie 0.005 of a row apart at 2 Gemma-2-9B
# layers, 0.044 at 6, 0.31 at 14 and 0.94 at 42, where even their argmax
# differs (Gemma-3-1B: 0.021 at 4 layers, 0.22 at 26), while Llama-3.1-8B
# and Phi-3-mini stay at 0.012-0.013 over 32 layers (NVIDIA H100 80GB
# HBM3 at 700 W: python -m aphrodite_tpu_torch.tools.logits_floor, this
# script's compare prefill). A comparison at LOGIT_TOL has no power
# there, so those paths compare their logits on their model's first
# COMPARE_LAYERS layers, where that floor is 0.033 (Gemma-2-9B, a
# 4500-token prefill) and 0.021 (Gemma-3-1B) of a row.
COMPARE_LAYERS = 4
NUM_REQUESTS = 16
MAX_TOKENS = 64
# main_path's launches: the key of the part made by CUDA graph replays.
IN_GRAPH_REPLAYS = "in graph replays"
# The int4 projections of one Llama-3.1-8B layer: name -> (K, N).
INT4_SITES = {"wqkv": (4096, 6144), "wo": (4096, 4096),
              "w13": (4096, 28672), "down": (14336, 4096)}
INT4_GROUP = 128
# Under 64 tokens both int4 wrappers take the decode body
# (csrc/decode_gemm.cuh), from there the prefill body (csrc/
# dequant_gemm.cuh): 63 and 64 hold the switch, 257 a ragged token tile;
# 16 is the main paths' decode step, 48 two token tiles of the decode body.
INT4_CHECK_T = (1, 8, 16, 32, 48, 63, 64, 100, 257, 2048)
INT4_TIME_T = (32, 128, 512, 2048)
# The decode body is timed at one token and at the decode step's 16 and 32
# too: the packed kernel at every site, the unpacked one (Q6_K-like, Q8_0,
# int8 G = K) at w13.
DECODE_TIME_T = (1, 16)
DECODE_ITERS = 100
# The FP8 product is timed at the decode step's 16 rows too: under
# FP8_WGMMA_MIN_T tokens it takes its mma.sync body.
FP8_TIME_T = (16, *INT4_TIME_T)
# int4 matmul outputs are compared row by row (the N outputs of one
# token): |kernel - other| <= tol * max|other row|, x at std 1, against
# two products. The exact one, with f32 weights: under 64 tokens the
# kernel multiplies raw nibbles and scales f32 partial sums per group, so
# it differs only in the order of its f32 sums (tensor-core fragments and
# split K against one cuBLAS f32 product), about sqrt(K) * 2^-24 of the
# row's largest element: INT4_TOL_SAME. And the plain version, which
# rounds the dequantized weight to bf16, up to 2^-9 relative per term,
# adding up as a random walk over K: INT4_TOL_ROUNDED, which also holds the
# plain version to the exact one. From 64 tokens on the prefill body rounds
# the weight as the plain version does, and the two tolerances swap.
INT4_TOL_SAME = 2.0**-14
INT4_TOL_ROUNDED = 2.0**-6
# The unpacked int4 matmul (one int8 level per byte), by container:
# levels [low, high), zero [low, high), group, whether scales are signed,
# and the bodies that take it (a group under 16 rows is dense only).
# q6_k: GGUF Q6_K (levels 0..63, zero 32, int8 sub-scales); q8_0: GGUF Q8_0
# (signed bytes, zero 0); act_order: GPTQ with desc_act (nibbles, one scale
# and zero row per weight row); gptq_g128: a GPTQ group of 128 that does
# not pack (K/2 not a multiple of the group at other widths).
Q4_CONTAINERS = {
    "q6_k": dict(levels=(0, 64), zero=(32, 33), group=16, signed=True,
                 bodies=("groupwise", "dense")),
    "q8_0": dict(levels=(-128, 128), zero=(0, 1), group=32, signed=False,
                 bodies=("groupwise", "dense")),
    "act_order": dict(levels=(0, 16), zero=(0, 17), group=1, signed=False,
                      bodies=("dense",)),
    "gptq_g128": dict(levels=(0, 16), zero=(0, 17), group=128, signed=False,
                      bodies=("groupwise", "dense")),
}
Q4_TIMED = ("q6_k", "q8_0")
Q4_SWEPT = ("q6_k", "q8_0", "gptq_g128")
# Its two bodies against the same two products as the packed kernel, with
# the roles swapped for the dense body: it forms (q - zero) * scale in f32
# and rounds it to bf16 exactly as the plain version does, so it differs
# from the plain version only in the order of the f32 sums (INT4_TOL_SAME)
# and from the exact product by that rounding (INT4_TOL_ROUNDED); the
# group-wise body multiplies raw levels and applies scale and zero to f32
# partial sums, so it follows the exact product (INT4_TOL_SAME) and differs
# from the plain version by the rounding (INT4_TOL_ROUNDED). In the
# group-wise form s * (x_g @ q_g) and (s * z) * rowsum(x_g) partly cancel
# (Q6_K: zero 32 against levels 0..63); both are f32 sums of exact bf16
# products over one group, so the loss is a few f32 ulps of terms a few
# times the result, well inside 2^-14 of the row's largest output. One case
# holds groups whose scale is 2^-20 and whose zero is offset * 2^20 (a GGUF
# min offset under a zero group scale): there w is -offset to 2^-15 and
# s * z is formed once in f32.
Q4_TOLS = {"dense": dict(plain=INT4_TOL_SAME, exact=INT4_TOL_ROUNDED),
           "groupwise": dict(plain=INT4_TOL_ROUNDED, exact=INT4_TOL_SAME)}
# W4A8 (int8 activations x packed int4) against its plain version: the int8
# activations are bit-equal on both sides and each group's product is an
# exact int32, so only the order of the f32 sums differs (INT4_TOL_SAME).
# Against the W4A16 product with f32 weights (no a8 rounding) the JAX
# package's own bound on a8 error (tests/test_quantization.py:257-276):
# under A8_BOUND of the output's largest value.
A8_BOUND = 0.02
INT8_OPS = 1979e12  # H100 SXM dense int8 (and fp8) tensor-core peak
# The FP8 W8A8 product (the quantizer kernel and either body) against its
# plain version: the e4m3 operands are equal on both sides, every product
# is exact and both sum in f32, so only the order of the sums differs
# (INT4_TOL_SAME). The fp8 path's logits cannot be held that close: each
# layer re-quantizes its activations to e4m3, which turns last-bit
# differences of the f32 sums into whole e4m3 steps, so two f32 orders of
# the same exact products land several 1e-2 of a row apart after 4
# layers. The script measures that floor in the same run (the plain
# product with the order of K reversed) and holds the kernel's logits at
# max(LOGIT_TOL, FP8_FLOOR_FACTOR x the floor's worst row), and their
# argmax on every row whose plain top two lie more than twice the floor's
# largest change apart (a closer pair no f32 order decides). The W4A8
# product (exact int32 group sums, f32 fix-ups) meets the same floor after
# 32 layers: there the plain product with K reversed is a third run, and
# argmax is held on the rows it decides, the logits at LOGIT_TOL.
FP8_FLOOR_FACTOR = 1.5
# The activation quantizer, (T, K) of its checks and timings.
ACT_CHECK_T = (1, 33, 2048)
ACT_TIME = ((32, 4096), (32, 14336), (2048, 4096), (2048, 14336))
# Depth of the Q6_K GGUF main path (full width; the other GGUF paths run 4
# layers; 32 until slice 18, cut to 16 for time: at 32 its host-side file
# writing and block decoding took 146-198 s of the run).
GGUF_Q6K_LAYERS = 16
GGML_F32, GGML_F16, GGML_Q8_0, GGML_Q2_K, GGML_Q3_K, GGML_Q6_K = (
    0, 1, 8, 10, 11, 14)
# (ggml type, values per block, bytes per block) of each block type the
# script writes.
GGUF_BLOCKS = {"q6_k": (GGML_Q6_K, 256, 210), "q8_0": (GGML_Q8_0, 32, 34),
               "q2_k": (GGML_Q2_K, 256, 84), "q3_k": (GGML_Q3_K, 256, 110)}


# The groups of the GGUF block types the main paths serve: Q6_K and Q8_0
# one level a byte, Q2_K (and Q3_K, its down projection) packed.
GGUF_GROUPS = {"q6_k": 16, "q8_0": 32, "q2_k": 16}


def projection_shapes(config):
    """(K, N) of the four quantized products of a Llama-family layer:
    wqkv, wo, w13 (gate and up), down."""
    H = config["hidden_size"]
    heads = config["num_attention_heads"]
    kv_heads = config.get("num_key_value_heads", heads)
    head_dim = config.get("head_dim", H // heads)
    inter = config["intermediate_size"]
    return [(H, (heads + 2 * kv_heads) * head_dim), (heads * head_dim, H),
            (H, 2 * inter), (inter, H)]


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


def attention_work(case, num_q_heads, num_kv_heads, head_dim, decode,
                   alibi=False):
    """(bytes, flops) the call needs on this data: q and out of the live
    tokens once (bf16), each live K/V row once at the page type's size,
    the index tensors the kernel takes (and the f32 slope table); 4 * D
    FLOPs per visible (query head, key) pair, 2 more with ALiBi."""
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
              + sum(t.numel() * 4 for t in index)
              + (num_q_heads * 4 if alibi else 0))
    flops = (4 * head_dim + (2 if alibi else 0)) * pairs * num_q_heads
    return nbytes, flops


def sdpa_inputs(case, layer, num_q_heads, num_kv_heads, head_dim,
                decode, slopes=None):
    """Pre-gathered contiguous inputs for one scaled_dot_product_attention
    call computing the same function over the live sequences. With ALiBi
    slopes the mask is a bf16 bias, slope * (key - query position) where
    visible and -inf elsewhere, per query head."""
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
        if slopes is not None:
            pos = case["kv_lens"][:n].long() - 1
            rel = (torch.arange(lmax, device=dev)[None, :]
                   - pos[:, None]).float()  # [n, L]
            bias = slopes.float()[None, :, None] * rel[:, None, :]
            mask = torch.where(mask[:, 0], bias, float("-inf"))[:, :, None]
            mask = mask.to(torch.bfloat16)
        return qq, kk, vv, mask
    k = torch.cat(ks).repeat_interleave(rep, 1).transpose(0, 1)[None]
    v = torch.cat(vs).repeat_interleave(rep, 1).transpose(0, 1)[None]
    tokens = cu[len(case["seqs"])]
    mask = torch.zeros((tokens, k.shape[2]), dtype=torch.bool, device=dev)
    rel = torch.zeros((tokens, k.shape[2]), device=dev)
    key0 = 0
    for s, (q_len, kv_len) in enumerate(case["seqs"]):
        pos = torch.arange(kv_len - q_len, kv_len, device=dev)
        keys = torch.arange(kv_len, device=dev)
        mask[cu[s]:cu[s + 1], key0:key0 + kv_len] = (
            keys[None, :] <= pos[:, None])
        rel[cu[s]:cu[s + 1], key0:key0 + kv_len] = (
            keys[None, :] - pos[:, None]).float()
        key0 += kv_len
    qq = case["q"][:tokens].transpose(0, 1)[None]
    if slopes is not None:
        bias = slopes.float()[:, None, None] * rel[None]  # [QH, T, L]
        mask = torch.where(mask[None], bias, float("-inf"))[None]
        mask = mask.to(torch.bfloat16)
    return qq, k, v, mask


def phi3_offsets(num_q_heads, device):
    """Phi-3-Small's hetero phases: query head h at h * max(1, vert //
    QH), an int32 tensor on the device."""
    import torch

    vert = PHI3_BLOCKSPARSE[2]
    return (torch.arange(num_q_heads, dtype=torch.int32, device=device)
            * max(1, vert // num_q_heads))


def visible_keys(q_pos, kv_len, offsets):
    """bool [QH, n, kv_len]: which keys each query head at positions q_pos
    sees under the causal and Phi-3-Small's blocksparse masks."""
    import torch

    block, local, vert = PHI3_BLOCKSPARSE
    keys = torch.arange(kv_len, device=q_pos.device)
    causal = keys[None, :] <= q_pos[:, None]
    bk = keys // block
    local_ok = (q_pos[:, None] // block - bk[None, :]) < local
    vert_ok = (bk[None, :] + offsets.long()[:, None] + 1) % vert == 0
    return causal[None] & (local_ok[None] | vert_ok[:, None, :])


def blocksparse_work(case, num_q_heads, num_kv_heads, head_dim, decode):
    """(bytes, flops) of a blocksparse call on this data: q and out of the
    live tokens once (bf16), each K/V row that some query head of its kv
    head can see once (at the page type's size), the index tensors and the
    phase table; 4 * D FLOPs per visible (query head, key) pair."""
    import torch

    kv_itemsize = case["kv"].dtype.itemsize
    offsets = phi3_offsets(num_q_heads, case["q"].device)
    qg = num_q_heads // num_kv_heads
    tokens = pairs = live_rows = 0
    for q_len, kv_len in case["seqs"]:
        q_pos = torch.arange(kv_len - q_len, kv_len, device=case["q"].device)
        vis = visible_keys(q_pos, kv_len, offsets)  # [QH, n, L]
        pairs += int(vis.sum())
        live_rows += int(vis.reshape(num_kv_heads, qg, q_len, kv_len)
                         .any(1).any(1).sum())
        tokens += q_len
        del vis
    index = [case["kv_lens"], case["page_indices"]]
    if not decode:
        index.append(case["cu_q_lens"])
    nbytes = (2 * tokens * num_q_heads * head_dim * 2
              + live_rows * 2 * head_dim * kv_itemsize
              + sum(t.numel() * 4 for t in index) + num_q_heads * 4)
    return nbytes, 4 * head_dim * pairs


def blocksparse_sdpa_inputs(case, layer, num_q_heads, num_kv_heads,
                            head_dim, decode):
    """sdpa_inputs with Phi-3-Small's blocksparse mask: a bool mask per
    query head."""
    import torch

    qq, kk, vv, mask = sdpa_inputs(case, layer, num_q_heads, num_kv_heads,
                                   head_dim, decode)
    offsets = phi3_offsets(num_q_heads, qq.device)
    dev = qq.device
    if decode:
        n = len(case["seqs"])
        full = torch.zeros((n, num_q_heads, 1, kk.shape[2]), dtype=torch.bool,
                           device=dev)
        for s, (_, kv_len) in enumerate(case["seqs"]):
            full[s, :, :, :kv_len] = visible_keys(
                torch.tensor([kv_len - 1], device=dev), kv_len, offsets)
        return qq, kk, vv, full
    cu = case["cu_q_lens"].tolist()
    full = torch.zeros((1, num_q_heads, qq.shape[2], kk.shape[2]),
                       dtype=torch.bool, device=dev)
    key0 = 0
    for s, (q_len, kv_len) in enumerate(case["seqs"]):
        full[0, :, cu[s]:cu[s + 1], key0:key0 + kv_len] = visible_keys(
            torch.arange(kv_len - q_len, kv_len, device=dev), kv_len,
            offsets)
        key0 += kv_len
    return qq, kk, vv, full


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------


def implementation_head(point, body):
    """A timed point with `ms` the time of the implementation `body` names:
    under 64 tokens a point holds both implementations' times ("mma_ms"
    for the mma.sync kernel, "decode_ms" for the decode body)."""
    if "mma_ms" not in point:
        return point
    return dict(point, ms=point["decode_ms" if body.endswith("_decode")
                                else "mma_ms"])


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
    errs[name] = max(errs.get(name, 0.0), float(err.max()))


def ragged_kernel_name(head_dim: int) -> str:
    """The name the ragged kernel goes by in this script's output at a
    head_dim: its library's ("ragged_paged_attention_d384" at a head_dim
    built apart, ops/decode_attention.py RAGGED_ONLY_HEAD_DIMS)."""
    from aphrodite_tpu_torch.ops.decode_attention import RAGGED_ONLY_HEAD_DIMS

    return "ragged_paged_attention" + (
        f"_d{head_dim}" if head_dim in RAGGED_ONLY_HEAD_DIMS else "")


def variant_name(kernel: str, page_type: str, blocksparse=False) -> str:
    """The name a kernel's variant for one page type goes by in this
    script's output: the bf16 one keeps the kernel's name; the blocksparse
    instantiations add "_blocksparse"."""
    name = kernel + ("_blocksparse" if blocksparse else "")
    return name if page_type == "bf16" else f"{name}_{page_type}"


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


def kernel_checks(device, name, geometry, errs):
    """Each kernel, on every page type, at one geometry of
    ATTN_GEOMETRIES (`name`), against its plain version (and the narrow
    variants against the bf16 one); with ALiBi every case takes the
    model's slopes, and the first case of each kernel also runs with
    all-zero slopes, which must equal no ALiBi bit for bit. Keeps the max
    abs error per kernel variant in `errs`."""
    import torch

    from aphrodite_tpu_torch.models.layers import get_alibi_slopes
    from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                                   ref_ragged_paged_attention)
    from aphrodite_tpu_torch.ops.decode_attention import (
        RAGGED_ONLY_HEAD_DIMS, paged_decode_attention,
        ref_paged_decode_attention)

    qh, kvh, d, alibi = geometry
    slopes = (torch.from_numpy(get_alibi_slopes(qh)).to(device) if alibi
              else None)
    # At a head_dim the decode kernel does not take (384) the ragged
    # kernel's own library takes both kinds of case: a pure-decode batch
    # goes to it over arange(S + 1) (cu_q_lens None).
    ragged_name, decode_fn = ragged_kernel_name(d), paged_decode_attention
    if d in RAGGED_ONLY_HEAD_DIMS:
        def decode_fn(q, kv, kv_lens, page_indices, num_seqs=None, **kw):
            return ragged_paged_attention(q, kv, kv_lens, page_indices, None,
                                          num_seqs, **kw)

    def zero_slopes_check(kernel, label, got, fn, case, args, kw):
        if not alibi:
            return
        off = {k: v for k, v in kw.items() if k != "alibi_slopes"}
        if not torch.equal(fn(case["q"], case["kv"][0], *args, **dict(
                kw, alibi_slopes=torch.zeros_like(slopes))),
                fn(case["q"], case["kv"][0], *args, **off)):
            fail(f"{kernel} [{label}]: all-zero ALiBi slopes differ from no "
                 "ALiBi")
        print(f"check {kernel} [{label}]: all-zero slopes equal, bit for "
              "bit, no ALiBi", flush=True)

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
    for page_type in PAGE_TYPES:
        ragged = variant_name(ragged_name, page_type)
        decode = (ragged if d in RAGGED_ONLY_HEAD_DIMS
                  else variant_name("paged_decode_attention", page_type))
        errs.setdefault(ragged, 0.0)
        errs.setdefault(decode, 0.0)
        for i, (label, seqs, kw) in enumerate(ragged_cases):
            label = f"{name}: {label}"
            tokens = sum(q for q, _ in seqs)
            case = make_attention_case(seqs, qh, kvh, d, padded_seqs=8,
                                       padded_tokens=tokens + 13,
                                       device=device, seed=SEED + i,
                                       page_type=page_type)
            kw = dict(kw, sm_scale=d**-0.5 * case["kv_scale"],
                      alibi_slopes=slopes)
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
            if i == 0:
                zero_slopes_check(ragged, label, got, ragged_paged_attention,
                                  case, args, kw)
        for i, (label, live, kw) in enumerate(decode_cases):
            label = f"{name}: {label}"
            rng = np.random.default_rng(SEED + 10 + i)
            lens = rng.integers(1, 1100, size=live)
            lens[:2] = (1500, 1025)
            seqs = [(1, int(n)) for n in lens]
            case = make_attention_case(seqs, qh, kvh, d, padded_seqs=16,
                                       padded_tokens=16, device=device,
                                       seed=SEED + 10 + i,
                                       page_type=page_type)
            kw = dict(kw, sm_scale=d**-0.5 * case["kv_scale"],
                      alibi_slopes=slopes)
            args = (case["kv_lens"], case["page_indices"])
            got = decode_fn(case["q"], case["kv"][0], *args,
                            case["num_seqs"], **kw)
            want = ref_paged_decode_attention(case["q"], case["kv"][0],
                                              *args, **kw)
            check_close(errs, decode, label, got, want, 16)
            if page_type != "bf16":
                check_equals_bf16_kernel(decode, label, got, decode_fn, case,
                                         args, kw)
            if i == 0:
                zero_slopes_check(decode, label, got, decode_fn, case, args,
                                  kw)


def blocksparse_checks(device, errs):
    """Both kernels with Phi-3-Small's blocksparse mask at its geometry
    (32 / 8 heads: QG 4), on every page type, over kv lengths of 1024 to
    6144 (the local window is 1024 keys, and at kv head 0 the first 128
    keys are dead for all four of its heads), against their plain versions
    row by row; the narrow variants against the bf16 one on the widened
    pages, bit for bit; and the layer gate off (bs_on=False) against the
    kernel without blocksparse, bit for bit. Keeps the max abs error per
    blocksparse variant in `errs`."""
    import torch

    from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                                   ref_ragged_paged_attention)
    from aphrodite_tpu_torch.ops.decode_attention import (
        paged_decode_attention, ref_paged_decode_attention)

    qh, kvh, d, _ = ATTN_GEOMETRIES["llama-3.1-8b 32/8"]
    bs_kw = dict(blocksparse=PHI3_BLOCKSPARSE,
                 bs_head_offsets=phi3_offsets(qh, device))
    name = BLOCKSPARSE_GEOMETRY
    ragged_seqs = [(512, 6144), (300, 2500), (64, 1100), (1, 1024),
                   (1, 3001), (200, 200)]
    rng = np.random.default_rng(SEED + 30)
    lens = rng.integers(1024, 6145, size=14)
    decode_seqs = [(1, int(n)) for n in lens]
    cases = (
        ("ragged_paged_attention", "long prefill chunks and decode rows",
         ragged_seqs, 8, sum(q for q, _ in ragged_seqs) + 13,
         ragged_paged_attention, ref_ragged_paged_attention),
        ("paged_decode_attention", "decode with dead rows", decode_seqs,
         16, 16, paged_decode_attention, ref_paged_decode_attention))
    for page_type in PAGE_TYPES:
        for i, (kernel, label, seqs, padded_seqs, padded_tokens, fn,
                ref) in enumerate(cases):
            variant = variant_name(kernel, page_type, blocksparse=True)
            errs.setdefault(variant, 0.0)
            label = f"{name}: {label}"
            case = make_attention_case(seqs, qh, kvh, d,
                                       padded_seqs=padded_seqs,
                                       padded_tokens=padded_tokens,
                                       device=device, seed=SEED + 31 + i,
                                       page_type=page_type)
            kw = dict(bs_kw, sm_scale=d**-0.5 * case["kv_scale"])
            args = (case["kv_lens"], case["page_indices"])
            if kernel == "ragged_paged_attention":
                args += (case["cu_q_lens"], case["num_seqs"])
                rows = sum(q for q, _ in seqs)
            else:
                rows = len(seqs)
            got = fn(case["q"], case["kv"][0], *args, **kw)
            want = ref(case["q"], case["kv"][0], *args, **kw)
            check_close(errs, variant, label, got, want, rows)
            if float(got[rows:].float().abs().max()) != 0.0:
                fail(f"{variant} [{label}]: padding rows not zero")
            if page_type != "bf16":
                check_equals_bf16_kernel(variant, label, got, fn, case, args,
                                         kw)
            dense = {k: v for k, v in kw.items() if k not in bs_kw}
            if not torch.equal(fn(case["q"], case["kv"][0], *args,
                                  bs_on=False, **kw),
                               fn(case["q"], case["kv"][0], *args, **dense)):
                fail(f"{variant} [{label}]: the gate off differs from the "
                     "kernel without blocksparse")
            print(f"check {variant} [{label}]: gate off equal, bit for bit, "
                  "to the kernel without blocksparse", flush=True)
            del case, got, want


def kernel_timings(device, name, geometry, prompt_lens, iters, errs,
                   page_types=PAGE_TYPES, layers=16, blocksparse=False):
    """Checks and times at the main path's shapes, at one geometry of
    ATTN_GEOMETRIES (`name`; with ALiBi, the model's slopes): a full
    2048-token prefill step (prompts in arrival order, the last one
    chunked) and a decode step of all requests mid-generation in their
    32-row bucket, on each of `page_types` in turn (the same sequences and
    page tables; the narrow caches hold the bf16 one's values over
    KV_SCALE), each timed launch on the next of `layers` cache layers
    (more K/V bytes than the 50 MB L2 holds). With blocksparse, Phi-3-
    Small's mask on every call, and the prefill step is the last 2048
    tokens of the longest prompt (where the mask hides the most); the
    library call takes the mask as a bool tensor, and the bound counts the
    K/V rows some query head can see and the visible pairs. Prints the
    decode kernel's split plan (split keys, splits, blocks) at each shape,
    as the wrapper launched it. At a head_dim the decode kernel does not
    take (384) the decode step goes through the ragged kernel (cu_q_lens
    None) and is keyed "<variant> decode". Returns, per kernel variant, a
    dict of shape, ms, plain_ms, library_ms, bound_ms, bound_by."""
    import torch

    from aphrodite_tpu_torch.models.layers import get_alibi_slopes
    from aphrodite_tpu_torch.ops.attention import (ragged_paged_attention,
                                                   ref_ragged_paged_attention)
    from aphrodite_tpu_torch.ops.decode_attention import (
        RAGGED_ONLY_HEAD_DIMS, paged_decode_attention,
        ref_paged_decode_attention)

    qh, kvh, d, alibi = geometry
    ragged_only = d in RAGGED_ONLY_HEAD_DIMS
    slopes = (torch.from_numpy(get_alibi_slopes(qh)).to(device) if alibi
              else None)
    bs_kw = {}
    if blocksparse:
        bs_kw = dict(blocksparse=PHI3_BLOCKSPARSE,
                     bs_head_offsets=phi3_offsets(qh, device))
    prefill, budget = [], 2048
    for n in prompt_lens:
        take = min(int(n), budget)
        prefill.append((take, take))
        budget -= take
        if budget == 0:
            break
    if blocksparse:
        prefill = [(2048, int(max(prompt_lens)))]
    decode = [(1, int(n) + MAX_TOKENS // 2) for n in prompt_lens]
    shapes = {
        "ragged_paged_attention": (prefill, 32, 2048),
        "paged_decode_attention": (decode, 32, 32),
    }
    out = {}
    for kernel, page_type in ((k, p) for k in shapes for p in page_types):
        seqs, padded_seqs, padded_tokens = shapes[kernel]
        variant = variant_name(kernel, page_type, blocksparse)
        if ragged_only:
            variant = variant_name(ragged_kernel_name(d), page_type)
        # The key of this shape's times, and the variant its check's
        # error is kept under.
        key = (f"{variant} decode" if ragged_only
               and kernel == "paged_decode_attention" else variant)
        case = make_attention_case(seqs, qh, kvh, d, padded_seqs=padded_seqs,
                                   padded_tokens=padded_tokens, device=device,
                                   seed=SEED + 20, num_layers=layers,
                                   page_type=page_type)
        scale = d**-0.5 * case["kv_scale"]
        decode_kernel = kernel == "paged_decode_attention"
        state = {"layer": 0}

        def call(use_kernel, bs_on=True):
            layer = state["layer"] = (state["layer"] + 1) % layers
            kv = case["kv"][layer]
            if decode_kernel and ragged_only and use_kernel:
                return ragged_paged_attention(
                    case["q"], kv, case["kv_lens"], case["page_indices"],
                    None, case["num_seqs"], sm_scale=scale)
            if decode_kernel:
                fn = (paged_decode_attention if use_kernel
                      else ref_paged_decode_attention)
                extra = ((case["num_seqs"],) if use_kernel else ())
                return fn(case["q"], kv, case["kv_lens"],
                          case["page_indices"], *extra, sm_scale=scale,
                          alibi_slopes=slopes, bs_on=bs_on, **bs_kw)
            fn = (ragged_paged_attention if use_kernel
                  else ref_ragged_paged_attention)
            return fn(case["q"], kv, case["kv_lens"], case["page_indices"],
                      case["cu_q_lens"], case["num_seqs"], sm_scale=scale,
                      alibi_slopes=slopes, bs_on=bs_on, **bs_kw)

        state["layer"] = layers - 1  # the next call reads layer 0
        got = call(True)
        state["layer"] = layers - 1
        rows = padded_seqs if decode_kernel else sum(q for q, _ in seqs)
        check_close(errs, variant, f"{name}: main-path shape", got,
                    call(False), rows)
        ms = time_ms(lambda: call(True), iters)
        plain_ms = time_ms(lambda: call(False), max(1, iters // 20))
        if blocksparse:
            qq, kk, vv, mask = blocksparse_sdpa_inputs(case, 0, qh, kvh, d,
                                                       decode_kernel)
            nbytes, flops = blocksparse_work(case, qh, kvh, d, decode_kernel)
        else:
            qq, kk, vv, mask = sdpa_inputs(case, 0, qh, kvh, d,
                                           decode_kernel, slopes)
            nbytes, flops = attention_work(case, qh, kvh, d, decode_kernel,
                                           alibi)
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask, scale=scale), iters)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        rows_label = (f"decode {len(seqs)} rows" if decode_kernel else
                      f"prefill {sum(q for q, _ in seqs)} tokens")
        if decode_kernel and ragged_only:
            rows_label += " through the ragged kernel"
        out[key] = dict(shape=f"{name}, {rows_label}", ms=ms,
                        plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else
                        "operations")
        if blocksparse:
            # The same launch with the layer's gate off: dense attention in
            # the kernel without blocksparse, which reads every K/V row.
            out[variant]["gate_off_ms"] = time_ms(
                lambda: call(True, bs_on=False), iters)
            print(f"time {variant} [{name}]: the same call with the gate off "
                  f"(the kernel without blocksparse) "
                  f"{out[variant]['gate_off_ms']:.4f} ms", flush=True)
        if decode_kernel and not ragged_only:
            # The split-KV plan the wrapper launched at this shape, as it
            # recorded it (printed only).
            plan = paged_decode_attention.last_plan
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
            print(f"splits {variant} [{name}]: {plan['splits']} splits of "
                  f"{plan['split_keys']} keys over {plan['blocks']} blocks "
                  f"({plan['slots']} per row and kv head) for {sms} SMs, as "
                  "launched", flush=True)
        bf16_key = (key if page_type == "bf16" else
                    key.replace(f"_{page_type}", "") if ragged_only else
                    variant_name(kernel, "bf16", blocksparse))
        beside = ("" if page_type == "bf16" else
                  f" (bf16 pages, same case: {out[bf16_key]['ms']:.4f} "
                  "ms)")
        print(f"time {key} [{name}]: {len(seqs)} seqs, "
              f"{sum(q for q, _ in seqs)} query tokens, "
              f"{sum(kv for _, kv in seqs)} kv rows: kernel {ms:.4f} ms"
              f"{beside}, plain {plain_ms:.4f} ms, library (sdpa on the "
              f"rows widened to bf16, gather excluded"
              f"{', ALiBi as a bf16 bias mask' if alibi else ''}"
              f"{', the blocksparse mask as a bool mask' if blocksparse else ''}"
              ") "
              f"{library_ms:.4f} ms, bound {out[key]['bound_ms']:.4f} ms "
              f"({out[key]['bound_by']}: {nbytes} bytes, {flops} FLOPs)",
              flush=True)
        del case, qq, kk, vv, mask
    return out


# ----------------------------------------------------------------------
# T5's relative-position bias in the decode kernel
# ----------------------------------------------------------------------

# The decode kernel's T5 bias: (query heads, kv heads, head_dim) by name.
# Flan-T5-XXL's 64 heads of 64 (QG 1, the T5 paths' shape), QG 1 at
# head_dim 128, QG 2 at 64 and QG 71 at 64 (the kernel's wide form).
REL_BIAS_GEOMETRIES = {
    "flan-t5-xxl 64/64 d64 rel_bias": (64, 64, 64),
    "qg1 16/16 d128 rel_bias": (16, 16, 128),
    "qg2 32/16 d64 rel_bias": (32, 16, 64),
    "qg71 71/1 d64 rel_bias": (71, 1, 64),
}
# T5's and Flan-T5's buckets and max_distance (saturation at distance 113).
REL_BIAS_META = (32, 128)
REL_BIAS_GEOMETRY = "flan-t5-xxl 64/64 d64 rel_bias"


def rel_bias_table(num_q_heads, device, seed):
    """A T5 table f32[QH, 32] at std 3, so that the bias moves the
    softmax (the dummy weights' table is at std 1/8)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((num_q_heads, REL_BIAS_META[0]), generator=gen)
            * 3).to(device)


def rel_bias_cases(prompt_lens):
    """(label, seqs) of the phase's decode batches, each in the 32-row
    bucket: the main paths' decode step (16 rows of the prompts plus 32
    tokens, 48-1056 keys) and the T5 paths' own, 16 rows of MAX_TOKENS
    keys (a decoder row at the end of its run)."""
    return [("main-path decode step",
             [(1, int(n) + MAX_TOKENS // 2) for n in prompt_lens]),
            ("t5 decoder rows", [(1, MAX_TOKENS)] * NUM_REQUESTS)]


def rel_bias_variant(page_type: str) -> str:
    """The kernels line's name of the decode kernel with the T5 bias."""
    return variant_name("paged_decode_attention_rel_bias", page_type)


def rel_bias_checks(device, errs, prompt_lens):
    """The decode kernel with the T5 bias at each of REL_BIAS_GEOMETRIES,
    on every page type, at both of rel_bias_cases, unscaled as T5 attends
    (sm_scale 1, times the narrow pages' scale), against its plain version
    row by row; the narrow variants equal the bf16 one on the widened
    pages, and an all-zero table equals no bias, bit for bit. Keeps the
    max abs error per page type in `errs`."""
    import torch

    from aphrodite_tpu_torch.ops.decode_attention import (
        paged_decode_attention, ref_paged_decode_attention)

    for g, (name, (qh, kvh, d)) in enumerate(REL_BIAS_GEOMETRIES.items()):
        table = rel_bias_table(qh, device, SEED + 40 + g)
        for i, (label, seqs) in enumerate(rel_bias_cases(prompt_lens)):
            for page_type in PAGE_TYPES:
                variant = rel_bias_variant(page_type)
                errs.setdefault(variant, 0.0)
                case = make_attention_case(seqs, qh, kvh, d, padded_seqs=32,
                                           padded_tokens=32, device=device,
                                           seed=SEED + 50 + i,
                                           page_type=page_type)
                kw = dict(sm_scale=case["kv_scale"], rel_bias=table,
                          rel_bias_meta=REL_BIAS_META)
                args = (case["kv_lens"], case["page_indices"])
                got = paged_decode_attention(case["q"], case["kv"][0], *args,
                                             case["num_seqs"], **kw)
                want = ref_paged_decode_attention(case["q"], case["kv"][0],
                                                  *args, **kw)
                full = f"{name}: {label}"
                check_close(errs, variant, full, got, want, len(seqs))
                if page_type != "bf16":
                    check_equals_bf16_kernel(variant, full, got,
                                             paged_decode_attention, case,
                                             args, kw)
                zero = paged_decode_attention(
                    case["q"], case["kv"][0], *args,
                    **dict(kw, rel_bias=torch.zeros_like(table)))
                plain = paged_decode_attention(case["q"], case["kv"][0],
                                               *args,
                                               sm_scale=case["kv_scale"])
                if not torch.equal(zero, plain):
                    fail(f"{variant} [{full}]: an all-zero table differs "
                         "from no bias")
                del case, got, want, zero, plain


def rel_bias_sdpa_mask(case, table, num_q_heads):
    """SDPA's additive mask for the decode rows of `case` with the T5
    bias: table[h, bucket(query - key)] on each row's keys, -inf past
    them, in bf16 [n, QH, 1, L]."""
    import torch

    from aphrodite_tpu_torch.ops.decode_attention import t5_relative_bucket

    n = len(case["seqs"])
    lmax = max(kv for _, kv in case["seqs"])
    dev = table.device
    keys = torch.arange(lmax, device=dev)
    pos = case["kv_lens"][:n].long() - 1
    bucket = t5_relative_bucket(keys[None, :] - pos[:, None], False,
                                *REL_BIAS_META)  # [n, L]
    bias = table[:, bucket].permute(1, 0, 2)  # [n, QH, L]
    live = keys[None, None, :] <= pos[:, None, None]
    return torch.where(live, bias, float("-inf"))[:, :, None].to(
        torch.bfloat16)


def rel_bias_timings(device, errs, iters=100, layers=8):
    """The decode kernel with the T5 bias at Flan-T5-XXL's geometry and
    the T5 paths' decode step (16 rows of MAX_TOKENS keys in the 32-row
    bucket), on every page type, each timed launch on the next of
    `layers` cache layers: kernel (the wrapper: its gather of the table's
    columns and the launch), plain version, and the library call
    (scaled_dot_product_attention on the rows gathered and widened to
    bf16 beforehand, the bias as a bf16 additive mask), beside the bound
    (bytes: q and the output once, each live K/V row once, the index
    tensors and the table; 4 D + 1 FLOPs per visible pair). Returns, per
    page type's variant, a dict of shape, ms, plain_ms, library_ms,
    bound_ms, bound_by."""
    import torch

    from aphrodite_tpu_torch.ops.decode_attention import (
        paged_decode_attention, ref_paged_decode_attention)

    qh, kvh, d = REL_BIAS_GEOMETRIES[REL_BIAS_GEOMETRY]
    table = rel_bias_table(qh, device, SEED + 45)
    seqs = [(1, MAX_TOKENS)] * NUM_REQUESTS
    out = {}
    for page_type in PAGE_TYPES:
        variant = rel_bias_variant(page_type)
        case = make_attention_case(seqs, qh, kvh, d, padded_seqs=32,
                                   padded_tokens=32, device=device,
                                   seed=SEED + 46, num_layers=layers,
                                   page_type=page_type)
        kw = dict(sm_scale=case["kv_scale"], rel_bias=table,
                  rel_bias_meta=REL_BIAS_META)
        state = {"layer": layers - 1}

        def call(use_kernel):
            layer = state["layer"] = (state["layer"] + 1) % layers
            fn = (paged_decode_attention if use_kernel
                  else ref_paged_decode_attention)
            return fn(case["q"], case["kv"][layer], case["kv_lens"],
                      case["page_indices"], **kw)

        got = call(True)
        state["layer"] = layers - 1
        check_close(errs, variant, f"{REL_BIAS_GEOMETRY}: timed shape", got,
                    call(False), len(seqs))
        ms = time_ms(lambda: call(True), iters)
        plain_ms = time_ms(lambda: call(False), max(1, iters // 20))
        qq, kk, vv, _ = sdpa_inputs(case, 0, qh, kvh, d, True)
        mask = rel_bias_sdpa_mask(case, table, qh)
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask, scale=case["kv_scale"]), iters)
        nbytes, flops = attention_work(case, qh, kvh, d, True)
        pairs = sum(kv for _, kv in seqs) * qh
        nbytes += table.numel() * 4
        flops += pairs
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        out[variant] = dict(
            shape=f"{REL_BIAS_GEOMETRY}, decode {len(seqs)} rows of "
                  f"{MAX_TOKENS} keys", ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        plan = paged_decode_attention.last_plan
        print(f"time {variant} [{REL_BIAS_GEOMETRY}]: {len(seqs)} seqs of "
              f"{MAX_TOKENS} keys: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (sdpa on the rows widened to "
              f"bf16, gather excluded, the bias as a bf16 mask) "
              f"{library_ms:.4f} ms, bound {out[variant]['bound_ms']:.4f} ms "
              f"({out[variant]['bound_by']}: {nbytes} bytes, {flops} "
              f"FLOPs); {plan['splits']} splits, {plan['blocks']} blocks",
              flush=True)
        del case, qq, kk, vv, mask
    return out


# ----------------------------------------------------------------------
# int4 matmul
# ----------------------------------------------------------------------


def make_int4_case(K, N, layers, device, seed, wide_zero=False,
                   group=INT4_GROUP):
    """A layer-stacked packed container [layers, K/2, N] with `group`
    (INT4_GROUP unless given), made on the device from a seed: nibbles
    uniform in 0..15,
    scale in 0.001..0.021, zero an integer in 0..15 (or -3..19 with
    wide_zero: GPTQ stores zero + 1 up to 16, and quantize_from_float
    does not clip it)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    groups = K // group
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


def int4_checks(device, group=INT4_GROUP):
    """The int4 kernel against its plain version and the exact f32
    product, at every site and T, at `group` (INT4_GROUP unless given;
    16 for GGUF Q2_K and Q3_K), and at K 1088 where the group divides its
    K/2 of 544 (the prefill body's 32-row last stage); under 64 tokens
    both implementations of the group-wise body, the mma.sync kernel and
    the decode body, whichever decode_route picks; returns the max abs
    error against the plain version of each ("groupwise",
    "groupwise_decode", "dense_wgmma")."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (dequantize_int4,
                                                      int4p_body,
                                                      int4p_matmul,
                                                      int4p_matmul_ref,
                                                      unpack_int4_rows)

    worst_abs = {"groupwise": 0.0, "groupwise_decode": 0.0,
                 "dense_wgmma": 0.0}
    for i, (site, (K, N)) in enumerate(with_tail_site(group).items()):
        wide = site == "wo"
        q4p, scale, zero = make_int4_case(K, N, 2, device, SEED + 40 + i,
                                          wide_zero=wide, group=group)
        w_exact = dequantize_int4(unpack_int4_rows(q4p[1]), scale[1],
                                  zero[1], group)
        where = f"{site} {K}x{N} group {group}"
        for T, decode in ((T, d) for T in INT4_CHECK_T
                          for d in ((False, True) if T < 64 else (None,))):
            x = make_x(T, K, device, SEED + 50 + T)
            got = int4p_matmul(x, q4p, scale, zero, group, layer_idx=1,
                               decode=decode)
            torch.cuda.synchronize()
            dense = int4p_body(T) == "dense"
            body = ("dense_wgmma" if dense else
                    "groupwise_decode" if decode else "groupwise")
            where = f"{site} {K}x{N} group {group} T={T}, {body}"
            if tuple(got.shape) != (T, N) or got.dtype != torch.float32:
                fail(f"int4p_matmul [{where}]: output {got.shape} "
                     f"{got.dtype}")
            if not bool(got.isfinite().all()):
                fail(f"int4p_matmul [{where}]: non-finite output")
            plain = int4p_matmul_ref(x, q4p[1], scale[1], zero[1], group)
            exact = x.float() @ w_exact
            pairs = (("kernel", got, "plain", plain,
                      INT4_TOL_SAME if dense else INT4_TOL_ROUNDED),
                     ("kernel", got, "exact f32", exact,
                      INT4_TOL_ROUNDED if dense else INT4_TOL_SAME),
                     ("plain", plain, "exact f32", exact, INT4_TOL_ROUNDED))
            ratios = []
            for name, a, label, other, tol in pairs:
                err = (a - other).abs().amax(-1)
                bound = other.abs().amax(-1)
                ratios.append(float((err / bound).max()))
                if not bool((err <= tol * bound).all()):
                    fail(f"int4p_matmul [{where}"
                         f"{' wide zero' if wide else ''}]: {name} disagrees "
                         f"with the {label} product: worst row err / "
                         f"max|row| {ratios[-1]:.3e} (tolerance {tol:.3e})")
            abs_err = float((got - plain).abs().max())
            worst_abs[body] = max(worst_abs[body], abs_err)
            print(f"check int4p_matmul [{where}"
                  f"{' wide zero' if wide else ''}]: max_abs_err "
                  f"against plain {abs_err:.3e}; worst row err "
                  f"/ max|row|: kernel vs plain {ratios[0]:.3e} (tolerance "
                  f"{pairs[0][4]:.3e}), kernel vs exact {ratios[1]:.3e} "
                  f"(tolerance {pairs[1][4]:.3e}), plain vs exact "
                  f"{ratios[2]:.3e} (tolerance {pairs[2][4]:.3e})",
                  flush=True)
        del q4p, scale, zero, w_exact
    return worst_abs


# A packed K/2 that is an odd multiple of 32: the prefill body's last stage
# holds 32 rows (and the W4A8 kernel takes such a K/2 too).
TAIL_SITE = {"k1088": (1088, 512)}


def with_tail_site(group):
    """INT4_SITES, and TAIL_SITE where `group` divides its K/2."""
    K = TAIL_SITE["k1088"][0]
    return {**INT4_SITES, **(TAIL_SITE if (K // 2) % group == 0 else {})}


def int4_work(T, K, N, group=INT4_GROUP):
    """(bytes, flops) of one call: x, the packed weights, f32 scale and
    zero and the f32 output once each; 2 * T * K * N FLOPs."""
    nbytes = (T * K * 2 + K * N // 2 + 2 * (K // group) * N * 4
              + T * N * 4)
    return nbytes, 2 * T * K * N


def plan_of(plan):
    """What a plan says of its grid: the decode body's token tile, token
    tiles, splits, blocks and stages, or the prefill body's token rows per
    block, splits, blocks and stages."""
    keys = ("t_tile", "t_tiles", "block_t", "splits", "blocks", "stages")
    return {k: plan[k] for k in keys if k in plan}


def int4_timings(device, iters, group=INT4_GROUP, sites=tuple(INT4_SITES)):
    """Times of the int4 kernel at every (site, T) of DECODE_TIME_T and
    INT4_TIME_T, at `group`, beside its plain version, the library call
    and the bound, with the plan launched;
    each timed launch takes the next layer of a stack that holds more
    bytes than the 50 MB L2. Returns a list of per-point dicts."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (decode_plan,
                                                      decode_route,
                                                      dequantize_int4,
                                                      int4p_body,
                                                      int4p_matmul,
                                                      int4p_matmul_ref,
                                                      kernel_plan,
                                                      unpack_int4_rows)

    points = []
    for i, site in enumerate(sites):
        K, N = INT4_SITES[site]
        layer_bytes = K * N // 2 + 2 * (K // group) * N * 4
        layers = -(-100_000_000 // layer_bytes) + 1
        q4p, scale, zero = make_int4_case(K, N, layers, device,
                                          SEED + 60 + i, group=group)
        dense = torch.stack([
            dequantize_int4(unpack_int4_rows(q4p[l]), scale[l], zero[l],
                            group).to(torch.bfloat16)
            for l in range(layers)])
        for T in (*DECODE_TIME_T, *INT4_TIME_T):
            x = make_x(T, K, device, SEED + 70 + T)
            state = {"layer": 0}

            def nxt():
                state["layer"] = (state["layer"] + 1) % layers
                return state["layer"]

            n = (DECODE_ITERS if T in DECODE_TIME_T else iters if T <= 64
                 else max(4, iters // 10))
            # Under 64 tokens both implementations of the group-wise body,
            # the mma.sync kernel and the decode body; `ms` is the one
            # decode_route picks.
            impl = {}
            for decode in ((False, True) if T < 64 else (None,)):
                impl[decode] = time_ms(
                    lambda: int4p_matmul(x, q4p, scale, zero, group,
                                         layer_idx=nxt(), decode=decode), n)
            routed = T < 64 and decode_route(T, K, N, group,
                                             "packed") == "decode"
            ms = impl[routed if T < 64 else None]
            plan = plan_of(decode_plan(T, K, N, group, "packed")
                           if T < 64 else int4p_matmul.last_plan)

            def plain():
                l = nxt()
                return int4p_matmul_ref(x, q4p[l], scale[l], zero[l], group)

            plain_ms = time_ms(plain, max(2, n // 20))
            library_ms = time_ms(lambda: torch.matmul(x, dense[nxt()]), n)
            nbytes, flops = int4_work(T, K, N, group)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS * 1e3
            body = ("dense_wgmma" if int4p_body(T) == "dense" else
                    "groupwise_decode" if routed else "groupwise")
            pt = dict(site=site, K=K, N=N, T=T, group=group, ms=ms,
                      body=body, plain_ms=plain_ms,
                      library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations",
                      plan=plan)
            if T < 64:
                pt.update(mma_ms=impl[False], decode_ms=impl[True],
                          mma_plan=dict(zip(("block_m", "splits"),
                                            kernel_plan(T, K, N))))
            points.append(pt)
            print(f"time int4p_matmul [{site} {K}x{N} T={T} group {group}, "
                  f"{layers} layers in turn, {body} body, plan {plan}"
                  + (f"; mma.sync {impl[False]:.4f} ms (plan "
                     f"{pt['mma_plan']}), decode body {impl[True]:.4f} ms"
                     if T < 64 else "") + "]: "
                  f"kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library (matmul on bf16 weights) "
                  f"{library_ms:.4f} ms, bound {pt['bound_ms']:.4f} ms "
                  f"({pt['bound_by']}: {nbytes} bytes, {flops} FLOPs)",
                  flush=True)
        del q4p, scale, zero, dense
        torch.cuda.empty_cache()
    return points


# ----------------------------------------------------------------------
# W4A8, the activation quantizer, int8 weight-only and FP8 W8A8
# ----------------------------------------------------------------------


def row_ratio(got, want):
    """The worst row's max|got - want| / max|want row|."""
    err = (got - want).abs().amax(-1)
    return float((err / want.abs().amax(-1).clamp_min(1e-30)).max())


def w4a8_checks(device, group=INT4_GROUP):
    """The W4A8 kernel against its plain version (INT4_TOL_SAME) and the
    exact W4A16 product (A8_BOUND of its largest value) at every site and
    T, on a layer-stacked container with a layer index (wide zeros at wo),
    at `group` (16: GGUF Q2_K / Q3_K), and at K 1088 where the group
    divides its K/2 of 544; returns the max abs error against the plain
    version."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (dequantize_int4,
                                                      int4p_matmul_w4a8,
                                                      int4p_matmul_w4a8_ref,
                                                      unpack_int4_rows)

    worst_abs = 0.0
    for i, (site, (K, N)) in enumerate(with_tail_site(group).items()):
        wide = site == "wo"
        q4p, scale, zero = make_int4_case(K, N, 2, device, SEED + 400 + i,
                                          wide_zero=wide, group=group)
        w_exact = dequantize_int4(unpack_int4_rows(q4p[1]), scale[1],
                                  zero[1], group)
        for T in INT4_CHECK_T:
            x = make_x(T, K, device, SEED + 50 + T)
            got = int4p_matmul_w4a8(x, q4p, scale, zero, group,
                                    layer_idx=1)
            torch.cuda.synchronize()
            where = (f"int4p_matmul_w4a8 [{site} T={T} group {group}"
                     f"{' wide zero' if wide else ''}]")
            if tuple(got.shape) != (T, N) or got.dtype != torch.float32:
                fail(f"{where}: output {got.shape} {got.dtype}")
            if not bool(got.isfinite().all()):
                fail(f"{where}: non-finite output")
            plain = int4p_matmul_w4a8_ref(x, q4p[1], scale[1], zero[1],
                                          group)
            ratio = row_ratio(got, plain)
            if ratio > INT4_TOL_SAME:
                fail(f"{where} disagrees with its plain version: worst row "
                     f"err / max|row| {ratio:.3e} (tolerance "
                     f"{INT4_TOL_SAME:.3e})")
            a16 = x.float() @ w_exact
            a8 = float((got - a16).abs().max() / a16.abs().max())
            if a8 >= A8_BOUND:
                fail(f"{where}: a8 error {a8:.3e} of max|W4A16| (bound "
                     f"{A8_BOUND})")
            abs_err = float((got - plain).abs().max())
            worst_abs = max(worst_abs, abs_err)
            print(f"check {where}: max_abs_err against plain {abs_err:.3e}, "
                  f"worst row err / max|row| {ratio:.3e} (tolerance "
                  f"{INT4_TOL_SAME:.3e}); against exact W4A16 max|diff| / "
                  f"max|W4A16| {a8:.3e} (bound {A8_BOUND})", flush=True)
        del q4p, scale, zero, w_exact
    return worst_abs


def make_act_rows(T, K, device, seed):
    """bf16 rows at scales e^-8 to e^6, with (T >= 3) an all-zero row
    (sx = 1e-8 / 127), a row with one large value, and a row of exact .5
    steps of its own sx = 1 (round half to even)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((T, K), generator=gen, device=device)
    x *= torch.exp(torch.rand((T, 1), generator=gen, device=device) * 14 - 8)
    if T >= 3:
        x[0] = 0.0
        x[1] *= 1e-3
        x[1, K // 2] = 300.0
        x[2] = (torch.arange(K, device=device) % 255 - 127).float() * 0.5
        x[2, 0] = 127.0
    return x.to(torch.bfloat16)


def quantizer_checks(device):
    """The activation quantizer, both formats, byte for byte against its
    plain version; returns the max abs difference of values and scales
    (0.0 when every byte is equal)."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (
        quantize_activations, quantize_activations_e4m3,
        quantize_activations_int8)

    plain = {"int8": quantize_activations_int8,
             "e4m3": quantize_activations_e4m3}
    worst = 0.0
    for fmt, fn in plain.items():
        for K in (4096, 14336):
            for T in ACT_CHECK_T:
                x = make_act_rows(T, K, device, SEED + 500 + T)
                got_q, got_s = quantize_activations(x, fmt)
                want_q, want_s = fn(x)
                torch.cuda.synchronize()
                same = (torch.equal(got_q.view(torch.uint8),
                                    want_q.view(torch.uint8))
                        and torch.equal(got_s, want_s))
                diff = max(float((got_q.float() - want_q.float()).abs().max()),
                           float((got_s - want_s).abs().max()))
                print(f"check quantize_activations [{fmt} T={T} K={K}]: "
                      f"{'bytes equal' if same else 'bytes differ'} to the "
                      f"plain version (max abs diff {diff:.3e})", flush=True)
                if not same:
                    fail(f"quantize_activations [{fmt} T={T} K={K}] is not "
                         "bit-equal to its plain version")
                worst = max(worst, diff)
    return worst


def int8_checks(device):
    """int8 per-channel containers (G = K, zero 0) through int4_matmul's
    kernel at every site and T (the group-wise body under 64 tokens, the
    prefill body's per-column form from there), against the plain version
    at INT4_TOL_SAME (exact products, f32 sums in another order). Returns
    the max abs error of each route."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (decode_route,
                                                      int4_route,
                                                      int8_matmul,
                                                      int8_matmul_ref)
    from aphrodite_tpu_torch.quantization import int8

    worst_abs = {}
    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        gen = torch.Generator(device=device).manual_seed(SEED + 600 + i)
        w = torch.randn((2, K, N), generator=gen, device=device) * K**-0.5
        c = int8.quantize_from_float(w)
        del w
        for T in INT4_CHECK_T:
            x = make_x(T, K, device, SEED + 50 + T)
            got = int8_matmul(x, c["q"], c["scale"], layer_idx=1)
            torch.cuda.synchronize()
            want = int8_matmul_ref(x, c["q"][1], c["scale"][1])
            ratio = row_ratio(got, want)
            route = int4_route(T, "groupwise", per_column=True)
            if route == "groupwise" and decode_route(
                    T, K, N, K, "groupwise") == "decode":
                route = "groupwise_decode"
            worst_abs[route] = max(worst_abs.get(route, 0.0),
                                   float((got - want).abs().max()))
            print(f"check int8_matmul ({route}, G = K) [{site} T={T}]"
                  f": worst row err / max|row| {ratio:.3e} (tolerance "
                  f"{INT4_TOL_SAME:.3e})", flush=True)
            if not got.isfinite().all() or ratio > INT4_TOL_SAME:
                fail(f"int8_matmul [{site} T={T}] disagrees with its plain "
                     "version")
        del c
    return worst_abs


def int8_timings(device, iters):
    """Times of the int8 per-channel product at every (site, T) of
    INT4_TIME_T (and DECODE_TIME_T at w13) beside its plain version, the library call (torch.matmul
    on the bf16 weight q * scale) and the bound (x bf16, one byte a
    weight, f32 scale and output once each; 2 * T * K * N bf16
    operations); each timed call takes the next layer of a stack larger
    than the 50 MB L2. Returns a list of per-point dicts."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (decode_plan,
                                                      decode_route,
                                                      int4_matmul,
                                                      int4_route,
                                                      int8_matmul,
                                                      int8_matmul_ref)
    from aphrodite_tpu_torch.quantization import int8

    points = []
    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        layers = -(-100_000_000 // (K * N)) + 1
        gen = torch.Generator(device=device).manual_seed(SEED + 650 + i)
        c = int8.quantize_from_float(torch.randn(
            (layers, K, N), generator=gen, device=device) * K**-0.5)
        dense = torch.stack([(c["q"][l].float() * c["scale"][l]).to(
            torch.bfloat16) for l in range(min(layers, 3))])
        for T in ((*DECODE_TIME_T, *INT4_TIME_T) if site == "w13"
                  else INT4_TIME_T):
            x = make_x(T, K, device, SEED + 70 + T)
            nxt = rotation(layers)
            n = (DECODE_ITERS if T in DECODE_TIME_T else iters if T <= 64
                 else max(4, iters // 10))
            ms = time_ms(lambda: int8_matmul(x, c["q"], c["scale"],
                                             layer_idx=nxt()), n)
            route = int4_route(T, "groupwise", per_column=True)
            impl = {}
            if T < 64:
                zero = torch.zeros((layers, 1, N), device=device)
                # Both implementations of the group-wise body at G = K.
                for decode in (False, True):
                    impl[decode] = time_ms(
                        lambda: int4_matmul(x, c["q"], c["scale"], zero, K,
                                            layer_idx=nxt(), body="groupwise",
                                            decode=decode), n)
                if decode_route(T, K, N, K, "groupwise") == "decode":
                    route = "groupwise_decode"
            plan = plan_of(decode_plan(T, K, N, K, "groupwise")
                           if T < 64 else int4_matmul.last_plan)

            def plain():
                l = nxt()
                return int8_matmul_ref(x, c["q"][l], c["scale"][l])

            plain_ms = time_ms(plain, max(2, n // 20))
            library_ms = time_ms(
                lambda: torch.matmul(x, dense[nxt() % len(dense)]), n)
            nbytes = T * K * 2 + K * N + N * 4 + T * N * 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * T * K * N / BF16_FLOPS * 1e3
            pt = dict(site=site, K=K, N=N, T=T, body=route,
                      ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                      bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations",
                      plan=plan)
            if impl:
                pt.update(mma_ms=impl[False], decode_ms=impl[True])
            points.append(pt)
            print(f"time int8_matmul [{site} {K}x{N} T={T}, {layers} layers "
                  f"in turn, {pt['body']}, plan {plan}]: kernel {ms:.4f} ms, "
                  "plain "
                  f"{plain_ms:.4f} ms, library (matmul on bf16 weights) "
                  f"{library_ms:.4f} ms, bound {pt['bound_ms']:.4f} ms "
                  f"({pt['bound_by']}: {nbytes} bytes, {2 * T * K * N} "
                  "FLOPs)", flush=True)
        del c, dense
        torch.cuda.empty_cache()
    return points


def fp8_checks(device):
    """The FP8 W8A8 product (the quantizer kernel and each body) at every
    site and T, on a layer-stacked container with a layer index, and at K
    4160 (65 stages of 64 rows), against its plain version at
    INT4_TOL_SAME: the body fp8_route picks at that T, then the other one
    named. Returns the max abs error against the plain version of each
    body."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (FP8_BODIES, fp8_route,
                                                      fp8_w8a8_matmul,
                                                      fp8_w8a8_matmul_ref)
    from aphrodite_tpu_torch.quantization import fp8

    worst_abs = dict.fromkeys(FP8_BODIES, 0.0)
    sites = {**INT4_SITES, "k4160": (4160, 512)}
    for i, (site, (K, N)) in enumerate(sites.items()):
        gen = torch.Generator(device=device).manual_seed(SEED + 650 + i)
        c = fp8.quantize_from_float(
            torch.randn((2, K, N), generator=gen, device=device) * K**-0.5)
        for T in INT4_CHECK_T:
            x = make_x(T, K, device, SEED + 50 + T)
            plain = fp8_w8a8_matmul_ref(x, c["q"][1], c["scale"][1])
            route = fp8_route(T)
            for body in (route, *(b for b in FP8_BODIES if b != route)):
                got = fp8_w8a8_matmul(x, c["q"], c["scale"], layer_idx=1,
                                      body=body)
                torch.cuda.synchronize()
                where = f"fp8_w8a8_matmul [{site} T={T} {body}]"
                if tuple(got.shape) != (T, N) or got.dtype != torch.float32:
                    fail(f"{where}: output {got.shape} {got.dtype}")
                if not bool(got.isfinite().all()):
                    fail(f"{where}: non-finite output")
                ratio = row_ratio(got, plain)
                abs_err = float((got - plain).abs().max())
                worst_abs[body] = max(worst_abs[body], abs_err)
                print(f"check {where}: max_abs_err against plain "
                      f"{abs_err:.3e}, worst row err / max|row| {ratio:.3e} "
                      f"(tolerance {INT4_TOL_SAME:.3e})", flush=True)
                if ratio > INT4_TOL_SAME:
                    fail(f"{where} disagrees with its plain version")
        del c
        torch.cuda.empty_cache()
    return worst_abs


def rotation(layers):
    """A function that returns the next layer index, round robin."""
    state = {"layer": 0}

    def nxt():
        state["layer"] = (state["layer"] + 1) % layers
        return state["layer"]

    return nxt


def w4a8_timings(device, iters, group=INT4_GROUP, sites=tuple(INT4_SITES)):
    """Times of the W4A8 wrapper (quantizer + kernel) at every (site, T)
    of INT4_TIME_T (at `group`, on `sites`) beside its plain version, torch._int_mm on the unpacked
    int8 levels (the int8 product without the group fix-ups, which the
    port never calls), torch.matmul on bf16 weights and the bound (bytes
    over 3.35 TB/s, operations over 1979 TOPS int8); each timed launch
    takes the next layer of a stack larger than the 50 MB L2."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (
        dequantize_int4, int4p_matmul_w4a8, int4p_matmul_w4a8_ref,
        quantize_activations_int8, unpack_int4_rows)

    points = []
    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        if site not in sites:
            continue
        layer_bytes = K * N // 2 + 2 * (K // group) * N * 4
        layers = -(-100_000_000 // layer_bytes) + 1
        q4p, scale, zero = make_int4_case(K, N, layers, device,
                                          SEED + 60 + i, group=group)
        q8 = torch.stack([unpack_int4_rows(q4p[l]) for l in range(layers)])
        dense = torch.stack([
            dequantize_int4(q8[l], scale[l], zero[l],
                            group).to(torch.bfloat16)
            for l in range(layers)])
        for T in INT4_TIME_T:
            x = make_x(T, K, device, SEED + 70 + T)
            xq, _ = quantize_activations_int8(x)
            nxt = rotation(layers)
            n = iters if T <= 64 else max(4, iters // 10)
            ms = time_ms(lambda: int4p_matmul_w4a8(
                x, q4p, scale, zero, group, layer_idx=nxt()), n)

            def plain():
                l = nxt()
                return int4p_matmul_w4a8_ref(x, q4p[l], scale[l], zero[l],
                                             group)

            plain_ms = time_ms(plain, max(2, n // 20))
            library_ms = time_ms(lambda: torch._int_mm(xq, q8[nxt()]), n)
            bf16_ms = time_ms(lambda: torch.matmul(x, dense[nxt()]), n)
            nbytes, ops = int4_work(T, K, N, group)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / INT8_OPS * 1e3
            pt = dict(site=site, K=K, N=N, T=T, group=group, ms=ms,
                      plain_ms=plain_ms,
                      library_ms=library_ms, bf16_library_ms=bf16_ms,
                      bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations")
            points.append(pt)
            print(f"time int4p_matmul_w4a8 [{site} {K}x{N} T={T} group "
                  f"{group}, {layers} layers in turn]: quantizer + kernel "
                  f"{ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library (torch._int_mm on int8 levels, "
                  f"no group fix-ups) {library_ms:.4f} ms, bf16 library "
                  f"(matmul on bf16 weights) {bf16_ms:.4f} ms, bound "
                  f"{pt['bound_ms']:.4f} ms ({pt['bound_by']}: {nbytes} "
                  f"bytes, {ops} int8 operations)", flush=True)
        del q4p, scale, zero, q8, dense
        torch.cuda.empty_cache()
    return points


def quantizer_timings(device, iters):
    """Times of the activation quantizer, both formats, at ACT_TIME beside
    its plain version and its byte bound (2 bytes read and 1 written per
    value); no one PyTorch call computes it (library_ms null)."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (
        quantize_activations, quantize_activations_e4m3,
        quantize_activations_int8)

    plain = {"int8": quantize_activations_int8,
             "e4m3": quantize_activations_e4m3}
    points = []
    for T, K in ACT_TIME:
        x = make_act_rows(T, K, device, SEED + 700 + T)
        for fmt, fn in plain.items():
            ms = time_ms(lambda: quantize_activations(x, fmt), iters)
            plain_ms = time_ms(lambda: fn(x), max(2, iters // 10))
            nbytes = T * K * 3 + T * 4
            pt = dict(format=fmt, T=T, K=K, ms=ms, plain_ms=plain_ms,
                      library_ms=None,
                      bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                      bound_by="bytes")
            points.append(pt)
            print(f"time quantize_activations [{fmt} T={T} K={K}]: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{pt['bound_ms']:.4f} ms (bytes: {nbytes})", flush=True)
    return points


def fp8_timings(device, iters):
    """Times of the FP8 W8A8 product's two bodies (the wrapper with body=:
    quantizer kernel and body, the scalings included) at every (site, T)
    of FP8_TIME_T beside its plain version, the library call
    (one torch._scaled_mm on the same e4m3 operands, the weight copied
    column-major as it asks, with an f32 result; the port never calls it)
    and the bound (bytes: x bf16, 1 byte a weight, f32 scale and output;
    operations over 1979 TFLOP/s fp8); each timed call takes the next
    layer of a stack larger than the 50 MB L2. Returns a list of per-point
    dicts."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (
        FP8_BODIES, fp8_w8a8_matmul, fp8_w8a8_matmul_ref,
        quantize_activations_e4m3)
    from aphrodite_tpu_torch.quantization import fp8

    points = []
    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        layers = -(-100_000_000 // (K * N)) + 1
        gen = torch.Generator(device=device).manual_seed(SEED + 800 + i)
        c = fp8.quantize_from_float(torch.randn(
            (layers, K, N), generator=gen, device=device) * K**-0.5)
        col_major = c["q"].mT.contiguous().mT
        one = torch.ones((), device=device)
        for T in FP8_TIME_T:
            x = make_x(T, K, device, SEED + 70 + T)
            xq, _ = quantize_activations_e4m3(x)
            nxt = rotation(layers)
            n = iters if T <= 64 else max(4, iters // 10)
            library_ms = time_ms(lambda: torch._scaled_mm(
                xq, col_major[nxt()], scale_a=one, scale_b=one,
                out_dtype=torch.float32), n)

            def plain():
                l = nxt()
                return fp8_w8a8_matmul_ref(x, c["q"][l], c["scale"][l])

            plain_ms = time_ms(plain, max(2, n // 20))
            nbytes = T * K * 2 + K * N + N * 4 + T * N * 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * T * K * N / INT8_OPS * 1e3
            for body in FP8_BODIES:
                ms = time_ms(lambda: fp8_w8a8_matmul(
                    x, c["q"], c["scale"], layer_idx=nxt(), body=body), n)
                pt = dict(body=body, site=site, K=K, N=N, T=T, ms=ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations")
                points.append(pt)
                print(f"time fp8_w8a8_matmul [{body} {site} {K}x{N} T={T}, "
                      f"{layers} layers in turn]: quantizer + body + scaling "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                      f"(_scaled_mm alone) {library_ms:.4f} ms, bound "
                      f"{pt['bound_ms']:.4f} ms ({pt['bound_by']}: {nbytes} "
                      f"bytes, {2 * T * K * N} fp8 operations)", flush=True)
        del c, col_major
        torch.cuda.empty_cache()
    return points


# ----------------------------------------------------------------------
# unpacked int4 matmul (one level per byte)
# ----------------------------------------------------------------------


def make_q4_case(K, N, layers, device, seed, kind, tiny_scale=False):
    """A layer-stacked unpacked container [layers, K, N] of one of
    Q4_CONTAINERS, made on the device from a seed: levels uniform in their
    range, scale in 0.001..0.021 (of either sign where the format's are
    signed), zero an integer in its range. With tiny_scale every seventh
    group row has scale 2^-20 and zero = offset * 2^20, offset in 0..0.5."""
    import torch

    spec = Q4_CONTAINERS[kind]
    gen = torch.Generator(device=device).manual_seed(seed)
    groups = K // spec["group"]
    q4 = torch.randint(*spec["levels"], (layers, K, N), generator=gen,
                       device=device, dtype=torch.int8)
    scale = torch.rand((layers, groups, N), generator=gen,
                       device=device) * 0.02 + 0.001
    if spec["signed"]:
        scale *= torch.randint(0, 2, scale.shape, generator=gen,
                               device=device).float() * 2 - 1
    zero = torch.randint(*spec["zero"], (layers, groups, N), generator=gen,
                         device=device).float()
    if tiny_scale:
        offset = torch.rand((layers, -(-groups // 7), N), generator=gen,
                            device=device) * 0.5
        scale[:, ::7] = 2.0**-20
        zero[:, ::7] = offset * 2.0**20
    return q4, scale, zero


def q4_checks(device):
    """Both bodies of the unpacked kernel, for every container, site and
    T (under 64 tokens on both implementations, the mma.sync kernel and
    the decode body), against the plain version and the exact f32
    product; returns the max abs error against the plain version per
    route."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (dequantize_int4,
                                                      int4_matmul,
                                                      int4_matmul_ref,
                                                      int4_route)

    worst_abs = {"groupwise": 0.0, "dense": 0.0, "groupwise_decode": 0.0,
                 "dense_decode": 0.0, "dense_wgmma": 0.0}
    for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
        for c, (kind, spec) in enumerate(Q4_CONTAINERS.items()):
            tiny = kind == "q6_k" and site == "wo"
            group = spec["group"]
            q4, scale, zero = make_q4_case(K, N, 2, device,
                                           SEED + 100 + 10 * i + c, kind,
                                           tiny_scale=tiny)
            w_exact = dequantize_int4(q4[1], scale[1], zero[1], group)
            label = f"{kind} g{group}{' with 2^-20 scale groups' if tiny else ''}"
            for T in INT4_CHECK_T:
                x = make_x(T, K, device, SEED + 50 + T)
                plain = int4_matmul_ref(x, q4[1], scale[1], zero[1], group)
                exact = x.float() @ w_exact
                line = []
                for body, decode in (
                        (b, d) for b in spec["bodies"]
                        for d in ((False, True) if T < 64 else (None,))):
                    got = int4_matmul(x, q4, scale, zero, group, layer_idx=1,
                                      body=body, decode=decode)
                    torch.cuda.synchronize()
                    route = int4_route(T, body) + ("_decode" if decode else "")
                    where = f"int4_matmul {route} [{site} T={T} {label}]"
                    if (tuple(got.shape) != (T, N)
                            or got.dtype != torch.float32):
                        fail(f"{where}: output {got.shape} {got.dtype}")
                    if not bool(got.isfinite().all()):
                        fail(f"{where}: non-finite output")
                    for name, other in (("plain", plain), ("exact", exact)):
                        tol = Q4_TOLS[body][name]
                        err = (got - other).abs().amax(-1)
                        bound = other.abs().amax(-1)
                        ratio = float((err / bound).max())
                        line.append(f"{route} vs {name} {ratio:.3e} "
                                    f"(tolerance {tol:.3e})")
                        if not bool((err <= tol * bound).all()):
                            fail(f"{where} disagrees with the {name} "
                                 f"product: worst row err / max|row| "
                                 f"{ratio:.3e} (tolerance {tol:.3e})")
                    worst_abs[route] = max(worst_abs[route],
                                           float((got - plain).abs().max()))
                err = (plain - exact).abs().amax(-1)
                bound = exact.abs().amax(-1)
                if not bool((err <= INT4_TOL_ROUNDED * bound).all()):
                    fail(f"int4_matmul_ref [{site} T={T} {label}] disagrees "
                         "with the exact f32 product")
                print(f"check int4_matmul [{site} {K}x{N} T={T} {label}]: "
                      "worst row err / max|row|: " + ", ".join(line),
                      flush=True)
            del q4, scale, zero, w_exact
            torch.cuda.empty_cache()
    return worst_abs


def q4_work(T, K, N, group):
    """(bytes, flops) of one call: x, one byte per level, f32 scale and
    zero and the f32 output once each; 2 * T * K * N FLOPs."""
    nbytes = T * K * 2 + K * N + 2 * (K // group) * N * 4 + T * N * 4
    return nbytes, 2 * T * K * N


def q4_timings(device, iters):
    """Times of both bodies at every (container, site, T) of Q4_TIMED and
    INT4_TIME_T (and DECODE_TIME_T at w13) beside the plain version, the library call (torch.matmul
    on the pre-dequantized bf16 weight) and the bound; each timed launch
    takes the next layer of a stack that holds more bytes than the 50 MB
    L2. Returns a list of per-point dicts, one per body."""
    import torch

    from aphrodite_tpu_torch.ops.quant_matmul import (decode_plan,
                                                      decode_route,
                                                      dequantize_int4,
                                                      int4_matmul,
                                                      int4_matmul_ref,
                                                      int4_route)

    points = []
    for c, kind in enumerate(Q4_TIMED):
        group = Q4_CONTAINERS[kind]["group"]
        for i, (site, (K, N)) in enumerate(INT4_SITES.items()):
            layer_bytes = K * N + 2 * (K // group) * N * 4
            layers = -(-100_000_000 // layer_bytes) + 1
            q4, scale, zero = make_q4_case(K, N, layers, device,
                                           SEED + 200 + 10 * i + c, kind)
            dense = torch.stack([
                dequantize_int4(q4[l], scale[l], zero[l], group).to(
                    torch.bfloat16) for l in range(layers)])
            for T in ((*DECODE_TIME_T, *INT4_TIME_T) if site == "w13"
                      else INT4_TIME_T):
                x = make_x(T, K, device, SEED + 70 + T)
                state = {"layer": 0}

                def nxt():
                    state["layer"] = (state["layer"] + 1) % layers
                    return state["layer"]

                n = (DECODE_ITERS if T in DECODE_TIME_T else iters
                     if T <= 64 else max(4, iters // 10))
                ms, plans, impl = {}, {}, {}
                for body in ("groupwise", "dense"):
                    ms[body] = time_ms(
                        lambda: int4_matmul(x, q4, scale, zero, group,
                                            layer_idx=nxt(), body=body), n)
                    plans[body] = plan_of(
                        decode_plan(T, K, N, group, body) if T < 64
                        else int4_matmul.last_plan)
                    if T < 64:
                        # Both implementations under 64 tokens.
                        impl[body] = {d: time_ms(
                            lambda: int4_matmul(x, q4, scale, zero, group,
                                                layer_idx=nxt(), body=body,
                                                decode=d), n)
                            for d in (False, True)}

                def plain():
                    l = nxt()
                    return int4_matmul_ref(x, q4[l], scale[l], zero[l], group)

                plain_ms = time_ms(plain, max(2, n // 20))
                library_ms = time_ms(lambda: torch.matmul(x, dense[nxt()]), n)
                nbytes, flops = q4_work(T, K, N, group)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / BF16_FLOPS * 1e3
                routed = int4_route(T)
                for body in ("groupwise", "dense"):
                    route = int4_route(T, body)
                    if T < 64 and decode_route(T, K, N, group,
                                               body) == "decode":
                        route += "_decode"
                    points.append(dict(
                        body=route, container=kind,
                        group=group, site=site,
                        K=K, N=N, T=T, ms=ms[body], plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                        bound_by=("bytes" if t_bytes >= t_ops
                                  else "operations"),
                        routed=int4_route(T, body) == routed,
                        plan=plans[body]))
                    if T < 64:
                        points[-1].update(mma_ms=impl[body][False],
                                          decode_ms=impl[body][True])
                print(f"time int4_matmul [{kind} g{group} {site} {K}x{N} "
                      f"T={T}, {layers} layers in turn]: group-wise "
                      f"{ms['groupwise']:.4f} ms (plan {plans['groupwise']}), "
                      f"{int4_route(T, 'dense')} {ms['dense']:.4f} ms (plan "
                      f"{plans['dense']}) "
                      f"(the wrapper takes {routed}), plain {plain_ms:.4f} "
                      f"ms, library (matmul on bf16 weights) "
                      f"{library_ms:.4f} ms, bound "
                      f"{points[-1]['bound_ms']:.4f} ms "
                      f"({points[-1]['bound_by']}: {nbytes} bytes, {flops} "
                      "FLOPs)", flush=True)
            del q4, scale, zero, dense
            torch.cuda.empty_cache()
    return points


# ----------------------------------------------------------------------
# A GGUF file from a seed
# ----------------------------------------------------------------------


def _gguf_blocks(rng, rows, row_len, quant):
    """Raw blocks uint8 [rows * row_len / block, block bytes] of a tensor
    whose dequantized values have std near row_len ** -0.5 (as the dummy
    weights): every level byte random, the scales chosen for that std."""
    std = row_len**-0.5
    if quant == "q6_k":
        # 210 bytes per 256 values: ql[128], qh[64] (any bytes: levels
        # uniform in 0..63, so q - 32 has std 18.47), 16 int8 sub-scales
        # (here +-(4..11), rms 7.84), d f16.
        n = rows * row_len // 256
        blk = rng.integers(0, 256, size=(n, 210), dtype=np.uint8)
        b = blk[:, 192:208]
        mag = (4 + (b & 7)).astype(np.int8)
        blk[:, 192:208] = np.where(b & 0x80, -mag, mag).view(np.uint8)
        d = std / (18.47 * 7.84) * (0.75 + 0.5 * rng.random(n))
        blk[:, 208:210] = d.astype(np.float16).view(np.uint8).reshape(n, 2)
        return blk
    if quant == "q8_0":
        # 34 bytes per 32 values: d f16, 32 int8 (uniform: std 73.9).
        n = rows * row_len // 32
        blk = rng.integers(0, 256, size=(n, 34), dtype=np.uint8)
        d = std / 73.9 * (0.75 + 0.5 * rng.random(n))
        blk[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(n, 2)
        return blk
    if quant == "q2_k":
        # 84 bytes per 256 values: 16 bytes of 4-bit scale | 4-bit min (a
        # scale of 1..15 here), qs[64] (2-bit levels, std 1.118), d and
        # dmin f16. w = d * sc * q - dmin * m: with dmin = d, the scales
        # (rms 9.5) and the group offsets d * (1.5 sc - m) give rms ~12.5 d.
        n = rows * row_len // 256
        blk = rng.integers(0, 256, size=(n, 84), dtype=np.uint8)
        sc = blk[:, 0:16]
        blk[:, 0:16] = (sc & 0xF0) | np.maximum(sc & 0x0F, 1)
        d = (std / 12.5 * (0.75 + 0.5 * rng.random(n))).astype(np.float16)
        blk[:, 80:82] = d.view(np.uint8).reshape(n, 2)
        blk[:, 82:84] = d.view(np.uint8).reshape(n, 2)
        return blk
    if quant == "q3_k":
        # 110 bytes per 256 values: hmask[32] and qs[64] (3-bit levels,
        # zero 4, std 2.29), 12 bytes of 6-bit scales (sc - 32: rms 18.5),
        # d f16.
        n = rows * row_len // 256
        blk = rng.integers(0, 256, size=(n, 110), dtype=np.uint8)
        d = std / (2.29 * 18.5) * (0.75 + 0.5 * rng.random(n))
        blk[:, 108:110] = d.astype(np.float16).view(np.uint8).reshape(n, 2)
        return blk
    raise ValueError(quant)


def write_gguf_llama(path, config, quant, seed):
    """Write a GGUF v3 file of a Llama of `config`'s geometry from a seed
    with numpy, whole tensors at a time: the seven projections of every
    layer as `quant` blocks ("q6_k", "q8_0", or "q2_k": Q2_K with a Q3_K
    down projection, as llama.cpp's Q2_K files mix them), norms as F32
    ones, and
    token_embd and output as F16 (uniform values of std hidden ** -0.5 and
    vocab ** -0.5 by table lookup: the loader widens both to the model
    dtype whatever their type, and F16 costs it one cast where a Q6_K
    tensor of that size costs a block decode). Returns the file's bytes."""
    import struct

    H, F = config["hidden_size"], config["intermediate_size"]
    V, L = config["vocab_size"], config["num_hidden_layers"]
    D = config["head_dim"]
    NH, NKV = config["num_attention_heads"], config["num_key_value_heads"]
    qtype = GGUF_BLOCKS[quant][0]
    down_type = GGUF_BLOCKS["q3_k" if quant == "q2_k" else quant][0]
    block_of = {t: (per, nb) for t, per, nb in GGUF_BLOCKS.values()}
    quant_of = {t: q for q, (t, _, _) in GGUF_BLOCKS.items()}
    # (name, [row length, rows], type)
    tensors = [("token_embd.weight", [H, V], GGML_F16),
               ("output_norm.weight", [H], GGML_F32),
               ("output.weight", [H, V], GGML_F16)]
    for i in range(L):
        b = f"blk.{i}."
        tensors += [(b + "attn_norm.weight", [H], GGML_F32),
                    (b + "attn_q.weight", [H, NH * D], qtype),
                    (b + "attn_k.weight", [H, NKV * D], qtype),
                    (b + "attn_v.weight", [H, NKV * D], qtype),
                    (b + "attn_output.weight", [NH * D, H], qtype),
                    (b + "ffn_norm.weight", [H], GGML_F32),
                    (b + "ffn_gate.weight", [H, F], qtype),
                    (b + "ffn_up.weight", [H, F], qtype),
                    (b + "ffn_down.weight", [F, H], down_type)]

    def nbytes(dims, gtype):
        n = int(np.prod(dims))
        if gtype in (GGML_F32, GGML_F16):
            return (4 if gtype == GGML_F32 else 2) * n
        per, bbytes = block_of[gtype]
        return n // per * bbytes

    def w_str(out, text):
        raw = text.encode()
        out += struct.pack("<Q", len(raw)) + raw

    meta = {"general.alignment": 32, "general.architecture": "llama",
            "llama.embedding_length": H, "llama.block_count": L,
            "llama.attention.head_count": NH,
            "llama.attention.head_count_kv": NKV,
            "llama.feed_forward_length": F,
            "llama.context_length": config["max_position_embeddings"],
            "llama.attention.layer_norm_rms_epsilon":
                float(config["rms_norm_eps"]),
            "llama.rope.freq_base": float(config["rope_theta"]),
            "llama.attention.key_length": D}
    head = bytearray(struct.pack("<IIQQ", 0x46554747, 3, len(tensors),
                                 len(meta)))
    for key, value in meta.items():
        w_str(head, key)
        if isinstance(value, str):
            head += struct.pack("<I", 8)
            w_str(head, value)
        elif isinstance(value, float):
            head += struct.pack("<If", 6, value)
        else:
            head += struct.pack("<II", 4, value)
    offset = 0
    for name, dims, gtype in tensors:
        w_str(head, name)
        head += struct.pack(f"<I{len(dims)}QIQ", len(dims), *dims, gtype,
                            offset)
        offset += -(-nbytes(dims, gtype) // 32) * 32
    head += b"\x00" * (-len(head) % 32)
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        f.write(head)
        for name, dims, gtype in tensors:
            if gtype == GGML_F32:
                data = np.ones(dims, "<f4")
            elif gtype == GGML_F16:
                std = (H if name == "token_embd.weight" else V)**-0.5
                table = ((np.arange(256) - 127.5) / 73.9 * std).astype("<f2")
                data = table[rng.integers(0, 256, size=dims[0] * dims[1],
                                          dtype=np.uint8)]
            else:
                data = _gguf_blocks(rng, dims[1], dims[0], quant_of[gtype])
            raw = data.tobytes()
            f.write(raw)
            f.write(b"\x00" * (-len(raw) % 32))
    return len(head) + offset



def write_model_dir(path: str, config: dict) -> str:
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return path


# kv_cache_dtype -> the page type its attention launches must be of.
CACHE_PAGE_TYPES = {"auto": "bf16", "fp8_e4m3": "e4m3", "fp8_e5m2": "e5m2",
                    "int8": "int8"}


# ----------------------------------------------------------------------
# The sampler (aphrodite_tpu_torch/sampling/sampler.py): plain PyTorch on
# the card, no kernel of its own
# ----------------------------------------------------------------------

SAMPLER_V = 128256  # Llama-3.1-8B's vocabulary
SAMPLER_S = 32
SAMPLER_HISTORY = 2048
# Each distribution stage alone: the rows' settings (cycled over the
# rows, every fourth row with the stage off).
SAMPLER_STAGES = {
    "temperature": [dict(temperature=0.7), dict(temperature=0.05),
                    dict(dynatemp_min=0.5, dynatemp_max=1.5)],
    "top_k_top_p": [dict(top_k=50, top_p=0.9), dict(top_p=0.5),
                    dict(top_k=1000)],
    "min_p": [dict(min_p=0.05), dict(min_p=0.3)],
    "top_a": [dict(top_a=0.2), dict(top_a=0.9)],
    "tfs": [dict(tfs=0.95), dict(tfs=0.5)],
    "eta_cutoff": [dict(eta_cutoff=3.0), dict(eta_cutoff=15.0)],
    "epsilon_cutoff": [dict(epsilon_cutoff=0.5), dict(epsilon_cutoff=3.0)],
    "typical_p": [dict(typical_p=0.9), dict(typical_p=0.5)],
    "quadratic": [dict(smoothing_factor=0.3),
                  dict(smoothing_factor=0.5, smoothing_curve=2.0)],
    "xtc": [dict(xtc_probability=0.5, xtc_threshold=2e-4),
            dict(xtc_probability=1.0, xtc_threshold=1e-3)],
    "top_nsigma": [dict(nsigma=1.0), dict(nsigma=2.5)],
    "skew": [dict(skew=0.5), dict(skew=-0.7)],
}
# Every history-free stage in one row.
SAMPLER_ALL_FREE = dict(
    temperature=0.9, dynatemp_min=0.6, dynatemp_max=1.4, top_k=2000,
    top_p=0.95, min_p=0.005, top_a=0.05, tfs=0.98, eta_cutoff=1.0,
    epsilon_cutoff=0.2, typical_p=0.98, smoothing_factor=0.1,
    xtc_probability=0.5, xtc_threshold=1e-3, nsigma=3.0, skew=0.3)
SAMPLER_HISTORY_ROWS = [
    dict(temperature=0.0, repetition_penalty=1.3),
    dict(temperature=0.0, frequency_penalty=0.6, presence_penalty=0.5),
    dict(temperature=0.0, dry_multiplier=0.8, dry_allowed_length=2,
         dry_sequence_breaker_ids=[5, 9]),
    dict(temperature=0.0, dry_multiplier=0.5, dry_allowed_length=1,
         dry_range=512),
    dict(temperature=0.0, no_repeat_ngram_size=3),
    dict(temperature=0.0, no_repeat_ngram_size=2),
    dict(SAMPLER_ALL_FREE, repetition_penalty=1.1, dry_multiplier=0.3),
    dict(temperature=0.0)]


def sampler_rows(mixes, S, seed, history=None, prompt_len=None, **common):
    """S SamplerInputRows cycling over `mixes` (sampling kwargs; a
    stochastic row's temperature 1 unless a mix sets it), every fourth row
    plain, seeds from `seed`; token histories from `history` [S, H]."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.sampling.metadata import SamplerInputRow

    rows = []
    for i in range(S):
        kw = dict(temperature=1.0, max_tokens=64)
        if i % 4 != 3:
            kw.update(mixes[i % len(mixes)])
        kw.update(common)
        ids = [1, 2, 3] if history is None else history[i].tolist()
        plen = len(ids) if prompt_len is None else prompt_len
        rows.append(SamplerInputRow(
            params=SamplingParams(**kw), token_ids=ids, prompt_len=plen,
            generated_len=len(ids) - plen, seed=seed + i,
            eos_token_id=SAMPLER_V - 1))
    return rows


def sampler_logits(S, V, seed):
    """f32 logits [S, V] whose values are distinct in each row: twice the
    normal's quantiles at (k + 0.5) / V, in an order drawn from the seed
    for each row."""
    import math

    import torch

    gen = torch.Generator().manual_seed(seed)
    p = (torch.arange(V, dtype=torch.float64) + 0.5) / V
    q = (torch.erfinv(2 * p - 1) * math.sqrt(2) * 2).float()
    if not bool((q[1:] > q[:-1]).all()):
        fail("the sampler's logits are not distinct")
    return torch.stack([q[torch.randperm(V, generator=gen)]
                        for _ in range(S)])


def sampler_checks(device="cuda"):
    """The sampler on the card against the same functions on the CPU, on
    logits [32, 128256] with distinct values: each distribution stage
    alone, the whole pipeline with every history-free stage on (and a
    sampler_priority), the history stages on token histories of 2048 ids,
    min_tokens with bans, and a random packed guided mask; then the tokens
    sample() draws for stochastic rows. The kept sets (finite entries)
    must be equal and the values within 1e-5 of each row's largest
    magnitude; the drawn tokens equal. Returns the worst error over a
    row's largest magnitude of each check."""
    import torch

    import aphrodite_tpu_torch.sampling.sampler as sampler_mod
    from aphrodite_tpu_torch.common.sampling_params import SamplerID
    from aphrodite_tpu_torch.sampling.metadata import build_sampling_tensors

    S, V = SAMPLER_S, SAMPLER_V
    logits = sampler_logits(S, V, SEED)
    on = {"cpu": torch.device("cpu"), "card": torch.device(device)}
    errs, failed = {}, []

    def tensors(rows, history_pad=0):
        t, flags, hist, hl = build_sampling_tensors(rows, S, V,
                                                    history_pad=history_pad)
        out = {}
        for name, dev in on.items():
            h = None
            if hist is not None:
                h = [torch.from_numpy(a).to(dev) for a in (hist, *hl)]
            out[name] = (sampler_mod.tensors_to_device(t, dev), h)
        return out, flags

    def check(name, fn, probs=False):
        """fn(device name) -> [S, V] on that device; the card's against
        the CPU's."""
        t0 = time.monotonic()
        got = fn("card").cpu().double()
        want = fn("cpu").double()
        if probs:
            got, want = got.clamp(min=0), want.clamp(min=0)
        kept = torch.isfinite(want)
        if not torch.equal(torch.isfinite(got), kept):
            diff = torch.isfinite(got) != kept
            print(f"sampler {name}: {int(diff.sum())} tokens kept on one "
                  f"side only, on rows {diff.any(-1).nonzero()[:, 0].tolist()}"
                  f"; card {got[diff][:4].tolist()}, CPU "
                  f"{want[diff][:4].tolist()}", flush=True)
            failed.append(f"{name}: the card keeps another set of tokens "
                          "than the CPU")
            kept &= torch.isfinite(got)
        scale = torch.where(kept, want, 0).abs().amax(-1, keepdim=True)
        err = torch.where(kept, got - want, 0).abs()
        ratio = float((err / scale.clamp(min=1e-30)).max())
        errs[name] = ratio
        print(f"sampler {name}: kept {int(kept.sum())} of {S * V} entries "
              f"on both, worst err / max|row| {ratio:.3e} (tolerance "
              f"1e-5; {time.monotonic() - t0:.1f} s)", flush=True)
        if ratio > 1e-5:
            failed.append(f"{name}: the card's values disagree with the "
                          "CPU's")

    stage_fns = {
        "temperature": sampler_mod._apply_temperatures,
        "top_k_top_p": sampler_mod._apply_top_k_top_p,
        "min_p": sampler_mod._apply_min_p,
        "top_a": sampler_mod._apply_top_a,
        "tfs": sampler_mod._apply_tfs,
        "eta_cutoff": sampler_mod._apply_eta_cutoff,
        "epsilon_cutoff": sampler_mod._apply_epsilon_cutoff,
        "typical_p": sampler_mod._apply_typical,
        "quadratic": sampler_mod._apply_quadratic,
        "xtc": sampler_mod._apply_xtc,
        "top_nsigma": sampler_mod._apply_top_nsigma}
    for name, mixes in SAMPLER_STAGES.items():
        ts, _ = tensors(sampler_rows(mixes, S, 1000))
        if name == "skew":
            check("skew", lambda d: sampler_mod._apply_skew(
                torch.softmax(logits.to(on[d]).double(), -1), ts[d][0]),
                probs=True)
            continue
        fn = stage_fns[name]
        check(name, lambda d: fn(logits.to(on[d]).double(), ts[d][0]))

    def pipeline(name, rows, history_pad=0, guided=None):
        ts, flags = tensors(rows, history_pad)
        if guided is not None:
            flags = flags._replace(do_guided=True)

        def run(d):
            hist = ts[d][1] or [None] * 3
            mask = None if guided is None else guided.to(on[d])
            return sampler_mod.shaped_logprobs(
                logits.to(on[d]), ts[d][0], flags, *hist, guided_mask=mask)
        check(name, run)
        return ts, flags

    free = [SAMPLER_ALL_FREE] + [
        dict(mix[0], temperature=1.1) for mix in SAMPLER_STAGES.values()]
    ts, flags = pipeline("pipeline, every history-free stage", sampler_rows(
        free, S, 2000, sampler_priority=None))
    prio = [dict(SAMPLER_ALL_FREE, sampler_priority=[
        SamplerID.MIN_P, SamplerID.XTC, SamplerID.TEMPERATURE,
        SamplerID.TOP_P_TOP_K, SamplerID.TFS, SamplerID.TYPICAL_P])] + free
    pipeline("pipeline, a sampler_priority", sampler_rows(prio, S, 3000))
    # Tokens drawn on both devices from the rows' keys.
    drawn = {d: sampler_mod.sample(logits.to(on[d]), ts[d][0],
                                   flags).sampled.cpu() for d in on}
    if not torch.equal(drawn["card"], drawn["cpu"]):
        failed.append("the card draws other tokens than the CPU from the "
                      f"same keys: {(drawn['card'] != drawn['cpu']).sum()} "
                      f"of {S}")
    print(f"sampler draws: the card's {S} tokens equal the CPU's "
          f"({drawn['card'][:6].tolist()}...)", flush=True)

    # Histories of 2048 ids: repeated motifs of a small alphabet, with
    # random ids between them, 1000 prompt tokens.
    rng = np.random.default_rng(SEED + 5)
    motifs = rng.integers(0, 40, (8, 6))
    history = np.empty((S, SAMPLER_HISTORY), np.int64)
    for i in range(S):
        parts = []
        while sum(len(p) for p in parts) < SAMPLER_HISTORY:
            parts.append(motifs[rng.integers(0, 8)] if rng.random() < 0.7
                         else rng.integers(0, V, 3))
        history[i] = np.concatenate(parts)[:SAMPLER_HISTORY]
    rows = sampler_rows(SAMPLER_HISTORY_ROWS, S, 4000, history=history,
                        prompt_len=1000)
    ts, flags = tensors(rows, SAMPLER_HISTORY)
    for name, fn in (
            ("penalties", lambda lg, t, h: sampler_mod._apply_penalties(
                lg, t, *sampler_mod._history_masks(*h, V))),
            ("dry", lambda lg, t, h: sampler_mod._apply_dry(
                lg, t, h[0], h[1], V)),
            ("no_repeat_ngram", lambda lg, t, h: sampler_mod
             ._apply_no_repeat_ngram(lg, t, h[0], h[1], V))):
        check(f"{name} (history {SAMPLER_HISTORY})",
              lambda d: fn(logits.to(on[d]).double(), ts[d][0], ts[d][1]))
    pipeline(f"pipeline, history stages (history {SAMPLER_HISTORY})", rows,
             SAMPLER_HISTORY)
    stops = [dict(temperature=0.0, min_tokens=48,
                  stop_token_ids=rng.integers(0, V, 16).tolist()),
             dict(temperature=1.0, custom_token_bans=rng.integers(
                 0, V, 64).tolist()),
             dict(temperature=0.7, min_tokens=4, stop_token_ids=[7],
                  custom_token_bans=[1, 2, 3])]
    pipeline("pipeline, min_tokens and bans", sampler_rows(stops, S, 5000))
    words = torch.from_numpy(rng.integers(0, 2**32, (S, -(-V // 32)),
                                          dtype=np.uint64).astype(
        np.uint32).view(np.int32))
    pipeline("pipeline, guided mask", sampler_rows(free, S, 6000),
             guided=words)
    if failed:
        fail("sampler: " + "; ".join(failed))
    return errs


def graph_ms(fn, replays: int = 20) -> float:
    """Device milliseconds of one call of `fn` captured into a CUDA graph
    (the way a decode window runs it), per replay, from CUDA events."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # first use: allocations, library initialisation
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / replays


def sampler_timings(card):
    """Milliseconds (CUDA events) of sample() at S 8 and 32, V 128256, on
    the card, each way the runner calls it: captured in a CUDA graph (as
    inside a decode window: the device's time) and launched eagerly (as on
    the single-step path, time_ms: at several hundred small launches a
    call, the host's launch rate binds it). Cases: the greedy floor
    (argmax and logprob only), stochastic rows with no stage (the noise),
    each stage alone on stochastic rows, every history-free stage at once,
    and the history stages on histories of 2048 ids."""
    import torch

    import aphrodite_tpu_torch.sampling.sampler as sampler_mod
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.sampling.metadata import (SamplerInputRow,
                                                       build_sampling_tensors)

    V, dev = SAMPLER_V, torch.device("cuda")
    out = {}
    for S in (8, 32):
        t0 = time.monotonic()
        logits = sampler_logits(S, V, SEED + S).to(dev)
        rng = np.random.default_rng(SEED + S)
        history = rng.integers(0, 64, (S, SAMPLER_HISTORY))
        cases = {"greedy floor": dict(temperature=0.0),
                 "noise (temperature 1)": dict(temperature=1.0)}
        for name, mixes in SAMPLER_STAGES.items():
            cases[name] = mixes[0]
        cases["every history-free stage"] = SAMPLER_ALL_FREE
        cases.update({
            "penalties": dict(temperature=0.0, repetition_penalty=1.2,
                              frequency_penalty=0.5),
            "dry": dict(temperature=0.0, dry_multiplier=0.8),
            "no_repeat_ngram": dict(temperature=0.0, no_repeat_ngram_size=3),
            "history all": dict(temperature=0.0, repetition_penalty=1.2,
                                dry_multiplier=0.8, no_repeat_ngram_size=3)})
        graphed, eager = {}, {}
        for name, mix in cases.items():
            rows = [SamplerInputRow(
                params=SamplingParams(**dict(dict(temperature=1.0), **mix)),
                token_ids=history[i].tolist(), prompt_len=1000,
                generated_len=SAMPLER_HISTORY - 1000, seed=i)
                for i in range(S)]
            t, flags, hist, hl = build_sampling_tensors(
                rows, S, V, history_pad=SAMPLER_HISTORY)
            t = sampler_mod.tensors_to_device(t, dev)
            h = ([torch.from_numpy(a).to(dev) for a in (hist, *hl)]
                 if hist is not None else [None] * 3)

            def call():
                sampler_mod.sample(logits, t, flags, *h)

            graphed[name] = graph_ms(call)
            eager[name] = time_ms(call, 10)
        torch.cuda.empty_cache()
        out[S] = {"graphed_ms": {k: round(v, 4) for k, v in graphed.items()},
                  "eager_ms": {k: round(v, 4) for k, v in eager.items()}}
        floor = graphed["greedy floor"]
        print(f"sampler times at S {S}, V {V} ({card}), graphed: " + ", ".join(
            f"{k} {v:.4f} ms" + ("" if k == "greedy floor" else
                                 f" (+{v - floor:.4f})")
            for k, v in graphed.items()), flush=True)
        print(f"sampler times at S {S}, V {V} ({card}), eager: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in eager.items())
            + f"; {time.monotonic() - t0:.1f} s", flush=True)
    return out


def history_free_params():
    """The 16 requests of the history-free sampler path: seeded random
    rows, each a different mix of the history-free stages (two set a
    sampler_priority, the first request's governs the batch); row 12 has
    temperature 1000, so its draws are its noise's whatever its logits'
    last bits (the one re-run alone)."""
    from aphrodite_tpu_torch.common.sampling_params import (SamplerID,
                                                            SamplingParams)

    mixes = [
        dict(temperature=0.8, dynatemp_min=0.5, dynatemp_max=1.5,
             sampler_priority=[SamplerID.MIN_P, SamplerID.TEMPERATURE,
                               SamplerID.TOP_P_TOP_K, SamplerID.XTC]),
        dict(temperature=1.0, top_k=50, top_p=0.9),
        dict(temperature=1.0, min_p=0.05),
        dict(temperature=1.0, top_a=0.2),
        dict(temperature=1.0, tfs=0.95),
        dict(temperature=1.0, eta_cutoff=3.0),
        dict(temperature=1.0, epsilon_cutoff=1.0),
        dict(temperature=1.0, typical_p=0.9),
        dict(temperature=1.0, smoothing_factor=0.3),
        dict(temperature=1.0, xtc_probability=0.5, xtc_threshold=2e-4,
             sampler_priority=[SamplerID.XTC, SamplerID.TEMPERATURE]),
        dict(temperature=1.0, nsigma=1.5),
        dict(temperature=1.0, skew=0.5),
        dict(temperature=1000.0),
        dict(temperature=0.7, top_k=20, temperature_last=True),
        dict(temperature=1.2, min_p=0.1, top_p=0.8),
        SAMPLER_ALL_FREE]
    return [SamplingParams(seed=100 + i, max_tokens=MAX_TOKENS,
                           ignore_eos=True, detokenize=False, **kw)
            for i, kw in enumerate(mixes)]


# The history path's rows: (what, sampling kwargs); prompt_logprobs 5 on
# rows 0, 5, 10 and 15. The penalties are strong enough that a token they
# hit loses its place as the argmax of a random-weight model's logits.
HISTORY_PATH_ROWS = [
    ("repetition", dict(repetition_penalty=1.5)),
    ("repetition", dict(repetition_penalty=1.5)),
    ("frequency", dict(frequency_penalty=2.0)),
    ("frequency", dict(frequency_penalty=2.0)),
    ("presence", dict(presence_penalty=2.0)),
    ("presence", dict(presence_penalty=2.0)),
    ("dry", dict(dry_multiplier=3.0, dry_allowed_length=2,
                 dry_sequence_breaker_ids=[13, 198])),
    ("dry", dict(dry_multiplier=3.0, dry_allowed_length=1)),
    ("no_repeat_ngram", dict(no_repeat_ngram_size=3)),
    ("no_repeat_ngram", dict(no_repeat_ngram_size=3)),
    ("min_tokens", dict(min_tokens=48)),
    ("min_tokens", dict(min_tokens=48)),
    ("bans", {}), ("bans", {}),
    ("processor", {}), ("processor", {})]
HISTORY_PLP_ROWS = (0, 5, 10, 15)


def forced_token(row, k, vocab):
    """The token the history path's logits processor forces at step k of
    a row."""
    return (7919 * k + 104729 * row) % vocab


def history_params(reference, vocab):
    """The 16 greedy requests of the history path. `reference`: each
    request's tokens on the greedy gptq+fp8_e4m3 path (same model and
    prompts): the min_tokens rows' stop ids are the first 16 distinct
    tokens of theirs, and the ban rows ban the first 64 distinct tokens of
    theirs, so both stages change what those rows would emit. Two rows
    carry a two-argument logits processor that forces forced_token."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams

    def first_distinct(tokens, n):
        return list(dict.fromkeys(tokens))[:n]

    def processor(row):
        def force(out_ids, logits):
            out = np.full_like(logits, -1e9)
            out[forced_token(row, len(out_ids), vocab)] = 0.0
            return out
        return force

    out = []
    for i, (what, kw) in enumerate(HISTORY_PATH_ROWS):
        kw = dict(kw)
        if what == "min_tokens":
            kw["stop_token_ids"] = first_distinct(reference[i], 16)
        elif what == "bans":
            kw["custom_token_bans"] = first_distinct(reference[i], 64)
        elif what == "processor":
            kw["logits_processors"] = [processor(i)]
        out.append(SamplingParams(
            temperature=0.0, max_tokens=MAX_TOKENS,
            ignore_eos=what != "min_tokens", detokenize=False,
            prompt_logprobs=5 if i in HISTORY_PLP_ROWS else None, **kw))
    return out


def repeats(prompt, tokens, n, prompt_counts=True):
    """Whether some n-gram ending in `tokens` occurs earlier in prompt +
    tokens (with prompt_counts False, earlier in tokens)."""
    seq = list(prompt) + list(tokens) if prompt_counts else list(tokens)
    first = len(seq) - len(tokens)
    seen = set()
    for end in range(n, len(seq) + 1):
        gram = tuple(seq[end - n:end])
        if end > first and gram in seen:
            return True
        seen.add(gram)
    return False


def check_history_path(label, prompts, outs, params, reference, vocab):
    """The history path's tokens. A penalized row whose stage would have
    hit the greedy path's tokens of the same request (a repeated token, a
    repeated n-gram) emits other tokens than those; the no-repeat-ngram
    rows repeat no 3-gram; no banned id appears; the min_tokens rows emit
    no stop id in their first 48 tokens; the processor rows emit the
    tokens it forces."""
    held, lens = [], {}
    would_hit = {
        "repetition": lambda p, r: repeats(p, r, 1),
        "frequency": lambda p, r: repeats(p, r, 1, prompt_counts=False),
        "presence": lambda p, r: repeats(p, r, 1, prompt_counts=False),
        "dry": lambda p, r: repeats(p, r, 2),
        "no_repeat_ngram": lambda p, r: repeats(p, r, 3)}
    for i, ((what, _), sp, o) in enumerate(zip(HISTORY_PATH_ROWS, params,
                                               outs)):
        toks = o.outputs[0].token_ids
        lens[i] = len(toks)
        if what in would_hit and would_hit[what](prompts[i], reference[i]):
            held.append(i)
            if toks == reference[i]:
                fail(f"{label}: row {i} ({what}) emits the greedy path's "
                     "tokens, which its stage penalizes")
        if what == "no_repeat_ngram" and repeats(prompts[i], toks, 3):
            fail(f"{label}: row {i} repeats a 3-gram")
        if what == "bans" and set(sp.custom_token_bans) & set(toks):
            fail(f"{label}: row {i} emits a banned id")
        if what == "min_tokens":
            if set(sp.stop_token_ids) & set(toks[:48]) or len(toks) < 48:
                fail(f"{label}: row {i} emits a stop id before token 48 "
                     f"or ends early ({len(toks)} tokens)")
        if what == "processor" and toks != [forced_token(i, k, vocab)
                                             for k in range(len(toks))]:
            fail(f"{label}: row {i} does not emit its processor's tokens")
    print(f"{label}: the penalized rows whose stage would hit the greedy "
          f"path's tokens ({held} of rows 0-9) emit others; no repeated "
          f"3-gram on rows 8-9, no banned id, no stop id before token 48 on "
          f"the min_tokens rows (lengths {lens[10]}, {lens[11]}), processor "
          "rows forced", flush=True)
    return held


def check_prompt_logprobs(llm, label, prompts, outs, device):
    """The prompt logprobs the engine returned for HISTORY_PLP_ROWS against
    a log-softmax of one prefill forward's logits of the same prompts (the
    kernels of compare_logits' kernel run), at every position: the
    target's and each top-5 id's logprob within LOGIT_TOL of the row's
    largest logit magnitude."""
    import torch

    from aphrodite_tpu_torch.models.interface import ForwardBatch

    runner = llm.engine.runner
    model, params = runner.model, runner.params
    rows = [prompts[i] for i in HISTORY_PLP_ROWS]
    lens = [len(p) for p in rows]
    S, T = 8, -(-sum(lens) // 512) * 512
    pps = runner.pages_per_seq
    ids = np.zeros((T,), np.int32)
    pos = np.zeros((T,), np.int32)
    slots = np.full((T,), runner.trash_slot_base, np.int32)
    pages = np.zeros((S, pps), np.int32)
    kv_lens = np.zeros((S,), np.int32)
    cu = np.zeros((S + 1,), np.int32)
    next_page, off = 0, 0
    for i, p in enumerate(rows):
        n = len(p)
        npg = -(-n // PAGE_SIZE)
        pages[i, :npg] = np.arange(next_page, next_page + npg)
        next_page += npg
        j = np.arange(n)
        ids[off:off + n] = p
        pos[off:off + n] = j
        slots[off:off + n] = pages[i, j // PAGE_SIZE] * PAGE_SIZE \
            + j % PAGE_SIZE
        kv_lens[i] = n
        cu[i + 1] = cu[i] + n
        off += n
    cu[len(rows) + 1:] = cu[len(rows)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    batch = ForwardBatch(t(ids), t(pos), t(slots), t(kv_lens), t(pages),
                         t(cu), t(np.asarray([len(rows)], np.int32)),
                         t(cu[1:S + 1] - 1))
    worst, checked = 0.0, 0
    with torch.inference_mode():
        hidden = model.forward(params, runner.kv_cache, batch,
                               runner.kv_scales)
        for i, r in enumerate(HISTORY_PLP_ROWS):
            plp = outs[r].prompt_logprobs
            if plp is None or len(plp) != lens[i] or plp[0] is not None:
                fail(f"{label}: request {r} has no prompt logprobs for "
                     "every prompt token")
            # Position j's logits predict token j + 1, 256 positions a pass.
            for start in range(0, lens[i] - 1, 256):
                end = min(start + 256, lens[i] - 1)
                logits = model.compute_logits(
                    params, hidden[cu[i] + start:cu[i] + end]).float()
                lp = torch.log_softmax(logits, -1).cpu()
                scale = logits.abs().amax(-1).cpu()
                for j in range(start + 1, end + 1):
                    entry = plp[j]
                    if rows[i][j] not in entry or len(entry) < 5:
                        fail(f"{label}: request {r} position {j}: no entry "
                             "for the prompt token or fewer than 5 top ids")
                    for tid, lpv in entry.items():
                        err = abs(lpv.logprob - float(lp[j - 1 - start, tid]))
                        worst = max(worst, err / float(scale[j - 1 - start]))
                        checked += 1
    print(f"{label}: {checked} prompt logprobs of {len(rows)} requests "
          f"({sum(lens)} prompt tokens) against a log-softmax of a prefill "
          f"forward's logits: worst err / max|logit row| {worst:.3e} "
          f"(tolerance {LOGIT_TOL:.1e})", flush=True)
    if worst > LOGIT_TOL:
        fail(f"{label}: the prompt logprobs disagree with the forward's "
             "logits")
    return worst


def main_path(device, model_config, prompt_lens, num_scheduler_steps=8,
              quantization=None, kv_cache_dtype="auto", kv_scale=None,
              gguf=None, q4_body=None, w4a8=False, compare_lens=None,
              window_check=False, sampler=None, reference=None,
              max_model_len=None, compare_layers=None,
              serve_reference=False, f64_floor=False, mla_latent=None):
    """LLM.generate through the port's entry point, with bf16 weights,
    (quantization="gptq") packed int4 ones, ("int8" or "fp8") per-channel
    8-bit ones quantized at load, or (gguf="q6_k" or "q8_0") a GGUF file
    of that block type written from the seed, whose projections load as
    unpacked one-level-per-byte containers, or (gguf="q2_k") one of Q2_K
    and Q3_K blocks, which load as packed containers at group 16; and a
    bf16 KV cache or
    (kv_cache_dtype) a narrow one, whose per-layer scales are ones or
    (kv_scale) come from a JSON file. q4_body sends every unpacked matmul
    of the path to that body of the kernel and not to the one the wrapper
    would choose: the projections' reference to the wrapper is replaced,
    for this path only, by one that names the body. w4a8 sets
    APHRODITE_W4_A8=1 for this path only (packed int4 weights, from gptq or
    the q2_k file, take W4A8 in forwards of 16 tokens or more).
    compare_lens: the sequence lengths of the forwards whose logits are
    compared (default: as compare_logits chooses). window_check: hold one
    decode window of 16 rows through the runner's CUDA graph against the
    eager window function, bit for bit, and time both. sampler: the
    requests' sampling, greedy by default; "history-free" (the requests of
    history_free_params, seeded random rows whose decode windows are graph
    replays; one of them is then re-run alone and must draw the tokens it
    drew in the batch), or "history" (those of history_params, made from
    `reference`, the greedy path's tokens of the same requests: history
    stages, min_tokens, bans, a logits processor and prompt logprobs, on
    the single-step path; held by check_history_path and
    check_prompt_logprobs). The sampler paths compare no logits: their
    model and cache are the gptq+fp8_e4m3 path's, which does.
    max_model_len: the served length (default: the config's
    max_position_embeddings); with LongRoPE scaling the model's rotary
    table must be the one its long factors give at that length.
    compare_layers: the depth at which the logits are compared (default:
    the model's; see COMPARE_LAYERS). f64_floor: the logits comparison
    holds argmax on the rows that the plain attention in f64 decides
    (compare_logits; always on for an MoE model). serve_reference: the
    engine gets the
    serving phase's word tokenizer, and runs the serving phase's greedy and
    beam requests alone before it is freed (serve_reference_requests; the
    result under "serve_reference"). mla_latent: APHRODITE_MLA_LATENT
    (the JAX package's switch, read at model build) for this path's model
    only; "0" serves an MLA model's materialized form. Returns the
    launch counts of the path's kernels in the timed run, by variant name
    (under IN_GRAPH_REPLAYS the part of them that graph replays made), and
    the rates (with the decode windows' graphs, chained windows, carry and
    sampling-cache hits of the timed run, each replayed key's traced
    launches, and under "token_ids" each request's tokens)."""
    import torch

    import aphrodite_tpu_torch.quantization.qlinear as qlinear_mod
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.attention import ragged_paged_attention
    from aphrodite_tpu_torch.ops.decode_attention import (
        RAGGED_ONLY_HEAD_DIMS, paged_decode_attention)
    from aphrodite_tpu_torch.ops.quant_matmul import (DENSE_MIN_T,
                                                      INT4_BODY,
                                                      decode_route,
                                                      fp8_route,
                                                      fp8_w8a8_matmul,
                                                      int4_matmul,
                                                      int4p_matmul,
                                                      int4p_matmul_w4a8,
                                                      quantize_activations)
    from aphrodite_tpu_torch.tools.window_check import (kernel_base,
                                                        trace_launches)

    wrappers = {"ragged_paged_attention": ragged_paged_attention,
                "paged_decode_attention": paged_decode_attention}
    # GGUF Q2_K / Q3_K load packed; the other GGUF types one level a byte.
    packed_gguf = gguf == "q2_k"
    packed = quantization == "gptq" or packed_gguf
    if packed and w4a8:
        wrappers["int4p_matmul_w4a8"] = int4p_matmul_w4a8
        wrappers["quantize_activations"] = quantize_activations
    elif packed:
        wrappers["int4p_matmul"] = int4p_matmul
    elif quantization == "fp8":
        wrappers["fp8_w8a8_matmul"] = fp8_w8a8_matmul
        wrappers["quantize_activations"] = quantize_activations
    if (gguf is not None and not packed_gguf) or quantization == "int8":
        wrappers["int4_matmul"] = int4_matmul
    page_type = CACHE_PAGE_TYPES[kv_cache_dtype]
    layers = config_layers(model_config)
    weights = (quantization or (gguf and gguf + ' gguf') or 'bf16') + (
        " w4a8" if w4a8 else "")
    label = (f"main path ({weights} weights, "
             f"{kv_cache_dtype if page_type != 'bf16' else 'bf16'} cache, "
             f"{layers} layers)")
    if w4a8:
        # Restored once this path's logits are compared; a failure ends the
        # script.
        saved_switch = os.environ.get("APHRODITE_W4_A8")
        os.environ["APHRODITE_W4_A8"] = "1"
    vocab = config_vocab(model_config)
    with tempfile.TemporaryDirectory() as td:
        scales_path = None
        if kv_scale is not None:
            scales_path = os.path.join(td, "kv_scales.json")
            with open(scales_path, "w") as f:
                json.dump({"kv_cache": {"scaling_factor": {"0": {
                    str(i): kv_scale for i in range(layers)}}}}, f)
        if gguf is None:
            source = dict(model=write_model_dir(td, model_config),
                          load_format="dummy", quantization=quantization)
            if serve_reference:
                write_word_tokenizer(td, vocab)
        else:
            # The file goes with the temporary directory when the engine
            # is up: the loader has decoded it by then.
            path = os.path.join(td, f"llama-{gguf}.gguf")
            t0 = time.monotonic()
            size = write_gguf_llama(path, model_config, gguf, SEED)
            print(f"{label}: wrote {size / 1e9:.2f} GB to {path} in "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
            source = dict(model=path, tokenizer=None)
        t0 = time.monotonic()
        saved_latent = os.environ.get("APHRODITE_MLA_LATENT")
        if mla_latent is not None:
            os.environ["APHRODITE_MLA_LATENT"] = mla_latent
        try:
            llm = LLM(**source, dtype="bfloat16", seed=SEED,
                      kv_cache_dtype=kv_cache_dtype,
                      quantization_param_path=scales_path,
                      num_scheduler_steps=num_scheduler_steps, block_size=16,
                      max_num_batched_tokens=2048,
                      skip_tokenizer_init=not serve_reference,
                      max_model_len=max_model_len, device=device)
        finally:
            if saved_latent is None:
                os.environ.pop("APHRODITE_MLA_LATENT", None)
            else:
                os.environ["APHRODITE_MLA_LATENT"] = saved_latent
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"{label}: engine up in {time.monotonic() - t0:.1f} s, "
              f"{llm.engine.runner.num_pages} KV pages of "
              f"{llm.engine.runner.kv_cache.dtype}, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
              flush=True)
    scaling = model_config.get("rope_scaling") or {}
    if scaling.get("type") == "longrope":
        check_longrope(llm.engine.runner.model, scaling, label)
    rng = np.random.default_rng(SEED)
    sp = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS,
                        ignore_eos=True, detokenize=False)
    params = {None: None, "history-free": history_free_params,
              "history": lambda: history_params(reference, vocab)}[sampler]
    params = params() if params else [sp] * NUM_REQUESTS
    warm = [SamplingParams(temperature=0.0, max_tokens=17, ignore_eos=True,
                           detokenize=False)] * NUM_REQUESTS
    if sampler == "history-free":
        # The timed run's flags: its decode windows' key is captured here.
        warm = [p.clone() for p in params]
        for p in warm:
            p.max_tokens = 17
    # Warm-up (library initialisation, allocator growth, and the decode
    # windows' warm-up and capture at both sequence buckets the timed run
    # reaches, 8 rows and 32): not counted.
    llm.generate(prompt_token_ids=[rng.integers(0, vocab, 32).tolist()] * 2,
                 sampling_params=warm[:2])
    llm.generate(
        prompt_token_ids=np.random.default_rng(SEED + 1).integers(
            0, vocab, (NUM_REQUESTS, 16)).tolist(),
        sampling_params=warm)
    prompts = [rng.integers(0, vocab, int(n)).tolist() for n in prompt_lens]
    for k in llm.engine.phase_timings:
        llm.engine.phase_timings[k] = 0 if isinstance(
            llm.engine.phase_timings[k], int) else 0.0
    # The wrappers count the launches they make; a window's replays run
    # outside them, so the decode windows of the timed run are counted by
    # tracing a replay of each key after it (trace_launches).
    runner = llm.engine.runner
    model = runner.model
    # An MoE model: its grouped product is held and timed (moe_checks).
    moe = hasattr(model, "route")
    attention_names = ("ragged_paged_attention", "paged_decode_attention")
    unpacked = (gguf is not None and not packed_gguf) or quantization == "int8"

    def zero_counts():
        """Every wrapper's launch counts set to 0."""
        for fn in (ragged_paged_attention, paged_decode_attention,
                   int4_matmul, int4p_matmul, int4p_matmul_w4a8,
                   quantize_activations, fp8_w8a8_matmul):
            fn.launches = 0
        for fn in (ragged_paged_attention, paged_decode_attention):
            fn.launches_by_dtype = {}
            fn.launches_by_shape = {}
        for fn in (int4_matmul, int4p_matmul, fp8_w8a8_matmul):
            fn.launches_by_body = {}
        quantize_activations.launches_by_format = {}

    def read_counts():
        """The wrappers' launch counts since zero_counts."""
        return dict(
            launches={name: fn.launches for name, fn in wrappers.items()},
            by_dtype={name: dict(wrappers[name].launches_by_dtype)
                      for name in attention_names},
            by_shape={name: dict(wrappers[name].launches_by_shape)
                      for name in attention_names},
            by_body=dict(int4_matmul.launches_by_body),
            packed_by_body=dict(int4p_matmul.launches_by_body),
            fp8_by_body=dict(fp8_w8a8_matmul.launches_by_body),
            by_format=dict(quantize_activations.launches_by_format),
            w4a16=int4p_matmul.launches,
            other_int4=(int4p_matmul.launches if unpacked
                        else int4_matmul.launches))

    # Every forward launches one attention kernel per layer, of the cache's
    # page type (the ragged one in prefill and mixed steps, the decode one
    # in the fused window, or the ragged one there too at a head_dim the
    # decode kernel does not take), of the instantiation of the cache's QH
    # / KV and head_dim (an MLA model's latent cache: all query heads on
    # one head of head_eff), with ALiBi exactly where the model has
    # slopes, and blocksparse on exactly the layers whose gate is on.
    ckv, head_dim = model.kv_cache_shape_suffix
    qg = model.num_heads // (ckv // 2)
    ragged_decode = head_dim in RAGGED_ONLY_HEAD_DIMS
    decode_wrapper = (ragged_paged_attention if ragged_decode
                      else paged_decode_attention)
    decode_bases = (("ragged_paged_attention_kernel",) if ragged_decode else
                    ("paged_decode_kernel", "paged_decode_wide_kernel"))
    shape = (f"qg{qg} d{head_dim}"
             + (" alibi" if model.alibi_slopes is not None else ""))
    per_forward = {shape: layers}
    if model.blocksparse_params is not None:
        sparse = sum(model.bs_layer_mask or [True] * layers)
        per_forward = {f"{shape} blocksparse": sparse, shape: layers - sparse}

    def small_key(body, group, fmt, large):
        """The key of a product of T tokens: `large` from DENSE_MIN_T
        tokens on, else `body`, or body + "_decode" where decode_route
        takes the decode body."""
        def key(t, K, N):
            if t >= DENSE_MIN_T:
                return large
            g = K if group is None else group
            return body + ("_decode" if decode_route(t, K, N, g, fmt)
                           == "decode" else "")
        return key

    def check_counts(c, forward_tokens, what):
        """Hold the launch counts ``c`` (read_counts) of forwards of
        ``forward_tokens`` tokens each to what those forwards launch: a
        forward that took a plain version would leave a sum short."""
        forwards = len(forward_tokens)
        launches = c["launches"]
        where = f"the {label} ({what})"

        def nonzero(counts):
            return {k: n for k, n in counts.items() if n}

        for name, counts in c["by_dtype"].items():
            want = {page_type: launches[name]} if launches[name] else {}
            if nonzero(counts) != want:
                fail(f"{name} on {where} was launched on page types "
                     f"{counts}, not only on {page_type}")
        attention = sum(launches[name] for name in attention_names)
        if attention != layers * forwards:
            fail(f"{attention} attention launches on {where} are not "
                 f"{layers} layers x {forwards} forwards")
        for name, counts in c["by_shape"].items():
            want = {k: n * launches[name] // layers
                    for k, n in per_forward.items() if n and launches[name]}
            if nonzero(counts) != want:
                fail(f"{name} on {where} was launched as {counts}, not as "
                     f"{want}")
        print(f"{label}: {what}: {forwards} forwards, each with {layers} "
              f"attention launches on {page_type} pages: {per_forward}",
              flush=True)
        # Forwards of 16 tokens or more, which W4A8 takes with the switch.
        wide = sum(1 for t in forward_tokens if t >= 16)
        # Forwards of DENSE_MIN_T tokens or more, whose int4 products take
        # the prefill body.
        prefill = sum(1 for t in forward_tokens if t >= DENSE_MIN_T)

        def by_route(route):
            """Launches by body of four products per layer and forward,
            each forward's on the body route(T) names."""
            want = {}
            for t in forward_tokens:
                want[route(t)] = want.get(route(t), 0) + 4 * layers
            return want

        def by_site(key):
            """Launches by body of the four products (wqkv, wo, w13, down)
            per layer and forward, each product's on the body key(T, K, N)
            names: under DENSE_MIN_T tokens decode_route picks the decode
            body or the mma.sync kernel by the product's shape."""
            want = {}
            for t in forward_tokens:
                for K, N in projection_shapes(model_config):
                    want[key(t, K, N)] = want.get(key(t, K, N), 0) + layers
            return want

        by_body, by_format = nonzero(c["by_body"]), nonzero(c["by_format"])
        if packed and not w4a8:
            # And four int4 matmuls (wqkv, wo, w13, down) per layer.
            packed_by_body = nonzero(c["packed_by_body"])
            if launches["int4p_matmul"] != 4 * layers * forwards:
                fail(f"int4p_matmul launches {launches['int4p_matmul']} on "
                     f"{where} are not 4 x {layers} layers x {forwards} "
                     "forwards")
            want = by_site(small_key("groupwise", 16 if packed_gguf else
                                     INT4_GROUP, "packed", "dense_wgmma"))
            if packed_by_body != want:
                fail(f"int4p_matmul launches by body {packed_by_body} on "
                     f"{where} are not {want} ({prefill} of {forwards} "
                     f"forwards of {DENSE_MIN_T} tokens or more)")
            print(f"{label}: {what}: int4p_matmul launched {4 * layers} "
                  f"times in each forward, by body {packed_by_body}",
                  flush=True)
        if w4a8:
            # Four W4A8 products (and activation quantizations) per layer
            # in every forward of 16 tokens or more, four W4A16 ones in
            # every other.
            want = {"int4p_matmul_w4a8": 4 * layers * wide,
                    "quantize_activations": 4 * layers * wide,
                    "int4p_matmul": 4 * layers * (forwards - wide)}
            got = {"int4p_matmul_w4a8": launches["int4p_matmul_w4a8"],
                   "quantize_activations": by_format.get("int8", 0),
                   "int4p_matmul": c["w4a16"]}
            if got != want or set(by_format) - {"int8"}:
                fail(f"W4A8 launches {got}, by format {by_format}, on "
                     f"{where} are not {want} for {wide} forwards of 16 "
                     f"tokens or more and {forwards - wide} under")
            print(f"{label}: {what}: {wide} forwards of 16 tokens or more, "
                  f"each with {4 * layers} int4p_matmul_w4a8 and int8 "
                  f"quantize_activations launches; {forwards - wide} under, "
                  f"each with {4 * layers} int4p_matmul launches; tokens per "
                  f"forward {sorted(set(forward_tokens))}", flush=True)
        if quantization == "int8":
            # Four launches (G = K) per layer and forward: the group-wise
            # body, or the prefill body's per-column form.
            want = by_site(small_key("groupwise", None, "groupwise",
                                     "per_column_wgmma"))
            if by_body != want:
                fail(f"int4_matmul launches by body {by_body} on {where} "
                     f"are not {want}")
            print(f"{label}: {what}: int4_matmul (G = K) launched "
                  f"{4 * layers} times in each forward, by body {by_body}",
                  flush=True)
        if quantization == "fp8":
            # Four e4m3 quantizations and products per layer, each
            # forward's on the body fp8_route names (the f16 body's
            # activations as f16).
            fp8_by_body = nonzero(c["fp8_by_body"])
            n = 4 * layers * forwards
            want = by_route(fp8_route)
            formats = {"f16_wgmma": "e4m3_f16", "e4m3_mma": "e4m3"}
            want_formats = {}
            for body, k in want.items():
                want_formats[formats[body]] = want_formats.get(
                    formats[body], 0) + k
            if (launches["fp8_w8a8_matmul"] != n or fp8_by_body != want
                    or by_format != want_formats):
                fail(f"fp8 launches on {where}: "
                     f"{launches['fp8_w8a8_matmul']} e4m3 products "
                     f"({fp8_by_body} by body, want {want}) and {by_format} "
                     f"quantizer launches are not 4 x {layers} layers x "
                     f"{forwards} forwards")
            print(f"{label}: {what}: fp8_w8a8_matmul and "
                  f"quantize_activations launched {4 * layers} times in each "
                  f"forward, by body {fp8_by_body}", flush=True)
        if gguf is not None and not packed_gguf:
            # And four unpacked matmuls (wqkv, wo, w13, down) per layer,
            # none through the packed kernel.
            if launches["int4_matmul"] != 4 * layers * forwards:
                fail(f"int4_matmul launches {launches['int4_matmul']} on "
                     f"{where} are not 4 x {layers} layers x {forwards} "
                     "forwards")
            group = GGUF_GROUPS[gguf]
            want = by_site(
                small_key("groupwise", group, "groupwise", "groupwise")
                if q4_body == "groupwise"
                else small_key("dense", group, "dense", "dense_wgmma"))
            if by_body != want:
                fail(f"int4_matmul launches by body {by_body} on {where} "
                     f"are not {want}")
            print(f"{label}: {what}: int4_matmul launched {4 * layers} "
                  f"times in each forward, by body {by_body}", flush=True)
        if c["other_int4"]:
            fail(f"{c['other_int4']} launches of the other int4 kernel on "
                 f"{where}")

    zero_counts()
    runner.eager_forwards_by_tokens.clear()
    if q4_body is not None:
        # Until this path's logits are compared; a failure ends the script.
        # The windows captured so far launch the wrapper's own choice.
        qlinear_mod.int4_matmul = functools.partial(int4_matmul,
                                                    body=q4_body)
        runner.reset_graphs()
    graphs_before = runner.graph_stats()
    hits_before = dict(chained=runner.chained_window_hits,
                       carry=runner.carry_hits,
                       sampling_cache=runner.sampling_cache_hits)
    t0 = time.monotonic()
    outs = llm.generate(prompt_token_ids=prompts, sampling_params=params)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    eager = read_counts()
    # T of each forward the runner ran eagerly in the timed run.
    eager_tokens = [t for t, n in
                    sorted(runner.eager_forwards_by_tokens.items())
                    for _ in range(n)]
    windows = window_stats(runner, graphs_before, hits_before)
    pt = llm.engine.get_phase_timings()
    lens = [len(o.outputs[0].token_ids) for o in outs]
    rates = dict(
        prefill_tok_s=pt["prefill_tokens"] / max(pt["prefill_s"], 1e-9),
        decode_tok_s=pt["decode_tokens"] / max(pt["decode_s"], 1e-9),
        decode_iterations=pt["decode_iterations"])
    # (Requests with stop ids may end early: check_history_path holds them.)
    if any(n != MAX_TOKENS for n, p in zip(lens, params) if p.ignore_eos):
        fail(f"outputs with other than {MAX_TOKENS} tokens: {lens}")
    W = min(num_scheduler_steps, runner.MULTI_STEP_WINDOW)
    check_counts(eager, eager_tokens, "eager forwards")
    replayed, traced = {}, {}
    if device == "cuda":
        # Every pure-decode window ran as its key's one warm-up or as a
        # replay of the key's one capture; and the runner's eager forwards
        # are the engine's prefill and mixed steps and the W forwards of
        # each warm-up, so no pure-decode step ran eagerly.
        for key, k in windows["graphs"].items():
            if k["warmups_total"] != 1 or k["captures_total"] > 1 or (
                    k["replays"] and k["captures_total"] != 1):
                fail(f"decode window {key} on the {label} ran "
                     f"{k['warmups_total']} windows eagerly and was captured "
                     f"{k['captures_total']} times: {k}")
        warmed = sum(k["warmups"] for k in windows["graphs"].values())
        if sampler == "history":
            # Every decode step on the single-step path, none in a window.
            replays = sum(k["replays"] for k in windows["graphs"].values())
            if (warmed or replays or len(eager_tokens) !=
                    pt["prefill_iterations"] + pt["decode_iterations"]):
                fail(f"{len(eager_tokens)} eager forwards on the {label} are "
                     f"not the engine's {pt['prefill_iterations']} prefill "
                     f"and mixed steps and {pt['decode_iterations']} decode "
                     f"steps ({warmed} windows warmed up, {replays} "
                     "replayed)")
        elif len(eager_tokens) != pt["prefill_iterations"] + W * warmed:
            fail(f"{len(eager_tokens)} eager forwards on the {label} are not "
                 f"the engine's {pt['prefill_iterations']} prefill and mixed "
                 f"steps and {warmed} warm-up windows of {W}")
        # Each key replayed in the run: one window of it run eagerly,
        # counted by the wrappers and held to its forwards, then a replay of
        # its graph traced by torch.profiler, which must launch the port's
        # kernels of that window by name and count, one decode attention
        # kernel per layer and forward among them. The run's replays of the
        # key launched what this replay did.
        for key, k in windows["graphs"].items():
            if not k["replays"]:
                continue
            S, W_key, _ = runner.window_keys()[key]
            zero_counts()
            t_trace = time.monotonic()
            def decode_count(counts):
                # (Above 16 query heads per kv head the decode kernel's
                # wide form runs; at a head_dim it does not take, the
                # ragged kernel.)
                return sum(n for name, n in counts.items()
                           if kernel_base(name) in decode_bases)

            trace = trace_launches(
                runner, key, reset=zero_counts,
                accept=lambda c: decode_count(c) == layers * W_key,
                wrapper_count=lambda: decode_wrapper.launches)
            t_trace = time.monotonic() - t_trace
            window = read_counts()
            check_counts(window, [S] * W_key, f"a window of {key}")
            decode_kernels = decode_count(trace["replay"])
            # Each pair's decode kernels: the wrapper's own count of the
            # eager window beside the eager and replay traces' records (the
            # profiler drops a launch's records now and then: ROADMAP §3).
            decode_pairs = [
                dict(wrapper=p["wrapper"], eager=decode_count(p["eager"]),
                     replay=decode_count(p["replay"]))
                for p in trace["pairs"]]
            if trace["replay"] != trace["eager"] or (
                    decode_kernels != layers * W_key):
                fail(f"a traced replay of {key} on the {label} launched "
                     f"{trace['replay']}, not the eager window's "
                     f"{trace['eager']} with {layers} x {W_key} decode "
                     f"attention kernels ({trace['tries']} traced pairs; "
                     f"decode kernels by pair {decode_pairs}, "
                     f"{trace['padding']} padding kernels each side)")
            by_kernel = {}
            for name, n in trace["replay"].items():
                by_kernel[kernel_base(name)] = by_kernel.get(
                    kernel_base(name), 0) + n
            mismatched = []
            for m in trace["mismatches"]:
                by_base = {}
                for name, d in m.items():
                    by_base[kernel_base(name)] = by_base.get(
                        kernel_base(name), 0) + d
                mismatched.append(by_base)
            traced[key] = dict(replays=k["replays"], launches=by_kernel,
                               trace_s=round(t_trace, 2),
                               traced_pairs=trace["tries"],
                               retraced_pairs=trace["retraced"],
                               mismatched_pairs=mismatched)
            if trace["retraced"]:
                # Where the records one side's first trace lacked lay in
                # the other side's order, and what each side's second trace
                # made of it.
                print(f"{label}: {key}: a first trace lacked records "
                      f"([side, position, lost, records in all]) "
                      f"{trace['missing']}; each side traced twice, pairs "
                      f"{trace['tries']}, decode kernels by pair (the "
                      f"wrapper's count, the eager and replay sides') "
                      f"{decode_pairs}", flush=True)
            if trace["tries"] > 1:
                print(f"{label}: {key}: traced again, the pairs before "
                      f"differed by (replay less eager) {mismatched}; "
                      f"decode kernels by pair (the wrapper's count, the "
                      f"eager and replay traces') {decode_pairs}, "
                      f"{trace['padding']} padding kernels each side",
                      flush=True)
            replayed = add_counts(replayed, window, k["replays"])
    total = add_counts(eager, replayed)
    launches = total["launches"]
    forwards = len(eager_tokens) + sum(
        runner.window_keys()[key][1] * t["replays"]
        for key, t in traced.items())
    print(f"{label}: {len(outs)} requests, {sum(prompt_lens)} prompt "
          f"tokens, {sum(lens)} generated tokens in {wall:.2f} s; "
          f"{pt['prefill_iterations']} prefill/mixed steps "
          f"({rates['prefill_tok_s']:.1f} prefill tok/s, "
          f"{pt['prefill_s'] / max(pt['prefill_iterations'], 1) * 1e3:.1f} "
          f"ms per step), {pt['decode_iterations']} decode steps "
          f"({rates['decode_tok_s']:.1f} decode tok/s, "
          f"{pt['decode_s'] / max(pt['decode_iterations'], 1) * 1e3:.1f} ms "
          f"per step); {forwards} forwards ({len(eager_tokens)} eager); "
          f"launches {launches} ({replayed.get('launches', {})} of them in "
          f"graph replays), attention launches by page type "
          f"{total['by_dtype']}, by shape {total['by_shape']}", flush=True)
    if moe and not sum(k["replays"] for k in windows["graphs"].values()):
        fail(f"no decode window of the {label} was a graph replay")
    for name, n in launches.items():
        # (On the history path every decode step is a single step: the
        # ragged kernel's, held above; so is every decode step at a
        # head_dim the decode kernel does not take.)
        if n <= 0 and not ((sampler == "history" or ragged_decode)
                           and name == "paged_decode_attention"):
            fail(f"{name} was never launched on the {label}")
    windows["traced_replays"] = traced
    print(f"{label}: decode windows {json.dumps(windows)}", flush=True)
    dummy = set(getattr(model, "dummy_token_ids", []))
    for o in outs:
        if not all(0 <= t < vocab for t in o.outputs[0].token_ids):
            fail("generated token id out of the vocabulary")
        if dummy & set(o.outputs[0].token_ids):
            fail(f"a dummy token was generated on the {label}")
    rates["windows"] = windows
    rates["token_ids"] = [o.outputs[0].token_ids for o in outs]
    if sampler == "history-free":
        rates["rerun"] = rerun_alone(llm, label, prompts, params, outs)
    if sampler == "history":
        rates["history_rows_held"] = check_history_path(
            label, prompts, outs, params, reference, vocab)
        rates["prompt_logprob_err"] = check_prompt_logprobs(
            llm, label, prompts, outs, device)
    if serve_reference:
        rates["serve_reference"] = serve_reference_requests(llm)
    if window_check:
        rates["window_check"] = check_window(
            runner, label, prompt_lens, num_scheduler_steps,
            params if sampler == "history-free" else None)
    if moe:
        rates["moe"] = moe_checks(llm, label, device)
        if window_check:
            # The capacity form's share of a graphed window: its time at
            # the window's 32 rows, a layer and a step.
            share = (rates["moe"]["capacity"]["ms"] * layers * W
                     / rates["window_check"]["graphed_ms"])
            rates["moe"]["window_share"] = share
            # The window's weight-byte floor: each of its W forwards reads
            # every weight once (the capacity form reads every expert),
            # but the embedding, which it gathers by row.
            read = {k: v for k, v in runner.params.items()
                    if k != "embed" or model.tie_word_embeddings}
            weight_bytes = sum(t.numel() * t.element_size()
                               for t in leaves(read))
            rates["moe"]["window_floor_ms"] = (W * weight_bytes
                                               / HBM_BYTES_PER_S * 1e3)
            print(f"{label}: the grouped product's capacity form takes "
                  f"about {share:.1%} of a graphed window "
                  f"({rates['moe']['capacity']['ms']:.3f} ms x {layers} "
                  f"layers x {W} steps of "
                  f"{rates['window_check']['graphed_ms']:.2f} ms); the "
                  f"window's weight-byte floor {W} x "
                  f"{weight_bytes / 1e9:.2f} GB at 3.35 TB/s = "
                  f"{rates['moe']['window_floor_ms']:.1f} ms", flush=True)
    # What this path adds is compared: the attention kernels (on its page
    # type) unless the cache is bf16 and the weights quantized, then their
    # matmul. (Not on the sampler paths: see above.)
    if sampler is None:
        what = "attention"
        if page_type == "bf16" and (quantization or gguf) and not moe:
            what = ("w4a8" if w4a8 else "int4" if packed_gguf else
                    "q4" if gguf else {"gptq": "int4", "int8": "int8",
                                       "fp8": "fp8"}[quantization])
        # With blocksparse, contexts past the local window of 16 64-key
        # blocks.
        lens = compare_lens or ([1500, 1100, 300]
                                if model.blocksparse_params is not None
                                else [300, 17, 129])
        compare_logits(llm, device, rng, vocab, what, q4_body or INT4_BODY,
                       lens, compare_layers, f64_floor=moe or f64_floor)
        if quantization == "fp8":
            # The check above holds the quantizer kernel with the e4m3
            # product on both sides; this one the whole product against its
            # plain version, at every site on the plain run's inputs.
            compare_logits(llm, device, rng, vocab, "fp8 exact", INT4_BODY)
    qlinear_mod.int4_matmul = int4_matmul
    if w4a8:
        if saved_switch is None:
            del os.environ["APHRODITE_W4_A8"]
        else:
            os.environ["APHRODITE_W4_A8"] = saved_switch

    def named(c):
        """Counts (read_counts) by the kernel variant names of the kernels
        line."""
        out = {variant_name(name, page_type) if name in attention_names
               else name: n for name, n in c.get("launches", {}).items()}
        if w4a8:
            out["int4p_matmul"] = c.get("w4a16", 0)
        for prefix, key in (("int4_matmul", "by_body"),
                            ("int4p_matmul", "packed_by_body"),
                            ("fp8_w8a8_matmul", "fp8_by_body")):
            for body, n in c.get(key, {}).items():
                out[f"{prefix}_{body}"] = n
        for name, counts in c.get("by_shape", {}).items():
            out[f"{variant_name(name, page_type)} by shape"] = counts
        return out

    launches = named(total)
    # The part of each count that the decode windows' graph replays made:
    # replays x the launches of one window of the key (trace_launches).
    launches[IN_GRAPH_REPLAYS] = named(replayed)
    return launches, rates


def check_longrope(model, scaling, label):
    """Fail unless the model rotates by the table LongRoPE gives at its
    served length, over its rotary width (an MLA model's rope dims): past
    the original length the long factors' table with the attention
    factor, and not the short factors'; up to it the short factors' table
    unscaled, and not the long factors'."""
    import math

    import torch

    cos = model._cos.cpu()
    dim = getattr(model, "rope_dim", model.head_dim)
    orig = scaling["original_max_position_embeddings"]
    past = model.max_position > orig
    base = 1.0 / (model.rope_theta**(
        np.arange(0, dim, 2, dtype=np.float64) / dim))
    factor = (math.sqrt(1.0 + math.log(model.max_position / orig)
                        / math.log(orig)) if past else 1.0)
    positions = np.arange(model.max_position, dtype=np.float64)

    def table(factors):
        inv_freq = base / np.asarray(scaling[factors], np.float64)
        return torch.tensor(np.cos(positions[:, None] * inv_freq[None, :])
                            * factor, dtype=torch.float32)

    mine, other = ("long_factor", "short_factor")[::1 if past else -1]
    if not torch.equal(cos, table(mine)) or torch.equal(cos, table(other)):
        fail(f"{label}: the rotary table is not the {mine}s' one")
    print(f"{label}: LongRoPE over {dim} dims, the {mine}s' table at "
          f"{model.max_position} positions (original {orig}), attention "
          f"factor {factor:.6f}", flush=True)


def rerun_alone(llm, label, prompts, params, outs):
    """Requests of the history-free path re-run alone (another sequence
    bucket, no chunked prefill mixed with other prompts). Request 12
    (temperature 1000, so its draws are its noise's) must draw the tokens
    it drew in the batch. Request 1 (top-k 50, top-p 0.9) is reported:
    on the card the forward's last bits depend on the batch's shapes (the
    kernels' plans follow T and S), and a near tie of its noised logits
    can then go the other way."""
    out = {}
    for row in (12, 1):
        inside = outs[row].outputs[0].token_ids
        alone = llm.generate(prompt_token_ids=[prompts[row]],
                             sampling_params=params[row])[0].outputs[
                                 0].token_ids
        prefix = next((k for k, (a, b) in enumerate(zip(alone, inside))
                       if a != b), len(inside))
        out[row] = dict(equal=alone == inside, equal_prefix=prefix)
        print(f"{label}: request {row} (seed {params[row].seed}, "
              f"temperature {params[row].temperature}) re-run alone: "
              f"{'the same' if alone == inside else 'other'} tokens as in "
              f"the batch (the first {prefix} of {len(inside)} equal)",
              flush=True)
    if not out[12]["equal"]:
        fail(f"{label}: a seeded request draws other tokens alone than in "
             "the batch")
    return out


def add_counts(a, b, times=1):
    """a + times x b, for launch counts and (nested) dicts of them; an
    empty dict stands for no counts."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: add_counts(a.get(k, 0), b.get(k, 0), times)
                for k in dict.fromkeys([*a, *b])}
    return a + times * b


def window_stats(runner, graphs_before, hits_before):
    """The decode windows of a run: for each key (``graph_stats``) its
    warm-ups, captures and replays in the run and since the engine
    started, the capture seconds and the memory its capture reserved; and
    the chained windows taken, carries reused and sampling tensors reused
    in the run."""
    graphs = {}
    for key, st in runner.graph_stats().items():
        before = graphs_before.get(key, {})
        graphs[key] = dict(
            warmups=st["warmups"] - before.get("warmups", 0),
            captures=st["captures"] - before.get("captures", 0),
            replays=st["replays"] - before.get("replays", 0),
            warmups_total=st["warmups"], captures_total=st["captures"],
            capture_s=round(st["capture_s"], 3),
            pool_bytes=st["pool_bytes"])
    return dict(
        graphs=graphs,
        chained_window_hits=runner.chained_window_hits - hits_before[
            "chained"],
        carry_hits=runner.carry_hits - hits_before["carry"],
        sampling_cache_hits=runner.sampling_cache_hits - hits_before[
            "sampling_cache"])


def check_window(runner, label, prompt_lens, num_scheduler_steps,
                 params=None):
    """One decode window of the 16 prompts' rows (bucket 32, kv lengths
    the prompts' lengths, random cache pages and tokens from the seed;
    greedy, or each row sampled by its `params`, its key from the seed)
    through the runner's CUDA graph and through the eager window function
    on the same cache, carry and sampling tensors: the packed outputs and
    carries must be equal bit for bit. Then the median of 10 windows each
    way, after 2, the fetch to the host included; and a profile of 3
    graphed windows."""
    from aphrodite_tpu_torch.tools.window_check import (WindowCase,
                                                        equal_windows,
                                                        profile_ops,
                                                        profile_windows)

    W = min(num_scheduler_steps, runner.MULTI_STEP_WINDOW)
    case = WindowCase(runner, 32, [int(n) for n in prompt_lens], W, SEED,
                      params=params)
    eager = case.windows("eager", 2)
    graphed = case.windows("graphed", 2)
    if not equal_windows(eager, graphed):
        fail(f"the graphed decode window on the {label} differs from the "
             "eager window")
    out = dict(S=32, rows=len(prompt_lens), W=W,
               graphed_ms=case.time_ms("graphed"),
               eager_ms=case.time_ms("eager"))
    print(f"{label}: a decode window of {W} steps, {len(prompt_lens)} rows "
          f"in bucket 32: graphed equal to eager bit for bit (2 windows in "
          f"a row); {out['graphed_ms']:.2f} ms graphed, "
          f"{out['eager_ms']:.2f} ms eager (median of 10)", flush=True)
    # Where a graphed window's device time goes (torch.profiler).
    out["profile"] = profile_windows(case)
    print(f"{label}: graphed window profile {json.dumps(out['profile'])}",
          flush=True)
    if hasattr(runner.model, "kv_rank"):
        out["mla_glue"] = mla_glue(runner.model, profile_ops(case), label)
    return out


def mla_glue(model, ops, label):
    """An MLA model's eager window by op (tools/window_check.py
    profile_ops): the device time of the MLA glue around its attention
    (the low-rank q and kv products, the two einsums that absorb kv_b,
    the pads and concatenations) beside the attention kernel's and the
    window's, and the ops that take the most."""
    H, NH = model.hidden_size, model.num_heads
    low_rank = {str([model.q_rank, NH * model.qk_dim]), str([H, model.q_rank]),
                str([H, model.kv_rank + model.rope_dim])}
    total = sum(ops.values())
    parts = {"low-rank products": 0.0, "absorbing einsums": 0.0,
             "pads and concatenations": 0.0, "attention kernel": 0.0}
    for (name, shapes), ms in ops.items():
        if name in ("aten::mm", "aten::addmm") and any(
                w in shapes for w in low_rank):
            parts["low-rank products"] += ms
        elif name == "aten::bmm":
            parts["absorbing einsums"] += ms
        elif name in ("aten::constant_pad_nd", "aten::cat"):
            parts["pads and concatenations"] += ms
        elif "ragged_paged_attention_kernel" in name:
            parts["attention kernel"] += ms
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
    out = dict(eager_device_ms=total,
               parts_ms={k: round(v, 3) for k, v in parts.items()},
               shares={k: round(v / total, 4) for k, v in parts.items()},
               top=[[name[:60], shapes[:80], round(ms, 3)]
                    for (name, shapes), ms in top])
    print(f"{label}: an eager window by op (device ms; the MLA glue beside "
          f"the attention kernel) {json.dumps(out)}", flush=True)
    return out


# The grouped expert product of the MoE paths (ops/moe.py, plain PyTorch:
# the JAX package computes it with XLA's ragged_dot, outside any Pallas
# kernel, so it has no row in the kernels line). Both forms are held
# against a plain product that takes each token through each of its k
# experts in f32 (silu(gate) * up rounded to bf16, as the function
# defines it) and does not round its result, row by row: |form - plain| <=
# MOE_TOL * max|plain row|. The forms round their result to bf16 (half
# an ulp: up to 2^-8 of a value), and their f32 sums in another order may
# move an element of silu(gate) * up across a bf16 rounding step (2^-8 of
# one term of the down product); a token sent to a wrong expert, or with
# a wrong weight, misses by about 1/k of its row.
MOE_TOL = 2.0**-7
# The capacity form at the decode bucket of the paths' 16 requests, the
# loop form at a full prefill step (max_num_batched_tokens).
MOE_CAPACITY_T = 32
MOE_LOOP_T = 2048


def leaves(tree):
    """The tensors of a params tree (containers' members included)."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def moe_checks(llm, label, device):
    """Both forms of the grouped product on the card at the path's own
    shapes, on layer 0's experts (experts_int8: dequantized as the forward
    does) and router, x random from the seed: the capacity form at
    MOE_CAPACITY_T tokens, the loop form at MOE_LOOP_T, each against
    moe.plain_expert_mlp within MOE_TOL of a row. Then each form's ms (the
    loop form's with its host read of the group sizes and its launches,
    as an eager step pays them), the plain product's, and the bound: the
    bytes of the experts the routing touches, x and the result, or the
    routed rows' operations at the bf16 peak. With experts_int8, the ms
    of one layer's dequantization too."""
    import torch

    from aphrodite_tpu_torch.models.mixtral import layer_experts
    from aphrodite_tpu_torch.ops import moe

    runner = llm.engine.runner
    model, lp = runner.model, runner.params["layers"]
    stacks = [layer_experts(lp[n], 0) for n in ("w1", "w3", "w2")]
    experts = [moe.materialize_experts(w, model.dtype) for w in stacks]
    H, F, k = model.hidden_size, model.intermediate_size, model.top_k
    item = model.dtype.itemsize
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    out = {}
    for form, T, fn, iters in (
            ("capacity", MOE_CAPACITY_T, moe.capacity_expert_mlp, 20),
            ("loop", MOE_LOOP_T, moe.loop_expert_mlp, 5)):
        x = torch.randn((T, H), generator=gen, device=device).to(model.dtype)
        with torch.inference_mode():
            weights, ids = model.route(lp["router"][0], x)
            got = fn(x, *experts, weights, ids)
            want = moe.plain_expert_mlp(x, *experts, weights, ids)
        if not bool(got.isfinite().all()) or got.shape != x.shape:
            fail(f"the {form} form on the {label} gave {tuple(got.shape)} "
                 "or values that are not finite")
        ratio = row_ratio(got.float(), want)
        touched = int(ids.unique().numel())
        moved = touched * 3 * H * F * item + 2 * T * H * item
        ops = 2 * T * k * 3 * H * F
        bound_ms = max(moved / HBM_BYTES_PER_S, ops / BF16_FLOPS) * 1e3
        with torch.inference_mode():
            ms = time_ms(lambda: fn(x, *experts, weights, ids), iters)
            plain_ms = time_ms(
                lambda: moe.plain_expert_mlp(x, *experts, weights, ids), 2)
        out[form] = dict(
            T=T, routed_rows=T * k, experts_touched=touched,
            experts=model.num_experts, max_err_over_row_max=ratio,
            max_abs_err=float((got.float() - want).abs().max()),
            tolerance=MOE_TOL, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=("bytes" if moved / HBM_BYTES_PER_S >= ops / BF16_FLOPS
                      else "operations"))
        print(f"{label}: grouped product, {form} form, T {T} (k {k}, "
              f"{touched} of {model.num_experts} experts touched): worst "
              f"row err / max|row| {ratio:.3e} against the plain per-token "
              f"product (tolerance {MOE_TOL:.1e}); {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
              f"({out[form]['bound_by']})", flush=True)
        if ratio > MOE_TOL:
            fail(f"the {form} form of the grouped product on the {label} "
                 "disagrees with the plain per-token product")
    if any(isinstance(w, dict) for w in stacks):
        # experts_int8: read int8 levels and scales, write the model dtype.
        moved = sum(w["q"].numel() * (1 + item) + w["scale"].numel() * 4
                    for w in stacks)
        with torch.inference_mode():
            ms = time_ms(lambda: [moe.materialize_experts(w, model.dtype)
                                  for w in stacks], 5)
        out["materialize"] = dict(ms=ms,
                                  bound_ms=moved / HBM_BYTES_PER_S * 1e3)
        print(f"{label}: experts_int8 dequantization of one layer's three "
              f"stacks {ms:.3f} ms (bound {out['materialize']['bound_ms']:.3f}"
              f" ms); per forward x {model.num_layers} layers", flush=True)
    return out


def compare_logits(llm, device, rng, vocab, what, q4_body,
                   lens=(300, 17, 129), layers=None, f64_floor=False):
    """One prefill forward (ragged kernel) of sequences of `lens` tokens
    and one decode forward (decode kernel) with every kernel, then the same
    with the plain version of one
    of them on the same inputs and the same starting cache (of the
    engine's page type, written through its scales); logits compared
    within LOGIT_TOL of a row, argmax equal. `what` names the kernels
    swapped for their plain versions: "attention" (both attention
    kernels), "int4" (the packed int4 matmul), "q4" (the unpacked one,
    which runs its body q4_body), "w4a8" (both packed products: the decode
    forward has 16 rows, so that it takes W4A8 too, and a third forward,
    a decode of 8 rows, takes W4A16; each forward's launches are held to
    that route), "int8" (int8 weight-only), "fp8" (the activation
    quantizer of FP8 W8A8; the e4m3 product on both sides) or "fp8 exact"
    (the whole FP8 W8A8 product against its plain version: the plain run
    also launches the product at every site on that run's own inputs and
    holds it at INT4_TOL_SAME). layers: the forwards run the model's
    first `layers` layers only (its own weights and cache), for a model
    whose random weights make its full depth chaotic (COMPARE_LAYERS).
    f64_floor (with "attention"): a third run takes the plain attention in
    f64 (tools/logits_floor.py: plain_f64), and argmax is held on the rows
    whose plain top two lie more than twice that run's largest change
    apart, as on the fp8 and w4a8 paths: an MoE router turns a rounding
    difference into another expert now and then, so a near tie there is
    decided by no rounding."""
    import torch

    import aphrodite_tpu_torch.models.deepseek as deepseek_mod
    import aphrodite_tpu_torch.models.llama as llama_mod
    import aphrodite_tpu_torch.ops.quant_matmul as quant_matmul_mod
    import aphrodite_tpu_torch.quantization.qlinear as qlinear_mod
    from aphrodite_tpu_torch.ops.quant_matmul import (
        dequantize_int4, fp8_w8a8_matmul_ref, int4_matmul_ref, int4p_body,
        int4p_matmul, int4p_matmul_ref, int4p_matmul_w4a8,
        int4p_matmul_w4a8_ref, int8_matmul_ref, quantize_activations_e4m3,
        quantize_activations_int8, unpack_int4_rows)
    from aphrodite_tpu_torch.models.interface import ForwardBatch
    from aphrodite_tpu_torch.ops.attention import ref_ragged_paged_attention
    from aphrodite_tpu_torch.ops.decode_attention import (
        MASK_VALUE, ref_paged_decode_attention)
    from aphrodite_tpu_torch.tools.logits_floor import plain_f64

    runner = llm.engine.runner
    model, params = runner.model, runner.params
    S, T = (16 if what == "w4a8" else 8), -(-sum(lens) // 512) * 512
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
    forwards = {"prefill": prefill, "decode": decode}
    if what == "w4a8":
        # The first 8 rows of the decode batch: under 16 tokens the switch
        # keeps the W4A16 product.
        forwards["decode T=8"] = ForwardBatch(
            *(None if v is None else v[:8] for v in decode[:6]),
            decode.num_seqs, decode.logits_indices[:8])
    base = runner.kv_cache[:, :next_page].clone()
    # Launches of the two packed products in each forward of a run.
    routed = {}

    def run():
        runner.kv_cache[:, :next_page] = base
        logits = []
        depth = model.num_layers
        model.num_layers = layers or depth
        try:
            with torch.inference_mode():
                for name, batch in forwards.items():
                    before = (int4p_matmul_w4a8.launches,
                              int4p_matmul.launches)
                    h = model.forward(params, runner.kv_cache, batch,
                                      runner.kv_scales)
                    logits.append(model.compute_logits(
                        params, h[batch.logits_indices])[:len(lens)])
                    routed[name] = (int4p_matmul_w4a8.launches - before[0],
                                    int4p_matmul.launches - before[1])
        finally:
            model.num_layers = depth
        return logits

    def plain_attention(q, kv_pages, kv_lens, page_indices, cu_q_lens,
                        num_seqs, decode_cu_q_lens=None, **kw):
        if cu_q_lens is None:
            return ref_paged_decode_attention(q, kv_pages, kv_lens,
                                              page_indices, **kw)
        return ref_ragged_paged_attention(q, kv_pages, kv_lens, page_indices,
                                          cu_q_lens, num_seqs, **kw)

    def plain_int4(x, q4p, scale, zero, group, layer_idx=None):
        # The arithmetic of the body the kernel takes at this T. Under
        # DENSE_MIN_T tokens (the group-wise body) f32 x, on which the plain
        # version keeps the dequantized weight in f32; from there (the
        # prefill body) bf16 x, on which it rounds the weight to bf16 as
        # that body does. The other rounding moves a logit by about 1 % of
        # the row's largest and can swap two near-equal logits of a
        # random-weight model.
        if int4p_body(x.shape[0]) == "groupwise":
            x = x.float()
        return int4p_matmul_ref(x, q4p[layer_idx], scale[layer_idx],
                                zero[layer_idx], group)

    def plain_q4(x, q4, scale, zero, group, layer_idx=None):
        # Where the kernel runs its dense body, which rounds the
        # dequantized weight to bf16 as the plain version does on bf16 x,
        # x stays bf16; for the group-wise body f32 x, as above.
        if q4_body != "dense":
            x = x.float()
        return int4_matmul_ref(x, q4[layer_idx], scale[layer_idx],
                               zero[layer_idx], group)

    def plain_w4a8(x, q4p, scale, zero, group, layer_idx=None):
        return int4p_matmul_w4a8_ref(x, q4p[layer_idx], scale[layer_idx],
                                     zero[layer_idx], group)

    def plain_int8(x, q, scale, layer_idx=None):
        return int8_matmul_ref(x, q[layer_idx], scale[layer_idx])

    site_ratios = []

    def plain_fp8(x, q, scale, layer_idx=None):
        # The product at this site on the plain run's own inputs, held
        # after the run.
        want = fp8_w8a8_matmul_ref(x, q[layer_idx], scale[layer_idx])
        site_ratios.append(row_ratio(
            kernels[0](x, q, scale, layer_idx=layer_idx), want))
        return want

    def plain_quantizer(x, fmt):
        xq, scale = (quantize_activations_int8 if fmt == "int8"
                     else quantize_activations_e4m3)(x)
        return (xq.to(torch.float16) if fmt == "e4m3_f16" else xq), scale

    def reordered_fp8(x, q, scale, layer_idx=None):
        # The plain product with the same exact e4m3 products summed in
        # another f32 order (K reversed): the fp8 path's floor.
        xq, act_scale = quantize_activations_e4m3(x)
        q, scale = q[layer_idx], scale[layer_idx]
        return (torch.matmul(xq.float().flip(-1), q.float().flip(0))
                * act_scale * scale)

    def reordered_w4a8(x, q4p, scale, zero, group, layer_idx=None):
        # The plain W4A8 product with its sums in another f32 order (K
        # reversed): the w4a8 path's floor.
        xq, sx = quantize_activations_int8(x)
        w = dequantize_int4(unpack_int4_rows(q4p[layer_idx]),
                            scale[layer_idx], zero[layer_idx], group)
        return torch.matmul(xq.float().flip(-1), w.flip(0)) * sx

    def reordered_int4(x, q4p, scale, zero, group, layer_idx=None):
        # plain_int4 with K reversed (the W4A16 forward of the w4a8 path).
        w = dequantize_int4(unpack_int4_rows(q4p[layer_idx]),
                            scale[layer_idx], zero[layer_idx], group)
        return torch.matmul(x.float().flip(-1), w.flip(0))

    swaps = {
        "attention": [(llama_mod, "ragged_paged_attention", plain_attention),
                      (deepseek_mod, "ragged_paged_attention",
                       plain_attention)],
        "int4": [(qlinear_mod, "int4p_matmul", plain_int4)],
        "q4": [(qlinear_mod, "int4_matmul", plain_q4)],
        "w4a8": [(qlinear_mod, "int4p_matmul_w4a8", plain_w4a8),
                 (qlinear_mod, "int4p_matmul", plain_int4)],
        "int8": [(qlinear_mod, "int8_matmul", plain_int8)],
        "fp8": [(quant_matmul_mod, "quantize_activations", plain_quantizer)],
        "fp8 exact": [(qlinear_mod, "fp8_w8a8_matmul", plain_fp8)]}[what]
    got = run()
    if what == "w4a8":
        # Four products per layer, by the route of the forward's T.
        n = 4 * model.num_layers
        want_routes = {"prefill": (n, 0), "decode": (n, 0),
                       "decode T=8": (0, n)}
        print(f"w4a8 routes (W4A8, W4A16 launches) by forward: {routed}",
              flush=True)
        if routed != want_routes:
            fail(f"W4A8 switch routed {routed}, not {want_routes}")
    kernels = [getattr(module, attr) for module, attr, _ in swaps]
    attention_kernels = [(module, module.ragged_paged_attention)
                         for module in (llama_mod, deepseek_mod)]
    for module, attr, plain in swaps:
        setattr(module, attr, plain)
    try:
        want = run()
        if what == "fp8 exact":
            qlinear_mod.fp8_w8a8_matmul = reordered_fp8
            floor = run()
        if what == "w4a8":
            qlinear_mod.int4p_matmul_w4a8 = reordered_w4a8
            qlinear_mod.int4p_matmul = reordered_int4
            w4a8_floor = run()
        if f64_floor:
            llama_mod.ragged_paged_attention = plain_f64
            deepseek_mod.ragged_paged_attention = plain_f64
            attention_floor = run()
    finally:
        for (module, attr, _), kernel in zip(swaps, kernels):
            setattr(module, attr, kernel)
        for module, kernel in attention_kernels:
            module.ragged_paged_attention = kernel
    dummy = list(getattr(model, "dummy_token_ids", []))
    if dummy:
        # Tokens the model never samples carry the mask value on both
        # sides; the comparison holds the other columns, whose largest
        # entry is then the row's scale.
        for g, w in zip(got, want):
            if not (bool((g[:, dummy] == MASK_VALUE).all())
                    and bool((w[:, dummy] == MASK_VALUE).all())):
                fail(f"{what}: dummy tokens' logits are not the mask value")
        keep = torch.ones(got[0].shape[-1], dtype=torch.bool,
                          device=got[0].device)
        keep[dummy] = False
        got = [g[:, keep] for g in got]
        want = [w[:, keep] for w in want]
        print(f"logits {what}: {len(dummy)} dummy tokens at the mask value "
              "on both sides, left out of the comparison", flush=True)
    tol = LOGIT_TOL
    # Rows whose argmax is held: all, or (fp8, w4a8) those the floor
    # decides.
    decided = [None] * len(forwards)
    if what == "fp8 exact":
        print(f"fp8 exact: {len(site_ratios)} products on the plain run's "
              f"inputs, worst row err / max|row| {max(site_ratios):.3e} "
              f"(tolerance {INT4_TOL_SAME:.3e})", flush=True)
        if max(site_ratios) > INT4_TOL_SAME:
            fail("an fp8 product of the main path disagrees with its plain "
                 "version")
        floor_ratio = max(row_ratio(f, w) for f, w in zip(floor, want))
        tol = max(LOGIT_TOL, FP8_FLOOR_FACTOR * floor_ratio)
        for i, (f, w) in enumerate(zip(floor, want)):
            top2 = w.topk(2, dim=-1).values
            change = float((f - w).abs().max())
            decided[i] = (top2[:, 0] - top2[:, 1]) > 2 * change
            print(f"logits fp8 floor {list(forwards)[i]} (plain, K "
                  f"reversed): worst row err / max|row| "
                  f"{row_ratio(f, w):.3e}, largest change {change:.3e}, "
                  f"argmax agreement "
                  f"{float((f.argmax(-1) == w.argmax(-1)).float().mean()):.2f}"
                  f"; argmax held on {int(decided[i].sum())} of "
                  f"{len(decided[i])} rows", flush=True)
    if what == "w4a8":
        # The logits tolerance stays LOGIT_TOL; argmax is held on the rows
        # the floor decides, as on the fp8 path.
        for i, (f, w, g) in enumerate(zip(w4a8_floor, want, got)):
            top2 = w.topk(2, dim=-1).values
            change = float((f - w).abs().max())
            decided[i] = (top2[:, 0] - top2[:, 1]) > 2 * change
            print(f"logits w4a8 floor {list(forwards)[i]} (plain, K "
                  f"reversed): worst row err / max|row| "
                  f"{row_ratio(f, w):.3e}, largest change {change:.3e}, "
                  f"rows whose argmax the floor moves "
                  f"{(f.argmax(-1) != w.argmax(-1)).nonzero()[:, 0].tolist()}"
                  f", rows whose argmax the kernel moves "
                  f"{(g.argmax(-1) != w.argmax(-1)).nonzero()[:, 0].tolist()}"
                  f"; argmax held on {int(decided[i].sum())} of "
                  f"{len(decided[i])} rows", flush=True)
    if f64_floor:
        # The logits tolerance stays LOGIT_TOL; argmax is held on the rows
        # the f64 floor decides.
        for i, (f, w, g) in enumerate(zip(attention_floor, want, got)):
            top2 = w.topk(2, dim=-1).values
            change = float((f - w).abs().max())
            decided[i] = (top2[:, 0] - top2[:, 1]) > 2 * change
            print(f"logits attention floor {list(forwards)[i]} (plain in "
                  f"f64): worst row err / max|row| {row_ratio(f, w):.3e}, "
                  f"largest change {change:.3e}, rows whose argmax the "
                  f"floor moves "
                  f"{(f.argmax(-1) != w.argmax(-1)).nonzero()[:, 0].tolist()}"
                  f", rows whose argmax the kernel moves "
                  f"{(g.argmax(-1) != w.argmax(-1)).nonzero()[:, 0].tolist()}"
                  f"; argmax held on {int(decided[i].sum())} of "
                  f"{len(decided[i])} rows", flush=True)
    worst = 0.0
    for (name, g, w), held in zip(zip(forwards, got, want), decided):
        label = f"{what} {name}" + (f" ({layers} layers)" if layers else "")
        if not bool(g.isfinite().all()):
            fail(f"{label} logits are not finite")
        err = (g - w).abs().amax(-1)
        scale = w.abs().amax(-1)
        same = g.argmax(-1) == w.argmax(-1)
        agree = float(same.float().mean())
        print(f"logits {label}: max_abs_err {float(err.max()):.3e}, worst "
              f"row err / max|row| {float((err / scale).max()):.3e} "
              f"(tolerance {tol:.1e}), argmax agreement {agree:.2f}",
              flush=True)
        if not bool((err <= tol * scale).all()):
            fail(f"{label} logits with the kernel disagree with the "
                 "plain version's")
        if not bool(same.all() if held is None else same[held].all()):
            # For whoever reads the failure: how far below its own best
            # the plain version holds the token the kernel run picked,
            # beside the gap between the plain version's best two.
            behind = w.amax(-1) - w.gather(
                -1, g.argmax(-1, keepdim=True))[:, 0]
            top2 = w.topk(2, dim=-1).values
            fail(f"{label} logits with the kernel pick another token "
                 "than with the plain version (the pick lies "
                 f"{float(behind.max()):.3e} under the plain version's "
                 f"best; its best two lie {(top2[:, 0] - top2[:, 1]).tolist()}"
                 " apart)")
        worst = max(worst, float(err.max()))
    return worst


def probe_check():
    """The page-gather probe's kernel against its plain version at the
    probe's shapes, random and sequential page ids: equal, bit for bit
    (both sum each row exactly in f64 and the waves in f32 in one order).
    Returns the max abs error (0)."""
    import torch

    from aphrodite_tpu_torch.tools import probe_gather_bw as probe

    saved = os.environ.get("PROBE_SEQ")
    for sequential in ("0", "1"):
        os.environ["PROBE_SEQ"] = sequential
        kv_lens, pages, kv, _ = probe.make_inputs("cuda", SEED)
        got = probe.gather(kv_lens, pages, kv)
        want = probe.ref_gather(kv_lens, pages, kv)
        torch.cuda.synchronize()
        if not bool(got.isfinite().all()) or not torch.equal(got, want):
            fail(f"gather_probe (PROBE_SEQ={sequential}) differs from its "
                 "plain version")
        print(f"check gather_probe [PROBE_SEQ={sequential}, S {probe.S}, "
              f"kv_len {probe.KV_LEN}]: equal, bit for bit, to its plain "
              "version", flush=True)
        del kv
    if saved is None:
        del os.environ["PROBE_SEQ"]
    else:
        os.environ["PROBE_SEQ"] = saved
    return 0.0


def probe_path():
    """The probe's entry point (tools/probe_gather_bw.py: main) as a user
    runs it, with its launch count set to 0 just before and read just
    after. Returns the launches and the times main measured."""
    from aphrodite_tpu_torch.tools import probe_gather_bw as probe

    probe.gather.launches = 0
    times = probe.main()
    launches = probe.gather.launches
    if launches <= 0:
        fail("gather_probe was never launched on its entry point")
    print(f"probe path: gather_probe launched {launches} times", flush=True)
    return launches, times


# ----------------------------------------------------------------------
# The serving phase: `python -m aphrodite_tpu_torch run` on the north star
# ----------------------------------------------------------------------

# Llama-3.1's bos and eos ids, the serving tokenizer's special words.
SERVE_BOS, SERVE_EOS = 128000, 128001
SERVE_MAX_TOKENS = MAX_TOKENS
# The requests sent alone, first through LLM.generate on the north-star
# path's engine, then through the server: a 200-token prompt (one prefill
# chunk at either token budget, so both engines run the same shapes).
SERVE_ALONE_PROMPT_LEN = 200
SERVE_BEAM = dict(use_beam_search=True, best_of=4, n=2)
# The stream the client closes, after this many chunks.
SERVE_CLOSE_AFTER = 8
SERVE_HEALTH_TIMEOUT_S = 600


def write_word_tokenizer(path: str, vocab_size: int) -> None:
    """A tokenizer of vocab_size words, written with the tokenizers
    package (nothing is downloaded): token i is the word "w<i>", words are
    split at whitespace, an unknown word is token 0, bos and eos are
    Llama-3.1's ids, and there is no chat template, so the server's
    fallback template applies. Generated text is the words of its tokens,
    one per token."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {f"w{i}": i for i in range(vocab_size)}
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="w0"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": f"w{SERVE_BOS}",
                   "eos_token": f"w{SERVE_EOS}",
                   "unk_token": "w0", "model_max_length": 131072}, f)


def serve_words(rng, n, vocab):
    """n token ids that are no special word, and their text."""
    ids = rng.integers(1, SERVE_BOS, n).tolist()
    return ids, " ".join(f"w{t}" for t in ids)


def serve_alone_prompt(vocab):
    return serve_words(np.random.default_rng(SEED + 16),
                       SERVE_ALONE_PROMPT_LEN, vocab)[0]


def serve_reference_requests(llm):
    """The serving phase's greedy request (with the sampled token's
    logprob at each step) and its beam request, each alone through
    LLM.generate: their text, tokens and logprobs, which the server must
    give again bit for bit."""
    from aphrodite_tpu_torch import SamplingParams

    prompt = serve_alone_prompt(llm.engine.model_config.get_vocab_size())
    common = dict(temperature=0.0, max_tokens=SERVE_MAX_TOKENS,
                  ignore_eos=True)
    greedy = llm.generate(prompt_token_ids=[prompt], sampling_params=
                          SamplingParams(logprobs=1, **common))[0].outputs[0]
    beam = llm.generate(prompt_token_ids=[prompt], sampling_params=
                        SamplingParams(**SERVE_BEAM, **common))[0].outputs
    return dict(
        greedy=dict(text=greedy.text, token_ids=list(greedy.token_ids),
                    logprobs=[lp[t].logprob for t, lp in
                              zip(greedy.token_ids, greedy.logprobs)]),
        beam=[dict(text=c.text, token_ids=list(c.token_ids),
                   cumulative_logprob=c.cumulative_logprob) for c in beam])


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def card_pids():
    """{pid: MiB} of the processes nvidia-smi sees on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    pids = {}
    for line in out.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            pids[int(parts[0])] = parts[1]
    return pids


def card_maps(pid: int):
    """The card's device files that the process maps into its memory
    (/dev/nvidia0, /dev/nvidia-uvm; not the control device): a CUDA
    context's memory, which a process that only asked whether there is a
    card does not map."""
    names = set()
    with open(f"/proc/{pid}/maps") as f:
        for line in f:
            fields = line.split()
            if (len(fields) >= 6 and fields[5].startswith("/dev/nvidia")
                    and fields[5] != "/dev/nvidiactl"):
                names.add(fields[5])
    return sorted(names)


def running(pid: int) -> bool:
    """Whether the process exists and has not exited (a zombie has)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def percentiles(xs):
    return dict(median=float(np.percentile(xs, 50)),
                p90=float(np.percentile(xs, 90)))


async def serve_requests(base, vocab, prompt_lens):
    """The 16 concurrent requests (greedy completions, plain and
    streamed; seeded random ones; streamed chat; a beam request; a Kobold
    generate; a stream the client closes after SERVE_CLOSE_AFTER chunks),
    each of 64 new tokens. Returns each one's result and its stream
    timings."""
    import aiohttp

    from aphrodite_tpu_torch.endpoints.openai.protocol import (
        ChatCompletionStreamResponse, CompletionResponse)

    rng = np.random.default_rng(SEED + 17)
    prompts = [serve_words(rng, int(n), vocab) for n in prompt_lens]
    common = dict(max_tokens=SERVE_MAX_TOKENS, ignore_eos=True)
    kinds = (["greedy"] * 3 + ["greedy stream"] * 4 + ["seeded"] * 3
             + ["chat stream"] * 2 + ["beam", "kobold", "closed stream",
                                      "greedy"])

    async def sse(resp, parse, close_after=None):
        """(chunks, the seconds at which each arrived)."""
        chunks, times = [], []
        async for raw in resp.content:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                break
            chunks.append(parse(**json.loads(data)))
            times.append(time.monotonic())
            if close_after is not None and len(chunks) >= close_after:
                resp.close()
                break
        return chunks, times

    async def one(session, i, kind):
        ids, text = prompts[i]
        t0 = time.monotonic()
        out = dict(kind=kind, prompt_len=len(ids))
        if kind in ("greedy", "seeded", "beam"):
            body = dict(prompt=ids, temperature=0.0, **common)
            if kind == "seeded":
                body.update(temperature=0.8, top_p=0.95, seed=1000 + i)
            if kind == "beam":
                body.update(SERVE_BEAM)
            async with session.post(base + "/v1/completions",
                                    json=body) as resp:
                if resp.status != 200:
                    fail(f"serving: {kind} request {i} answered "
                         f"{resp.status}: {await resp.text()}")
                r = CompletionResponse(**await resp.json())
            out["texts"] = [c.text for c in r.choices]
            out["finish"] = [c.finish_reason for c in r.choices]
        elif kind in ("greedy stream", "closed stream"):
            body = dict(prompt=ids, temperature=0.0, stream=True, **common)
            async with session.post(base + "/v1/completions",
                                    json=body) as resp:
                chunks, times = await sse(
                    resp, CompletionResponse,
                    SERVE_CLOSE_AFTER if kind == "closed stream" else None)
            out["texts"] = ["".join(c.choices[0].text for c in chunks)]
            out["finish"] = [chunks[-1].choices[0].finish_reason]
            out["chunks"] = len(chunks)
            first = next(t for t, c in zip(times, chunks)
                         if c.choices[0].text)
            out["ttft_s"], out["last_s"] = first - t0, times[-1] - t0
        elif kind == "chat stream":
            body = dict(messages=[{"role": "user", "content": text}],
                        temperature=0.0, stream=True, **common)
            async with session.post(base + "/v1/chat/completions",
                                    json=body) as resp:
                chunks, times = await sse(resp, ChatCompletionStreamResponse)
            out["texts"] = ["".join(c.choices[0].delta.content or ""
                                    for c in chunks)]
            out["finish"] = [chunks[-1].choices[0].finish_reason]
            first = next(t for t, c in zip(times, chunks)
                         if c.choices[0].delta.content)
            out["ttft_s"], out["last_s"] = first - t0, times[-1] - t0
        else:  # kobold
            body = dict(prompt=text, max_length=SERVE_MAX_TOKENS,
                        temperature=0.0, use_default_badwordsids=True)
            async with session.post(base + "/api/v1/generate",
                                    json=body) as resp:
                if resp.status != 200:
                    fail(f"serving: Kobold request answered {resp.status}")
                out["texts"] = [(await resp.json())["results"][0]["text"]]
            out["finish"] = ["length"]
        out["seconds"] = time.monotonic() - t0
        return out

    timeout = aiohttp.ClientTimeout(total=SERVE_HEALTH_TIMEOUT_S)
    async with aiohttp.ClientSession(timeout=timeout) as session:
        results = await asyncio.gather(*[one(session, i, kind)
                                         for i, kind in enumerate(kinds)])
        # What the phase checks after the concurrent run: each alone, and
        # the small routes.
        async def post(route, body):
            async with session.post(base + route, json=body) as resp:
                return resp.status, await resp.json()

        async def get(route):
            async with session.get(base + route) as resp:
                return resp.status, await resp.text()

        status, stats = await get("/v1/internal/engine_stats")
        stats = json.loads(stats)
        alone_ids = serve_alone_prompt(vocab)
        alone = dict(temperature=0.0, prompt=alone_ids, **common)
        _, greedy = await post("/v1/completions", dict(alone, logprobs=1))
        async with session.post(base + "/v1/completions",
                                json=dict(alone, stream=True)) as resp:
            chunks, _ = await sse(resp, CompletionResponse)
        streamed = "".join(c.choices[0].text for c in chunks)
        _, beam = await post("/v1/completions", dict(alone, **SERVE_BEAM))
        checks = dict(
            greedy=CompletionResponse(**greedy), streamed=streamed,
            beam=CompletionResponse(**beam),
            metrics=await get("/metrics"),
            tokenize=await post("/v1/tokenize", {"prompt": "w5 w6 w7"}),
            detokenize=await post("/v1/detokenize", {"tokens": [5, 6, 7]}),
            unported=await post("/v1/chat/completions", {"messages": [
                {"role": "user", "content": [
                    {"type": "image_url",
                     "image_url": {"url": "data:image/png;base64,"}}]}]}),
            models=await get("/v1/models"))
    return results, stats, checks


def check_serving(results, stats, checks, reference, vocab, graphs=True):
    """Hold the serving phase's answers: every request's text is its 64
    tokens' words (the closed stream fewer), streamed text joined equals
    the same request's final text, the decode windows ran as graph
    replays, the greedy and beam requests sent alone equal LLM.generate's
    bit for bit, and the small routes answer. (graphs=False: on the CPU,
    which captures no graph.)"""
    for i, r in enumerate(results):
        for text, finish in zip(r["texts"], r["finish"]):
            words = text.split()
            if not all(w.startswith("w") and w[1:].isdigit()
                       and 0 <= int(w[1:]) < vocab for w in words):
                fail(f"serving: request {i} ({r['kind']}) gave text that "
                     f"is not the vocabulary's words: {text[:200]!r}")
            if r["kind"] == "closed stream":
                if not words or len(words) >= SERVE_MAX_TOKENS:
                    fail(f"serving: the closed stream got {len(words)} "
                         "tokens")
                continue
            if len(words) != SERVE_MAX_TOKENS or finish != "length":
                fail(f"serving: request {i} ({r['kind']}) gave "
                     f"{len(words)} tokens, finish {finish}")
        if r["kind"] == "beam" and len(r["texts"]) != SERVE_BEAM["n"]:
            fail(f"serving: the beam request gave {len(r['texts'])} "
                 "hypotheses")
    if graphs and stats.get("graph_replays", 0) <= 0:
        fail(f"serving: engine_stats shows no graph replay: {stats}")
    greedy = checks["greedy"].choices[0]
    ref = reference["greedy"]
    if greedy.text != ref["text"]:
        fail(f"serving: the greedy request alone gave {greedy.text[:200]!r},"
             f" LLM.generate {ref['text'][:200]!r}")
    if greedy.logprobs.token_logprobs != ref["logprobs"]:
        diff = max(abs(a - b) for a, b in zip(greedy.logprobs.token_logprobs,
                                              ref["logprobs"]))
        fail(f"serving: the greedy request's logprobs differ from "
             f"LLM.generate's by up to {diff}")
    if checks["streamed"] != ref["text"]:
        fail("serving: the greedy request streamed alone joined to "
             f"{checks['streamed'][:200]!r}, not its final text")
    beam = [c.text for c in checks["beam"].choices]
    if beam != [h["text"] for h in reference["beam"]]:
        fail(f"serving: the beam request alone gave {beam}, LLM.generate "
             f"{[h['text'] for h in reference['beam']]}")
    status, metrics = checks["metrics"]
    if status != 200 or "aphrodite:generation_tokens_total" not in metrics:
        fail("serving: /metrics has no generation token counter")
    if checks["tokenize"] != (200, {
            "tokens": [5, 6, 7], "count": 3,
            "max_model_len": LLAMA_8B["max_position_embeddings"]}):
        fail(f"serving: /v1/tokenize answered {checks['tokenize']}")
    if checks["detokenize"] != (200, {"prompt": "w5 w6 w7"}):
        fail(f"serving: /v1/detokenize answered {checks['detokenize']}")
    status, body = checks["unported"]
    if status != 400 or "not ported" not in body["error"]["message"]:
        fail(f"serving: an image chat part answered {status} {body}")
    if checks["models"][0] != 200:
        fail("serving: /v1/models did not answer")


def serving_phase(card, offline_rates, reference, device="cuda"):
    """`python -m aphrodite_tpu_torch run` on the north-star configuration
    (Llama-3.1-8B geometry, 32 layers, gptq, E4M3 cache, dummy weights from
    seed 0), its engine in a child process, warmed up before the port
    opens: the checks of check_serving, the card's memory held by the
    engine child alone, and SIGINT stopping both processes. Prints the
    streamed requests' time to first token and time per output token,
    the seconds to /health and of the warm-up, and the engine's rates.
    device="cpu" rehearses the phase on the CPU (with a smaller LLAMA_8B
    patched in), without the check of the card's memory."""
    import signal
    import urllib.request

    vocab = LLAMA_8B["vocab_size"]
    prompt_lens = np.random.default_rng(SEED).integers(
        16, 1025, size=NUM_REQUESTS)
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as td:
        write_model_dir(td, LLAMA_8B)
        write_word_tokenizer(td, vocab)
        port = free_port()
        log_path = os.path.join(td, "serve.log")
        log = open(log_path, "w")
        cmd = [sys.executable, "-m", "aphrodite_tpu_torch", "run", td,
               "--load-format", "dummy", "--quantization", "gptq",
               "--kv-cache-dtype", "fp8_e4m3", "--num-scheduler-steps", "8",
               "--warmup", "--port", str(port)] + (
                   ["--device", "cpu"] if device == "cpu" else [])
        t0 = time.monotonic()
        proc = subprocess.Popen(
            cmd, cwd=repo, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=repo), start_new_session=True)
        base = f"http://127.0.0.1:{port}"

        def log_tail():
            log.flush()
            with open(log_path) as f:
                return f.read()[-3000:]

        try:
            while True:
                try:
                    with urllib.request.urlopen(base + "/health",
                                                timeout=2) as resp:
                        if resp.status == 200:
                            break
                except OSError:
                    pass
                if proc.poll() is not None:
                    fail(f"serving: the server exited with {proc.returncode}"
                         f" before /health:\n{log_tail()}")
                if time.monotonic() - t0 > SERVE_HEALTH_TIMEOUT_S:
                    fail(f"serving: no /health in {SERVE_HEALTH_TIMEOUT_S} s:"
                         f"\n{log_tail()}")
                time.sleep(0.5)
            health_s = time.monotonic() - t0
            warm = [line for line in log_tail().splitlines()
                    if "warmup:" in line]
            children = [int(p) for p in subprocess.run(
                ["ps", "-o", "pid=", "--ppid", str(proc.pid)],
                capture_output=True, text=True).stdout.split()]
            maps = {p: card_maps(p) for p in [proc.pid, *children]}
            engine_pids = [p for p in children if maps[p]]
            on_card = card_pids() if device == "cuda" else {}
            # nvidia-smi decides where it names these processes; in another
            # pid namespace it names others, and the maps decide.
            ours = set(on_card) & set(maps)
            if device == "cpu":
                engine_pids = children
            elif (len(engine_pids) != 1 or maps[proc.pid]
                  or (ours and ours != set(engine_pids))):
                fail(f"serving: the card is held by {engine_pids} of the "
                     f"frontend {proc.pid}'s children {children} (device "
                     f"files mapped: {maps}; nvidia-smi: {on_card})")
            print(f"serving: /health after {health_s:.1f} s ({warm}); the "
                  f"engine child {engine_pids[0]} holds the card, the "
                  f"frontend {proc.pid} does not (device files mapped: "
                  f"{maps}; nvidia-smi: {on_card})", flush=True)
            t1 = time.monotonic()
            results, stats, checks = asyncio.run(
                serve_requests(base, vocab, prompt_lens))
            run_s = time.monotonic() - t1
            check_serving(results, stats, checks, reference, vocab,
                          graphs=device == "cuda")
            streams = [r for r in results
                       if r["kind"] in ("greedy stream", "chat stream")]
            ttft = percentiles([r["ttft_s"] for r in streams])
            tpot = percentiles([(r["last_s"] - r["ttft_s"])
                                / (SERVE_MAX_TOKENS - 1) for r in streams])
            serve_rates = dict(
                decode_tok_s=stats["decode_tokens"] / max(stats["decode_s"],
                                                          1e-9),
                prefill_tok_s=stats["prefill_tokens"]
                / max(stats["prefill_s"], 1e-9))
            summary = dict(
                card=card, health_s=round(health_s, 1), warmup=warm,
                requests=len(results), prompt_tokens=int(sum(prompt_lens)),
                concurrent_s=round(run_s, 2), ttft_s=ttft, tpot_s=tpot,
                streams=len(streams), engine=serve_rates,
                offline=dict(decode_tok_s=offline_rates["decode_tok_s"],
                             prefill_tok_s=offline_rates["prefill_tok_s"]),
                graph_replays=stats["graph_replays"],
                graph_captures=stats["graph_captures"],
                closed_stream_chunks=next(r["chunks"] for r in results
                                          if r["kind"] == "closed stream"))
            print(f"serving ({card}): " + json.dumps(summary), flush=True)
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                fail("serving: the frontend did not exit on SIGINT")
            deadline = time.monotonic() + 30
            while any(running(p) for p in children):
                if time.monotonic() > deadline:
                    fail(f"serving: the engine child {children} outlived "
                         "the frontend")
                time.sleep(0.2)
            return summary
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            log.close()


# ----------------------------------------------------------------------
# Encoder-decoder paths (slice 19)
# ----------------------------------------------------------------------

# The encoder prompts of the encoder-decoder paths: 16-512 tokens (T5's
# n_positions is 512).
ENCDEC_PROMPT_LENS = (16, 513)
# The logits comparison's encoder prompts and decoder prompts.
ENCDEC_COMPARE_ENC = (300, 17, 129)
ENCDEC_COMPARE_DEC = (9, 1, 23)


def encdec_batches(runner, rng, vocab, device):
    """Hand-built steps of the runner's model over the encoder prompts
    ENCDEC_COMPARE_ENC (their encoder passes run here, into the runner's
    cross cache) with decoder prompts ENCDEC_COMPARE_DEC: a prefill of the
    decoder prompts and the decode step after it (8 rows, 3 live), on
    pages from 0 up (the engine is idle between generate calls). Returns
    (the two ForwardBatch, the pages they use)."""
    import torch

    from aphrodite_tpu_torch.models.interface import ForwardBatch
    from aphrodite_tpu_torch.worker.model_runner import _pad_to_bucket

    bs, model = runner.block_size, runner.model
    S = 8
    t = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        np.asarray(a, np.int32))).to(device)
    next_page = 0
    width = -(-_pad_to_bucket(max(ENCDEC_COMPARE_ENC), runner.history_buckets)
              // bs)
    cross = np.zeros((S, width), np.int32)
    cross_lens = np.zeros((S,), np.int32)
    pages = np.zeros((S, runner.pages_per_seq), np.int32)
    for i, (E, n) in enumerate(zip(ENCDEC_COMPARE_ENC, ENCDEC_COMPARE_DEC)):
        npg = -(-E // bs)
        cross[i, :npg] = np.arange(next_page, next_page + npg)
        next_page += npg
        Ep = _pad_to_bucket(E, runner.history_buckets)
        tokens = np.zeros((Ep,), np.int32)
        tokens[:E] = rng.integers(0, vocab, E)
        pos = np.arange(Ep)
        pos[E:] = 0
        slots = runner.trash_slot_base + np.arange(Ep) % bs
        slots[:E] = cross[i, pos[:E] // bs] * bs + pos[:E] % bs
        model.encode_and_write_cross(runner.params, runner.cross_kv,
                                     t(tokens), t(pos), t(slots), E)
        cross_lens[i] = E
        npg = -(-(n + 1) // bs)
        pages[i, :npg] = np.arange(next_page, next_page + npg)
        next_page += npg
    T = 16 * -(-sum(ENCDEC_COMPARE_DEC) // 16)
    ids = np.zeros((T,), np.int32)
    pos = np.zeros((T,), np.int32)
    slots = runner.trash_slot_base + np.arange(T) % bs
    cu = np.zeros((S + 1,), np.int32)
    off = 0
    for i, n in enumerate(ENCDEC_COMPARE_DEC):
        p = np.arange(n)
        ids[off:off + n] = rng.integers(0, vocab, n)
        pos[off:off + n] = p
        slots[off:off + n] = pages[i, p // bs] * bs + p % bs
        cu[i + 1] = cu[i] + n
        off += n
    live = len(ENCDEC_COMPARE_DEC)
    cu[live + 1:] = cu[live]
    kv_lens = np.zeros((S,), np.int32)
    kv_lens[:live] = ENCDEC_COMPARE_DEC
    cross_t = (t(cross), t(cross_lens))
    prefill = ForwardBatch(t(ids), t(pos), t(slots), t(kv_lens), t(pages),
                           t(cu), t([live]),
                           t(np.pad(cu[1:live + 1] - 1, (0, S - live))),
                           *cross_t)
    dpos = np.zeros((S,), np.int32)
    dpos[:live] = ENCDEC_COMPARE_DEC
    dslots = runner.trash_slot_base + np.arange(S) % bs
    dslots[:live] = [pages[i, n // bs] * bs + n % bs
                     for i, n in enumerate(ENCDEC_COMPARE_DEC)]
    decode = ForwardBatch(t(rng.integers(0, vocab, S)), t(dpos), t(dslots),
                          t(np.where(np.arange(S) < live, dpos + 1, 0)),
                          t(pages), None, t([live]), t(np.arange(S)),
                          *cross_t)
    return {"prefill": prefill, "decode": decode}, next_page


def cross_attention_share(runner, batch):
    """The share of a traced decode forward's device time that its
    cross-attention takes (torch.profiler over one forward, each
    cross-attention call in a range: a kernel counts there when the host
    launched it inside one), and that device time in ms; (None, 0.0) where
    the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import aphrodite_tpu_torch.models.bart as bart_mod
    import aphrodite_tpu_torch.models.t5 as t5_mod

    model = runner.model
    module = t5_mod if isinstance(
        model, t5_mod.T5ForConditionalGeneration) else bart_mod
    inner = module.cross_attention

    def ranged(*args, **kwargs):
        with record_function("cross_attention"):
            return inner(*args, **kwargs)

    module.cross_attention = ranged
    try:
        with torch.inference_mode():
            model.forward(runner.params, runner.kv_cache, batch,
                          cross_kv=runner.cross_kv)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model.forward(runner.params, runner.kv_cache, batch,
                              cross_kv=runner.cross_kv)
                torch.cuda.synchronize()
    finally:
        module.cross_attention = inner
    events = list(prof.profiler.kineto_results.events())
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
              if e.name() == "cross_attention"
              and e.device_type() != DeviceType.CUDA]
    launch_at = {e.correlation_id(): e.start_ns() for e in events
                 if e.device_type() != DeviceType.CUDA
                 and "Launch" in e.name()}
    total = inside = 0
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        total += e.duration_ns()
        at = launch_at.get(e.correlation_id())
        if at is not None and any(a <= at <= b for a, b in ranges):
            inside += e.duration_ns()
    if not total:
        return None, 0.0
    return inside / total, total / 1e6


def compare_encdec_logits(llm, device, rng, vocab, layers=None):
    """The compare steps (encdec_batches) through the model with its
    attention kernels, then with their plain versions, then with the plain
    attention in f64 (tools/logits_floor.py: plain_f64), on the same inputs
    and the same starting cache: logits within LOGIT_TOL of each row, and
    argmax held on the rows whose plain top two lie more than twice the
    f64 run's largest change apart (random weights leave near ties, and a
    rounding in the attention output can swap them). The T5 model's
    self-attention kernel is the decode kernel with the T5 bias (its
    prefill is plain on both sides); BART's the ragged kernel and the
    decode kernel. layers: the decoder's first `layers` layers only
    (COMPARE_LAYERS), for a model whose random depth is chaotic; the
    floor at its full depth is printed beside. Returns the worst row
    error (relative to the row's largest logit) and the batches."""
    import torch

    import aphrodite_tpu_torch.models.bart as bart_mod
    import aphrodite_tpu_torch.models.t5 as t5_mod
    from aphrodite_tpu_torch.ops.attention import ref_ragged_paged_attention
    from aphrodite_tpu_torch.ops.decode_attention import \
        ref_paged_decode_attention
    from aphrodite_tpu_torch.tools.logits_floor import plain_f64

    runner = llm.engine.runner
    model = runner.model
    forwards, used = encdec_batches(runner, rng, vocab, device)
    base = runner.kv_cache[:, :used].clone()
    live = len(ENCDEC_COMPARE_DEC)
    depth = model.num_layers

    def run(n_layers):
        runner.kv_cache[:, :used] = base
        model.num_layers = n_layers
        out = []
        try:
            with torch.inference_mode():
                for batch in forwards.values():
                    h = model.forward(runner.params, runner.kv_cache, batch,
                                      cross_kv=runner.cross_kv)
                    out.append(model.compute_logits(
                        runner.params, h[batch.logits_indices])[:live])
        finally:
            model.num_layers = depth
        return out

    def plain_decode(q, kv_pages, kv_lens, page_indices, num_seqs=None,
                     **kw):
        return ref_paged_decode_attention(q, kv_pages, kv_lens, page_indices,
                                          **kw)

    def plain_attention(q, kv_pages, kv_lens, page_indices, cu_q_lens,
                        num_seqs, decode_cu_q_lens=None, **kw):
        if cu_q_lens is None:
            return plain_decode(q, kv_pages, kv_lens, page_indices, **kw)
        return ref_ragged_paged_attention(q, kv_pages, kv_lens, page_indices,
                                          cu_q_lens, num_seqs, **kw)

    def f64_decode(q, kv_pages, kv_lens, page_indices, num_seqs=None, **kw):
        return plain_f64(q, kv_pages, kv_lens, page_indices, None, **kw)

    if isinstance(model, t5_mod.T5ForConditionalGeneration):
        swaps = {"plain": [(t5_mod, "paged_decode_attention", plain_decode)],
                 "f64": [(t5_mod, "paged_decode_attention", f64_decode),
                         (t5_mod, "ref_ragged_paged_attention", plain_f64)]}
    else:
        swaps = {"plain": [(bart_mod, "ragged_paged_attention",
                            plain_attention)],
                 "f64": [(bart_mod, "ragged_paged_attention", plain_f64)]}

    def swapped(kind, n_layers):
        saved = [(m, a, getattr(m, a)) for m, a, _ in swaps[kind]]
        for m, a, fn in swaps[kind]:
            setattr(m, a, fn)
        try:
            return run(n_layers)
        finally:
            for m, a, fn in saved:
                setattr(m, a, fn)

    n = layers or depth
    got, want, floor = run(n), swapped("plain", n), swapped("f64", n)
    if layers:
        full = [row_ratio(f, w) for f, w in zip(swapped("f64", depth),
                                                 swapped("plain", depth))]
        print(f"logits encoder-decoder at all {depth} decoder layers: plain "
              f"attention in f32 and in f64 lie {max(full):.3e} of a row "
              f"apart (by step: {[f'{r:.3e}' for r in full]})", flush=True)
    worst = 0.0
    for name, g, w, f in zip(forwards, got, want, floor):
        label = f"encoder-decoder {name}" + (f" ({layers} layers)" if layers
                                             else "")
        if not bool(g.isfinite().all()):
            fail(f"{label} logits are not finite")
        err = (g - w).abs().amax(-1)
        ratio = float((err / w.abs().amax(-1)).max())
        top2 = w.topk(2, dim=-1).values
        change = float((f - w).abs().max())
        decided = (top2[:, 0] - top2[:, 1]) > 2 * change
        same = g.argmax(-1) == w.argmax(-1)
        print(f"logits {label}: max_abs_err {float(err.max()):.3e}, worst "
              f"row err / max|row| {ratio:.3e} (tolerance {LOGIT_TOL:.1e}), "
              f"argmax agreement {float(same.float().mean()):.2f}; the f64 "
              f"floor: worst row err / max|row| {row_ratio(f, w):.3e}, "
              f"largest change {change:.3e}; plain top-two gaps "
              f"{(top2[:, 0] - top2[:, 1]).tolist()}; argmax held on "
              f"{int(decided.sum())} of {live} rows", flush=True)
        if not bool((err <= LOGIT_TOL * w.abs().amax(-1)).all()):
            fail(f"{label} logits with the kernels disagree with the plain "
                 "versions'")
        if not bool(same[decided].all()):
            fail(f"{label} logits with the kernels pick another token than "
                 "with the plain versions on a row the floor decides")
        worst = max(worst, ratio)
    return worst, forwards


def encdec_path(device, model_config, kv_cache_dtype="auto",
                compare_layers=None):
    """LLM.generate of an encoder-decoder model (T5 or BART, from
    `model_config` with dummy bf16 weights from the seed) through the
    port's entry point: NUM_REQUESTS encoder prompts of ENCDEC_PROMPT_LENS
    tokens, MAX_TOKENS new tokens each, greedy, on a cache of
    kv_cache_dtype. Every forward runs eagerly (no decode window for these
    models). Holds the attention launches of the timed run: the decode
    kernel once a layer in every pure-decode step (with the T5 bias,
    "qg1 d64 rel_bias", for T5), and for BART the ragged kernel once a
    layer in every prefill or mixed step (T5's prefill is plain PyTorch),
    all on the cache's page type; times each encoder pass; then
    compare_encdec_logits (on the decoder's first compare_layers layers
    where given) and cross_attention_share on its decode step. Returns
    the launches (as main_path names them) and the rates."""
    import torch

    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.attention import ragged_paged_attention
    from aphrodite_tpu_torch.ops.decode_attention import \
        paged_decode_attention

    page_type = CACHE_PAGE_TYPES[kv_cache_dtype]
    arch = model_config["architectures"][0]
    t5 = arch.startswith("T5")
    layers = model_config.get("num_decoder_layers",
                              model_config.get("decoder_layers"))
    enc_layers = model_config.get("num_layers",
                                  model_config.get("encoder_layers"))
    label = (f"encoder-decoder path ({arch}, {kv_cache_dtype} cache, "
             f"{enc_layers} + {layers} layers)")
    vocab = model_config["vocab_size"]
    with tempfile.TemporaryDirectory() as td:
        t0 = time.monotonic()
        llm = LLM(model=write_model_dir(td, model_config),
                  load_format="dummy", dtype="bfloat16", seed=SEED,
                  kv_cache_dtype=kv_cache_dtype, block_size=PAGE_SIZE,
                  max_num_batched_tokens=2048, num_scheduler_steps=8,
                  skip_tokenizer_init=True, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"{label}: engine up in {time.monotonic() - t0:.1f} s, "
              f"{llm.engine.runner.num_pages} pages of self and cross KV "
              f"of {llm.engine.runner.kv_cache.dtype}", flush=True)
    runner = llm.engine.runner
    model = runner.model
    rng = np.random.default_rng(SEED)
    enc_lens = rng.integers(*ENCDEC_PROMPT_LENS, size=NUM_REQUESTS)
    prompts = [{"prompt_token_ids": rng.integers(2, vocab, int(n)).tolist()}
               for n in enc_lens]
    sp = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS,
                        ignore_eos=True, detokenize=False)
    # Warm-up (library initialisation, allocator growth): not counted.
    llm.generate(prompts[:2], SamplingParams(temperature=0.0, max_tokens=4,
                                             ignore_eos=True,
                                             detokenize=False))
    for k in llm.engine.phase_timings:
        llm.engine.phase_timings[k] = 0 if isinstance(
            llm.engine.phase_timings[k], int) else 0.0
    wrappers = {"ragged_paged_attention": ragged_paged_attention,
                "paged_decode_attention": paged_decode_attention}
    for fn in wrappers.values():
        fn.launches, fn.launches_by_dtype, fn.launches_by_shape = 0, {}, {}
    encoder_s = []
    inner = runner._run_encoder

    def timed_encoder(ss):
        if device == "cuda":
            torch.cuda.synchronize()
        t_enc = time.perf_counter()
        inner(ss)
        if device == "cuda":
            torch.cuda.synchronize()
        encoder_s.append(time.perf_counter() - t_enc)

    runner._run_encoder = timed_encoder
    try:
        t0 = time.monotonic()
        outs = llm.generate(prompts, sp)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        del runner._run_encoder
    counts = {name: dict(launches=fn.launches,
                         by_dtype=dict(fn.launches_by_dtype),
                         by_shape=dict(fn.launches_by_shape))
              for name, fn in wrappers.items()}
    pt = llm.engine.get_phase_timings()
    lens = [len(o.outputs[0].token_ids) for o in outs]
    if lens != [MAX_TOKENS] * NUM_REQUESTS:
        fail(f"{label}: outputs with other than {MAX_TOKENS} tokens: {lens}")
    for o in outs:
        if not all(0 <= t < vocab for t in o.outputs[0].token_ids):
            fail(f"{label}: generated token id out of the vocabulary")
    if len(encoder_s) != NUM_REQUESTS:
        fail(f"{label}: {len(encoder_s)} encoder passes for "
             f"{NUM_REQUESTS} requests")
    shape = f"qg1 d{model.head_dim}" + (" rel_bias" if t5 else "")
    want = {"paged_decode_attention": layers * pt["decode_iterations"],
            "ragged_paged_attention": (0 if t5 else
                                       layers * pt["prefill_iterations"])}
    for name, c in counts.items():
        n = want[name]
        expect = dict(launches=n, by_dtype={page_type: n} if n else {},
                      by_shape={shape: n} if n else {})
        got = {k: ({kk: v for kk, v in c[k].items() if v}
                   if isinstance(c[k], dict) else c[k]) for k in c}
        if got != expect:
            fail(f"{name} on the {label} launched {got}, not {expect} "
                 f"({pt['decode_iterations']} decode and "
                 f"{pt['prefill_iterations']} prefill steps of {layers} "
                 "layers)")
    rates = dict(
        prefill_tok_s=pt["prefill_tokens"] / max(pt["prefill_s"], 1e-9),
        decode_tok_s=pt["decode_tokens"] / max(pt["decode_s"], 1e-9),
        decode_step_ms=pt["decode_s"] / max(pt["decode_iterations"], 1)
        * 1e3,
        decode_iterations=pt["decode_iterations"],
        prefill_iterations=pt["prefill_iterations"],
        encoder_s=sum(encoder_s), encoder_s_each_max=max(encoder_s),
        encoder_tokens=int(sum(enc_lens)), wall_s=wall)
    print(f"{label}: {NUM_REQUESTS} requests, {int(sum(enc_lens))} encoder "
          f"tokens, {sum(lens)} generated tokens in {wall:.2f} s; "
          f"{len(encoder_s)} encoder passes, {sum(encoder_s):.3f} s in all "
          f"(longest {max(encoder_s):.3f} s); {pt['prefill_iterations']} "
          f"prefill/mixed steps ({rates['prefill_tok_s']:.1f} decoder "
          f"prompt tok/s), {pt['decode_iterations']} decode steps "
          f"({rates['decode_tok_s']:.1f} tok/s, "
          f"{rates['decode_step_ms']:.1f} ms a step); launches "
          f"{json.dumps(counts)}; greedy tokens of request 0: "
          f"{outs[0].outputs[0].token_ids[:16]}", flush=True)
    worst, forwards = compare_encdec_logits(llm, device, rng, vocab,
                                            compare_layers)
    rates["logits_worst_row_err"] = worst
    if device == "cuda":
        share, device_ms = cross_attention_share(runner, forwards["decode"])
        rates["cross_attention_share"] = share
        rates["traced_decode_device_ms"] = device_ms
        print(f"{label}: a traced decode step (8 rows, 3 live): "
              f"{device_ms:.2f} device ms, cross-attention "
              + ("not measured (no device time traced)" if share is None
                 else f"{share:.1%} of it"), flush=True)

    named = {variant_name(name, page_type): c["launches"]
             for name, c in counts.items() if c["launches"]}
    for name, c in counts.items():
        named[f"{variant_name(name, page_type)} by shape"] = c["by_shape"]
    named[IN_GRAPH_REPLAYS] = {}
    return named, rates


def encdec_paths():
    """encdec_path's arguments for each encoder-decoder path, by name."""
    return {
        # (Its logits are compared on the first COMPARE_LAYERS decoder
        # layers: at 24, the plain attention in f32 and in f64 lie far
        # apart, as at Gemma-2-9B's depth; the floor at 24 is printed.)
        "flan-t5-xxl, 12 + 12 layers": dict(
            model_config=dict(FLAN_T5_XXL, num_layers=12,
                              num_decoder_layers=12),
            compare_layers=COMPARE_LAYERS),
        "flan-t5-xxl+fp8_e4m3, 4 layers": dict(
            model_config=dict(FLAN_T5_XXL, num_layers=4,
                              num_decoder_layers=4),
            kv_cache_dtype="fp8_e4m3"),
        "t5-small": dict(model_config=T5_SMALL),
        "bart-large-cnn": dict(model_config=BART_LARGE_CNN),
    }


def main_paths():
    """main_path's arguments for each main path, by name (the prompts
    of 16-1024 tokens unless one names others).

    Two cover the page types the north-star path does not use, cut to 4
    layers. The last two serve GGUF files: Q6_K at GGUF_Q6K_LAYERS
    through the body the wrapper chooses (the dense one, at every T),
    and Q8_0 at 4 layers with every unpacked matmul forced to the
    group-wise body, which no call would reach otherwise."""
    prompt_lens = np.random.default_rng(SEED).integers(
        16, 1025, size=NUM_REQUESTS)
    phi_prompt_lens = np.random.default_rng(SEED).integers(
        1024, 6145, size=NUM_REQUESTS)
    qwen_prompt_lens = np.random.default_rng(SEED).integers(
        1024, 4097, size=NUM_REQUESTS)
    # Phi-3-mini-4k serves 4096 positions: prompts of 1024-4032 leave room
    # for the 64 new tokens, and run past its 2047-key window.
    phi3_prompt_lens = np.random.default_rng(SEED).integers(
        1024, 4033, size=NUM_REQUESTS)
    short = dict(LLAMA_8B, num_hidden_layers=4)
    # Slice 20 halved nine earlier paths' depth for time (the whole run
    # took 1266.3 s before, on an H100 machine whose kernels build took
    # 139.9 s): bf16 (32), baichuan2-13b (40), phi-3-small (32),
    # gemma-2-9b (21), phi-3-mini-4k (32), qwen3-30b-a3b (24), olmoe-1b-7b
    # (16), falcon-7b (32) and flan-t5-xxl (24 + 24). The paths that
    # decode_ab.py names keep theirs.
    paths = {
        "bf16, 16 layers": dict(model_config=with_layers(LLAMA_8B, 16)),
        "gptq": dict(model_config=LLAMA_8B, quantization="gptq",
                     window_check=True),
        "gptq+fp8_e4m3": dict(model_config=LLAMA_8B, quantization="gptq",
                              kv_cache_dtype="fp8_e4m3", window_check=True,
                              serve_reference=True),
        "gptq+fp8_e5m2, 4 layers": dict(model_config=short,
                                        quantization="gptq",
                                        kv_cache_dtype="fp8_e5m2"),
        "gptq+int8, 4 layers": dict(model_config=short, quantization="gptq",
                                    kv_cache_dtype="int8", kv_scale=0.05),
        f"q6_k gguf, {GGUF_Q6K_LAYERS} layers": dict(
            model_config=dict(LLAMA_8B, num_hidden_layers=GGUF_Q6K_LAYERS),
            gguf="q6_k", window_check=True),
        "q8_0 gguf, 4 layers, group-wise body": dict(
            model_config=short, gguf="q8_0", q4_body="groupwise"),
        # Slice 5: W4A8 (the switch set for this path only), then the two
        # 8-bit weight kinds quantized at load, cut to 4 layers.
        # (32 layers until slice 15 cut it to 8 for time; its argmax is held
        # on the rows a K-reversed plain run decides, at any depth.)
        "gptq w4a8, 8 layers": dict(
            model_config=dict(LLAMA_8B, num_hidden_layers=8),
            quantization="gptq", w4a8=True),
        "int8, 4 layers": dict(model_config=short, quantization="int8"),
        "fp8, 4 layers": dict(model_config=short, quantization="fp8"),
        # Slice 6: Baichuan2-13B (MHA, ALiBi) at full width and depth, its
        # ALiBi on E4M3 pages at 4 layers, and bench.py's 1.4B geometry
        # (QH/KV 2) with the north-star quantization.
        "baichuan2-13b, 20 layers": dict(
            model_config=with_layers(BAICHUAN2_13B, 20)),
        "baichuan2-13b+fp8_e4m3, 4 layers": dict(
            model_config=dict(BAICHUAN2_13B, num_hidden_layers=4),
            kv_cache_dtype="fp8_e4m3"),
        "bench-1.4b gptq+fp8_e4m3": dict(model_config=BENCH_1P4B,
                                         quantization="gptq",
                                         kv_cache_dtype="fp8_e4m3"),
        # Slice 7: Phi-3-Small (blocksparse on every other layer) at full
        # width and depth on prompts of 1024-6144 tokens, the same on E4M3
        # pages at 4 layers, and a GGUF Q2_K file (packed at group 16).
        "phi-3-small, 16 layers": dict(
            model_config=with_layers(PHI3_SMALL, 16),
            prompt_lens=phi_prompt_lens),
        "phi-3-small+fp8_e4m3, 4 layers": dict(
            model_config=dict(PHI3_SMALL, num_hidden_layers=4),
            kv_cache_dtype="fp8_e4m3", prompt_lens=phi_prompt_lens),
        "q2_k gguf, 4 layers": dict(model_config=short, gguf="q2_k"),
        # Slice 8: W4A8 on the Q2_K file (group 16); Qwen2.5-7B (QH/KV 7,
        # q|k|v bias) at full width and depth on prompts of 1024-4096
        # tokens; Qwen2.5-0.5B (head_dim 64, tied) on E4M3 pages at full
        # depth; Qwen3-14B (QH/KV 5, q/k norm) and Mistral-7B (a window of
        # 4096 keys, one prompt of 4500 tokens) at 4 layers.
        "q2_k gguf w4a8, 4 layers": dict(model_config=short, gguf="q2_k",
                                         w4a8=True),
        "qwen2.5-7b": dict(model_config=QWEN25_7B,
                           prompt_lens=qwen_prompt_lens, window_check=True),
        "qwen2.5-0.5b+fp8_e4m3": dict(model_config=QWEN25_05B,
                                      kv_cache_dtype="fp8_e4m3"),
        "qwen3-14b, 4 layers": dict(
            model_config=dict(QWEN3_14B, num_hidden_layers=4)),
        "mistral-7b, 4 layers": dict(
            model_config=dict(MISTRAL_7B, num_hidden_layers=4),
            prompt_lens=[*prompt_lens[:NUM_REQUESTS - 1], 4500],
            compare_lens=[4500, 17, 129]),
        # Slice 14: the sampler, on the north-star configuration at full
        # width and depth (after gptq+fp8_e4m3, whose tokens the history
        # path takes as its reference).
        "samplers, history-free": dict(
            model_config=LLAMA_8B, quantization="gptq",
            kv_cache_dtype="fp8_e4m3", sampler="history-free",
            window_check=True),
        "samplers, history": dict(
            model_config=LLAMA_8B, quantization="gptq",
            kv_cache_dtype="fp8_e4m3", sampler="history"),
        # Slice 15: head_dim 256 and 96. Gemma-2-9B at full width and depth
        # on prompts of 1024-6144 tokens (its local layers' 4096-key window
        # bites; logits compared on a 4500-token prefill), Phi-3-mini-4k at
        # full width and depth on prompts of 1024-4032 (its 2047-key window;
        # a 2500-token prefill compared); Gemma-2-9B's shapes with int4
        # weights and an E4M3 cache, Gemma-7B (QH/KV 1) and Phi-3-mini-128k
        # (LongRoPE, stand-in factors) at 4 layers; Gemma-3-1B (5 local
        # layers to 1 global, two rope bases, q/k norm) at full depth.
        "gemma-2-9b, 10 layers": dict(
            model_config=with_layers(GEMMA2_9B, 10),
            prompt_lens=phi_prompt_lens, window_check=True,
            compare_lens=[4500, 17, 129], compare_layers=COMPARE_LAYERS),
        "phi-3-mini-4k, 16 layers": dict(
            model_config=with_layers(PHI3_MINI_4K, 16),
            prompt_lens=phi3_prompt_lens, window_check=True,
            compare_lens=[2500, 17, 129]),
        "gemma-2-9b gptq+fp8_e4m3, 4 layers": dict(
            model_config=dict(GEMMA2_9B, num_hidden_layers=4),
            quantization="gptq", kv_cache_dtype="fp8_e4m3",
            prompt_lens=phi_prompt_lens),
        "gemma-7b, 4 layers": dict(
            model_config=dict(GEMMA_7B, num_hidden_layers=4)),
        "gemma-3-1b": dict(model_config=GEMMA3_1B,
                           compare_layers=COMPARE_LAYERS),
        "phi-3-mini-128k, 4 layers": dict(
            model_config=phi3_128k_config(4),
            max_model_len=PHI3_MINI_128K_LEN,
            prompt_lens=[*prompt_lens[:NUM_REQUESTS - 1], 5000],
            compare_lens=[5000, 17, 129]),
        # Slice 17: Mixture-of-Experts. Qwen3-30B-A3B at full width and all
        # 48 layers (the headline); Mixtral-8x7B with its experts quantized
        # to int8 at load on E4M3 pages, Qwen1.5-MoE-A2.7B (shared expert)
        # and Phi-3.5-MoE (sparsemixer, stand-in LongRoPE factors, served
        # at 16384 with one prompt of 5000 tokens; its logits compared on
        # the usual prompts: the plain attention of a 5000-token prefill
        # did not fit beside its engine) at 4 layers;
        # OLMoE-1B-7B at its full 16 layers, its logits compared on its
        # first COMPARE_LAYERS layers (at 16 its random model is chaotic:
        # plain attention in f32 and in f64 lie 0.94 of a row apart on the
        # compare prefill, NVIDIA H100 80GB HBM3 at 700 W). Each holds both
        # forms of the grouped product (moe_checks) and its graphed window.
        # (Qwen3-30B-A3B ran all 48 layers and Gemma-2-9B all 42 until
        # slice 18 cut both to half their depth for time.)
        "qwen3-30b-a3b, 12 layers": dict(
            model_config=with_layers(QWEN3_30B_A3B, 12),
            window_check=True),
        "mixtral-8x7b experts_int8+fp8_e4m3, 4 layers": dict(
            model_config=dict(MIXTRAL_8X7B, num_hidden_layers=4),
            quantization="experts_int8", kv_cache_dtype="fp8_e4m3",
            window_check=True),
        "qwen1.5-moe-a2.7b, 4 layers": dict(
            model_config=dict(QWEN15_MOE_A27B, num_hidden_layers=4),
            window_check=True),
        "olmoe-1b-7b, 8 layers": dict(
            model_config=with_layers(OLMOE_1B_7B, 8), window_check=True,
            compare_layers=COMPARE_LAYERS),
        "phi-3.5-moe, 4 layers": dict(
            model_config=phi35_moe_config(4),
            max_model_len=PHI3_MINI_128K_LEN,
            prompt_lens=[*prompt_lens[:NUM_REQUESTS - 1], 5000],
            window_check=True),
        # Slice 18: 71 query heads on one kv head and ALiBi at head_dim 64.
        # Falcon-7B at full width and all 32 layers (the headline: both
        # attention kernels at QG 71, its window held graphed against
        # eager), on E4M3 pages at 4 layers; Falcon-40B (new decoder
        # architecture, QG 16) at 4; Falcon-RW-1B (ALiBi, MHA, sequential)
        # at all 24 layers; Bloom-560m (ALiBi at head_dim 64, the embedding
        # norm, 250880 tokens) on E4M3 pages at all 24; MPT-7B and JAIS-13b
        # (ALiBi at head_dim 128 with the non-Llama blocks) at 4.
        "falcon-7b, 16 layers": dict(model_config=with_layers(FALCON_7B, 16),
                                     window_check=True),
        "falcon-7b+fp8_e4m3, 4 layers": dict(
            model_config=with_layers(FALCON_7B, 4),
            kv_cache_dtype="fp8_e4m3"),
        "falcon-40b, 4 layers": dict(model_config=with_layers(FALCON_40B,
                                                              4)),
        "falcon-rw-1b": dict(model_config=FALCON_RW_1B),
        "bloom-560m+fp8_e4m3": dict(model_config=BLOOM_560M,
                                    kv_cache_dtype="fp8_e4m3"),
        "mpt-7b, 4 layers": dict(model_config=with_layers(MPT_7B, 4)),
        "jais-13b, 4 layers": dict(model_config=with_layers(JAIS_13B, 4)),
        # Slice 20: partial and interleaved rotary, head_dim 80. Phi-2 at
        # full width and all 32 layers (the headline: both kernels at d80,
        # its window held graphed against eager), on E4M3 pages at 4;
        # StableLM-3B-4e1t (d80, rotary 20 of 80), GPT-NeoX-20B (d96,
        # rotary_pct 0.25, parallel residual), GPT-J-6B (d256, interleaved
        # over 64), Persimmon-8B (q/k LayerNorm, relu2, 262144 tokens),
        # ChatGLM3-6B (QH/KV 16, interleaved over half) and Qwen2.5-7B
        # with its documented YaRN scaling, each at 4 layers. Phi-2's
        # logits are compared at all 32 layers: plain attention in f32 and
        # f64 lie 0.0073-0.0077 of a row apart there (0.0030-0.0038 at 4;
        # tools/logits_floor.py phi2, NVIDIA H100 80GB HBM3 at 700 W).
        # Argmax is held on the rows the f64 floor decides: on the card
        # GPT-NeoX-20B's and Qwen2.5-7B-YaRN's random decode logits held
        # rows whose plain top two lay 1.7e-3 and 2.5e-5 apart, which the
        # kernel's rounding flipped.
        "phi-2": dict(model_config=PHI_2, window_check=True, f64_floor=True),
        "phi-2+fp8_e4m3, 4 layers": dict(model_config=with_layers(PHI_2, 4),
                                         kv_cache_dtype="fp8_e4m3",
                                         f64_floor=True),
        "stablelm-3b-4e1t, 4 layers": dict(
            model_config=with_layers(STABLELM_3B, 4), f64_floor=True),
        "gpt-neox-20b, 4 layers": dict(
            model_config=with_layers(GPT_NEOX_20B, 4), f64_floor=True),
        "gpt-j-6b, 4 layers": dict(model_config=with_layers(GPT_J_6B, 4),
                                   f64_floor=True),
        "persimmon-8b, 4 layers": dict(
            model_config=with_layers(PERSIMMON_8B, 4), f64_floor=True),
        "chatglm3-6b, 4 layers": dict(
            model_config=with_layers(CHATGLM3_6B, 4), f64_floor=True),
        "qwen2.5-7b yarn, 4 layers": dict(
            model_config=with_layers(QWEN25_7B_YARN, 4), f64_floor=True),
        # Slice 21: head_dim 160 and the learned-position and Llama-hook
        # families. StableLM-2-12B at full width and all 40 layers (the
        # headline: both kernels at d160, its window held graphed against
        # eager), on E4M3 pages at 4; StarCoder (the decode kernel's wide
        # form at QH/KV 48, learned positions), OPT-6.7B (OPT's offset of
        # 2), GPT-2-XL (MHA at d64, 1024 learned positions: its prompts of
        # 16-960 tokens and 64 new ones stay inside the table) and
        # Granite-3.1-8B (the four multipliers), each at 4 layers; the
        # windows of GPT-2-XL (learned positions) and Granite (the
        # residual multiplier) are held graphed against eager.
        "stablelm-2-12b": dict(model_config=STABLELM_2_12B,
                               window_check=True, f64_floor=True),
        "stablelm-2-12b+fp8_e4m3, 4 layers": dict(
            model_config=with_layers(STABLELM_2_12B, 4),
            kv_cache_dtype="fp8_e4m3", f64_floor=True),
        "starcoder, 4 layers": dict(model_config=with_layers(STARCODER, 4),
                                    f64_floor=True),
        "opt-6.7b, 4 layers": dict(model_config=with_layers(OPT_6P7B, 4),
                                   f64_floor=True),
        "gpt2-xl, 4 layers": dict(
            model_config=with_layers(GPT2_XL, 4), window_check=True,
            prompt_lens=np.random.default_rng(SEED).integers(
                16, GPT2_XL["n_positions"] - MAX_TOKENS + 1,
                size=NUM_REQUESTS),
            f64_floor=True),
        "granite-3.1-8b, 4 layers": dict(
            model_config=with_layers(GRANITE_31_8B, 4), window_check=True,
            f64_floor=True),
        # Slice 22: multi-head latent attention and head_dim 384 in the
        # ragged kernel. MiniCPM3-4B at full width and all 62 layers on its
        # latent cache (the headline: every attention launch at 40/1 d384
        # on the ragged kernel, prefill and decode; its window held
        # graphed against eager), on E4M3 pages at 4 layers (row 3 at
        # d384), and in its materialized form at 4 layers
        # (APHRODITE_MLA_LATENT=0: 40/40 at d96 on both kernels as they
        # were); MiniCPM-2B, MiniCPM-MoE-8x2B and OLMo-2-7B at 4 layers.
        "minicpm3-4b": dict(model_config=MINICPM3_4B,
                            max_model_len=MINICPM3_LEN, window_check=True,
                            f64_floor=True),
        "minicpm3-4b+fp8_e4m3, 4 layers": dict(
            model_config=minicpm3_config(4), max_model_len=MINICPM3_LEN,
            kv_cache_dtype="fp8_e4m3", f64_floor=True),
        "minicpm3-4b materialized, 4 layers": dict(
            model_config=minicpm3_config(4), max_model_len=MINICPM3_LEN,
            mla_latent="0", f64_floor=True),
        "minicpm-2b, 4 layers": dict(model_config=with_layers(MINICPM_2B, 4),
                                     f64_floor=True),
        "minicpm-moe-8x2b, 4 layers": dict(
            model_config=with_layers(MINICPM_MOE_8X2B, 4),
            window_check=True),
        "olmo2-7b, 4 layers": dict(model_config=with_layers(OLMO2_7B, 4),
                                   f64_floor=True),
    }
    return {name: {"prompt_lens": prompt_lens, **kw}
            for name, kw in paths.items()}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a card")
    import aphrodite_tpu_torch  # noqa: F401  (fails outside the repo)

    t_start = time.monotonic()

    def stamp(phase):
        print(f"phase {phase}: done {time.monotonic() - t_start:.1f} s after "
              "the start", flush=True)

    build_kernels()
    card = card_line()
    print(card, flush=True)
    errs = {}
    for name, geometry in ATTN_GEOMETRIES.items():
        kernel_checks("cuda", name, geometry, errs)
    blocksparse_checks("cuda", errs)
    prompt_lens = np.random.default_rng(SEED).integers(
        16, 1025, size=NUM_REQUESTS)
    rel_bias_checks("cuda", errs, prompt_lens)
    stamp("attention checks")
    int4_errs = [int4_checks("cuda"), int4_checks("cuda", 16)]
    for body in ("groupwise", "groupwise_decode", "dense_wgmma"):
        errs[f"int4p_matmul_{body}"] = max(e[body] for e in int4_errs)
    errs["int4p_matmul_w4a8"] = max(w4a8_checks("cuda"),
                                    w4a8_checks("cuda", 16))
    errs["quantize_activations"] = quantizer_checks("cuda")
    int8_errs = int8_checks("cuda")
    for body, err in fp8_checks("cuda").items():
        errs[f"fp8_w8a8_matmul_{body}"] = err
    q4_errs = q4_checks("cuda")
    errs["gather_probe"] = probe_check()
    stamp("matmul and probe checks")
    sampler_errs = sampler_checks()
    stamp("sampler checks")
    llama = "llama-3.1-8b 32/8"
    times = kernel_timings("cuda", llama, ATTN_GEOMETRIES[llama],
                           prompt_lens, iters=200, errs=errs)
    stamp("timings: attention, llama-3.1-8b")
    # At the Baichuan geometry four cache layers already hold more K/V than
    # the L2 (80 kv heads' rows).
    baichuan = "baichuan2-13b 40/40 alibi"
    alibi_times = kernel_timings("cuda", baichuan, ATTN_GEOMETRIES[baichuan],
                                 prompt_lens, iters=200, errs=errs,
                                 page_types=("bf16", "e4m3"), layers=4)
    # Phi-3-Small's prompts: 1024 to 6144 tokens, so that most keys lie past
    # the local window of 1024.
    phi_prompt_lens = np.random.default_rng(SEED).integers(
        1024, 6145, size=NUM_REQUESTS)
    bs_times = kernel_timings("cuda", BLOCKSPARSE_GEOMETRY,
                              ATTN_GEOMETRIES[llama], phi_prompt_lens,
                              iters=100, errs=errs,
                              page_types=("bf16", "e4m3"), layers=4,
                              blocksparse=True)
    stamp("timings: attention, ALiBi and blocksparse")
    # Slice 8's shapes at their main paths' prompts (1024-4096 tokens):
    # Qwen2.5-7B (QH/KV 7) on bf16 pages, Qwen2.5-0.5B (QH/KV 7, head_dim
    # 64) on bf16 and E4M3 pages.
    qwen_prompt_lens = np.random.default_rng(SEED).integers(
        1024, 4097, size=NUM_REQUESTS)
    geometry_times = {}
    for geometry, page_types in (("qwen2.5-7b 28/4", ("bf16",)),
                                 ("qwen2.5-0.5b 14/2 d64", ("bf16", "e4m3"))):
        geometry_times[geometry] = kernel_timings(
            "cuda", geometry, ATTN_GEOMETRIES[geometry], qwen_prompt_lens,
            iters=100, errs=errs, page_types=page_types)
    # Slice 15's geometries at their main paths' prompts: Phi-3-mini's
    # 1024-4032 tokens, Gemma-2-9B's 1024-6144 (bf16 pages, and E4M3,
    # which its 4-layer path runs on), Gemma-7B's and Gemma-3-1B's
    # 16-1024; each launch on the next of `layers` cache layers, more K/V
    # than the L2 holds.
    phi3_prompt_lens = np.random.default_rng(SEED).integers(
        1024, 4033, size=NUM_REQUESTS)
    for geometry, lens, page_types, layers in (
            ("phi-3-mini 32/32 d96", phi3_prompt_lens, ("bf16",), 4),
            ("gemma-2-9b 16/8 d256", phi_prompt_lens, ("bf16", "e4m3"), 4),
            ("gemma-7b 16/16 d256", prompt_lens, ("bf16",), 4),
            ("gemma-3-1b 4/1 d256", prompt_lens, ("bf16",), 16)):
        geometry_times[geometry] = kernel_timings(
            "cuda", geometry, ATTN_GEOMETRIES[geometry], lens, iters=100,
            errs=errs, page_types=page_types, layers=layers)
    stamp("timings: attention, Qwen2.5, Phi-3-mini and Gemma geometries")
    # Slice 18's geometries at their paths' prompts (16-1024 tokens), on
    # every page type: Falcon-7B's 71 query heads on one kv head (48 cache
    # layers: a layer holds 256 bytes of K/V a token) and Bloom-560m's
    # ALiBi at head_dim 64.
    for geometry, layers in (("falcon-7b 71/1 d64", 48),
                             ("bloom-560m 16/16 alibi d64", 4)):
        geometry_times[geometry] = kernel_timings(
            "cuda", geometry, ATTN_GEOMETRIES[geometry], prompt_lens,
            iters=100, errs=errs, layers=layers)
    stamp("timings: attention, Falcon-7B and Bloom-560m geometries")
    # Slice 20's: Phi-2 (head_dim 80) at its path's prompts, on bf16 and
    # E4M3 pages (its 4-layer path's).
    geometry_times["phi-2 32/32 d80"] = kernel_timings(
        "cuda", "phi-2 32/32 d80", ATTN_GEOMETRIES["phi-2 32/32 d80"],
        prompt_lens, iters=100, errs=errs, page_types=("bf16", "e4m3"),
        layers=4)
    stamp("timings: attention, Phi-2 geometry")
    # Slice 21's: StableLM-2-12B (head_dim 160) at its paths' prompts, on
    # bf16 and E4M3 pages (its 4-layer path's).
    geometry_times["stablelm-2-12b 32/8 d160"] = kernel_timings(
        "cuda", "stablelm-2-12b 32/8 d160",
        ATTN_GEOMETRIES["stablelm-2-12b 32/8 d160"], prompt_lens, iters=100,
        errs=errs, page_types=("bf16", "e4m3"), layers=4)
    stamp("timings: attention, StableLM-2-12B geometry")
    # Slice 22's: MiniCPM3-4B's latent head (40/1 at head_dim 384) at its
    # paths' prompts, on bf16 and E4M3 pages (its 4-layer path's): a
    # 2048-token prefill and 16 decode rows, both through the ragged
    # kernel; 16 cache layers of K/V, more than the L2 holds at decode.
    d384 = "minicpm3-4b 40/1 d384"
    d384_times = kernel_timings("cuda", d384, ATTN_GEOMETRIES[d384],
                                prompt_lens, iters=100, errs=errs,
                                page_types=("bf16", "e4m3"), layers=16)
    stamp("timings: attention, MiniCPM3-4B geometry")
    rel_bias_times = rel_bias_timings("cuda", errs)
    stamp("timings: attention with the T5 bias")
    int4_points = int4_timings("cuda", iters=200)
    int4_points += int4_timings("cuda", iters=200, group=16, sites=("w13",))
    stamp("timings: int4p_matmul")
    w4a8_points = w4a8_timings("cuda", iters=200)
    w4a8_points += w4a8_timings("cuda", iters=200, group=16, sites=("w13",))
    act_points = quantizer_timings("cuda", iters=200)
    fp8_points = fp8_timings("cuda", iters=200)
    int8_points = int8_timings("cuda", iters=200)
    stamp("timings: W4A8, quantizer, FP8, int8")
    q4_points = q4_timings("cuda", iters=200)
    stamp("timings: int4_matmul")
    sampler_times = sampler_timings(card)
    stamp("timings")
    # Every engine sizes its KV cache from the free memory, so each is
    # freed (main_path holds the only reference) before the next starts.
    launches, rates = {}, {}
    for path, kw in main_paths().items():
        gc.collect()
        torch.cuda.empty_cache()
        if kw.get("sampler") == "history":
            kw = dict(kw, reference=rates["gptq+fp8_e4m3"]["token_ids"])
        launches[path], rates[path] = main_path("cuda", **kw)
        stamp(f"main path {path}")
    for r in rates.values():
        r.pop("token_ids")
    serve_reference = rates["gptq+fp8_e4m3"].pop("serve_reference")
    for path, kw in encdec_paths().items():
        gc.collect()
        torch.cuda.empty_cache()
        launches[path], rates[path] = encdec_path("cuda", **kw)
        stamp(f"encoder-decoder path {path}")

    # The page-gather probe's own entry point, at its defaults.
    probe_launches, probe_times = probe_path()
    stamp("probe path")
    gc.collect()
    torch.cuda.empty_cache()
    serving_phase(card, rates["gptq+fp8_e4m3"], serve_reference)
    stamp("serving")

    def on_paths(name, part=None):
        """Launches of one kernel variant on each main path that ran it:
        each was read right after its run, with the counts set to 0 just
        before it; with part=IN_GRAPH_REPLAYS, the part of them that the
        decode windows' graph replays made (main_path)."""
        out = {}
        for path, counts in launches.items():
            counts = counts if part is None else counts[part]
            if name in counts:
                out[path] = counts[name]
        return out

    def in_replays(name):
        """The launches of a kernel variant on all main paths that graph
        replays made: each key's replays in a path's run times the
        launches of one window of the key, whose replay was traced."""
        return sum(on_paths(name, IN_GRAPH_REPLAYS).values())

    sources = {
        "paged_decode_attention": (
            "aphrodite_tpu_torch/csrc/paged_decode_attention.cuh",
            dict.fromkeys(PAGE_TYPES,
                          "aphrodite_tpu/ops/decode_attention.py:95")),
        "ragged_paged_attention": (
            # Built twice: ragged_paged_attention.cu (no ALiBi) and
            # ragged_paged_attention_alibi.cu.
            "aphrodite_tpu_torch/csrc/ragged_paged_attention.cuh",
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
            by_shape = {}
            for counts in on_paths(f"{name} by shape").values():
                for shape, n in counts.items():
                    by_shape[shape] = by_shape.get(shape, 0) + n
            entry = dict(name=name, route="cuda", source=src,
                         replaces=replaces[page_type], page_type=page_type,
                         launches=sum(by_path.values()),
                         launches_in_graph_replays=in_replays(name),
                         launches_by_path=by_path,
                         launches_by_shape=by_shape, max_abs_err=errs[name],
                         **times[name])
            if kernel == "ragged_paged_attention":
                # ALiBi prefill goes to the vendored fork on every page type.
                entry["also_replaces"] = ("aphrodite_tpu/ops/"
                                          "rpa_alibi_kernel.py:832 (ALiBi)")
            if page_type != "bf16":
                entry["bf16_ms"] = times[kernel]["ms"]
            if name in alibi_times:
                entry["baichuan2-13b"] = alibi_times[name]
            for geometry, got in geometry_times.items():
                if name in got:
                    entry[geometry.split()[0]] = got[name]
            kernels.append(entry)
    # The blocksparse instantiations on the pages the main paths gave them
    # (bf16 and E4M3; the others are held in the checks above), timed at
    # Phi-3-Small's geometry.
    bs_sources = {
        "paged_decode_attention": (
            "aphrodite_tpu_torch/csrc/paged_decode_attention.cuh",
            "aphrodite_tpu/ops/decode_attention.py:95"),
        "ragged_paged_attention": (
            "aphrodite_tpu_torch/csrc/ragged_paged_attention_blocksparse.cu",
            "aphrodite_tpu/ops/rpa_alibi_kernel.py:832")}
    for kernel, (src, replaces) in bs_sources.items():
        for page_type in ("bf16", "e4m3"):
            name = variant_name(kernel, page_type, blocksparse=True)
            by_shape = on_paths(f"{variant_name(kernel, page_type)} by shape")
            by_path = {path: counts["qg4 d128 blocksparse"]
                       for path, counts in by_shape.items()
                       if counts.get("qg4 d128 blocksparse")}
            if not sum(by_path.values()):
                fail(f"{name} was launched on no main path")
            kernels.append(dict(
                name=name, route="cuda", source=src, replaces=replaces,
                option="blocksparse", page_type=page_type,
                launches=sum(by_path.values()),
                launches_in_graph_replays=sum(
                    counts.get("qg4 d128 blocksparse", 0)
                    for counts in on_paths(
                        f"{variant_name(kernel, page_type)} by shape",
                        IN_GRAPH_REPLAYS).values()),
                launches_by_path=by_path, max_abs_err=errs[name],
                **bs_times[name]))
    # The decode kernel with T5's bias on the pages the T5 paths gave it
    # (bf16 and E4M3; the others are held in the checks above), timed at
    # Flan-T5-XXL's geometry.
    for page_type in ("bf16", "e4m3"):
        name = rel_bias_variant(page_type)
        by_shape = on_paths(
            f"{variant_name('paged_decode_attention', page_type)} by shape")
        by_path = {path: counts["qg1 d64 rel_bias"]
                   for path, counts in by_shape.items()
                   if counts.get("qg1 d64 rel_bias")}
        if not sum(by_path.values()):
            fail(f"{name} was launched on no main path")
        kernels.append(dict(
            name=name, route="cuda",
            source="aphrodite_tpu_torch/csrc/paged_decode_attention_rel.cu",
            replaces="aphrodite_tpu/ops/decode_attention.py:95",
            option="rel_bias", page_type=page_type,
            launches=sum(by_path.values()), launches_in_graph_replays=0,
            launches_by_path=by_path, max_abs_err=errs[name],
            **rel_bias_times[name]))
    # The ragged kernel at head_dim 384 (its own library) on the pages the
    # main paths gave it (bf16 and E4M3; the others are held in the checks
    # above), with its times at MiniCPM3-4B's geometry: a 2048-token
    # prefill, and under "decode" the 16 decode rows it takes too.
    for page_type in ("bf16", "e4m3"):
        name = variant_name("ragged_paged_attention_d384", page_type)
        by_shape = on_paths(
            f"{variant_name('ragged_paged_attention', page_type)} by shape")
        by_path = {path: counts["qg40 d384"]
                   for path, counts in by_shape.items()
                   if counts.get("qg40 d384")}
        if not sum(by_path.values()):
            fail(f"{name} was launched on no main path")
        kernels.append(dict(
            name=name, route="cuda",
            source="aphrodite_tpu_torch/csrc/ragged_paged_attention_d384.cu",
            replaces=("aphrodite_tpu/ops/attention.py:336" if page_type
                      == "bf16" else
                      "aphrodite_tpu/ops/rpa_alibi_kernel.py:832"),
            option="head_dim 384", page_type=page_type,
            launches=sum(by_path.values()),
            launches_in_graph_replays=sum(
                counts.get("qg40 d384", 0) for counts in on_paths(
                    f"{variant_name('ragged_paged_attention', page_type)} "
                    "by shape", IN_GRAPH_REPLAYS).values()),
            launches_by_path=by_path, max_abs_err=errs[name],
            **d384_times[name], decode=d384_times[f"{name} decode"]))
    # The packed int4 kernel, one entry per body and implementation: the
    # group-wise body under 64 tokens on the mma.sync kernel (csrc/
    # int4p_matmul.cu) and on the decode body (csrc/decode_gemm.cuh), as
    # decode_route picks, each with the headline times of the largest site
    # at a decode step it takes, and the prefill body (csrc/
    # dequant_gemm.cuh) with those of the largest site at a 2048-token
    # prefill step; every (site, T, group) point follows in "points" (at
    # decode sizes with both implementations' times), group 16 (GGUF Q2_K
    # and Q3_K) at w13.
    packed_bodies = {
        "groupwise": ("aphrodite_tpu_torch/csrc/int4p_matmul.cu",
                      "aphrodite_tpu/ops/quant_matmul.py:528 "
                      "(_kernel_packed_groupwise, :268)", 16,
                      "group-wise body, mma.sync kernel"),
        "groupwise_decode": ("aphrodite_tpu_torch/csrc/decode_gemm.cuh",
                             "aphrodite_tpu/ops/quant_matmul.py:528 "
                             "(_kernel_packed_groupwise, :268)", 32,
                             "group-wise body, decode body (PACKED)"),
        "dense_wgmma": ("aphrodite_tpu_torch/csrc/dequant_gemm.cuh",
                        "aphrodite_tpu/ops/quant_matmul.py:528 "
                        "(_kernel_packed_dense, :321)", 2048,
                        "prefill body, packed")}
    packed_by_body = {b: sum(on_paths(f"int4p_matmul_{b}").values())
                      for b in packed_bodies}
    # Launches of each packed body on each main path that ran the kernel.
    packed_by_path = {}
    for body in packed_bodies:
        for path, n in on_paths(f"int4p_matmul_{body}").items():
            packed_by_path.setdefault(path, {})[body] = n
    print("int4p_matmul launches by body on each main path: "
          + json.dumps(packed_by_path), flush=True)
    for body, (src, replaces, T, form) in packed_bodies.items():
        name = ("int4p_matmul" if body == "groupwise"
                else f"int4p_matmul_{body}")
        by_path = on_paths(f"int4p_matmul_{body}")
        if not sum(by_path.values()):
            fail(f"{name} was launched on no main path")
        points = [p for p in int4_points if p["body"] == body]
        head = implementation_head(
            next(p for p in int4_points if p["site"] == "w13"
                 and p["T"] == T and p["group"] == 128), body)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            form=form, launches=sum(by_path.values()),
            launches_in_graph_replays=in_replays(f"int4p_matmul_{body}"),
            launches_by_path=by_path, launches_by_body=packed_by_body,
            launches_by_body_by_path=packed_by_path,
            max_abs_err=errs[f"int4p_matmul_{body}"],
            **{k: head[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")},
            shape=f"w13 4096x28672 T={T}", points=points))
    # The unpacked kernel, one entry per body: the headline times are
    # those of the largest site at the decode step's size (the decode
    # body's level forms, csrc/decode_gemm.cuh, built in
    # csrc/int4_matmul.cu) or at a 2048-token prefill step (the prefill
    # body and its int8 per-column form), on the container the wrapper
    # sends to that body; every (container, site, T) point follows in
    # "points". Each level body replaces one 2-D TPU kernel and one body of
    # the layer-stacked one.
    q4_bodies = {
        "groupwise": ("q8_0", 32, "aphrodite_tpu_torch/csrc/int4_matmul.cu",
                      "aphrodite_tpu/ops/quant_matmul.py:178",
                      "named on the q8_0 gguf path (body=, bound into the "
                      "projections' reference to the wrapper), and the int8 "
                      "path under 64 tokens (G = K), where decode_route "
                      "picks the mma.sync kernel"),
        "dense": ("q6_k", 32, "aphrodite_tpu_torch/csrc/int4_matmul.cu",
                  "aphrodite_tpu/ops/quant_matmul.py:81",
                  "the wrapper's choice under 64 tokens, where decode_route "
                  "picks the mma.sync kernel"),
        "groupwise_decode": ("q8_0", 32,
                             "aphrodite_tpu_torch/csrc/decode_gemm.cuh",
                             "aphrodite_tpu/ops/quant_matmul.py:178",
                             "the group-wise body where decode_route picks "
                             "the decode body (GROUPWISE)"),
        "dense_decode": ("q6_k", 32, "aphrodite_tpu_torch/csrc/decode_gemm.cuh",
                         "aphrodite_tpu/ops/quant_matmul.py:81",
                         "the dense body where decode_route picks the decode "
                         "body (DENSE)"),
        "dense_wgmma": ("q6_k", 2048,
                        "aphrodite_tpu_torch/csrc/dequant_gemm.cuh",
                        "aphrodite_tpu/ops/quant_matmul.py:81",
                        "the wrapper's choice from 64 tokens on"),
        "per_column_wgmma": (None, 2048,
                             "aphrodite_tpu_torch/csrc/dequant_gemm.cuh",
                             "aphrodite_tpu/quantization/qlinear.py:54 "
                             "_int8_matmul (XLA code, no Pallas kernel)",
                             "int8 per-channel weights from 64 tokens on")}
    for body, err in int8_errs.items():
        q4_errs[body] = max(q4_errs.get(body, 0.0), err)
    q4_by_body = {b: sum(on_paths(f"int4_matmul_{b}").values())
                  for b in q4_bodies}
    for body, (kind, T, src, replaces, where) in q4_bodies.items():
        name = f"int4_matmul_{body}"
        by_path = on_paths(name)
        if not sum(by_path.values()):
            fail(f"{name} was launched on no main path")
        if kind is None:
            points = int8_points
            head = next(p for p in points if p["site"] == "w13"
                        and p["T"] == T)
        else:
            points = [p for p in q4_points if p["body"] == body]
            head = implementation_head(
                next(p for p in q4_points if p["container"] == kind
                     and p["site"] == "w13" and p["T"] == T
                     and p["body"].startswith(body.split("_")[0])), body)
        entry = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            form={"groupwise": "group-wise body, mma.sync kernel",
                  "dense": "dense body, mma.sync kernel",
                  "groupwise_decode": "decode body, GROUPWISE",
                  "dense_decode": "decode body, DENSE (DENSE_ROWS under G 16)",
                  "dense_wgmma": "prefill body, unpacked",
                  "per_column_wgmma": "prefill body, PER_COLUMN"}[body],
            launches=sum(by_path.values()),
            launches_in_graph_replays=in_replays(name),
            launches_by_path=by_path,
            launches_by_body=q4_by_body, max_abs_err=q4_errs[body],
            **{k: head[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")},
            shape=(f"w13 4096x28672 T={T}"
                   + (f", {kind} container" if kind else ", int8 per-channel")),
            on_main_path=where, points=points)
        if kind is not None:
            entry["also_replaces"] = "aphrodite_tpu/ops/quant_matmul.py:694"
        kernels.append(entry)
    # W4A8 and the quantizer. The W4A8 headline times are those of the
    # largest site at the decode step's size (the wrapper: quantizer and
    # kernel); every (site, T) point follows in "points".
    head = next(p for p in w4a8_points
                if p["site"] == "w13" and p["T"] == 32)
    by_path = on_paths("int4p_matmul_w4a8")
    if not sum(by_path.values()):
        fail("int4p_matmul_w4a8 was launched on no main path")
    kernels.append(dict(
        name="int4p_matmul_w4a8", route="cuda",
        source="aphrodite_tpu_torch/csrc/int4p_matmul_w4a8.cu",
        replaces="aphrodite_tpu/ops/quant_matmul.py:434",
        launches=sum(by_path.values()),
        launches_in_graph_replays=in_replays("int4p_matmul_w4a8"),
        launches_by_path=by_path,
        max_abs_err=errs["int4p_matmul_w4a8"],
        **{k: head[k] for k in ("ms", "plain_ms", "library_ms",
                                "bf16_library_ms", "bound_ms", "bound_by")},
        library="torch._int_mm on the unpacked int8 levels (no group "
                "fix-ups)",
        shape="w13 4096x28672 T=32", points=w4a8_points))
    head = next(p for p in act_points
                if p["format"] == "int8" and p["T"] == 32 and p["K"] == 4096)
    by_path = on_paths("quantize_activations")
    if not sum(by_path.values()):
        fail("quantize_activations was launched on no main path")
    kernels.append(dict(
        name="quantize_activations", route="cuda",
        source="aphrodite_tpu_torch/csrc/int4p_matmul_w4a8.cu",
        replaces=("aphrodite_tpu/ops/quant_matmul.py:424 "
                  "quantize_activations_int8 and "
                  "aphrodite_tpu/quantization/qlinear.py:72 "
                  "_fp8_w8a8_matmul's activation cast (XLA code)"),
        launches=sum(by_path.values()),
        launches_in_graph_replays=in_replays("quantize_activations"),
        launches_by_path=by_path,
        max_abs_err=errs["quantize_activations"],
        **{k: head[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
        shape="int8, T=32, K=4096", points=act_points))
    # The FP8 W8A8 product: the quantizer (counted above) and one entry per
    # body the paths launched: the e4m3 mma.sync body of csrc/int4_matmul.cu
    # ("fp8_w8a8_matmul" as in earlier slices) with the headline times of
    # the largest site at the decode step's size, the f16 wgmma body (the
    # prefill body's e4m3 form, built in csrc/int4_matmul.cu) at a
    # 2048-token prefill step; every (site, T) point follows in "points".
    fp8_bodies = {"e4m3_mma": ("aphrodite_tpu_torch/csrc/int4_matmul.cu", 16,
                               "fp8_w8a8_matmul"),
                  "f16_wgmma": ("aphrodite_tpu_torch/csrc/dequant_gemm.cuh",
                                2048, "fp8_w8a8_matmul_f16_wgmma")}
    fp8_by_body = {b: sum(on_paths(f"fp8_w8a8_matmul_{b}").values())
                   for b in fp8_bodies}
    if not sum(fp8_by_body.values()):
        fail("fp8_w8a8_matmul was launched on no main path")
    for body, (src, T, name) in fp8_bodies.items():
        by_path = on_paths(f"fp8_w8a8_matmul_{body}")
        if not sum(by_path.values()):
            # main_path held each forward's launches to fp8_route at its T:
            # no forward of the paths was under FP8_WGMMA_MIN_T tokens.
            continue
        points = [p for p in fp8_points if p["body"] == body]
        head = next(p for p in points if p["site"] == "w13" and p["T"] == T)
        kernels.append(dict(
            name=name, route="cuda", source=src,
            replaces=("aphrodite_tpu/quantization/qlinear.py:72 "
                      "_fp8_w8a8_matmul's product (XLA code, no Pallas "
                      "kernel)"),
            launches=sum(by_path.values()),
            launches_in_graph_replays=in_replays(
                f"fp8_w8a8_matmul_{body}"),
            launches_by_path=by_path,
            launches_by_body=fp8_by_body,
            max_abs_err=errs[f"fp8_w8a8_matmul_{body}"],
            **{k: head[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")},
            library="torch._scaled_mm on the same e4m3 operands",
            shape=(f"w13 4096x28672 T={T} (quantizer and scaling "
                   "included)"),
            points=points))
    # The page-gather probe (TPU kernel row 9), on its own entry point.
    kernels.append(dict(
        name="gather_probe", route="cuda",
        source="aphrodite_tpu_torch/csrc/gather_probe.cu",
        replaces="tools/probe_gather_bw.py:84",
        launches=probe_launches, launches_in_graph_replays=0,
        launches_by_path={"probe_gather_bw main": probe_launches},
        max_abs_err=errs["gather_probe"],
        **{k: probe_times[k] for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
        library="index_select of the same pages, then a sum",
        shape=probe_times["shape"]))
    print(f"sampler ({card}): " + json.dumps(
        {"max_err_over_row_max": sampler_errs, "ms": sampler_times}),
        flush=True)
    for a, b in (("samplers, history-free", "gptq+fp8_e4m3"),
                 ("samplers, history", "gptq+fp8_e4m3")):
        print(f"rates {a} against {b} (this run): decode "
              f"{rates[a]['decode_tok_s']:.1f} against "
              f"{rates[b]['decode_tok_s']:.1f} tok/s, prefill "
              f"{rates[a]['prefill_tok_s']:.1f} against "
              f"{rates[b]['prefill_tok_s']:.1f} tok/s", flush=True)
    for path in encdec_paths():
        r = rates[path]
        print(f"encoder-decoder {path} ({card}): " + json.dumps(r),
              flush=True)
    for path, r in rates.items():
        if "moe" in r:
            print(f"moe {path} ({card}): " + json.dumps(dict(
                decode_tok_s=r["decode_tok_s"],
                prefill_tok_s=r["prefill_tok_s"],
                window_ms=r["window_check"]["graphed_ms"], **r["moe"])),
                flush=True)
    print("rates: " + json.dumps(rates), flush=True)
    print(f"total: {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
