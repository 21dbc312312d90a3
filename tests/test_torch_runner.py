"""The port's fused decode window, its carry, window chaining and the
sampling-tensor cache against the JAX package, on the CPU.

The JAX runner compiles a decode window into one program
(``_get_multi_step_fn``), keeps its carry on the device, dispatches the
next step's first window before it reads this step's outputs
(``_can_chain_window``) and reuses an all-greedy step's sampling tensors;
its scheduler reserves KV for the chained window of eligible requests.
The port runs the same window as one function of static buffers (a CUDA
graph on a card, eagerly here). Each test runs both packages on the same
inputs: a tiny float32 checkpoint, or the same scheduled rows.
"""

import ast
import inspect
import pathlib
import types
from typing import get_args

import numpy as np
import pytest
import torch

import aphrodite_tpu.common.config as jax_config
import aphrodite_tpu.common.sampling_params as jax_sp
import aphrodite_tpu.common.sequence as jax_seq
import aphrodite_tpu.processing.scheduler as jax_sched
import aphrodite_tpu.sampling.metadata as jax_meta
import aphrodite_tpu.worker.model_runner as jax_runner
import aphrodite_tpu_torch.common.config as port_config
import aphrodite_tpu_torch.common.sampling_params as port_sp
import aphrodite_tpu_torch.common.sequence as port_seq
import aphrodite_tpu_torch.processing.scheduler as port_sched
import aphrodite_tpu_torch.sampling.metadata as port_meta
import aphrodite_tpu_torch.worker.model_runner as port_runner
from aphrodite_tpu import LLM as JaxLLM
from aphrodite_tpu import SamplingParams as JaxSamplingParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.ops import decode_attention, quant_matmul
from aphrodite_tpu_torch.ops import launches as launches_mod
from aphrodite_tpu_torch.tools import decode_ab, window_check

PROMPTS = ["the quick brown fox", "hello world this is"]
# tests/test_multi_step.py's chaining settings.
ENGINE_KW = dict(dtype="float32", max_num_seqs=4,
                 num_device_blocks_override=128, block_size=8)

# Each package's classes under one set of names.
JAX = types.SimpleNamespace(
    SamplingParams=jax_sp.SamplingParams, Sequence=jax_seq.Sequence,
    SequenceGroup=jax_seq.SequenceGroup,
    ScheduledSequence=jax_seq.ScheduledSequence,
    SamplingFlags=jax_meta.SamplingFlags, Scheduler=jax_sched.Scheduler,
    SchedulerConfig=jax_config.SchedulerConfig,
    CacheConfig=jax_config.CacheConfig,
    can_chain=jax_runner.ModelRunner._can_chain_window)
PORT = types.SimpleNamespace(
    SamplingParams=port_sp.SamplingParams, Sequence=port_seq.Sequence,
    SequenceGroup=port_seq.SequenceGroup,
    ScheduledSequence=port_seq.ScheduledSequence,
    SamplingFlags=port_meta.SamplingFlags, Scheduler=port_sched.Scheduler,
    SchedulerConfig=port_config.SchedulerConfig,
    CacheConfig=port_config.CacheConfig,
    can_chain=port_runner.ModelRunner._can_chain_window)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from tests.utils import make_tiny_llama_checkpoint

    path = tmp_path_factory.mktemp("tiny_llama_runner")
    make_tiny_llama_checkpoint(str(path))
    return str(path)


def _hits(llm) -> int:
    return getattr(llm.engine.runner, "chained_window_hits", 0)


def _tokens(outs):
    return [o.outputs[0].token_ids for o in outs]


@pytest.mark.parametrize("chain", ["on", "off"])
@pytest.mark.parametrize("steps", [4, 8])
def test_greedy_tokens_and_chaining_match_jax(model_dir, monkeypatch, steps,
                                              chain):
    """tests/test_multi_step.py's chaining test, both packages: greedy
    tokens equal, the chained window taken with chaining on and never
    with APHRODITE_CHAIN_WINDOWS=0."""
    if chain == "off":
        monkeypatch.setenv("APHRODITE_CHAIN_WINDOWS", "0")
    else:
        monkeypatch.delenv("APHRODITE_CHAIN_WINDOWS", raising=False)
    kw = dict(ENGINE_KW, num_scheduler_steps=steps)
    jax_llm = JaxLLM(model=model_dir, **kw)
    want = _tokens(jax_llm.generate(PROMPTS, JaxSamplingParams(
        temperature=0.0, max_tokens=24, ignore_eos=True)))
    llm = LLM(model=model_dir, device="cpu", **kw)
    got = _tokens(llm.generate(PROMPTS, SamplingParams(
        temperature=0.0, max_tokens=24, ignore_eos=True)))
    assert got == want
    if chain == "on":
        assert _hits(jax_llm) > 0 and _hits(llm) > 0
    else:
        assert _hits(jax_llm) == 0 and _hits(llm) == 0


def test_seeded_request_blocks_chaining(model_dir, monkeypatch):
    """tests/test_multi_step.py's seeded test: an explicit seed makes the
    batch ineligible in both packages, so the port's tokens are the same
    with chaining on and off."""
    kw = dict(ENGINE_KW, num_scheduler_steps=4)
    jax_llm = JaxLLM(model=model_dir, **kw)
    jax_llm.generate(["hello world"], JaxSamplingParams(
        temperature=1.0, seed=1234, max_tokens=16, ignore_eos=True))
    assert _hits(jax_llm) == 0
    sp = SamplingParams(temperature=1.0, seed=1234, max_tokens=16,
                        ignore_eos=True)
    llm = LLM(model=model_dir, device="cpu", **kw)
    got = _tokens(llm.generate(["hello world"], sp))
    assert _hits(llm) == 0
    monkeypatch.setenv("APHRODITE_CHAIN_WINDOWS", "0")
    plain = LLM(model=model_dir, device="cpu", **kw)
    assert _tokens(plain.generate(["hello world"], sp)) == got


SAMPLING_GRID = [
    dict(temperature=0.0), dict(temperature=0.8),
    dict(temperature=0.8, seed=1), dict(temperature=0.0, seed=1),
    dict(temperature=0.8, top_p=0.9, top_k=20, min_p=0.05),
    dict(temperature=0.0, presence_penalty=0.5),
    dict(temperature=0.0, frequency_penalty=0.5),
    dict(temperature=0.0, repetition_penalty=1.2),
    dict(temperature=0.0, no_repeat_ngram_size=3),
    dict(temperature=0.0, dry_multiplier=0.5),
    dict(temperature=0.0, min_tokens=2),
    dict(temperature=0.0, custom_token_bans=[5]),
    dict(temperature=0.0, guided_regex="[ab]+"),
    dict(temperature=0.0, logprobs=2, stop=["zz"]),
]


@pytest.mark.parametrize("kw", SAMPLING_GRID, ids=str)
def test_chain_speculation_eligible_matches_jax(kw):
    want = JAX.SamplingParams(max_tokens=8, **kw).chain_speculation_eligible
    assert PORT.SamplingParams(max_tokens=8,
                               **kw).chain_speculation_eligible == want


def _scheduled(pkg, rows, block_size=8):
    """ScheduledSequences of `pkg` for rows of (sampling kwargs, output
    tokens, KV blocks): a 10-token prompt, everything computed."""
    out = []
    for i, (sp_kw, n_out, blocks) in enumerate(rows):
        seq = pkg.Sequence(seq_id=i, prompt_token_ids=list(range(10)),
                           block_size=block_size)
        for _ in range(n_out):
            seq.append_token_id(5)
        seq.num_computed_tokens = seq.get_len() - 1
        group = pkg.SequenceGroup(
            request_id=str(i), seqs=[seq],
            sampling_params=pkg.SamplingParams(**sp_kw))
        out.append(pkg.ScheduledSequence(
            seq=seq, group=group, num_tokens=1,
            first_token_idx=seq.num_computed_tokens,
            block_ids=list(range(i * 8, i * 8 + blocks)), do_sample=True))
    return out


GREEDY = dict(temperature=0.0, max_tokens=40)
# (rows, flags, done, W, APHRODITE_CHAIN_WINDOWS, fsm on row 0): the rows
# hold 11-15 tokens, so 4 blocks of 8 leave room for two windows of 4 and
# 3 blocks for one.
CHAIN_CASES = {
    "eligible": ([(GREEDY, 1, 4), (GREEDY, 3, 4)], {}, 4, 4, "1", False),
    "no_room": ([(GREEDY, 1, 4), (GREEDY, 3, 3)], {}, 4, 4, "1", False),
    "certain_finish": ([(dict(GREEDY, max_tokens=8), 4, 4)], {}, 4, 4, "1",
                       False),
    "seeded": ([(dict(temperature=1.0, seed=3, max_tokens=40), 1, 4)],
               dict(all_greedy=False), 4, 4, "1", False),
    "unseeded": ([(dict(temperature=1.0, max_tokens=40), 1, 4)],
                 dict(all_greedy=False), 4, 4, "1", False),
    "penalties_flag": ([(GREEDY, 1, 4)], dict(do_penalties=True), 4, 4, "1",
                       False),
    "min_tokens_flag": ([(GREEDY, 1, 4)], dict(do_min_tokens=True), 4, 4,
                        "1", False),
    "penalised_row": ([(dict(GREEDY, repetition_penalty=1.2), 1, 4)], {}, 4,
                      4, "1", False),
    "fsm": ([(GREEDY, 1, 4)], {}, 4, 4, "1", True),
    "chain_off": ([(GREEDY, 1, 4)], {}, 4, 4, "0", False),
    "window_8": ([(GREEDY, 1, 4)], {}, 8, 8, "1", False),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_can_chain_window_matches_jax(case, monkeypatch):
    rows, flags_kw, done, W, env, fsm = CHAIN_CASES[case]
    monkeypatch.setenv("APHRODITE_CHAIN_WINDOWS", env)
    got = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        scheduled = _scheduled(pkg, rows)
        if fsm:
            scheduled[0].seq.fsm = object()
        runner = types.SimpleNamespace(block_size=8, _multihost=False)
        got[name] = pkg.can_chain(runner, scheduled,
                                  pkg.SamplingFlags(**flags_kw), done, W)
    assert got["port"] == got["jax"]


def _decode_tables(pkg, nss, sp_kw, steps=3):
    """Block-table lengths of one request after a prefill and each of
    `steps` decode steps (tests/test_scheduler.py's _decode_table_len)."""
    sched_cfg = pkg.SchedulerConfig(
        max_num_batched_tokens=64, max_num_seqs=8, max_model_len=128,
        enable_chunked_prefill=True, num_scheduler_steps=nss)
    cache_cfg = pkg.CacheConfig(block_size=4)
    cache_cfg.num_device_blocks = 64
    s = pkg.Scheduler(sched_cfg, cache_cfg)
    seq = pkg.Sequence(seq_id=0, prompt_token_ids=list(range(8)),
                       block_size=4)
    group = pkg.SequenceGroup(request_id="r0", seqs=[seq],
                              sampling_params=pkg.SamplingParams(
                                  max_tokens=64, **sp_kw))
    s.add_seq_group(group)
    lens = []
    for _ in range(steps + 1):
        out = s.schedule()
        s.mark_step_computed(out)
        for ss in out.scheduled:
            if ss.do_sample:
                ss.seq.append_token_id(7)
        lens.append(len(s.block_manager.get_block_table(seq)))
    return lens


@pytest.mark.parametrize("nss,sp_kw,env", [
    (8, dict(temperature=0.0), "1"),
    (8, dict(temperature=1.0, seed=3), "1"),
    (8, dict(temperature=0.0, repetition_penalty=1.2), "1"),
    (8, dict(temperature=0.0), "0"),
    (4, dict(temperature=0.8), "1"),
    (1, dict(temperature=0.0), "1"),
], ids=["greedy", "seeded", "penalised", "chain_off", "unseeded_nss4",
        "nss1"])
def test_scheduler_reservations_match_jax(nss, sp_kw, env, monkeypatch):
    monkeypatch.setenv("APHRODITE_CHAIN_WINDOWS", env)
    want = _decode_tables(JAX, nss, sp_kw)
    assert _decode_tables(PORT, nss, sp_kw) == want
    if env == "1" and nss > 1 and JAX.SamplingParams(
            **sp_kw).chain_speculation_eligible:
        # One window beyond the plain multi-step lookahead.
        assert PORT.Scheduler(
            PORT.SchedulerConfig(num_scheduler_steps=nss),
            _sized_cache()).num_chain_lookahead_slots == nss


def _sized_cache():
    cfg = PORT.CacheConfig(block_size=4)
    cfg.num_device_blocks = 64
    return cfg


@pytest.fixture
def cpu_runner(model_dir):
    return LLM(model=model_dir, device="cpu",
               num_scheduler_steps=4, **ENGINE_KW).engine.runner


def test_sampling_tensor_cache(cpu_runner, monkeypatch):
    """An all-greedy step whose rows are the previous step's builds and
    uploads nothing; a joined row or a stochastic row misses, and a
    stochastic step is not kept."""
    built = []
    build = port_runner.build_sampling_tensors
    monkeypatch.setattr(port_runner, "build_sampling_tensors",
                        lambda *a, **k: built.append(1) or build(*a, **k))
    uploaded = []
    to_device = port_runner.tensors_to_device
    monkeypatch.setattr(port_runner, "tensors_to_device",
                        lambda *a: uploaded.append(1) or to_device(*a))
    runner = cpu_runner
    rows = _scheduled(PORT, [(GREEDY, 1, 4), (GREEDY, 2, 4)])
    first = runner._sampling_inputs(rows, 8)
    assert (len(built), len(uploaded), runner.sampling_cache_hits) == (1, 1,
                                                                       0)
    again = runner._sampling_inputs(rows, 8)
    assert again[0] is first[0] and again[1] == first[1]
    assert (len(built), len(uploaded), runner.sampling_cache_hits) == (1, 1,
                                                                       1)
    joined = rows + _scheduled(PORT, [(GREEDY, 1, 4)] * 3)[2:]
    runner._sampling_inputs(joined, 8)
    assert (len(built), runner.sampling_cache_hits) == (2, 1)
    stochastic = _scheduled(PORT, [(GREEDY, 1, 4),
                                   (dict(temperature=0.7), 1, 4)])
    for _ in range(2):
        runner._sampling_inputs(stochastic, 8)
    assert (len(built), runner.sampling_cache_hits) == (4, 1)
    assert runner._sampling_cache is None


def test_decode_carry_hits_and_misses_match_jax(model_dir, monkeypatch):
    """With chaining off, a steady batch reuses the device carry and
    uploads none; after a finish the batch changes and the carry is
    rebuilt. Tokens equal the JAX engine's either way."""
    monkeypatch.setenv("APHRODITE_CHAIN_WINDOWS", "0")
    kw = dict(ENGINE_KW, num_scheduler_steps=4)
    lens = [24, 12]
    want = _tokens(JaxLLM(model=model_dir, **kw).generate(PROMPTS, [
        JaxSamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)
        for n in lens]))
    llm = LLM(model=model_dir, device="cpu", **kw)
    runner = llm.engine.runner
    carry_uploads = []
    upload = port_runner._upload_into

    def counted(dst, host):
        if any(dst is b.carry for b in runner._window_buffers.values()):
            carry_uploads.append(int(host[0]))
        upload(dst, host)

    monkeypatch.setattr(port_runner, "_upload_into", counted)
    got = _tokens(llm.generate(PROMPTS, [
        SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)
        for n in lens]))
    assert got == want
    # 23 decode tokens of the long row in windows of 4 (the 12-token row
    # finishes after its third): a carry upload at the first window and
    # after the finish, a hit on every other step.
    assert len(carry_uploads) == 2
    assert runner.carry_hits == 4 and runner.chained_window_hits == 0


def test_chained_window_not_taken_rebuilds_the_carry(model_dir,
                                                    monkeypatch):
    """A chained window dispatched ahead of a step that does not take it
    (here a stop token ends a row) leaves the carry a window ahead: the
    next step rebuilds it, and the tokens still equal the JAX engine's."""
    kw = dict(ENGINE_KW, num_scheduler_steps=4)
    jax_llm = JaxLLM(model=model_dir, **kw)
    greedy = _tokens(jax_llm.generate(PROMPTS, JaxSamplingParams(
        temperature=0.0, max_tokens=24, ignore_eos=True)))
    # Row 1 stops at the first token past its 8th that it has not made
    # before, a finish no gate foresees.
    j = next(j for j in range(8, 24) if greedy[1][j] not in greedy[1][:j])
    stop = [greedy[1][j]]
    want = _tokens(jax_llm.generate(PROMPTS, [
        JaxSamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True),
        JaxSamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True,
                          stop_token_ids=stop)]))
    llm = LLM(model=model_dir, device="cpu", **kw)
    runner = llm.engine.runner
    dispatched = []
    can_chain = runner._can_chain_window

    def counted(*a):
        dispatched.append(can_chain(*a))
        return dispatched[-1]

    monkeypatch.setattr(runner, "_can_chain_window", counted)
    got = _tokens(llm.generate(PROMPTS, [
        SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True),
        SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True,
                       stop_token_ids=stop)]))
    assert got == want and len(got[1]) == j + 1
    assert 0 < runner.chained_window_hits < sum(dispatched)


def test_window_function_is_the_eager_loop(cpu_runner):
    """decode_window on the static buffers advances the carry in place and
    gives, bit for bit, what W single-step forwards give on the same cache
    and rows (the port's pre-window loop), and again from a reloaded
    carry."""
    from aphrodite_tpu_torch.models.interface import ForwardBatch
    from aphrodite_tpu_torch.sampling.sampler import sample

    runner, S, W = cpu_runner, 8, 4
    rng = np.random.default_rng(0)
    runner.kv_cache.copy_(torch.from_numpy(rng.standard_normal(
        tuple(runner.kv_cache.shape)).astype(np.float32)))
    rows = _scheduled(PORT, [(GREEDY, 1, 4), (GREEDY, 2, 4)])
    tensors, flags, _ = runner._sampling_inputs(rows, S)
    buf = runner.window_buffers(S)
    pps = runner.pages_per_seq
    sched = np.zeros((S * pps + S + 1,), np.int32)
    for i, ss in enumerate(rows):
        sched[i * pps:i * pps + 4] = ss.block_ids
        sched[S * pps + i] = 32
    sched[-1] = len(rows)
    carry = np.zeros((2 * S + 1,), np.int32)
    carry[:2] = [17, 29]
    carry[S:S + 2] = [ss.seq.num_computed_tokens for ss in rows]
    cache0 = runner.kv_cache.clone()
    with torch.inference_mode():
        buf.sched.copy_(torch.from_numpy(sched))
        buf.carry.copy_(torch.from_numpy(carry))
        runner.load_window_tensors(buf, tensors)
        packed = runner.decode_window(buf, flags, W)
        got_carry = buf.carry.clone()
        cache1 = runner.kv_cache.clone()
        # The same steps one forward at a time.
        runner.kv_cache.copy_(cache0)
        ids = torch.from_numpy(carry[:S].copy())
        pos = torch.from_numpy(carry[S:2 * S].copy())
        table = torch.from_numpy(sched[:S * pps].reshape(S, pps).copy())
        outs = []
        for _ in range(W):
            slot = torch.full((S,), runner.trash_slot_base,
                              dtype=torch.int32)
            slot += torch.arange(S, dtype=torch.int32) % runner.block_size
            for i in range(len(rows)):
                p = int(pos[i])
                slot[i] = int(table[i, p // 8]) * 8 + p % 8
            kv_lens = torch.where(torch.arange(S) < len(rows), pos + 1, 0)
            batch = ForwardBatch(ids, pos, slot, kv_lens.int(), table, None,
                                 torch.tensor([len(rows)], dtype=torch.int32),
                                 torch.arange(S, dtype=torch.int32))
            hidden = runner.model.forward(runner.params, runner.kv_cache,
                                          batch, runner.kv_scales)
            step = len(outs)
            out = sample(runner.model.compute_logits(runner.params, hidden),
                         tensors._replace(key_data=port_runner._fold_key_data(
                             tensors.key_data, step)), flags)
            outs.append(out)
            ids, pos = out.sampled, pos + 1
        want = port_runner._pack_step_outputs(outs)
        assert torch.equal(packed, want)
        assert torch.equal(got_carry[:S], ids)
        assert torch.equal(got_carry[S:2 * S], pos)
        assert int(got_carry[2 * S]) == W
        assert torch.equal(runner.kv_cache[:, :-1], cache1[:, :-1])
        # Reloading the carry and the cache gives the same window again.
        runner.kv_cache.copy_(cache0)
        buf.carry.copy_(torch.from_numpy(carry))
        assert torch.equal(runner.decode_window(buf, flags, W), packed)


@pytest.mark.parametrize("capturing", [False, True])
def test_count_launch_counts_nothing_under_capture(monkeypatch, capturing):
    """count_launch adds one to a wrapper's total and to each keyed count;
    while the current stream is being captured into a CUDA graph it counts
    nothing: a capture launches nothing, and the replays are counted by
    tracing them."""
    monkeypatch.setattr(launches_mod, "capturing", lambda: capturing)
    fn = types.SimpleNamespace(launches=0, launches_by_dtype={},
                               launches_by_shape={"qg4 d128": 2})
    for _ in range(2):
        launches_mod.count_launch(fn, dtype="bf16", shape="qg4 d128")
    if capturing:
        assert (fn.launches, fn.launches_by_dtype, fn.launches_by_shape) == (
            0, {}, {"qg4 d128": 2})
    else:
        assert (fn.launches, fn.launches_by_dtype, fn.launches_by_shape) == (
            2, {"bf16": 2}, {"qg4 d128": 4})


def test_launch_counts_grow_only_in_count_launch():
    """No wrapper of the port's ops grows a launch count but through
    count_launch, so none counts a launch that a capture only records."""
    ops_dir = pathlib.Path(launches_mod.__file__).parent
    for path in sorted(ops_dir.glob("*.py")):
        if path.name == "launches.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            # `x.launches... += n`, or `x.launches_by_...[key] = n`; a
            # plain `x.launches = 0` only sets a count up.
            if isinstance(node, ast.AugAssign):
                targets = [node.target]
            elif isinstance(node, ast.Assign):
                targets = [t.value for t in node.targets
                           if isinstance(t, ast.Subscript)]
            else:
                continue
            for t in targets:
                while isinstance(t, ast.Subscript):
                    t = t.value
                assert not (isinstance(t, ast.Attribute)
                            and t.attr.startswith("launches")), (
                    f"{path.name}:{node.lineno} counts a launch outside "
                    "count_launch")
    assert not launches_mod.capturing()  # no card here


# (traced kernel name, its base): the forms torch.profiler gives.
TRACED_NAMES = [
    ("void (anonymous namespace)::paged_decode_kernel<kv_page::Bf16, 128, "
     "false>(__nv_bfloat16 const*, unsigned char const*)",
     "paged_decode_kernel"),
    ("void dqd::decode_gemm_kernel<4, 0>(CUtensorMap_st, CUtensorMap_st)",
     "decode_gemm_kernel"),
    ("split_reduce_kernel(float4 const*, float4*, unsigned long, int)",
     "split_reduce_kernel"),
    ("nvjet_tss_512x32_64x3_2x1_v_bz_NNT",
     "nvjet_tss_512x32_64x3_2x1_v_bz_NNT"),
]


@pytest.mark.parametrize("name,base", TRACED_NAMES)
def test_traced_kernel_names_reduce_to_the_port_kernels(name, base):
    """The trace of a replay is matched to the port's kernels by their
    function names, read from every __global__ of csrc/."""
    ours = window_check.port_kernel_names()
    assert window_check.kernel_base(name) == base
    assert (base in ours) == (not base.startswith("nvjet"))
    assert {"paged_decode_kernel", "paged_decode_combine_kernel",
            "ragged_paged_attention_kernel", "decode_gemm_kernel",
            "step_sums_kernel", "dequant_gemm_kernel", "int4_matmul_kernel",
            "int4p_matmul_kernel", "int4p_matmul_w4a8_kernel",
            "quantize_rows_kernel", "split_reduce_kernel",
            "split_reduce_scaled_kernel"} <= ours


def test_decode_ab_runs_chip_smokes_own_paths():
    """decode_ab takes its paths and their arguments from
    chip_smoke.main_paths, so the two cannot drift apart: every default
    path is there, and its arguments bind to main_path's."""
    import json
    import sys

    for path in decode_ab.PATHS:
        kw = json.loads(decode_ab.path_arguments(path))
        assert "window_check" not in kw
        inspect.signature(sys.modules["chip_smoke"].main_path).bind(
            "cuda", **kw)


# The planners the captured window's wrappers consult: each takes host
# values only (ints, strings, bools), so one plan holds for every replay
# of a graph whatever the tensors hold.
PLANNERS = (decode_attention.plan_decode_splits, quant_matmul.decode_route,
            quant_matmul.decode_plan, quant_matmul.dequant_gemm_plan,
            quant_matmul.int4p_body, quant_matmul.int4_route,
            quant_matmul.fp8_route, quant_matmul.kernel_plan,
            quant_matmul.int4_kernel_plan)


@pytest.mark.parametrize("planner", PLANNERS, ids=lambda f: f.__name__)
def test_window_plans_are_functions_of_shapes(planner):
    for p in inspect.signature(planner).parameters.values():
        kinds = set(get_args(p.annotation)) or {p.annotation}
        assert kinds <= {int, str, bool, type(None)}, (p.name, p.annotation)
    table_a = torch.zeros((8, 257), dtype=torch.int32)
    table_b = torch.randint(0, 1000, (8, 257), dtype=torch.int32)
    args = {
        "plan_decode_splits": lambda t: (t.shape[0], 8, t.shape[1] * 16, 16,
                                         132),
        "decode_route": lambda t: (t.shape[0], 4096, 28672, 128, "packed"),
        "decode_plan": lambda t: (t.shape[0], 4096, 28672, 128, "packed"),
        "dequant_gemm_plan": lambda t: (t.shape[1], 4096, 6144, 128,
                                        "packed"),
        "int4p_body": lambda t: (t.shape[0],),
        "int4_route": lambda t: (t.shape[0],),
        "fp8_route": lambda t: (t.shape[0],),
        "kernel_plan": lambda t: (t.shape[0], 4096, 6144),
        "int4_kernel_plan": lambda t: (t.shape[0], 4096, 6144, 16,
                                       "groupwise"),
    }[planner.__name__]
    assert planner(*args(table_a)) == planner(*args(table_b))


def test_window_case_runs_both_ways_on_the_cpu(cpu_runner):
    """The card's graph-against-eager check (tools/window_check.py), where
    both ways are the eager function: equal windows, a carry advanced by
    W each window, tokens in the vocabulary."""
    from aphrodite_tpu_torch.tools.window_check import (WindowCase,
                                                        equal_windows)

    case = WindowCase(cpu_runner, 8, [20, 33, 5], W=4, seed=0)
    eager = case.windows("eager", 3)
    assert equal_windows(eager, case.windows("graphed", 3))
    for i, (packed, carry) in enumerate(eager):
        assert list(carry[8:11]) == [20 + 4 * (i + 1), 33 + 4 * (i + 1),
                                     5 + 4 * (i + 1)]
        assert carry[16] == 4 * (i + 1)
        sampled = packed[:4 * 8].reshape(4, 8)[:, :3]
        assert ((0 <= sampled) & (sampled < 256)).all()
    assert not equal_windows(eager[:1], eager[1:2])
