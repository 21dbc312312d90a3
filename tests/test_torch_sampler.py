"""The port's sampler stage by stage against the JAX sampler, and its
per-row seeded streams, on the CPU.

Each stage runs in both packages on the same numpy logits and on sampling
tensors that both packages' ``build_sampling_tensors`` make from the same
rows (asserted equal): the kept set (the tokens left finite) must be
exact, and the values within 1e-5 of the row's largest magnitude. Skew is
held in probability space: the JAX package differences its powered CDF
in f32, where a tail token's share is rounding noise or 0; the port
takes each share without that cancellation, in f64. TFS: on a row
at tfs 1 in a batch that runs the stage, the JAX package's f32 CDF can end
above 1 and drop the row's second least likely token as well as its least
likely one; the port's CDF ends at 1 exactly and keeps it, which is the
one difference of kept sets allowed (``tfs_off``).

The port's noise is keyed per row like the JAX package's but drawn
through other folds, so random rows are held by distribution: a row's
draws depend only on its key and step, and 4000 seeded draws follow the
JAX package's shaped distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aphrodite_tpu.sampling.sampler as J
import aphrodite_tpu_torch.sampling.sampler as P
import aphrodite_tpu_torch.worker.model_runner as port_runner
from aphrodite_tpu.common.sampling_params import \
    SamplingParams as JaxSamplingParams
from aphrodite_tpu.sampling.metadata import \
    SamplerInputRow as JaxRow
from aphrodite_tpu.sampling.metadata import \
    build_sampling_tensors as jax_build
from aphrodite_tpu_torch.common.sampling_params import (SamplerID,
                                                        SamplingParams)
from aphrodite_tpu_torch.sampling.metadata import (SamplerInputRow,
                                                   build_sampling_tensors)

CPU = torch.device("cpu")
# The JAX pipeline and the history stages compiled once per flags (their
# op-by-op dispatch takes seconds a call on the CPU).
jax_shaped_logprobs = jax.jit(J.shaped_logprobs, static_argnums=(2,))
jax_sample = jax.jit(J.sample, static_argnums=(2,))
JAX_HISTORY = {"dry": jax.jit(J._apply_dry, static_argnums=(4,)),
               "no_repeat_ngram": jax.jit(J._apply_no_repeat_ngram,
                                          static_argnums=(4,))}


class Case:
    """The same rows through both packages: sampling tensors and flags
    (asserted equal), histories and numpy logits [S, V] from a seed (a
    normal of scale 2, and in row 1 a few -inf entries, as a ban before
    the stage leaves them)."""

    def __init__(self, kws, V=256, S=None, seed=0, histories=None,
                 prompt_len=4, generated=0, history_pad=0):
        S = S or len(kws)
        histories = histories or [[1, 2, 3]] * len(kws)
        rows, jrows = [], []
        for i, (kw, hist) in enumerate(zip(kws, histories)):
            plen = min(prompt_len, len(hist))
            common = dict(token_ids=list(hist), prompt_len=plen,
                          generated_len=generated + len(hist) - plen,
                          seed=1000 + i, eos_token_id=V - 1)
            rows.append(SamplerInputRow(params=SamplingParams(**kw),
                                        **common))
            jrows.append(JaxRow(params=JaxSamplingParams(**kw), **common))
        pt, self.flags, ph, phl = build_sampling_tensors(
            rows, S, V, history_pad=history_pad)
        jt, jflags, jh, _ = jax_build(jrows, S, V, history_pad=history_pad)
        assert tuple(self.flags) == tuple(jflags)
        for a, b in zip(pt, jt):
            np.testing.assert_array_equal(a, b)
        self.t = P.tensors_to_device(pt, CPU)
        self.jt = type(jt)(*map(jnp.asarray, jt))
        self.hist = None
        if ph is not None:
            np.testing.assert_array_equal(ph, jh)
            self.hist = (ph, *phl)
        rng = np.random.default_rng(seed)
        self.logits = (rng.standard_normal((S, V)) * 2).astype(np.float32)
        self.logits[1 % S, rng.integers(0, V, 5)] = -np.inf
        self.V, self.S = V, S

    def port_hist(self):
        return [torch.from_numpy(a) for a in self.hist]

    def jax_hist(self):
        return [jnp.asarray(a) for a in self.hist]


def tfs_off(c, flags=None):
    """Rows at tfs 1 of a batch that runs TFS."""
    flags = flags or c.flags
    return (c.t.tfs.numpy() >= 1.0) & flags.do_tfss


def assert_same(got, want, probs=False, tfs_rows=None):
    """The kept set exact, the finite values within 1e-5 of the row's
    largest magnitude (probs: compared as probabilities). On `tfs_rows`
    the JAX side may have removed one more token, the port's least likely
    kept one (TFS's CDF, above)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    want = want.copy()
    for r in np.nonzero(tfs_rows if tfs_rows is not None else [])[0]:
        extra = np.isfinite(got[r]) & ~np.isfinite(want[r])
        if extra.any():
            least = np.argmin(np.where(np.isfinite(got[r]), got[r], np.inf))
            assert extra.sum() == 1 and extra[least]
            want[r, least] = got[r, least]
    if probs:
        got, want = np.exp(got), np.exp(want)
    else:
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = np.isfinite(want)
    scale = np.abs(np.where(finite, want, 0)).max(axis=-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        err = np.abs(np.where(finite, got - want, 0))
    assert (err <= 1e-5 * scale).all(), float((err / scale).max())


# (rows' sampling kwargs, port stage, JAX stage) of each distribution
# stage; every case has a row with the stage off (its default values).
OFF = dict(temperature=1.0)
STAGES = {
    "temperature": ([dict(temperature=0.7), dict(temperature=0.05),
                     dict(temperature=1.0, dynatemp_min=0.5,
                          dynatemp_max=1.5, dynatemp_exponent=1.3),
                     OFF],
                    P._apply_temperatures,
                    lambda lg, t: J._apply_temperatures(lg, t, None)),
    "top_k_top_p": ([dict(temperature=1.0, top_k=7, top_p=0.8),
                     dict(temperature=1.0, top_p=0.5),
                     dict(temperature=1.0, top_k=3), OFF],
                    P._apply_top_k_top_p, J._apply_top_k_top_p),
    "min_p": ([dict(temperature=1.0, min_p=0.1),
               dict(temperature=1.0, min_p=0.3), OFF],
              P._apply_min_p, J._apply_min_p),
    "top_a": ([dict(temperature=1.0, top_a=0.2),
               dict(temperature=1.0, top_a=0.5), OFF],
              P._apply_top_a, J._apply_top_a),
    "tfs": ([dict(temperature=1.0, tfs=0.9), dict(temperature=1.0, tfs=0.5),
             OFF], P._apply_tfs, J._apply_tfs),
    "eta_cutoff": ([dict(temperature=1.0, eta_cutoff=3.0),
                    dict(temperature=1.0, eta_cutoff=15.0), OFF],
                   P._apply_eta_cutoff, J._apply_eta_cutoff),
    "epsilon_cutoff": ([dict(temperature=1.0, epsilon_cutoff=3.0),
                        dict(temperature=1.0, epsilon_cutoff=15.0), OFF],
                       P._apply_epsilon_cutoff, J._apply_epsilon_cutoff),
    "typical_p": ([dict(temperature=1.0, typical_p=0.9),
                   dict(temperature=1.0, typical_p=0.5), OFF],
                  P._apply_typical, J._apply_typical),
    "quadratic": ([dict(temperature=1.0, smoothing_factor=0.3),
                   dict(temperature=1.0, smoothing_factor=0.5,
                        smoothing_curve=2.0), OFF],
                  P._apply_quadratic, J._apply_quadratic),
    "top_nsigma": ([dict(temperature=1.0, nsigma=1.0),
                    dict(temperature=1.0, nsigma=2.0), OFF],
                   P._apply_top_nsigma, J._apply_top_nsigma),
}


@pytest.mark.parametrize("V", [64, 512])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_matches_jax(stage, V):
    kws, port_fn, jax_fn = STAGES[stage]
    c = Case(kws, V=V, seed=V)
    got = port_fn(torch.from_numpy(c.logits).double(), c.t)
    want = jax_fn(jnp.asarray(c.logits), c.jt)
    assert_same(got.numpy(), want, tfs_rows=tfs_off(c)
                if stage == "tfs" else None)
    # Every case's stage removes tokens on some row or moves the values.
    assert not np.array_equal(got.numpy(), c.logits)


@pytest.mark.parametrize("skew", [0.5, -0.7])
def test_skew_matches_jax(skew):
    c = Case([dict(temperature=1.0, skew=skew), OFF], V=128)
    probs = torch.softmax(torch.from_numpy(c.logits).double(), -1)
    got = P._apply_skew(probs, c.t)
    want = J._apply_skew(jnp.asarray(probs.float().numpy()), c.jt)
    assert_same(np.log(got.numpy()), np.log(np.asarray(want)), probs=True)


@pytest.mark.parametrize("probability", [0.0, 1.0])
@pytest.mark.parametrize("threshold", [0.01, 0.1])
def test_xtc_at_probability_0_and_1_matches_jax(probability, threshold):
    """The coin decides nothing at probability 0 or 1: the kept sets and
    values equal the JAX package's exactly."""
    c = Case([dict(temperature=1.0, xtc_probability=probability,
                   xtc_threshold=threshold)] * 3 + [OFF], V=64)
    got = P._apply_xtc(torch.from_numpy(c.logits).double(), c.t)
    want = J._apply_xtc(jnp.asarray(c.logits), c.jt,
                        J._keys_from_data(c.jt.key_data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    removed = np.isinf(got.numpy()).sum(-1) - np.isinf(c.logits).sum(-1)
    assert (removed[:3] > 0).all() == (probability == 1.0)


def test_keep_argmax_matches_jax():
    rng = np.random.default_rng(3)
    remove = rng.random((5, 40)) < 0.7
    probs = rng.random((5, 40)).astype(np.float32)
    probs[2, [4, 9]] = 2.0  # a tie: the first index is kept
    got = P._keep_argmax(torch.from_numpy(remove), torch.from_numpy(probs))
    want = J._keep_argmax(jnp.asarray(remove), jnp.asarray(probs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# History-dependent stages: rows of repeats from a small alphabet, of
# different lengths (padding), one longer than the history window (kept
# from its tail), prompts of 4 tokens.
HISTORIES = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5],
             [7, 3, 7, 3, 9, 7, 3, 7, 3, 9, 7, 3],
             [2, 2, 2, 2, 4, 2, 2, 2, 2, 4, 2, 2, 2, 2, 4, 2, 2, 2, 2, 4,
              2, 2, 2, 2, 4, 2, 2, 2, 2, 4, 2, 2, 2, 2, 4, 2]]
HISTORY_STAGES = {
    "penalties": [dict(temperature=0.0, repetition_penalty=1.3),
                  dict(temperature=0.0, frequency_penalty=0.4,
                       presence_penalty=0.3),
                  dict(temperature=0.0, repetition_penalty=0.8,
                       presence_penalty=-0.5),
                  dict(temperature=0.0)],
    "dry": [dict(temperature=0.0, dry_multiplier=0.8, dry_allowed_length=1),
            dict(temperature=0.0, dry_multiplier=1.0, dry_allowed_length=2,
                 dry_sequence_breaker_ids=[9]),
            dict(temperature=0.0, dry_multiplier=0.5, dry_base=2.0,
                 dry_range=10, dry_allowed_length=1),
            dict(temperature=0.0, dry_multiplier=0.7, dry_allowed_length=1,
                 dry_sequence_breaker_ids=[4])],
    "dry_last_is_breaker": [
        dict(temperature=0.0, dry_multiplier=0.8, dry_allowed_length=1,
             dry_sequence_breaker_ids=[2]),
        dict(temperature=0.0, dry_multiplier=0.8, dry_allowed_length=1,
             dry_sequence_breaker_ids=[5]),
        dict(temperature=0.0, dry_multiplier=0.8, dry_allowed_length=1,
             dry_sequence_breaker_ids=[3]),
        dict(temperature=0.0)],
    "no_repeat_ngram": [dict(temperature=0.0, no_repeat_ngram_size=2),
                        dict(temperature=0.0, no_repeat_ngram_size=3),
                        dict(temperature=0.0, no_repeat_ngram_size=1),
                        dict(temperature=0.0, no_repeat_ngram_size=4)],
}


@pytest.mark.parametrize("history_pad", [8, 64])
@pytest.mark.parametrize("stage", sorted(HISTORY_STAGES))
def test_history_stage_matches_jax(stage, history_pad):
    c = Case(HISTORY_STAGES[stage], V=96, S=6, histories=HISTORIES,
             history_pad=history_pad)
    lg, jlg = torch.from_numpy(c.logits).double(), jnp.asarray(c.logits)
    ph, jh = c.port_hist(), c.jax_hist()
    if stage == "penalties":
        got = P._apply_penalties(lg, c.t, *P._history_masks(*ph, c.V))
        want = J._apply_penalties(jlg, c.jt, *J._history_masks(*jh, c.V))
    elif stage.startswith("dry"):
        got = P._apply_dry(lg, c.t, *ph[:2], c.V)
        want = JAX_HISTORY["dry"](jlg, c.jt, *jh[:2], c.V)
    else:
        got = P._apply_no_repeat_ngram(lg, c.t, *ph[:2], c.V)
        want = JAX_HISTORY["no_repeat_ngram"](jlg, c.jt, *jh[:2], c.V)
    assert_same(got.numpy(), want)
    if stage != "dry_last_is_breaker":
        assert not np.array_equal(got.numpy(), c.logits)


def test_token_id_bans_and_guided_mask_match_jax():
    c = Case([OFF] * 4, V=200)
    rng = np.random.default_rng(5)
    ids = rng.integers(-1, 200, (4, 7)).astype(np.int32)
    got = P._apply_token_id_bans(torch.from_numpy(c.logits),
                                 torch.from_numpy(ids))
    want = J._apply_token_id_bans(jnp.asarray(c.logits), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    words = rng.integers(0, 2**32, (4, 7), dtype=np.uint64).astype(np.uint32)
    got = P.apply_guided_mask(torch.from_numpy(c.logits),
                              torch.from_numpy(words.view(np.int32)))
    want = J.apply_guided_mask(jnp.asarray(c.logits), jnp.asarray(words))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# Whole pipelines: every history-free stage at once (in the default order,
# with temperature last, and in a custom order), the history stages with
# them, min_tokens and bans, and skew after the pipeline.
ALL_FREE = dict(temperature=0.8, top_k=40, top_p=0.95, min_p=0.01,
                top_a=0.05, tfs=0.97, eta_cutoff=1.0, epsilon_cutoff=1.0,
                typical_p=0.97, smoothing_factor=0.2, nsigma=3.0)
PRIORITY = [SamplerID.MIN_P, SamplerID.TEMPERATURE, SamplerID.TOP_P_TOP_K,
            SamplerID.QUADRATIC, SamplerID.TOP_A]
PIPELINES = {
    "history_free": [ALL_FREE, dict(temperature=1.2, dynatemp_min=0.4,
                                    dynatemp_max=1.6), OFF,
                     dict(temperature=0.0)],
    "temperature_last": [dict(ALL_FREE, temperature_last=True),
                         dict(temperature=0.3, min_p=0.2), OFF],
    "priority": [dict(ALL_FREE, sampler_priority=PRIORITY),
                 dict(temperature=0.5, top_p=0.6), OFF],
    "xtc_certain": [dict(ALL_FREE, xtc_probability=1.0, xtc_threshold=0.02),
                    OFF],
    "history": [dict(ALL_FREE, repetition_penalty=1.2, dry_multiplier=0.8,
                     no_repeat_ngram_size=2),
                dict(temperature=0.0, frequency_penalty=0.5,
                     dry_multiplier=0.5, dry_allowed_length=1),
                dict(temperature=0.0, no_repeat_ngram_size=3,
                     presence_penalty=1.0), OFF],
    "min_tokens_and_bans": [
        dict(temperature=0.0, min_tokens=8, stop_token_ids=[3, 4]),
        dict(temperature=1.0, min_tokens=2, custom_token_bans=[1, 2, 7]),
        dict(temperature=0.7, custom_token_bans=[0, 9]), OFF],
    "skew": [dict(temperature=0.9, top_k=50, skew=0.8), OFF],
}


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_shaped_logprobs_match_jax(pipeline, guided):
    c = Case(PIPELINES[pipeline], V=128, histories=HISTORIES[:len(
        PIPELINES[pipeline])], history_pad=16)
    flags = c.flags._replace(do_guided=guided)
    mask = jmask = None
    if guided:
        words = np.random.default_rng(7).integers(
            0, 2**32, (c.S, 4), dtype=np.uint64).astype(np.uint32)
        words[:, 0] |= 0xFF  # every row keeps tokens 0-7
        mask, jmask = torch.from_numpy(words.view(np.int32)), \
            jnp.asarray(words)
    hist = c.port_hist() if c.hist else [None] * 3
    jhist = c.jax_hist() if c.hist else [None] * 3
    got = P.shaped_logprobs(torch.from_numpy(c.logits), c.t, flags, *hist,
                            guided_mask=mask)
    want = jax_shaped_logprobs(jnp.asarray(c.logits), c.jt, flags, *jhist,
                               guided_mask=jmask)
    assert_same(got.numpy(), want, probs=pipeline == "skew",
                tfs_rows=tfs_off(c))
    if pipeline == "min_tokens_and_bans":
        assert np.isinf(got.numpy()[0, [3, 4, c.V - 1]]).all()
        assert np.isinf(got.numpy()[1, [1, 2, 7]]).all()
    # The greedy token, its logprob and rank and the top-k equal too.
    out = P.sample(torch.from_numpy(c.logits), c.t,
                   flags._replace(all_greedy=True, max_logprobs=4), *hist,
                   guided_mask=mask)
    jout = jax_sample(jnp.asarray(c.logits), c.jt,
                      flags._replace(all_greedy=True, max_logprobs=4), *jhist,
                      guided_mask=jmask)
    np.testing.assert_array_equal(out.sampled.numpy(),
                                  np.asarray(jout.sampled))
    np.testing.assert_array_equal(out.sampled_rank.numpy(),
                                  np.asarray(jout.sampled_rank))
    # Ids of the finite top-k entries (among -inf ties the order is
    # arbitrary).
    kept = np.isfinite(np.asarray(jout.topk_logprobs))
    np.testing.assert_array_equal(out.topk_ids.numpy()[kept],
                                  np.asarray(jout.topk_ids)[kept])


def test_stage_order_matches_jax_dispatch():
    """The order the port runs the stages in is the JAX pipeline's: the
    default, temperature last, and a custom priority (which ignores
    temperature_last)."""
    base = P.SamplingFlags()
    default = P.stage_order(base)
    assert default[:4] == [SamplerID.DRY, SamplerID.PENALTIES,
                           SamplerID.NO_REPEAT_NGRAM, SamplerID.TEMPERATURE]
    assert default[-1] == SamplerID.XTC and len(default) == 14
    last = P.stage_order(base._replace(do_temp_last=True))
    assert last[-1] == SamplerID.TEMPERATURE and len(last) == 14
    custom = P.stage_order(base._replace(
        priority_order=tuple(int(s) for s in PRIORITY), do_temp_last=True))
    assert custom == [int(s) for s in PRIORITY]


def test_prompt_logprob_pass_matches_jax():
    """The prompt pass over a token stream's logits: the target's logprob
    and rank and the top-k, as the JAX step program computes them."""
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((37, 300)) * 3).astype(np.float32)
    targets = rng.integers(0, 300, 37).astype(np.int32)
    got = P.prompt_logprobs(torch.from_numpy(logits),
                            torch.from_numpy(targets), 5)
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    tgt_lp = jnp.take_along_axis(lp, jnp.asarray(targets)[:, None],
                                 axis=-1)[:, 0]
    pk_lp, pk_ids = jax.lax.top_k(lp, 5)
    ranks = jnp.sum(lp > tgt_lp[:, None], axis=-1) + 1
    np.testing.assert_allclose(got[0].numpy(), np.asarray(tgt_lp),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ranks))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(pk_ids))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(pk_lp), rtol=0,
                               atol=1e-5)


# ----------------------------------------------------------------------
# Per-row seeded streams
# ----------------------------------------------------------------------


def test_threefry_matches_jax():
    from jax._src.prng import threefry_2x32

    key = np.array([0x13198A2E, 0x03707344], np.uint32)
    count = np.arange(64, dtype=np.uint32)
    want = np.asarray(threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
    x0, x1 = P.threefry2x32(torch.tensor(int(key[0])),
                            torch.tensor(int(key[1])),
                            torch.arange(32), torch.arange(32, 64))
    np.testing.assert_array_equal(
        torch.cat([x0, x1]).numpy().astype(np.uint32), want)


@pytest.mark.parametrize("generated", [0, 17, 2**31 + 7])
def test_fold_key_data_steps_the_host_key(generated):
    """The runner's fold of j steps into a row's key (an int, or a tensor
    on the device as in a decode window) gives the key both packages'
    build_sampling_tensors make j tokens later: a window of W steps draws
    what W single steps draw."""
    seeds = [0, 1, 1234, 2**31 - 1]

    def keys(g, build, Row, SP):
        rows = [Row(params=SP(temperature=1.0), token_ids=[1], prompt_len=1,
                    generated_len=g, seed=s) for s in seeds]
        return build(rows, 4, 64)[0].key_data

    base = torch.from_numpy(keys(generated, build_sampling_tensors,
                                 SamplerInputRow, SamplingParams).astype(
                                     np.int64))
    for j in (0, 1, 5, 31):
        want = keys(generated + j, jax_build, JaxRow, JaxSamplingParams)
        for steps in (j, torch.tensor([j], dtype=torch.int32)):
            got = port_runner._fold_key_data(base, steps)
            np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                          want)


def _seeded_rows(seeds, generated=0, **kw):
    sp = SamplingParams(**dict(dict(temperature=1.0), **kw))
    return [SamplerInputRow(params=sp, token_ids=[1, 2], prompt_len=2,
                            generated_len=generated, seed=s) for s in seeds]


def test_row_noise_is_independent_of_the_rows_around_it():
    """A row's draws are those of its key: the same seed at another
    position of another batch (other seeds around it, another bucket)
    draws the same uniforms and the same token."""
    V = 300
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, V)).astype(np.float32)).repeat(32, 1)
    draws = {}
    for seeds, S in (([7, 1, 2, 3], 4), ([9, 8, 7], 8),
                     ([7] + list(range(100, 120)), 32)):
        t, flags, _, _ = build_sampling_tensors(_seeded_rows(seeds), S, V)
        t = P.tensors_to_device(t, CPU)
        i = seeds.index(7)
        u = P.row_uniforms(t.key_data, P.GUMBEL_FOLD, V)[i]
        tok = P.sample(logits[:S], t, flags).sampled[i]
        draws.setdefault("u", []).append(u)
        draws.setdefault("tok", []).append(int(tok))
    assert all(torch.equal(u, draws["u"][0]) for u in draws["u"])
    assert len(set(draws["tok"])) == 1
    # Another step or another seed draws other noise.
    t1, _, _, _ = build_sampling_tensors(_seeded_rows([7], generated=1), 1,
                                         V)
    t2, _, _, _ = build_sampling_tensors(_seeded_rows([8]), 1, V)
    for t in (t1, t2):
        u = P.row_uniforms(P.tensors_to_device(t, CPU).key_data,
                           P.GUMBEL_FOLD, V)[0]
        assert not torch.equal(u, draws["u"][0])
    assert ((u > 0) & (u < 1)).all()


def _tv(counts, probs):
    return 0.5 * np.abs(counts / counts.sum() - probs).sum()


@pytest.mark.parametrize("kind", ["min_p", "xtc"])
def test_seeded_draws_follow_the_jax_distribution(kind):
    """4000 rows, one seed each, on the same logits at V 32: the empirical
    frequencies lie within 0.05 total variation of exp of the JAX
    package's shaped_logprobs (for XTC at probability 0.5, the even mix
    of its distributions with the coin up and down)."""
    V, N = 32, 4000
    logits = (np.random.default_rng(4).standard_normal(V) * 1.5).astype(
        np.float32)
    kw = (dict(temperature=0.8, min_p=0.05) if kind == "min_p" else
          dict(temperature=1.0, xtc_probability=0.5, xtc_threshold=0.05))
    rows = _seeded_rows(range(N), **kw)
    t, flags, _, _ = build_sampling_tensors(rows, N, V)
    toks = P.sample(torch.from_numpy(np.tile(logits, (N, 1))),
                    P.tensors_to_device(t, CPU), flags).sampled.numpy()
    counts = np.bincount(toks, minlength=V).astype(np.float64)

    def jax_probs(**over):
        jrows = [JaxRow(params=JaxSamplingParams(**dict(kw, **over)),
                        token_ids=[1, 2], prompt_len=2, generated_len=0,
                        seed=0)]
        jt, jflags, _, _ = jax_build(jrows, 1, V)
        lp = J.shaped_logprobs(jnp.asarray(logits[None]),
                               type(jt)(*map(jnp.asarray, jt)), jflags)
        return np.exp(np.asarray(lp, np.float64))[0]

    if kind == "xtc":
        up = jax_probs(xtc_probability=1.0)
        down = jax_probs(xtc_probability=0.0)
        assert _tv(up * N, down) > 0.2  # the coin matters
        probs = 0.5 * (up + down)
    else:
        probs = jax_probs()
    assert _tv(counts, probs) < 0.05, _tv(counts, probs)


def test_window_of_w_draws_what_w_single_steps_draw(tmp_path):
    """A decode window of W steps with stochastic rows, each step's key
    the tensors' key folded with the step index plus the carry's offset,
    draws what W windows of one step draw from the same carry and cache
    when each is given the sampling tensors built on the host at its
    length, offset 0: what the single-step path draws."""
    import json

    from aphrodite_tpu_torch import LLM

    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(architectures=["LlamaForCausalLM"], hidden_size=64,
                       intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2,
                       vocab_size=256, max_position_embeddings=256,
                       rms_norm_eps=1e-5, tie_word_embeddings=False), f)
    runner = LLM(model=str(tmp_path), load_format="dummy", device="cpu",
                 dtype="float32", seed=0, skip_tokenizer_init=True,
                 num_scheduler_steps=4, max_num_seqs=4,
                 num_device_blocks_override=64, block_size=8).engine.runner
    S, W, vocab = 8, 4, runner.model.vocab_size
    pps = runner.pages_per_seq
    sched = np.zeros((S * pps + S + 1,), np.int32)
    for i in range(3):
        sched[i * pps:i * pps + 2] = [2 * i, 2 * i + 1]
        sched[S * pps + i] = 16
    sched[-1] = 3
    carry = np.zeros((2 * S + 1,), np.int32)
    carry[:3] = [5, 6, 7]
    carry[S:S + 3] = [4, 5, 6]
    buf = runner.window_buffers(S)

    def tensors(generated):
        sp = SamplingParams(temperature=1.3, top_k=20, min_p=0.01)
        rows = [SamplerInputRow(params=sp, token_ids=[1, 2, 3],
                                prompt_len=3, generated_len=generated,
                                seed=s) for s in (3, 4, 5)]
        t, flags, _, _ = build_sampling_tensors(rows, S, vocab)
        return P.tensors_to_device(t, CPU), flags

    def run(widths):
        with torch.inference_mode():
            runner.kv_cache.zero_()
            buf.sched.copy_(torch.from_numpy(sched))
            buf.carry.copy_(torch.from_numpy(carry))
            out, g = [], 2
            for w in widths:
                t, flags = tensors(g)
                runner.load_window_tensors(buf, t)
                buf.carry[2 * S] = 0
                packed = runner.decode_window(buf, flags, w).numpy()
                out.append(packed[:w * S].reshape(w, S)[:, :3])
                g += w
            return np.concatenate(out), buf.carry.numpy().copy()

    window, carry_w = run([W])
    singles, carry_1 = run([1] * W)
    np.testing.assert_array_equal(window, singles)
    np.testing.assert_array_equal(carry_w[:2 * S], carry_1[:2 * S])
    assert carry_w[2 * S] == W
    # The rows draw from their keys: not all steps the same token.
    assert len(np.unique(window)) > 3
