"""Engine stats: Prometheus registry + periodic logging (counterpart of
aphrodite_tpu/engine/metrics.py, without the speculative-decoding
families: the port has no speculative decoding yet).

The same metric families: scheduler state gauges, KV-cache usage,
prefix-cache hit rate, prompt/generation token counters, TTFT/TPOT/E2E
histograms, preemption counter, finish-reason counters, and the engine
iteration's phase histograms. ``prometheus_client`` is optional.
"""

import time
from dataclasses import dataclass, field
from typing import List, Optional

from aphrodite_tpu_torch.common.logger import init_logger

logger = init_logger(__name__)

_LABEL = "model_name"


@dataclass
class Stats:
    """Snapshot of one engine iteration (reference metrics_types.Stats)."""

    now: float
    num_running: int = 0
    num_waiting: int = 0
    kv_usage: float = 0.0
    prefix_cache_hit_rate: float = 0.0
    num_preemptions_iter: int = 0
    num_prompt_tokens_iter: int = 0
    num_generation_tokens_iter: int = 0
    time_to_first_tokens_iter: List[float] = field(default_factory=list)
    time_per_output_tokens_iter: List[float] = field(default_factory=list)
    time_e2e_requests: List[float] = field(default_factory=list)
    finished_reason_iter: List[str] = field(default_factory=list)
    # Per-phase wall time of this engine iteration (ms). The split host
    # engineers tune against: schedule = host scheduling,
    # execute = batch build + device program + output fetch,
    # postprocess = token append / detok / stop checks.
    schedule_ms_iter: float = 0.0
    execute_ms_iter: float = 0.0
    postprocess_ms_iter: float = 0.0


class PrometheusMetrics:
    """Prometheus metric family definitions (lazily, optionally)."""

    def __init__(self, model_name: str) -> None:
        import prometheus_client as prom

        self.model_name = model_name
        labels = [_LABEL]
        ns = "aphrodite"
        self.gauge_running = self._gauge(
            prom, f"{ns}:num_requests_running",
            "Number of requests currently running.", labels)
        self.gauge_waiting = self._gauge(
            prom, f"{ns}:num_requests_waiting",
            "Number of requests waiting to be processed.", labels)
        self.gauge_kv_usage = self._gauge(
            prom, f"{ns}:kv_cache_usage_perc",
            "KV-cache usage (1 = 100%).", labels)
        self.gauge_prefix_hit = self._gauge(
            prom, f"{ns}:prefix_cache_hit_rate",
            "Cumulative prefix-cache hit rate.", labels)
        self.counter_preempt = self._counter(
            prom, f"{ns}:num_preemptions_total",
            "Cumulative preemptions.", labels)
        self.counter_prompt_tokens = self._counter(
            prom, f"{ns}:prompt_tokens_total",
            "Prefill tokens processed.", labels)
        self.counter_gen_tokens = self._counter(
            prom, f"{ns}:generation_tokens_total",
            "Generated tokens.", labels)
        self.hist_ttft = self._histogram(
            prom, f"{ns}:time_to_first_token_seconds",
            "Time to first token.", labels,
            (0.001, 0.005, 0.01, 0.02, 0.04, 0.06, 0.08, 0.1, 0.25, 0.5,
             0.75, 1.0, 2.5, 5.0, 7.5, 10.0))
        self.hist_tpot = self._histogram(
            prom, f"{ns}:time_per_output_token_seconds",
            "Inter-token latency.", labels,
            (0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.75,
             1.0, 2.5))
        self.hist_e2e = self._histogram(
            prom, f"{ns}:e2e_request_latency_seconds",
            "End-to-end request latency.", labels,
            (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 20, 40, 80))
        self.counter_finish = self._counter(
            prom, f"{ns}:request_success_total",
            "Finished requests.", labels + ["finished_reason"])
        self.hist_phase_schedule = self._histogram(
            prom, f"{ns}:iteration_schedule_ms",
            "Engine iteration scheduling phase (ms).", labels,
            (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100))
        self.hist_phase_execute = self._histogram(
            prom, f"{ns}:iteration_execute_ms",
            "Engine iteration execute phase incl. device time (ms).",
            labels, (1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500))
        self.hist_phase_postprocess = self._histogram(
            prom, f"{ns}:iteration_postprocess_ms",
            "Engine iteration output postprocess phase (ms).", labels,
            (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250))

    @staticmethod
    def _get_or_make(prom, cls, name, doc, labels, **kw):
        try:
            return cls(name, doc, labelnames=labels, **kw)
        except ValueError:
            # Already registered (multiple engines in one process — tests).
            return prom.REGISTRY._names_to_collectors[name]

    def _gauge(self, prom, name, doc, labels):
        return self._get_or_make(prom, prom.Gauge, name, doc, labels)

    def _counter(self, prom, name, doc, labels):
        return self._get_or_make(prom, prom.Counter, name, doc, labels)

    def _histogram(self, prom, name, doc, labels, buckets):
        return self._get_or_make(prom, prom.Histogram, name, doc, labels,
                                 buckets=buckets)


class StatLogger:
    """Aggregates per-iteration stats; logs a summary every `interval`
    seconds and feeds Prometheus when available."""

    def __init__(self, model_name: str, log_interval: float = 10.0) -> None:
        self.model_name = model_name
        self.log_interval = log_interval
        self._last_log = time.monotonic()
        self._prompt_tokens = 0
        self._gen_tokens = 0
        self.prom: Optional[PrometheusMetrics] = None
        try:
            self.prom = PrometheusMetrics(model_name)
        except ImportError:
            pass

    def log(self, stats: Stats) -> None:
        self._prompt_tokens += stats.num_prompt_tokens_iter
        self._gen_tokens += stats.num_generation_tokens_iter
        if self.prom is not None:
            lbl = {_LABEL: self.model_name}
            self.prom.gauge_running.labels(**lbl).set(stats.num_running)
            self.prom.gauge_waiting.labels(**lbl).set(stats.num_waiting)
            self.prom.gauge_kv_usage.labels(**lbl).set(stats.kv_usage)
            self.prom.gauge_prefix_hit.labels(**lbl).set(
                stats.prefix_cache_hit_rate)
            if stats.num_preemptions_iter:
                self.prom.counter_preempt.labels(**lbl).inc(
                    stats.num_preemptions_iter)
            if stats.num_prompt_tokens_iter:
                self.prom.counter_prompt_tokens.labels(**lbl).inc(
                    stats.num_prompt_tokens_iter)
            if stats.num_generation_tokens_iter:
                self.prom.counter_gen_tokens.labels(**lbl).inc(
                    stats.num_generation_tokens_iter)
            for v in stats.time_to_first_tokens_iter:
                self.prom.hist_ttft.labels(**lbl).observe(v)
            for v in stats.time_per_output_tokens_iter:
                self.prom.hist_tpot.labels(**lbl).observe(v)
            for v in stats.time_e2e_requests:
                self.prom.hist_e2e.labels(**lbl).observe(v)
            for reason in stats.finished_reason_iter:
                self.prom.counter_finish.labels(
                    finished_reason=reason, **lbl).inc()
            if stats.execute_ms_iter:
                self.prom.hist_phase_schedule.labels(**lbl).observe(
                    stats.schedule_ms_iter)
                self.prom.hist_phase_execute.labels(**lbl).observe(
                    stats.execute_ms_iter)
                self.prom.hist_phase_postprocess.labels(**lbl).observe(
                    stats.postprocess_ms_iter)

        now = time.monotonic()
        if now - self._last_log >= self.log_interval:
            dt = now - self._last_log
            logger.info(
                "throughput: %.1f prefill tok/s, %.1f decode tok/s | "
                "running %d, waiting %d | kv usage %.1f%%, prefix hit %.1f%%",
                self._prompt_tokens / dt, self._gen_tokens / dt,
                stats.num_running, stats.num_waiting,
                stats.kv_usage * 100, stats.prefix_cache_hit_rate * 100)
            self._prompt_tokens = 0
            self._gen_tokens = 0
            self._last_log = now
