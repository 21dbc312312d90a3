"""Stop-condition checking (reference engine/output_processor/
stop_checker.py:10): EOS, stop token ids, stop strings (with optional
truncation), max_tokens, max_model_len, min_tokens guard.
"""

from typing import Callable, List, Optional

from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.sequence import Sequence, SequenceStatus


class StopChecker:
    def __init__(self, max_model_len: int,
                 get_eos: Optional[Callable[[], Optional[int]]] = None
                 ) -> None:
        self.max_model_len = max_model_len

    def maybe_stop_sequence(
        self,
        seq: Sequence,
        new_text: str,
        sampling_params: SamplingParams,
    ) -> None:
        """Mutates seq.status / seq.stop_reason / seq.output_text."""
        # min_tokens: never stop early (the sampler also bans stop tokens
        # in-graph; this is the host-side backstop).
        if seq.get_output_len() < sampling_params.min_tokens:
            self._check_length(seq, sampling_params)
            return

        last = seq.get_last_token_id()
        if (not sampling_params.ignore_eos and seq.eos_token_id is not None
                and last == seq.eos_token_id):
            if not sampling_params.include_stop_str_in_output:
                # EOS text is not part of the visible output; the EOS token
                # was never detokenized into output_text so nothing to trim.
                pass
            seq.status = SequenceStatus.FINISHED_STOPPED
            return

        if last in sampling_params.all_stop_token_ids:
            seq.status = SequenceStatus.FINISHED_STOPPED
            seq.stop_reason = last
            return

        if sampling_params.stop and new_text:
            stop_str = self._check_stop_strings(seq, new_text,
                                                sampling_params)
            if stop_str is not None:
                seq.status = SequenceStatus.FINISHED_STOPPED
                seq.stop_reason = stop_str
                return

        self._check_length(seq, sampling_params)

    def _check_length(self, seq: Sequence,
                      sampling_params: SamplingParams) -> None:
        if (sampling_params.max_tokens is not None
                and seq.get_output_len() >= sampling_params.max_tokens):
            seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
        elif seq.get_len() >= self.max_model_len:
            seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED

    @staticmethod
    def _check_stop_strings(seq: Sequence, new_text: str,
                            sampling_params: SamplingParams
                            ) -> Optional[str]:
        """Search for stop strings overlapping the newly emitted text; trim
        output_text accordingly (reference StopChecker.check_stop_strings).
        """
        for stop_str in sampling_params.stop:
            # The stop string may straddle the old/new text boundary.
            start = max(
                0,
                len(seq.output_text) - len(new_text) - len(stop_str) + 1)
            pos = seq.output_text.find(stop_str, start)
            if pos == -1:
                continue
            if sampling_params.include_stop_str_in_output:
                seq.output_text = seq.output_text[:pos + len(stop_str)]
            else:
                seq.output_text = seq.output_text[:pos]
            return stop_str
        return None
