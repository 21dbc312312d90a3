"""Offline batch inference API (counterpart of
aphrodite_tpu/endpoints/llm.py: LLM.generate).

``LLM(model=...).generate(prompts, sampling_params)`` drives the engine's
hot loop directly. It runs on the card by default; pass ``device="cpu"``
to run on the CPU.
"""

from typing import List, Optional, Sequence, Union

from aphrodite_tpu_torch.common.outputs import RequestOutput
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.engine.args import EngineArgs
from aphrodite_tpu_torch.engine.engine import AphroditeEngine


class LLM:
    def __init__(self, model: str, **kwargs) -> None:
        """kwargs are the fields of ``EngineArgs`` (dtype, block_size,
        max_num_seqs, num_scheduler_steps, device, quantization,
        kv_cache_dtype, quantization_param_path, ...). ``model`` is a
        checkpoint directory, or one ``.gguf`` file (Llama architecture)
        with ``tokenizer=<directory of an HF tokenizer>`` or
        ``skip_tokenizer_init=True``: its quantized tensors are served as
        int4 containers, packed where the levels fit a nibble and one
        level per byte otherwise (Q5, Q6, Q8 and the IQ types).
        ``quantization="gptq"`` or ``"awq"`` serves int4 weights: a
        checkpoint in that format is loaded as it is, a dense or dummy one
        is quantized at load. ``kv_cache_dtype`` ("auto", "bfloat16",
        "fp8" = "fp8_e4m3", "fp8_e5m2", "int8") stores the KV cache in 8
        bits, quantized on write with the per-layer scales of the JSON
        file ``quantization_param_path`` names (tools/kv_calibrate.py
        makes one), else of the checkpoint's ``k_scale``/``v_scale``
        tensors, else ones; int8 pages need calibrated scales."""
        self.engine = AphroditeEngine.from_engine_args(
            EngineArgs(model=model, **kwargs))
        # Offline generation reads text only at finish: skip per-step
        # incremental detokenization (stop strings still force it).
        self.engine.lazy_detokenize = True
        self._request_counter = 0

    def get_tokenizer(self):
        return self.engine.tokenizer

    def generate(
        self,
        prompts: Union[str, Sequence[str], None] = None,
        sampling_params: Union[SamplingParams, Sequence[SamplingParams],
                               None] = None,
        prompt_token_ids: Optional[Sequence[List[int]]] = None,
    ) -> List[RequestOutput]:
        if isinstance(prompts, str):
            prompts = [prompts]
        num = len(prompts) if prompts is not None else len(prompt_token_ids)
        if sampling_params is None:
            sampling_params = SamplingParams()
        if isinstance(sampling_params, SamplingParams):
            sampling_params = [sampling_params] * num
        if len(sampling_params) != num:
            raise ValueError("sampling_params length mismatch")
        request_ids = []
        for i in range(num):
            self._request_counter += 1
            rid = str(self._request_counter)
            request_ids.append(rid)
            self.engine.add_request(
                request_id=rid,
                prompt=prompts[i] if prompts is not None else None,
                sampling_params=sampling_params[i],
                prompt_token_ids=(prompt_token_ids[i]
                                  if prompt_token_ids is not None else None),
            )
        return self._run_engine(request_ids)

    def _run_engine(self, request_ids: List[str]) -> List[RequestOutput]:
        results = {}
        try:
            while self.engine.has_unfinished_requests():
                for out in self.engine.step():
                    if out.finished:
                        results[out.request_id] = out
        except Exception:
            # Abort this call's requests so a failed step does not wedge
            # the engine for later generate() calls on the same LLM.
            for rid in request_ids:
                if rid not in results:
                    self.engine.abort_request(rid)
            raise
        missing = [rid for rid in request_ids if rid not in results]
        if missing:
            raise RuntimeError(f"requests never finished: {missing[:4]}")
        return [results[rid] for rid in request_ids]
