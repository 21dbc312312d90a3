"""KV-cache scale calibration and export (counterpart of
aphrodite_tpu/tools/kv_calibrate.py).

Run calibration text through the model with a full-precision KV cache,
read the per-layer absmax of K and V straight off the paged cache after
prefill (its rows are the post-RoPE K/V that quantize-on-write will see),
and export per-layer scales in the JSON schema the engine loads through
``quantization_param_path`` (loader/weights.py: load_kv_cache_scales).

    python -m aphrodite_tpu_torch.tools.kv_calibrate <model_dir> \
        --output kv_scales.json [--text-file calib.txt] [--fmt e4m3]

then serve with ``LLM(model_dir, kv_cache_dtype="fp8",
quantization_param_path="kv_scales.json")``. The tool runs on the card
unless ``--device cpu`` is given.
"""

import argparse
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from aphrodite_tpu_torch.common.logger import init_logger

logger = init_logger(__name__)

# Largest finite value of each narrow cache type (float8_e4m3fn,
# float8_e5m2, int8).
FMT_MAX = {"e4m3": 448.0, "e5m2": 57344.0, "int8": 127.0}

_DEFAULT_CALIB_TEXTS = [
    "The quick brown fox jumps over the lazy dog. " * 8,
    "In a shocking finding, scientists discovered a herd of unicorns "
    "living in a remote, previously unexplored valley. " * 4,
    "def fibonacci(n):\n    if n < 2:\n        return n\n    "
    "return fibonacci(n - 1) + fibonacci(n - 2)\n" * 4,
    "1 2 3 4 5 6 7 8 9 10 11 12 13 14 15 16 17 18 19 20 " * 4,
]


def observe_kv_absmax(llm) -> Dict[str, np.ndarray]:
    """Per-layer absmax of the K and V now in the full-precision cache.

    Cache layout [L, P+1, ps, 2*KV, D]: combined head 2h holds K of kv
    head h, 2h+1 its V. Unwritten slots are zero and raise no absmax.
    """
    pages = llm.engine.runner.kv_cache
    if pages.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            f"calibration needs a full-precision cache, got {pages.dtype}"
            ": run with kv_cache_dtype='auto'")
    # One layer at a time: the cache may fill most of the card.
    k_amax = [layer[:, :, 0::2].abs().amax().item() for layer in pages]
    v_amax = [layer[:, :, 1::2].abs().amax().item() for layer in pages]
    return {"k_amax": np.asarray(k_amax, np.float32),
            "v_amax": np.asarray(v_amax, np.float32)}


def calibrate_kv_scales(
    llm,
    texts: Optional[Sequence[str]] = None,
    prompt_token_ids: Optional[List[List[int]]] = None,
    fmt: str = "e4m3",
) -> Dict[int, float]:
    """Prefill the calibration prompts, observe the K/V ranges and return
    per-layer scales (one per layer, for both K and V, as the schema and
    the loader have it)."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams

    sp = SamplingParams(temperature=0.0, max_tokens=1, detokenize=False)
    if prompt_token_ids is not None:
        llm.generate(prompt_token_ids=prompt_token_ids, sampling_params=sp)
    else:
        llm.generate(list(texts or _DEFAULT_CALIB_TEXTS),
                     sampling_params=sp)
    obs = observe_kv_absmax(llm)
    amax = np.maximum(obs["k_amax"], obs["v_amax"])
    dtype_max = FMT_MAX[fmt]
    scales = {}
    for layer, a in enumerate(amax):
        # A layer that saw nothing (absmax 0) keeps the identity scale.
        scales[layer] = float(a / dtype_max) if a > 0 else 1.0
    logger.info("calibrated %d layers: scale range [%.4g, %.4g]",
                len(scales), min(scales.values()), max(scales.values()))
    return scales


def export_kv_params(scales: Dict[int, float], path: str,
                     tp_rank: int = 0) -> None:
    """Write the ``quantization_param_path`` JSON."""
    payload = {
        "kv_cache": {
            "dtype": "float8_e4m3",
            "scaling_factor": {
                str(tp_rank): {str(k): v for k, v in sorted(scales.items())}
            },
        }
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    logger.info("kv scales written to %s", path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="calibrate per-layer KV-cache scales")
    parser.add_argument("model", help="model directory")
    parser.add_argument("--output", default="kv_scales.json")
    parser.add_argument("--text-file", default=None,
                        help="newline-separated calibration texts "
                             "(default: built-in sample)")
    parser.add_argument("--fmt", choices=sorted(FMT_MAX), default="e4m3")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--max-num-seqs", type=int, default=8)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    from aphrodite_tpu_torch import LLM

    texts = None
    if args.text_file:
        with open(args.text_file) as f:
            texts = [ln.strip() for ln in f if ln.strip()]
    llm = LLM(model=args.model, dtype=args.dtype,
              max_num_seqs=args.max_num_seqs, device=args.device)
    scales = calibrate_kv_scales(llm, texts=texts, fmt=args.fmt)
    export_kv_params(scales, args.output)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
