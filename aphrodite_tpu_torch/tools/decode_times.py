"""Decode attention kernel times (no T5 bias) at the main paths' decode
shapes, in the checkout it is run from:

    (cd CHECKOUT && python /path/to/decode_times.py)

Run from the root of each checkout in turns in one call on one card
(parent, change, change, parent: each run imports the ``chip_smoke`` and
package of the directory it is started from, and builds that checkout's
decode kernel into its own build/kernels/), it shows whether a change to
the decode kernel moved the launches it should leave alone. At each of
nine geometries (Llama-3.1-8B, Qwen2.5-7B, Baichuan2-13B with ALiBi,
Falcon-7B's wide form, Bloom-560m's ALiBi at head_dim 64, Phi-3-mini at
96, Gemma-2-9B at 256 on bf16 and E4M3 pages, Qwen2.5-0.5B at 64) it
times a decode step of 16 rows in the 32-row bucket (the prompts of
chip_smoke.py plus 32 tokens; Gemma-2-9B's of 1024-6144), each launch on
the next of 8 cache layers, with chip_smoke.py's ``time_ms``, and prints
the best of three means per geometry on one line ("DECODE_TIMES").
Needs a card.
"""

import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from aphrodite_tpu_torch.models.layers import get_alibi_slopes  # noqa: E402
from aphrodite_tpu_torch.ops import cuda_build  # noqa: E402
from aphrodite_tpu_torch.ops.decode_attention import \
    paged_decode_attention  # noqa: E402

# name -> ((query heads, kv heads, head_dim, ALiBi), long prompts, pages)
GEOMETRIES = {
    "llama-3.1-8b 32/8": ((32, 8, 128, False), False, "bf16"),
    "qwen2.5-7b 28/4": ((28, 4, 128, False), False, "bf16"),
    "baichuan 40/40 alibi": ((40, 40, 128, True), False, "bf16"),
    "falcon-7b 71/1 d64": ((71, 1, 64, False), False, "bf16"),
    "bloom 16/16 alibi d64": ((16, 16, 64, True), False, "bf16"),
    "phi-3-mini 32/32 d96": ((32, 32, 96, False), False, "bf16"),
    "gemma-2-9b 16/8 d256": ((16, 8, 256, False), True, "bf16"),
    "gemma-2-9b 16/8 d256 e4m3": ((16, 8, 256, False), True, "e4m3"),
    "qwen2.5-0.5b 14/2 d64": ((14, 2, 64, False), False, "bf16"),
}


def main() -> None:
    cuda_build.build(["paged_decode_attention"])
    lens = np.random.default_rng(0).integers(16, 1025, size=16)
    long_lens = np.random.default_rng(0).integers(1024, 6145, size=16)
    out = {}
    for name, ((qh, kvh, d, alibi), long, page_type) in GEOMETRIES.items():
        seqs = [(1, int(n) + 32) for n in (long_lens if long else lens)]
        case = cs.make_attention_case(seqs, qh, kvh, d, padded_seqs=32,
                                      padded_tokens=32, device="cuda",
                                      seed=20, num_layers=8,
                                      page_type=page_type)
        slopes = (torch.from_numpy(get_alibi_slopes(qh)).cuda() if alibi
                  else None)
        state = {"layer": 0}

        def call():
            state["layer"] = (state["layer"] + 1) % 8
            return paged_decode_attention(
                case["q"], case["kv"][state["layer"]], case["kv_lens"],
                case["page_indices"], sm_scale=d**-0.5 * case["kv_scale"],
                alibi_slopes=slopes)

        out[name] = min(cs.time_ms(call, 200) for _ in range(3))
        del case
    print("DECODE_TIMES", {k: round(v, 4) for k, v in out.items()},
          flush=True)


if __name__ == "__main__":
    main()
