"""Decode and prefill tok/s of main paths of ``chip_smoke.py`` in two or
more checkouts, in turns, on one card:

    python -m aphrodite_tpu_torch.tools.decode_ab --out DIR \\
        PARENT CHANGE CHANGE PARENT [--path gptq --path qwen2.5-7b ...]

Each checkout is the root of a copy of the repository (a ``git archive``
of another commit, say). The paths and their arguments are those of
``chip_smoke.main_paths`` in the repository this tool is part of. For
each checkout in the order given, and each path, one process runs
``chip_smoke.main_path`` of that checkout from its root with those
arguments, so each runs its own package and kernels (built into its own
build/kernels/ first, one nvcc per source). Before the path's own
warm-up, every engine serves one batch of 16 rows of 16 prompt tokens
and 17 new ones, so that every checkout has run both sequence buckets of
the timed run (8 and 32 rows) before it is timed. The timed run serves
16 greedy requests of 64 new tokens, as chip_smoke.py does. Prints one
line per run and writes every run's rates to DIR/decode_ab.json, with
the card's name and power limit.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]

# Run in each checkout: its main_path on the arguments given as JSON, the
# engine's first generate preceded by the 32-row warm-up batch; then the
# rates on one line.
_RUN = r"""
import json, sys
import numpy as np
import chip_smoke as c
from aphrodite_tpu_torch import LLM, SamplingParams
kw = json.loads(sys.argv[1])
generate, warmed = LLM.generate, set()
def warm_generate(llm, *args, **kwargs):
    if id(llm) not in warmed:
        warmed.add(id(llm))
        vocab = kw["model_config"]["vocab_size"]
        generate(llm, prompt_token_ids=np.random.default_rng(
            c.SEED + 1).integers(0, vocab, (c.NUM_REQUESTS, 16)).tolist(),
            sampling_params=SamplingParams(temperature=0.0, max_tokens=17,
                                           ignore_eos=True,
                                           detokenize=False))
    return generate(llm, *args, **kwargs)
LLM.generate = warm_generate
_, rates = c.main_path("cuda", **kw)
print("DECODE_AB " + json.dumps(rates), flush=True)
"""
PATHS = ("gptq", "qwen2.5-7b", "q6_k gguf, 16 layers")


def path_arguments(path: str) -> str:
    """main_path's arguments for ``path`` (``chip_smoke.main_paths``), as
    JSON, without the graph-against-eager window check."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    kw = dict(chip_smoke.main_paths()[path])
    kw.pop("window_check", None)
    return json.dumps({k: v.tolist() if hasattr(v, "tolist") else v
                       for k, v in kw.items()})


def run_path(checkout: str, path: str, log: str) -> dict:
    """One path's run in one checkout; its output goes to `log`."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, path_arguments(path)], cwd=checkout,
        capture_output=True, text=True)
    with open(log, "w") as f:
        f.write(proc.stdout + proc.stderr)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("DECODE_AB ")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"decode_ab: {path} in {checkout} failed "
                         f"(exit {proc.returncode})")
    rates = json.loads(lines[-1][len("DECODE_AB "):])
    rates["seconds"] = time.monotonic() - t0
    return rates


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--out", required=True)
    ap.add_argument("--path", action="append", dest="paths",
                    help="a name of chip_smoke.main_paths (repeatable; "
                    f"default {', '.join(PATHS)})")
    args = ap.parse_args()
    paths = args.paths or list(PATHS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    for checkout in dict.fromkeys(args.checkouts):
        subprocess.run([sys.executable, "-c",
                        "import chip_smoke; chip_smoke.build_kernels()"],
                       cwd=checkout, check=True)
    os.makedirs(args.out, exist_ok=True)
    runs = []
    for turn, checkout in enumerate(args.checkouts):
        for path in paths:
            rates = run_path(checkout, path, os.path.join(
                args.out, f"turn{turn}-{path.replace(' ', '_')}.log"))
            runs.append(dict(turn=turn, checkout=checkout, path=path,
                             **rates))
            print(f"turn {turn} {checkout} {path}: decode "
                  f"{rates['decode_tok_s']:.1f} tok/s, prefill "
                  f"{rates['prefill_tok_s']:.1f} tok/s "
                  f"({rates['seconds']:.0f} s)", flush=True)
    with open(os.path.join(args.out, "decode_ab.json"), "w") as f:
        json.dump(dict(card=card, runs=runs), f, indent=1)
    print(json.dumps(dict(card=card, runs=[
        {k: r[k] for k in ("turn", "checkout", "path", "decode_tok_s",
                           "prefill_tok_s")} for r in runs])), flush=True)


if __name__ == "__main__":
    main()
