"""Compare the machine code of this checkout's kernels with another
checkout's, kernel by kernel.

    python -m aphrodite_tpu_torch.tools.sass_compare OTHER [NAME ...] [--skip TEXT]

Builds the named sources of ``csrc/`` (default: the attention ones; a
source a checkout does not have is left out there) in both checkouts
(``ops/cuda_build.py``, each into its own ``build/kernels/``),
disassembles each library with ``cuobjdump -sass`` and compares every
kernel instantiation's instructions and encodings (addresses and
trailing blank lines left out), by
its mangled name with the anonymous namespace's per-file hash taken out,
so a kernel that moved from one source to another is still paired. It
prints how many kernels both builds have and how many of them are equal,
and the names of those that differ or that only one build has; with
``--skip``, this checkout's instantiations whose name holds that text (say
``Li80E``, head_dim 80) are counted apart. Exits 1 if a kernel that both
builds have differs. Needs the CUDA toolkit; no card.
"""

import argparse
import difflib
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, Iterable

from aphrodite_tpu_torch.ops import cuda_build

ATTENTION = ("paged_decode_attention", "paged_decode_attention_rel",
             "ragged_paged_attention", "ragged_paged_attention_alibi",
             "ragged_paged_attention_blocksparse")


def kernels(library: Path) -> Dict[str, str]:
    """Each kernel's SASS in the library, by its name (the anonymous
    namespace's per-file hash taken out), without addresses."""
    cuobjdump = Path(cuda_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(library)],
                         capture_output=True, text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", out)
    found = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        # Addresses (/*0a40*/) and the blank lines after a library's last
        # function differ between builds of the same code.
        body = re.sub(r"/\*[0-9a-f]{4,}\*/", "", body).strip()
        # _ZN<length>_GLOBAL__N__<hash>_<n>_<file>_cu_<8 hex digits>: the
        # anonymous namespace of one source file.
        name = re.sub(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                      "_ZN_ANON_", name)
        found[name] = body
    return found


def checkout_kernels(checkout: Path, names: Iterable[str]) -> Dict[str, str]:
    """Every kernel of the named sources that the checkout has, built
    there by its own cuda_build (all of them at once, in parallel)."""
    have = [n for n in names if (checkout / "aphrodite_tpu_torch" / "csrc"
                                 / f"{n}.cu").is_file()]
    code = ("import sys; from aphrodite_tpu_torch.ops import cuda_build as c;"
            " names = sys.argv[1:]; c.build(names);"
            " print('\\n'.join(str(c.library_path(n)) for n in names))")
    out = subprocess.run([sys.executable, "-c", code, *have], cwd=checkout,
                         capture_output=True, text=True, check=True).stdout
    found: Dict[str, str] = {}
    for line in out.strip().splitlines()[-len(have):]:
        found.update(kernels(Path(line)))
    return found


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("names", nargs="*", default=list(ATTENTION))
    parser.add_argument("--skip", default=None,
                        help="count this checkout's kernels whose name "
                             "holds this text apart")
    args = parser.parse_args()
    here = Path(cuda_build.__file__).resolve().parents[2]
    mine = checkout_kernels(here, args.names)
    theirs = checkout_kernels(args.other.resolve(), args.names)
    skipped = [n for n in mine if args.skip and args.skip in n]
    both = [n for n in mine if n in theirs]
    bad = [n for n in both if mine[n] != theirs[n]]
    only_mine = [n for n in mine if n not in theirs and n not in skipped]
    only_theirs = [n for n in theirs if n not in mine]
    print(f"{len(both)} kernels in both builds, {len(both) - len(bad)} "
          f"equal, {len(bad)} differ; {len(skipped)} named {args.skip!r} "
          f"apart; {len(only_mine)} only here, {len(only_theirs)} only "
          "there", flush=True)
    for n in bad:
        diff = list(difflib.unified_diff(theirs[n].splitlines(),
                                         mine[n].splitlines(), "there",
                                         "here", n=0, lineterm=""))
        print(f"  differs: {n} ({len(diff)} diff lines)", flush=True)
        print("\n".join(diff[:12]), flush=True)
    for n in only_mine + only_theirs:
        print(f"  only {'here' if n in mine else 'there'}: {n}", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
