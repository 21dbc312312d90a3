"""Small shared utilities (reference: aphrodite/common/utils.py)."""

import argparse
import itertools
import uuid
from typing import Iterable, List, TypeVar

T = TypeVar("T")


def cdiv(a: int, b: int) -> int:
    return -(a // -b)


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def round_down(x: int, multiple: int) -> int:
    return (x // multiple) * multiple


def next_power_of_2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


class Counter:
    """Monotonic id source (reference utils.Counter)."""

    def __init__(self, start: int = 0) -> None:
        self._it = itertools.count(start)

    def __next__(self) -> int:
        return next(self._it)

    def reset(self) -> None:
        self._it = itertools.count()


def random_uuid() -> str:
    return str(uuid.uuid4().hex)


def chunk_list(lst: List[T], size: int) -> Iterable[List[T]]:
    for i in range(0, len(lst), size):
        yield lst[i:i + size]


STR_DTYPE_TO_JAX = {
    "float32": "float32",
    "float": "float32",
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
    "float16": "float16",
    "half": "float16",
    "fp16": "float16",
}


class FlexibleArgumentParser(argparse.ArgumentParser):
    """ArgumentParser accepting both --underscore_args and --dash-args
    (reference common/utils.py FlexibleArgumentParser)."""

    def parse_args(self, args=None, namespace=None):
        import sys

        if args is None:
            args = sys.argv[1:]
        processed = []
        for arg in args:
            if arg.startswith("--") and "=" in arg:
                key, value = arg.split("=", 1)
                processed.append(f"{key.replace('_', '-')}={value}")
            elif arg.startswith("--"):
                processed.append(arg.replace("_", "-"))
            else:
                processed.append(arg)
        return super().parse_args(processed, namespace)
