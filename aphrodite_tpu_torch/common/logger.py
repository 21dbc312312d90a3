"""Logging setup.

Capability parity with the reference's loguru-based logger
(``aphrodite/common/logger.py``) using only stdlib logging: leveled console
output, one-time messages, and an env-controlled log level.
"""

import logging
import os
import sys
from functools import lru_cache

_FORMAT = "%(levelname)s %(asctime)s [%(name)s] %(message)s"
_DATEFMT = "%H:%M:%S"

_root_configured = False


def _configure_root() -> None:
    global _root_configured
    if _root_configured:
        return
    level = os.environ.get("APHRODITE_TPU_LOG_LEVEL", "INFO").upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
    root = logging.getLogger("aphrodite_tpu_torch")
    root.setLevel(level)
    if not root.handlers:
        root.addHandler(handler)
    root.propagate = False
    _root_configured = True


def init_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith("aphrodite_tpu_torch"):
        name = f"aphrodite_tpu_torch.{name}"
    return logging.getLogger(name)


@lru_cache(maxsize=None)
def _log_once_key(key: str) -> bool:
    return True


def log_once(logger: logging.Logger, level: int, msg: str, *args) -> None:
    """Log a message only the first time it is seen (reference `log_once`)."""
    key = f"{logger.name}:{level}:{msg}"
    if _log_once_key.cache_info().currsize >= 0 and key not in getattr(
        log_once, "_seen", set()
    ):
        seen = getattr(log_once, "_seen", set())
        seen.add(key)
        log_once._seen = seen
        logger.log(level, msg, *args)


def enable_trace_function_call(log_file_path: str,
                               root_dir: str = None) -> None:
    """Record every aphrodite_tpu-internal function call/return to a
    file via sys.settrace (reference common/logger.py:138-208,
    APHRODITE_TRACE_FUNCTION). Heavy — debugging hangs/crashes only."""
    import datetime
    import os
    import sys
    from functools import partial

    if root_dir is None:
        root_dir = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))

    def _trace_calls(log_path, root, frame, event, arg=None):
        if event in ("call", "return"):
            filename = frame.f_code.co_filename
            if not filename.startswith(root):
                return None
            try:
                last = frame.f_back
                ctx = (f"{last.f_code.co_name} in "
                       f"{last.f_code.co_filename}:{last.f_lineno}"
                       if last is not None else "<root>")
                with open(log_path, "a") as f:
                    kind = "Call to" if event == "call" else "Return from"
                    f.write(f"{datetime.datetime.now()} {kind} "
                            f"{frame.f_code.co_name} in "
                            f"{filename}:{frame.f_lineno} from {ctx}\n")
            except NameError:
                pass  # interpreter shutdown
        return partial(_trace_calls, log_path, root)

    logging.getLogger("aphrodite_tpu_torch").warning(
        "function-call tracing is enabled (every internal call/return "
        "is written to %s); expect a large slowdown and log file",
        log_file_path)
    sys.settrace(partial(_trace_calls, log_file_path, root_dir))
