"""Launch counts of the kernel wrappers.

Each wrapper keeps ``launches`` and, where it has them, dicts
``launches_by_<what>`` keyed by the page type, shape, body or format of a
launch. ``count_launch`` is the one place they grow. A wrapper called
while the current stream is being captured into a CUDA graph puts its
kernel into the graph and launches nothing, so it counts nothing; the
replays of a graph run no Python and are counted by tracing them
(``aphrodite_tpu_torch/tools/window_check.py`` ``trace_launches``).
"""

import torch


def capturing() -> bool:
    """Whether work on the current CUDA stream is being captured into a
    graph rather than launched."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def count_launch(wrapper, **by: str) -> None:
    """One launch of ``wrapper``'s kernel: ``wrapper.launches`` and, for
    each keyword ``what=key``, ``wrapper.launches_by_<what>[key]`` grow by
    one, unless the call is being captured."""
    if capturing():
        return
    wrapper.launches += 1
    for what, key in by.items():
        counts = getattr(wrapper, f"launches_by_{what}")
        counts[key] = counts.get(key, 0) + 1
