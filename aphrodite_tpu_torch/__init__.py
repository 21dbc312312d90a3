"""aphrodite-tpu's PyTorch/CUDA port: the serving engine of the JAX
package ``aphrodite_tpu`` rebuilt on PyTorch, with hand-written Hopper
kernels in ``csrc/``. It imports nothing of JAX or of the JAX package.
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from aphrodite_tpu_torch.common.outputs import CompletionOutput, RequestOutput
from aphrodite_tpu_torch.common.sampling_params import SamplingParams

__all__ = [
    "__version__",
    "SamplingParams",
    "CompletionOutput",
    "RequestOutput",
    "LLM",
]


def __getattr__(name):
    # Lazy import keeps `import aphrodite_tpu_torch` cheap.
    if name == "LLM":
        from aphrodite_tpu_torch.endpoints.llm import LLM

        return LLM
    raise AttributeError(
        f"module 'aphrodite_tpu_torch' has no attribute {name!r}")
