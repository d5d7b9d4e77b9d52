"""Out-of-memory-shaped error detection for conservative-fallback paths.

Counterpart of ``mvuld_tpu/utils/oom.py``. A caller that can retry with a
less memory-hungry setting (a smaller batch, more checkpointing) asks
``is_oom_shaped`` whether the error it caught is worth the retry. The
JAX package matches the XLA allocator's texts (``RESOURCE_EXHAUSTED``,
``Ran out of memory``) and its relay's ``remote_compile`` wrapper; the
port also takes ``torch.cuda.OutOfMemoryError`` and the CUDA allocator's
``RuntimeError`` ("CUDA out of memory", "CUBLAS_STATUS_ALLOC_FAILED").
"""

from __future__ import annotations

_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",          # XLA's allocator
    "Ran out of memory",           # PJRT's allocator message
    "remote_compile",              # the JAX relay's opaque wrapper
    "out of memory",               # the CUDA caching allocator
    "CUBLAS_STATUS_ALLOC_FAILED",  # cuBLAS workspace allocation
)


def is_oom_shaped(exc: BaseException) -> bool:
    """True when ``exc`` plausibly signals device memory exhaustion and a
    less memory-hungry retry is worth attempting."""
    try:
        import torch
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except (ImportError, AttributeError):
        pass
    text = str(exc)
    return any(marker in text for marker in _OOM_MARKERS)
