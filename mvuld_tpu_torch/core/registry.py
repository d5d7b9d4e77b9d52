"""Named registries for models, fusion architectures, datasets, schedulers
(a copy of ``mvuld_tpu/core/registry.py``).

The reference selects its 26 fusion-model ablations by editing commented-out
constructor lines (mvuld/main_bigvul.py:123-146). Here every architecture
registers under a string key and is selected by ``MODEL.MULTI.ARCH``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable] = {}

    def register(self, key: str | None = None) -> Callable:
        def deco(fn: Callable) -> Callable:
            k = key or fn.__name__
            if k in self._entries:
                raise KeyError(f"{k!r} already registered in {self.name}")
            self._entries[k] = fn
            return fn
        return deco

    def get(self, key: str) -> Callable:
        if key not in self._entries:
            raise KeyError(
                f"{key!r} not found in registry {self.name!r}. "
                f"Available: {sorted(self._entries)}")
        return self._entries[key]

    def build(self, key: str, *args: Any, **kwargs: Any) -> Any:
        return self.get(key)(*args, **kwargs)

    def keys(self):
        return sorted(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries


MODELS = Registry("models")            # image backbones (swin, swinv2, ...)
FUSION_MODELS = Registry("fusion")     # tri-modal fusion heads (ablation zoo)
BASELINES = Registry("baselines")      # devign / reveal / ivdetect / cunixcoder
SCHEDULERS = Registry("schedulers")    # lr schedules
