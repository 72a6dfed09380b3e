"""Erasure-code plugin registry (the ErasurePluginRegistry role,
reference src/erasure-code/ErasureCodePlugin.{h,cc}): name -> factory.

Port of ``ceph_tpu/ec/registry.py``.  A factory takes the profile and
the device its codec runs on.  ``lrc``, ``shec`` and ``clay`` are
registered so that asking for them names what is missing: they come
with later slices of the port.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError

Factory = Callable[..., ErasureCode]

_LATER = {
    "lrc": "lrc runs on the GF(2) bit-matrix kernel and layered codecs "
           "(ROADMAP queue 1, bit-matrix engine)",
    "shec": "shec decode runs on the GF(2) bit-matrix kernel (ROADMAP "
            "queue 1, bit-matrix engine)",
    "clay": "clay needs the queue's cdec/crep kinds (ROADMAP queue 1, "
            "clay)",
}


def _not_ported(name: str) -> Factory:
    def make(profile: dict, device=None) -> ErasureCode:
        raise ErasureCodeError(
            f"erasure-code plugin {name!r} is not ported yet: {_LATER[name]}")

    return make


class ErasureCodePluginRegistry:
    _instance: "ErasureCodePluginRegistry | None" = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        from ceph_tpu_torch.ec.isa import ErasureCodeIsa
        from ceph_tpu_torch.ec.jerasure import ErasureCodeJerasure

        self._factories: Dict[str, Factory] = {
            "jerasure": ErasureCodeJerasure.create,
            "isa": ErasureCodeIsa.create,
        }
        for name in _LATER:
            self._factories[name] = _not_ported(name)

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def add(self, name: str, factory: Factory) -> None:
        if name in self._factories:
            raise ErasureCodeError(f"plugin {name!r} already registered")
        self._factories[name] = factory

    def factory(self, plugin: str, profile: dict,
                device=None) -> ErasureCode:
        """A codec of ``plugin`` for ``profile`` whose products run on
        ``device`` (CUDA unless named)."""
        if plugin not in self._factories:
            raise ErasureCodeError(f"unknown erasure-code plugin {plugin!r}")
        device = resolve_device(device)  # no CUDA and none named: raises
        try:
            return self._factories[plugin](dict(profile), device=device)
        except ErasureCodeError:
            raise
        except Exception as e:
            raise ErasureCodeError(
                f"erasure-code plugin {plugin!r} failed to "
                f"initialize: {e!r}") from e


def instance() -> ErasureCodePluginRegistry:
    return ErasureCodePluginRegistry.instance()
