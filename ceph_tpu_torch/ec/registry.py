"""Erasure-code plugin registry (the ErasurePluginRegistry role,
reference src/erasure-code/ErasureCodePlugin.{h,cc}): name -> factory.

Port of ``ceph_tpu/ec/registry.py``.  A factory takes the profile and
the device its codec runs on: ``jerasure``, ``isa``, ``shec``, ``lrc``
and ``clay``.

``preload`` imports the default plugin set at daemon start, and
``load_module`` loads a third-party plugin by its module's
``ec_plugin_create`` entry point, with the reference's checks: a module
without the entry point, or whose import fails or hangs past its
timeout, is a clean ``ErasureCodeError``.  A third-party entry point is
called as every factory is, with the profile and ``device=``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError

Factory = Callable[..., ErasureCode]

class ErasureCodePluginRegistry:
    _instance: "ErasureCodePluginRegistry | None" = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        from ceph_tpu_torch.ec.clay import ErasureCodeClay
        from ceph_tpu_torch.ec.isa import ErasureCodeIsa
        from ceph_tpu_torch.ec.jerasure import ErasureCodeJerasure
        from ceph_tpu_torch.ec.lrc import ErasureCodeLrc
        from ceph_tpu_torch.ec.shec import ErasureCodeShec

        self._factories: Dict[str, Factory] = {
            "jerasure": ErasureCodeJerasure.create,
            "isa": ErasureCodeIsa.create,
            "shec": ErasureCodeShec.create,
            "lrc": ErasureCodeLrc.create,
            "clay": ErasureCodeClay.create,
        }

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

    _PLUGIN_MODULES = {
        "jerasure": "ceph_tpu_torch.ec.jerasure",
        "isa": "ceph_tpu_torch.ec.isa",
        "lrc": "ceph_tpu_torch.ec.lrc",
        "shec": "ceph_tpu_torch.ec.shec",
        "clay": "ceph_tpu_torch.ec.clay",
    }

    def preload(self, names=("jerasure", "isa", "lrc", "shec",
                             "clay")) -> None:
        """Eagerly import the default plugin set at daemon start so a
        broken plugin fails boot, not the first request (the reference's
        dlopen + version check, ErasureCodePlugin.cc:126-186)."""
        import importlib

        for n in names:
            if n not in self._factories:
                raise ErasureCodeError(f"cannot preload {n!r}")
            mod = self._PLUGIN_MODULES.get(n)
            if mod is not None:
                try:
                    importlib.import_module(mod)
                except Exception as e:
                    raise ErasureCodeError(
                        f"erasure-code plugin {n!r} failed to load: {e}"
                    ) from e

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


    ENTRY_POINT = "ec_plugin_create"

    def load_module(self, name: str, module: str,
                    timeout_s: float = 10.0) -> None:
        """Third-party plugin loading — the dlopen analog (reference
        ErasureCodePlugin.cc:126-186): import `module`, resolve the
        well-known entry point, register it under `name`.  Mirrors the
        reference's deliberately-broken fixtures: a module without the
        entry point is a clean error (…MissingEntryPoint.cc), and an
        import that HANGS past timeout_s fails the load instead of
        wedging the daemon (…Hangs.cc)."""
        import importlib

        box: list = [None, None]  # (module, exc)

        def _imp():
            try:
                box[0] = importlib.import_module(module)
            except BaseException as e:  # noqa: BLE001
                box[1] = e

        th = threading.Thread(target=_imp, daemon=True)
        th.start()
        th.join(timeout_s)
        if th.is_alive():
            raise ErasureCodeError(
                f"plugin {name!r} ({module}) hung during load "
                f"(> {timeout_s}s)")
        if box[1] is not None:
            raise ErasureCodeError(
                f"plugin {name!r} ({module}) failed to load: "
                f"{box[1]!r}") from box[1]
        entry = getattr(box[0], self.ENTRY_POINT, None)
        if entry is None or not callable(entry):
            raise ErasureCodeError(
                f"plugin {name!r} ({module}) has no "
                f"{self.ENTRY_POINT!r} entry point")
        self.add(name, entry)


def instance() -> ErasureCodePluginRegistry:
    return ErasureCodePluginRegistry.instance()
