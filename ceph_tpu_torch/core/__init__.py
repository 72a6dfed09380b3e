"""Core host runtime: encoding, crc, config, log, perf, throttle, and
the rest of the layer every daemon and client shares.

Port of ``ceph_tpu/core/``, module for module (reference roles:
``src/include/``, ``src/common/``, ``src/log/``, ``src/global/``):
versioned wire encoding, the host CRC-32C, typed config with hot
reload, leveled subsystem logging with a crash ring, perf counters,
throttles, an LRU, reservations, the admin socket, thread liveness,
trace spans, op tracking, fault injection, sharded work queues, the
per-process context and the crash archive.  Lock-order checking
(``lockdep``) and fault injection (``failpoint``) reach the device path
through ``gpu/staging.py`` and ``gpu/queue.py``.
"""
