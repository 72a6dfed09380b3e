"""The scrub stamp codec of ``ceph_tpu/osd/scrub.py`` (``:62-63,82-91``):
the PG meta omap keys the scrub engine writes, and the
(last scrub, last deep scrub, errors) stamps the PG reloads at boot
(``PG.load_from_store``), byte for byte.

``ScrubEngine`` itself (the chunked deep scrub with auto-repair) waits
for ROADMAP queue 1 item 1h, with the PG's scrub and repair half.
"""

from __future__ import annotations

from typing import Tuple

from ceph_tpu_torch.core.encoding import Decoder, Encoder

# pg-meta omap keys (ride _persist_meta's extra_omap)
CURSOR_KEY = "scrub_cursor"
STAMPS_KEY = "scrub_stamps"


def encode_stamps(last_scrub: float, last_deep: float,
                  errors: int) -> bytes:
    e = Encoder()
    e.f64(last_scrub).f64(last_deep).u64(errors)
    return e.bytes()


def decode_stamps(blob: bytes) -> Tuple[float, float, int]:
    d = Decoder(blob)
    return d.f64(), d.f64(), d.u64()
