"""Erasure-code surface of the port: plugin registry, the RS, bit-matrix,
shec, lrc and clay codecs, and the constructors the rest of the system
builds codecs with."""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ec.interface import ErasureCodeError  # noqa: F401
from ceph_tpu_torch.ec.registry import (  # noqa: F401
    ErasureCodePluginRegistry, instance)


def parse_profile(profile_str: str) -> dict:
    """'plugin=isa k=8 m=4 ...' -> {key: value}."""
    profile = {}
    for part in profile_str.split():
        if "=" in part:
            key, val = part.split("=", 1)
            profile[key] = val
    return profile


def codec_from_profile(profile_str: str, device=None):
    """Build a codec from a 'plugin=isa k=8 m=4 ...' profile string (the
    form EC profiles take inside pool definitions)."""
    profile = parse_profile(profile_str)
    plugin = profile.pop("plugin", "isa")
    return instance().factory(plugin, profile, device=device)


def codec_from_reference(k: int, m: int, coding: np.ndarray, profile: dict,
                         device=None):
    """The port's codec for a coding matrix carried over from another
    implementation (the reference package's ``codec.coding``), passed as
    numpy: the matrix is the codec's whole state."""
    from ceph_tpu_torch.ec.codec import RSMatrixCodec

    codec = RSMatrixCodec(k, m, np.asarray(coding), device=device)
    codec.init(dict(profile))
    return codec
