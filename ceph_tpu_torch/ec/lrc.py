"""Locally repairable layered code (LRC).

Port of ``ceph_tpu/ec/lrc.py`` (reference: src/erasure-code/lrc/
ErasureCodeLrc.{h,cc}):

- ``layers``: a JSON array of [chunks_map, layer_profile]; each layer
  applies an inner codec to the chunk positions its map covers ('D'
  data, any other letter but '_' coding, '_' skipped);
- the k/m/l shorthand generates the global and local layers and the
  mapping exactly as parse_kml does (ErasureCodeLrc.cc:295-365); (k+m)
  must be a multiple of l and k, m multiples of (k+m)/l;
- encode runs the layers top down on the device, each layer's coding
  written into the one [chunks, n] buffer the next layer reads;
- decode walks the layers bottom up, local repair first, recovered
  chunks feeding the layers above;
- ``_minimum_to_decode`` is the same three-case search that prefers
  reading the local group over a global decode.

Inner codecs come from the port's registry, on the lrc codec's device.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Mapping, Set, Tuple

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError, to_int


class _Layer:
    def __init__(self, chunks_map: str, codec: ErasureCode) -> None:
        self.chunks_map = chunks_map
        self.codec = codec
        self.chunks: List[int] = [i for i, c in enumerate(chunks_map)
                                  if c != "_"]
        self.data: List[int] = [i for i, c in enumerate(chunks_map)
                                if c == "D"]
        self.coding: List[int] = [i for i, c in enumerate(chunks_map)
                                  if c not in ("_", "D")]
        self.chunks_set: Set[int] = set(self.chunks)


def _parse_layer_profile(spec) -> dict:
    if isinstance(spec, dict):
        return dict(spec)
    out = {}
    for tok in (spec or "").split():
        if "=" not in tok:
            raise ErasureCodeError(f"bad layer profile token {tok!r}")
        key, val = tok.split("=", 1)
        out[key] = val
    return out


class ErasureCodeLrc(ErasureCode):
    DEFAULT_KML = -1

    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.layers: List[_Layer] = []
        self._chunk_count = 0
        self._data_chunk_count = 0
        self.rule_steps: List[Tuple[str, str, int]] = [
            ("chooseleaf", "host", 0)]

    @property
    def k(self) -> int:
        return self._data_chunk_count

    @property
    def m(self) -> int:
        return self._chunk_count - self._data_chunk_count

    @classmethod
    def create(cls, profile: dict, device=None) -> "ErasureCodeLrc":
        self = cls(device)
        self.init(profile)
        return self

    # -- profile ----------------------------------------------------------
    def parse(self, profile: dict) -> None:
        self._parse_kml(profile)
        mapping = profile.get("mapping")
        if not mapping:
            raise ErasureCodeError("lrc profile needs mapping (or k/m/l)")
        self._chunk_count = len(mapping)
        self._data_chunk_count = mapping.count("D")
        super().parse(profile)

        layers_spec = profile.get("layers")
        if not layers_spec:
            raise ErasureCodeError("lrc profile needs layers (or k/m/l)")
        try:
            desc = json.loads(layers_spec)
        except json.JSONDecodeError as e:
            raise ErasureCodeError(f"lrc layers is not valid JSON: {e}")
        if not isinstance(desc, list) or not desc:
            raise ErasureCodeError("lrc layers must be a non-empty array")

        from ceph_tpu_torch.ec.registry import instance

        self.layers = []
        for entry in desc:
            if not isinstance(entry, list) or not 1 <= len(entry) <= 2:
                raise ErasureCodeError(f"bad lrc layer entry {entry!r}")
            chunks_map = entry[0]
            if len(chunks_map) != self._chunk_count:
                raise ErasureCodeError(
                    f"layer map {chunks_map!r} length != mapping length "
                    f"{self._chunk_count}")
            lp = _parse_layer_profile(entry[1] if len(entry) == 2 else "")
            plugin = lp.pop("plugin", "jerasure")
            lp.setdefault("technique", "reed_sol_van")
            lp["k"] = str(chunks_map.count("D"))
            lp["m"] = str(sum(1 for c in chunks_map if c not in ("_", "D")))
            codec = instance().factory(plugin, lp, device=self.device)
            self.layers.append(_Layer(chunks_map, codec))
        covered: Set[int] = set()
        for layer in self.layers:
            covered |= layer.chunks_set
        if covered != set(range(self._chunk_count)):
            raise ErasureCodeError(
                "lrc layers leave chunks uncovered: "
                f"{sorted(set(range(self._chunk_count)) - covered)}")

    def _parse_kml(self, profile: dict) -> None:
        k = to_int(profile, "k", self.DEFAULT_KML)
        m = to_int(profile, "m", self.DEFAULT_KML)
        l = to_int(profile, "l", self.DEFAULT_KML)  # noqa: E741
        if k == -1 and m == -1 and l == -1:
            for key in ("k", "m", "l"):
                profile.pop(key, None)
            return
        if -1 in (k, m, l):
            raise ErasureCodeError("all of k, m, l must be set or none")
        for key in ("mapping", "layers"):
            if profile.get(key):
                raise ErasureCodeError(
                    f"{key} cannot be set when k/m/l are set")
        if (k + m) % l:
            raise ErasureCodeError("k + m must be a multiple of l")
        groups = (k + m) // l
        if k % groups or m % groups:
            raise ErasureCodeError("k and m must be multiples of (k+m)/l")

        profile["mapping"] = ("D" * (k // groups) + "_" * (m // groups)
                              + "_") * groups
        layers = [[("D" * (k // groups) + "c" * (m // groups) + "_")
                   * groups, ""]]
        for i in range(groups):
            layers.append(["".join(("D" * l + "c") if i == j
                                   else "_" * (l + 1)
                                   for j in range(groups)), ""])
        profile["layers"] = json.dumps(layers)

        locality = profile.get("crush-locality", "")
        failure_domain = profile.get("crush-failure-domain", "host")
        if locality:
            self.rule_steps = [("choose", locality, groups),
                               ("chooseleaf", failure_domain, l + 1)]
        elif failure_domain:
            self.rule_steps = [("chooseleaf", failure_domain, 0)]

    # -- shape ------------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self._chunk_count

    def get_data_chunk_count(self) -> int:
        return self._data_chunk_count

    def get_alignment(self) -> int:
        return math.lcm(*(layer.codec.get_alignment()
                          for layer in self.layers))

    def supports_partial_writes(self) -> bool:
        return all(layer.codec.supports_partial_writes()
                   for layer in self.layers)

    # -- coding -----------------------------------------------------------
    def _encode_full(self, data: np.ndarray) -> torch.Tensor:
        """uint8 data planes [k, n] -> every chunk [chunks, n] on the
        device: the data planes at their chunk positions, then each
        layer's coding from the chunks the layers above wrote."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.ndim != 2 or data.shape[0] != self._data_chunk_count:
            raise ValueError(f"lrc data must be uint8 "
                             f"[{self._data_chunk_count}, n], got "
                             f"{data.shape}")
        full = torch.zeros((self._chunk_count, data.shape[1]),
                           dtype=torch.uint8, device=self.device)
        pos = [self.chunk_index(i) for i in range(self._data_chunk_count)]
        full[pos] = torch.from_numpy(data).to(self.device)
        for layer in self.layers:
            full[layer.coding] = layer.codec.encode_planes(full[layer.data])
        return full

    def encode_array(self, data: np.ndarray) -> np.ndarray:
        """uint8 data planes [k, n] -> the [m, n] planes of the chunk
        positions that hold no data, in chunk order (the coding chunks
        of every layer, each product on the device)."""
        data_pos = {self.chunk_index(i)
                    for i in range(self._data_chunk_count)}
        coding = [c for c in range(self._chunk_count) if c not in data_pos]
        return self._encode_full(data)[coding].cpu().numpy()

    def encode(self, want_to_encode, data: bytes):
        planes, _ = self.encode_prepare(data)
        host = self._encode_full(planes).cpu().numpy()
        return {i: host[i] for i in want_to_encode}

    def decode(self, want_to_read: Iterable[int],
               chunks: Mapping[int, np.ndarray],
               chunk_size: int | None = None) -> Dict[int, np.ndarray]:
        want = sorted(set(want_to_read))
        if set(want) <= set(chunks.keys()):
            return {i: np.asarray(chunks[i]) for i in want}
        decoded: Dict[int, np.ndarray] = {
            i: np.asarray(c, dtype=np.uint8) for i, c in chunks.items()}
        erasures = {i for i in range(self._chunk_count) if i not in chunks}
        want_erasures = set(want) & erasures
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_set & erasures
            if not layer_erasures:
                continue
            if len(layer_erasures) > layer.codec.get_coding_chunk_count():
                continue  # too many for this layer; an upper one may help
            # the inner codec numbers its chunks data first, as encode
            # feeds it: layer.data then layer.coding
            sub_ids = layer.data + layer.coding
            sub_avail = {pos: decoded[cid] for pos, cid in enumerate(sub_ids)
                         if cid not in erasures}
            sub_out = layer.codec.decode(range(len(sub_ids)), sub_avail)
            for pos, cid in enumerate(sub_ids):
                decoded[cid] = np.asarray(sub_out[pos])
                erasures.discard(cid)
            want_erasures = set(want) & erasures
            if not want_erasures:
                break
        if want_erasures:
            raise ErasureCodeError(
                f"lrc cannot recover chunks {sorted(want_erasures)}")
        return {i: decoded[i] for i in want}

    # -- minimum_to_decode (3-case local-repair-first search) --------------
    def _minimum_to_decode(self, want_to_read: Iterable[int],
                           available: Iterable[int]) -> List[int]:
        want = set(want_to_read)
        avail = set(available)
        erasures_total = set(range(self._chunk_count)) - avail
        erasures_not_recovered = set(erasures_total)
        erasures_want = want & erasures_total
        if not erasures_want:
            return sorted(want)

        minimum: Set[int] = set()
        for layer in reversed(self.layers):
            layer_want = want & layer.chunks_set
            if not layer_want:
                continue
            if not layer_want & erasures_want:
                layer_minimum = layer_want
            else:
                erasures = layer.chunks_set & erasures_not_recovered
                if len(erasures) > layer.codec.get_coding_chunk_count():
                    continue
                layer_minimum = layer.chunks_set - erasures_not_recovered
                erasures_not_recovered -= erasures
                erasures_want -= erasures
            minimum |= layer_minimum
        if not erasures_want:
            minimum |= want
            minimum -= erasures_total
            return sorted(minimum)

        # case 3: recover chunks nobody wants, to help upper layers
        erasures_total = set(range(self._chunk_count)) - avail
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_set & erasures_total
            if layer_erasures and (len(layer_erasures)
                                   <= layer.codec.get_coding_chunk_count()):
                erasures_total -= layer_erasures
        if not erasures_total:
            return sorted(avail)
        raise ErasureCodeError(
            f"not enough chunks in {sorted(avail)} to read {sorted(want)}")
