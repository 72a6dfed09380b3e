"""Keyring — named shared secrets (reference: src/auth/KeyRing.cc,
the [entity] / key = ... files ceph tooling manages).

Port of ``ceph_tpu/auth/keyring.py``; the file format is the same."""

from __future__ import annotations

import base64
import os
import secrets
from typing import Dict, Optional


def generate_secret() -> bytes:
    return secrets.token_bytes(32)


class Keyring:
    def __init__(self) -> None:
        self._keys: Dict[str, bytes] = {}

    def add(self, name: str, secret: Optional[bytes] = None) -> bytes:
        key = secret if secret is not None else generate_secret()
        self._keys[name] = key
        return key

    def get(self, name: str) -> Optional[bytes]:
        return self._keys.get(name)

    def names(self):
        return sorted(self._keys)

    # -- file format (parity with the reference's keyring files) ---------
    def dump(self) -> str:
        out = []
        for name in self.names():
            b64 = base64.b64encode(self._keys[name]).decode()
            out.append(f"[{name}]\n\tkey = {b64}\n")
        return "".join(out)

    @classmethod
    def loads(cls, text: str) -> "Keyring":
        kr = cls()
        name = None
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("[") and line.endswith("]"):
                name = line[1:-1]
            elif line.startswith("key") and "=" in line and name:
                kr._keys[name] = base64.b64decode(
                    line.split("=", 1)[1].strip())
        return kr

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.dump())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "Keyring":
        with open(path) as f:
            return cls.loads(f.read())
