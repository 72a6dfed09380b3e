"""RadosStriper — logical byte ranges striped over many RADOS objects.

Reference role: src/libradosstriper/ (RadosStriperImpl) with the
file_layout_t math (stripe_unit su, stripe_count sc, object_size os):
logical stripe number off//su round-robins over sc parallel objects,
su_per_object = os//su stripe units fill an object before the next
object SET begins.  Object names are "<soid>.<%016x index>"; the
logical size lives in an xattr on object 0 (the reference stores
striper metadata the same way).

This is the client-side scale-out axis (SURVEY §2.4 "client striping"):
a large logical write fans out into per-object ops that land on
different PGs/OSDs in parallel via the Objecter.

Port of ``ceph_tpu/client/striper.py``, all of it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ceph_tpu_torch.client.rados import IoCtx, RadosError
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.osd.types import OSDOp

SIZE_XATTR = "striper.size"
LAYOUT_XATTR = "striper.layout"


class RadosStriper:
    def __init__(self, ioctx: IoCtx, stripe_unit: int = 65536,
                 stripe_count: int = 4,
                 object_size: int = 4 << 20) -> None:
        if object_size % stripe_unit:
            raise ValueError("object_size must be a stripe_unit multiple")
        self.io = ioctx
        self.su = stripe_unit
        self.sc = stripe_count
        self.os = object_size
        self.su_per_obj = object_size // stripe_unit

    # -- layout math (file_layout_t, reference Striper::file_to_extents) --
    def _obj_name(self, soid: str, idx: int) -> str:
        return f"{soid}.{idx:016x}"

    def _extents(
        self, off: int, length: int
    ) -> List[Tuple[int, int, List[Tuple[int, int, int]]]]:
        """Touched extents as (object index, object offset, units) where
        units = [(object offset, LOGICAL offset, length), ...] — a
        merged object extent is contiguous in the OBJECT but its units
        interleave logically (the whole point of striping), so data
        moves per unit."""
        by_obj: Dict[int, List[Tuple[int, int, int]]] = {}
        pos = off
        end = off + length
        while pos < end:
            stripeno = pos // self.su
            stripepos = stripeno % self.sc
            objectsetno = stripeno // (self.sc * self.su_per_obj)
            objectno = objectsetno * self.sc + stripepos
            blockno = (stripeno // self.sc) % self.su_per_obj
            off_in_obj = blockno * self.su + pos % self.su
            n = min(end - pos, self.su - pos % self.su)
            by_obj.setdefault(objectno, []).append((off_in_obj, pos, n))
            pos += n
        merged: List[Tuple[int, int, List[Tuple[int, int, int]]]] = []
        for objno in sorted(by_obj):
            units = sorted(by_obj[objno])
            run: List[Tuple[int, int, int]] = []
            for u in units:
                if run and run[-1][0] + run[-1][2] == u[0]:
                    run.append(u)
                else:
                    if run:
                        merged.append((objno, run[0][0], run))
                    run = [u]
            if run:
                merged.append((objno, run[0][0], run))
        return merged

    def component_oids(self, soid: str, size: int) -> List[str]:
        """Every RADOS object a striped object of `size` bytes touches
        (snapshot trim and scrub helpers walk these)."""
        if size <= 0:
            return [self._obj_name(soid, 0)]
        objs = {0}
        for objno, _, _ in self._extents(0, size):
            objs.add(objno)
        return [self._obj_name(soid, i) for i in sorted(objs)]

    # -- metadata ---------------------------------------------------------
    def _meta_oid(self, soid: str) -> str:
        return self._obj_name(soid, 0)

    def size(self, soid: str) -> int:
        try:
            return int(self.io.getxattr(self._meta_oid(soid), SIZE_XATTR))
        except RadosError:
            raise RadosError(-2, f"{soid}: no striped object")

    def _set_size(self, soid: str, size: int) -> None:
        self.io.setxattr(self._meta_oid(soid), SIZE_XATTR,
                         str(size).encode())
        self.io.setxattr(
            self._meta_oid(soid), LAYOUT_XATTR,
            f"{self.su}:{self.sc}:{self.os}".encode())

    # -- IO ---------------------------------------------------------------
    def write(self, soid: str, data: bytes, off: int = 0) -> None:
        """Ranged write: per-object extent ops issued CONCURRENTLY
        through the Objecter, then the size xattr advances."""
        ops = []
        for objno, o, units in self._extents(off, len(data)):
            chunk = b"".join(
                data[lpos - off: lpos - off + n] for _, lpos, n in units)
            ops.append(self.io.aio_operate(
                self._obj_name(soid, objno),
                [OSDOp(t_.OP_WRITE, off=o, data=chunk)]))
        for op in ops:
            rep = op.result(30.0)
            if rep.result < 0:
                raise RadosError(rep.result, soid)
        try:
            cur = self.size(soid)
        except RadosError:
            cur = 0
        if off + len(data) > cur or cur == 0:
            self._set_size(soid, max(cur, off + len(data)))

    def _logical_pos(self, objno: int, off_in_obj: int) -> int:
        """Inverse layout: (object, offset) -> logical offset."""
        objectsetno, stripepos = divmod(objno, self.sc)
        blockno, rem = divmod(off_in_obj, self.su)
        stripeno = (objectsetno * self.su_per_obj + blockno) * self.sc \
            + stripepos
        return stripeno * self.su + rem

    def read(self, soid: str, length: int = 0, off: int = 0,
             snapid: int = 0, size: int = 0) -> bytes:
        """snapid reads the striped extents AS OF that snap (librbd
        snapshot reads); `size` overrides the head's size xattr (the
        caller supplies the at-snap logical size, since the size xattr
        tracks head)."""
        total = size or self.size(soid)
        if off >= total:
            return b""
        if length == 0 or off + length > total:
            length = total - off
        buf = bytearray(length)
        ops = []
        for objno, o, units in self._extents(off, length):
            n = sum(u[2] for u in units)
            ops.append((units, self.io.aio_operate(
                self._obj_name(soid, objno),
                [OSDOp(t_.OP_READ, off=o, length=n)],
                snapid=snapid)))
        for units, op in ops:
            rep = op.result(30.0)
            if rep.result == -2:
                continue  # hole: a never-written object reads as zeros
            if rep.result < 0:
                raise RadosError(rep.result, soid)
            got = rep.ops[0].out_data
            at = 0
            for _, lpos, n in units:  # scatter units back to logical
                chunk = got[at: at + n]
                if len(chunk) < n:
                    # short object (sparse tail): zero-fill — a
                    # mismatched slice assignment would RESIZE the
                    # buffer and shift every later byte
                    chunk = chunk + b"\0" * (n - len(chunk))
                buf[lpos - off: lpos - off + n] = chunk
                at += n
        return bytes(buf)

    def stat(self, soid: str) -> int:
        return self.size(soid)

    def truncate(self, soid: str, size: int) -> None:
        cur = self.size(soid)
        if size >= cur:
            self._set_size(soid, size)
            return
        # drop whole objects beyond the new end, trim the boundary one
        for objno, o, _units in self._extents(size, cur - size):
            name = self._obj_name(soid, objno)
            try:
                if o == 0 and objno != 0:
                    self.io.remove(name)
                else:
                    self.io.truncate(name, o)
            except RadosError:
                pass
        self._set_size(soid, size)

    def remove(self, soid: str) -> None:
        total = self.size(soid)
        nobjs = max(1, -(-total // self.os) + self.sc)
        for objno in range(nobjs):
            try:
                self.io.remove(self._obj_name(soid, objno))
            except RadosError:
                pass
