"""Face-neighbor exchange of one device (``vpic_tpu/comm/facecomm.py``
:class:`LocalComm`): a periodic (self-joined) face receives our own
opposite-face payload; an unjoined face receives None."""

from __future__ import annotations

from ..core.types import FACE_AXIS, Grid, PERIODIC_FIELDS

OPP = (3, 4, 5, 0, 1, 2)


class LocalComm:
    """Single-device exchange."""

    def __init__(self, g: Grid):
        self.g = g

    def joined(self, face: int) -> bool:
        shards = (self.g.gpx, self.g.gpy, self.g.gpz)[FACE_AXIS[face]]
        if shards > 1:
            raise NotImplementedError("multi-device exchange is not ported")
        return self.g.fbc[face] == PERIODIC_FIELDS

    def exchange(self, payloads: dict) -> dict:
        return {f: payloads[OPP[f]] if self.joined(f) else None
                for f in payloads}

    def allsum(self, x):
        """mp_allsum_d analogue: identity on one device."""
        return x
