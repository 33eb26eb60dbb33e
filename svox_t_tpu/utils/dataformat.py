"""Data-format mini-DSL and local-index marker.

Capability parity with the reference `svox_t/helpers.py:378-420`
(`DataFormat` string parser "RGBA"/"SH{n}"/"SG{n}"/"ASG{n}" and
`LocalIndex`), re-implemented for this framework.
"""

from __future__ import annotations

import re

class LocalIndex:
    """Marker to query an N3Tree with 'local' coordinates in [0, 1]^3.

    Use ``tree[LocalIndex(points)]`` where ``points`` is (N, 3).
    (parity: svox_t/helpers.py:378-384)
    """

    def __init__(self, val):
        self.val = val


class DataFormat:
    """Parses the leaf-data format string.

    Formats (capability parity: svox_t/helpers.py:386-420):
      - ``"RGBA"`` (or any unrecognized string): raw channels + sigma.
      - ``"SH{n}"``: spherical harmonics with n basis functions per channel.
      - ``"SG{n}"``: spherical gaussians.
      - ``"ASG{n}"``: anisotropic spherical gaussians.

    A format string is an alphabetic tag optionally followed by a basis
    size. Unknown tags fall back to RGBA; a tag with no size has
    ``basis_dim == -1``.
    """

    RGBA = 0
    SH = 1
    SG = 2
    ASG = 3

    _CODES = {"SH": SH, "SG": SG, "ASG": ASG}
    _NAMES = {SH: "SH", SG: "SG", ASG: "ASG", RGBA: "RGBA"}

    def __init__(self, txt: str):
        tag, size = re.fullmatch(r"([A-Za-z]*)(.*)", txt, re.S).group(1, 2)
        if size:
            self.format = self._CODES.get(tag, DataFormat.RGBA)
            self.basis_dim = int(size)
        else:
            self.format = DataFormat.RGBA
            self.basis_dim = -1

    def __repr__(self):
        suffix = str(self.basis_dim) if self.basis_dim >= 0 else ""
        return self._NAMES[self.format] + suffix

    def __eq__(self, other):
        if not isinstance(other, DataFormat):
            return NotImplemented
        return self.format == other.format and self.basis_dim == other.basis_dim

    def __hash__(self):
        return hash((self.format, self.basis_dim))
