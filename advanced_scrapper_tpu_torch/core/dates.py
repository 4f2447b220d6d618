"""ISO 8601 date parsing on the standard library, in place of
``dateutil.parser.parse`` (which the card's host does not have).

:func:`parse_date` agrees with ``dateutil.parser.parse`` on the forms the
pipeline produces and reads: ``YYYY-MM-DD`` (also ``YYYY-M-D`` and
``YYYYMMDD``), optionally followed by ``T``/``t``/space and ``HH``,
``HH:MM`` or ``HH:MM:SS`` with an optional fraction (cut to microseconds,
as dateutil does), then optionally ``Z``, ``UTC``, ``GMT`` or a ``±HH``,
``±HHMM`` or ``±HH:MM`` offset; surrounding whitespace is ignored.  A
result without a zone is naive, as dateutil's; a zone gives an aware
result with the same UTC offset (dateutil's ``tzutc``/``tzlocal``/
``tzoffset`` here are ``datetime.timezone``).  What it cannot read (or an
impossible date) gives ``None``, where dateutil raises; dateutil's other
forms (month names, RFC 2822, free text) are not read.
"""

from __future__ import annotations

import re
from datetime import datetime, timedelta, timezone

_ISO = re.compile(
    r"(?P<y>\d{4})(?:-(?P<m>\d{1,2})-(?P<d>\d{1,2})|(?P<m8>\d{2})(?P<d8>\d{2}))"
    r"(?:[Tt ](?P<H>\d{2})(?::(?P<M>\d{2})(?::(?P<S>\d{2})(?:\.(?P<f>\d+))?)?)?)?"
    r"\s*(?:(?P<utc>[Zz]|UTC|GMT)|(?P<sign>[+-])(?P<oh>\d{2})(?::?(?P<om>\d{2}))?)?"
)


def parse_date(raw: str) -> datetime | None:
    """The datetime that ``dateutil.parser.parse(raw)`` gives on the forms
    above, or ``None``."""
    m = _ISO.fullmatch(raw.strip())
    if m is None:
        return None
    g = m.groupdict()
    frac = (g["f"] or "")[:6].ljust(6, "0")
    try:
        tz = None
        if g["utc"]:
            tz = timezone.utc
        elif g["sign"]:
            off = timedelta(hours=int(g["oh"]), minutes=int(g["om"] or 0))
            tz = timezone(-off if g["sign"] == "-" else off)
        return datetime(
            int(g["y"]), int(g["m"] or g["m8"]), int(g["d"] or g["d8"]),
            int(g["H"] or 0), int(g["M"] or 0), int(g["S"] or 0), int(frac), tzinfo=tz,
        )
    except ValueError:
        return None
