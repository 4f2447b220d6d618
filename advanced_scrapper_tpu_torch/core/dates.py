"""Date parsing on the standard library, in place of
``dateutil.parser.parse`` (which the card's host does not have).

:func:`parse_date` agrees with ``dateutil.parser.parse`` on these forms,
each with a full year, month and day, surrounding whitespace ignored:

- ISO 8601: ``YYYY-MM-DD`` (also ``YYYY-M-D`` and ``YYYYMMDD``);
- slashes, month first or year first: ``M/D/YYYY``, ``YYYY/M/D``, and
  ``D/M/YYYY`` where the first number cannot be a month (``13/06/2020``),
  as dateutil resolves them with ``dayfirst=False``;
- a two-digit year in ``M/D/YY``, put within 50 years of the current year
  as dateutil's ``parserinfo.convertyear`` does;
- month names, full or three-letter, in either order: ``June 1, 2020``,
  ``Jun 1 2020``, ``1 Jun 2020``, ``01 June, 2020``;
- an optional leading weekday name (``Mon, 01 Jun 2020 ...``, as RFC 2822
  writes it), which dateutil reads and then ignores.

The date may be followed (after ``T``/``t`` for ISO, or whitespace) by a
time: ``HH`` (ISO only), ``H:MM`` or ``H:MM:SS`` with an optional
fraction (cut to microseconds, as dateutil does), with an optional
``AM``/``PM`` (``H AM`` also; 12 AM is hour 0, and an hour above 12
with either is refused, as dateutil refuses it); then by ``Z``, ``z``,
``UTC``, ``GMT`` (in upper case, as dateutil takes a zone name; month and
weekday names are read in any case) or a ``±HH``, ``±HHMM`` or ``±HH:MM``
offset.  A result without a zone is naive, as dateutil's; a zone gives an
aware result with the same UTC offset (dateutil's ``tzutc``/``tzoffset`` are ``datetime.timezone``
here).  What it cannot read (or an impossible date) gives ``None``, where
dateutil raises or reads more: forms with a field missing (dateutil fills
it from today), named zones other than UTC/GMT, offsets of 24 h or more,
ordinals and free text.
"""

from __future__ import annotations

import re
import time
from datetime import datetime, timedelta, timezone

_MONTHS = {
    name: i + 1
    for i, names in enumerate((
        ("jan", "january"), ("feb", "february"), ("mar", "march"), ("apr", "april"),
        ("may",), ("jun", "june"), ("jul", "july"), ("aug", "august"),
        ("sep", "sept", "september"), ("oct", "october"), ("nov", "november"),
        ("dec", "december"),
    ))
    for name in names
}
_MONTH = "|".join(sorted(_MONTHS, key=len, reverse=True))
_WEEKDAY = ("mon|monday|tue|tues|tuesday|wed|wednesday|thu|thurs|thursday|fri|friday|"
            "sat|saturday|sun|sunday")

_TIME = (
    r"(?:(?P<H>\d{1,2}):(?P<M>\d{2})(?::(?P<S>\d{2})(?:\.(?P<f>\d+))?)?"
    r"(?:\s*(?P<ampm>[AaPp][Mm]))?"
    r"|(?P<Ha>\d{1,2})\s*(?P<ampm2>[AaPp][Mm]))"
)
_ZONE = r"(?:\s*(?:(?P<utc>[Zz]|UTC|GMT)|(?P<sign>[+-])(?P<oh>\d{2})(?::?(?P<om>\d{2}))?))?"

_ISO = re.compile(
    r"(?P<y>\d{4})(?:-(?P<m>\d{1,2})-(?P<d>\d{1,2})|(?P<m8>\d{2})(?P<d8>\d{2}))"
    r"(?:[Tt ](?:(?P<H2>\d{2})(?![\d:])|" + _TIME + r"))?" + _ZONE
)
_SLASH = re.compile(
    r"(?:(?P<a>\d{1,2})/(?P<b>\d{1,2})/(?P<c>\d{4}|\d{2})"
    r"|(?P<y>\d{4})/(?P<m>\d{1,2})/(?P<d>\d{1,2}))"
    r"(?:\s+" + _TIME + r")?" + _ZONE
)
# month and weekday names in any case; the zone names only as dateutil
# takes them (UTC, GMT, Z or z)
_NAMED = re.compile(
    r"(?:(?i:" + _WEEKDAY + r")(?:,\s*|\s+))?"
    r"(?:(?P<mon>(?i:" + _MONTH + r"))\s+(?P<d>\d{1,2}),?\s+(?P<y>\d{4})"
    r"|(?P<d2>\d{1,2})\s+(?P<mon2>(?i:" + _MONTH + r")),?\s+(?P<y2>\d{4}))"
    r"(?:\s+" + _TIME + r")?" + _ZONE
)


def convert_year(year: int) -> int:
    """dateutil's ``parserinfo.convertyear`` for a year written with two
    digits: the current century, moved by 100 years to lie within 50 years
    of the current year."""
    now = time.localtime().tm_year
    year += now // 100 * 100
    if year >= now + 50:
        year -= 100
    elif year < now - 50:
        year += 100
    return year


def _ymd(m: re.Match) -> tuple[int, int, int]:
    g = m.groupdict()
    if g.get("mon") or g.get("mon2"):  # month name: the digits in order d, y
        return (int(g["y"] or g["y2"]), _MONTHS[(g["mon"] or g["mon2"]).lower()],
                int(g["d"] or g["d2"]))
    if g.get("a"):  # dateutil's three-number resolution, dayfirst=False
        a, b, c = int(g["a"]), int(g["b"]), int(g["c"])
        if a > 31:  # a two-digit year first
            return convert_year(a), b, c
        if len(g["c"]) == 2:
            c = convert_year(c)
        return (c, b, a) if a > 12 else (c, a, b)
    return int(g["y"]), int(g["m"] or g.get("m8")), int(g["d"] or g.get("d8"))


def _hms(g: dict) -> tuple[int, int, int, int] | None:
    hour = g["H"] or g["Ha"] or g.get("H2")
    ampm = (g["ampm"] or g["ampm2"] or "").lower()
    h = int(hour or 0)
    if ampm:
        if h > 12:
            return None
        h = h % 12 + (12 if ampm == "pm" else 0)
    frac = (g["f"] or "")[:6].ljust(6, "0")
    return h, int(g["M"] or 0), int(g["S"] or 0), int(frac)


def parse_date(raw: str) -> datetime | None:
    """The datetime that ``dateutil.parser.parse(raw)`` gives on the forms
    above, or ``None``."""
    s = raw.strip()
    m = _ISO.fullmatch(s) or _SLASH.fullmatch(s) or _NAMED.fullmatch(s)
    if m is None:
        return None
    g = m.groupdict()
    hms = _hms(g)
    if hms is None:
        return None
    try:
        tz = None
        if g["utc"]:
            tz = timezone.utc
        elif g["sign"]:
            off = timedelta(hours=int(g["oh"]), minutes=int(g["om"] or 0))
            tz = timezone(-off if g["sign"] == "-" else off)
        return datetime(*_ymd(m), *hms, tzinfo=tz)
    except ValueError:
        return None
