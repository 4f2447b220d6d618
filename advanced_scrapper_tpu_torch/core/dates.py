"""Date parsing on the standard library, in place of
``dateutil.parser.parse`` (which the card's host does not have).

:func:`parse_date` agrees with ``dateutil.parser.parse`` (2.9) on these
forms, surrounding whitespace ignored:

- ISO 8601: ``YYYY-MM-DD`` (also ``YYYY-M-D`` and ``YYYYMMDD``);
- slashes, month first or year first: ``M/D/YYYY``, ``YYYY/M/D``, and
  ``D/M/YYYY`` where the first number cannot be a month (``13/06/2020``),
  as dateutil resolves them with ``dayfirst=False``; two numbers, ``M/D``,
  or a month and a year where one number is above 31 (``6/2020``,
  ``45/1``);
- a two-digit year, put within 50 years of the current year as dateutil's
  ``parserinfo.convertyear`` does;
- month names, full or three-letter, with or without a dot, in either
  order, the day with or without an ordinal (``st``, ``nd``, ``rd``,
  ``th``): ``June 1, 2020``, ``Jun. 1 2020``, ``1st June 2020``, and
  without the year (``June 1``) or the day (``June 2020``);
- an optional leading weekday name (``Mon, 01 Jun 2020 ...``, as RFC 2822
  writes it), which dateutil ignores where the day is given and otherwise
  moves the date to (on or after the default day).

A field that is not written comes from ``default``, which is today at
midnight as dateutil takes it; where only the day is missing and
default's day is past the month's end, the month's last day.

The date may be followed (after ``T``/``t`` for ISO, or whitespace) by a
time: ``HH`` or ``HHMM`` (after a whole date: year, month and day all
written), ``H:MM`` or ``H:MM:SS`` with an optional
fraction (cut to microseconds, as dateutil does), with an optional
``AM``/``PM`` (also ``A.M.``, ``p.m`` and a bare ``a``/``p``; ``H AM``
also; 12 AM is hour 0, and an hour above 12 with either is refused, as
dateutil refuses it).  After a time may come a zone:

- ``Z``, ``z``, ``UTC`` or ``GMT``: UTC;
- another name of 1-5 upper-case letters: naive, as dateutil leaves a name
  it does not know, unless the name is in ``time.tzname``: then the local
  zone's offset at that time;
- a ``±H``, ``±HH``, ``±HHMM`` or ``±H:MM`` offset: that offset;
- a name directly followed by an offset (``GMT+2``): dateutil reads it as
  "this time plus 2 hours is GMT", an offset of -2 hours, and drops a UTC
  name; another name in ``time.tzname`` still gives the local zone;
- a name, whitespace, then an offset (``GMT +2``, ``EST +2``): the offset
  as written, except after a UTC name, which keeps UTC (dateutil's
  ``parserinfo.validate``); a name in ``time.tzname`` gives the local zone.

An aware result has dateutil's UTC offset, as a ``datetime.timezone``; an
offset of 24 hours or more, which ``datetime.timezone`` cannot hold, as a
tzinfo of this module that reports it, so that ``.timestamp()`` and a
comparison with another zone raise ``ValueError`` as they do on
dateutil's result.  The ``M`` of ``A.M``/``P.M`` written in capitals
after a dot is a zone name to dateutil (so no other name may follow).
A number after whitespace (and an optional ``-``) where no time follows
the date is what dateutil makes of it: after a date that lacks its day or
its year, that field (``June 2020 03`` is June 3, ``June 1 03`` and ``1/6
03`` are in 2003, ``1/6 0330`` in the year 330), by dateutil's rules for
three date values; after a whole date, an ``HH`` or ``HHMM`` time
(``2020-06-01 -0430`` is 04:30).  One more ``-HH`` or ``-HHMM`` after the
field is the time, after the time a negative offset.  After a date that
lacks its day or year, ``H AM``/``H PM`` keeps an hour above 12 (``June 1
15 P.M.`` is 15:00), as dateutil does there.

What it cannot read (or an impossible date) gives ``None``, where
dateutil raises or reads more: a zone without a time, a weekday with
neither a day nor a month, and free text.
"""

from __future__ import annotations

import functools
import re
import time
from calendar import monthrange
from datetime import datetime, timedelta, timezone, tzinfo

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
_WEEKDAYS = {
    name: i
    for i, names in enumerate((
        ("mon", "monday"), ("tue", "tues", "tuesday"), ("wed", "wednesday"),
        ("thu", "thurs", "thursday"), ("fri", "friday"), ("sat", "saturday"),
        ("sun", "sunday"),
    ))
    for name in names
}
_WEEKDAY = "|".join(sorted(_WEEKDAYS, key=len, reverse=True))
_UTC_NAMES = ("UTC", "GMT", "Z", "z")

_AMPM = r"[AaPp](?:\.?[Mm])?\.?(?![A-Za-z])"
_TIME = (
    r"(?:(?P<H>\d{1,2}):(?P<M>\d{2})(?::(?P<S>\d{2})(?:\.(?P<f>\d+))?)?"
    r"(?:\s*(?P<ampm>" + _AMPM + r"))?"
    r"|(?P<Ha>\d{1,2})\s*(?P<ampm2>" + _AMPM + r")"
    r"|(?P<Hb>\d{2})(?P<Mb>\d{2})?(?![\d:])(?:\s*(?P<ampm3>" + _AMPM + r"))?)"
)
_OFFSET = r"\d{4}|\d{1,2}(?::\d{2})?"
# a zone only after a time; a, p, am and pm are never zone names
_ZONE = (
    r"(?:\s*(?:(?P<zname>(?![AP]M?(?![A-Z]))[A-Z]{1,5}(?![A-Za-z])|z(?![A-Za-z]))"
    r"(?:(?P<isign>[+-])(?P<ioff>" + _OFFSET + r")"
    r"|\s+(?P<nsign>[+-])(?P<noff>" + _OFFSET + r"))?"
    r"|(?P<sign>[+-])(?P<off>" + _OFFSET + r")))?"
)
# or, in place of a time, a number after a jump (whitespace and an optional
# ``-``), then at most one more after a ``-``: a date field or the time
_NUMBER = r"|\s+-?(?P<n>\d{1,4})(?:\s+-(?P<n2>\d{2}|\d{4}))?"

_ISO = re.compile(
    r"(?P<y>\d{4})(?:-(?P<m>\d{1,2})-(?P<d>\d{1,2})|(?P<m8>\d{2})(?P<d8>\d{2}))"
    r"(?:[Tt ](?:(?P<H2>\d{2})(?![\d:])|" + _TIME + r")" + _ZONE + _NUMBER + r")?"
)
_SLASH = re.compile(
    r"(?:(?P<a>\d{1,2})/(?P<b>\d{1,2})/(?P<c>\d{4}|\d{2})"
    r"|(?P<y>\d{4})/(?P<m>\d{1,2})/(?P<d>\d{1,2})"
    r"|(?P<p>\d{4}|\d{1,2})/(?P<q>\d{4}|\d{1,2}))"
    r"(?:\s+" + _TIME + _ZONE + _NUMBER + r")?"
)
# month and weekday names and ordinals in any case; the zone names only as
# dateutil takes them (upper case, or z)
_ORD = r"(?i:st|nd|rd|th)?"
_NAMED = re.compile(
    r"(?:(?P<wd>(?i:" + _WEEKDAY + r"))(?:,\s*|\s+))?"
    r"(?:(?P<mon>(?i:" + _MONTH + r"))\.?\s*(?P<d>\d{1,2})" + _ORD
    + r"(?:(?:,\s*|\s+)(?P<y>\d{4}))?"
    r"|(?P<d2>\d{1,2})" + _ORD + r"\s+(?P<mon2>(?i:" + _MONTH + r"))\.?"
    r"(?:(?:,\s*|\s+)(?P<y2>\d{4}))?"
    r"|(?P<mon3>(?i:" + _MONTH + r"))\.?,?\s+(?P<y3>\d{4}))"
    r"(?:\s+" + _TIME + _ZONE + _NUMBER + r")?"
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


def _year(digits: str) -> int:
    return int(digits) if len(digits) > 2 else convert_year(int(digits))


def _ymd(m: re.Match) -> tuple[int | None, int | None, int | None]:
    """(year, month, day) as written, ``None`` where a field is missing."""
    g = m.groupdict()
    mon = g.get("mon") or g.get("mon2") or g.get("mon3")
    if mon:
        year = g["y"] or g["y2"] or g["y3"]
        day = g["d"] or g["d2"]
        if year is None and day is not None and int(day) > 31:  # June 45: a year
            return convert_year(int(day)), _MONTHS[mon.lower()], None
        return (None if year is None else int(year), _MONTHS[mon.lower()],
                None if day is None else int(day))
    if g.get("a"):  # dateutil's three-number resolution, dayfirst=False
        a, b, c = int(g["a"]), int(g["b"]), int(g["c"])
        if a > 31:  # a two-digit year first
            return convert_year(a), b, c
        if len(g["c"]) == 2:
            c = convert_year(c)
        return (c, b, a) if a > 12 else (c, a, b)
    if g.get("p"):  # two numbers: a year where one is above 31, else M/D
        p, q = int(g["p"]), int(g["q"])
        if p > 31:
            return _year(g["p"]), q, None
        if q > 31:
            return _year(g["q"]), p, None
        return None, p, q
    return int(g["y"]), int(g["m"] or g.get("m8")), int(g["d"] or g.get("d8"))


def _fields(m: re.Match) -> list[tuple[int, str | None]]:
    """A date that lacks its day or its year as dateutil's list of date
    values holds it: each number with ``"M"`` for a month name and ``"Y"``
    for a number it takes as a year (more than two digits between slashes,
    above 100 elsewhere)."""
    g = m.groupdict()
    if g.get("p"):
        return [(int(x), "Y" if len(x) > 2 else None) for x in (g["p"], g["q"])]
    month = (_MONTHS[(g.get("mon") or g.get("mon2") or g["mon3"]).lower()], "M")
    if g.get("mon2"):
        return [(int(g["d2"]), None), month]
    value = int(g.get("d") or g["y3"])
    return [month, (value, "Y" if value > 100 else None)]


def _three(fields: list[tuple[int, str | None]]) -> tuple[int, int, int] | None:
    """(year, month, day) of three date values as dateutil 2.9 resolves
    them (``_ymd.resolve_ymd``, neither day nor year first), the year of
    two digits moved as ``convertyear`` moves it; ``None`` where it
    refuses (two years)."""
    labels = [lab for _v, lab in fields]
    if labels.count("Y") > 1:
        return None
    (a, _), (b, _), (c, _) = fields
    at = {lab: i for i, lab in enumerate(labels) if lab}
    if len(at) == 2:  # the third field is the one not named
        vals = dict.fromkeys("YMD")
        for lab in "YMD":
            i = at[lab] if lab in at else ({0, 1, 2} - set(at.values())).pop()
            vals[lab] = fields[i][0]
        year, month, day = vals["Y"], vals["M"], vals["D"]
    elif at.get("M") == 0:
        year, month, day = (b, a, c) if b > 31 else (c, a, b)
    elif at.get("M") == 1:
        year, month, day = (a, b, c) if a > 31 else (c, b, a)
    elif a > 31 or at.get("Y") == 0:
        year, month, day = a, b, c
    else:
        year, month, day = (c, b, a) if a > 12 else (c, a, b)
    if year < 100 and "Y" not in labels:
        year = convert_year(year)
    return year, month, day


def _hms(g: dict, partial: bool = False) -> tuple[int, int, int, int] | None:
    """The time's fields; ``partial``: the date lacks its day or year, and
    then ``H AM``/``H PM`` keeps an hour above 12 (dateutil adjusts that
    hour without the check it makes after a whole date)."""
    hour = g["H"] or g["Ha"] or g.get("H2") or g["Hb"]
    ampm = (g["ampm"] or g["ampm2"] or g["ampm3"] or "")[:1].lower()
    h = int(hour or 0)
    if ampm:
        if h > 12 and not (partial and g["Ha"]):
            return None
        if h <= 12:
            h = h % 12 + (12 if ampm == "p" else 0)
    frac = (g["f"] or "")[:6].ljust(6, "0")
    return h, int(g["M"] or g["Mb"] or 0), int(g["S"] or 0), int(frac)


class _FarOffset(tzinfo):
    """A fixed offset of 24 hours or more, as dateutil's ``tzoffset`` holds
    it: ``datetime`` refuses it wherever it asks for the offset
    (``.timestamp()``, a comparison with another zone), with ``ValueError``.
    One instance per offset within a process, as dateutil caches them, so
    two such dates of one offset compare; a pickled copy is a new one, as
    dateutil's is."""

    def __init__(self, offset: timedelta):
        self._offset = offset

    def utcoffset(self, dt):
        return self._offset

    def dst(self, dt):
        return timedelta(0)

    def tzname(self, dt):
        return None

    def __reduce__(self):
        return _FarOffset, (self._offset,)


@functools.cache
def _far_offset(offset: timedelta) -> _FarOffset:
    return _FarOffset(offset)


def _offset(text: str, sign: str) -> timedelta:
    """``±H``, ``±HH``, ``±HHMM`` or ``±H:MM`` as dateutil reads it."""
    if ":" in text:
        h, mm = text.split(":")
    elif len(text) == 4:
        h, mm = text[:2], text[2:]
    else:
        h, mm = text, "0"
    off = timedelta(hours=int(h), minutes=int(mm))
    return -off if sign == "-" else off


def _local(naive: datetime, name: str) -> datetime:
    """dateutil's result for a zone name in ``time.tzname``: the local
    zone's offset at that time (the later of an ambiguous hour where that
    one bears the name), UTC for a UTC name the local zone does not bear
    then."""
    aware = naive.astimezone()
    if aware.tzname() != name:
        later = naive.replace(fold=1).astimezone()
        if later.tzname() == name:
            aware = later
    if aware.tzname() != name and name in _UTC_NAMES:
        return naive.replace(tzinfo=timezone.utc)
    return naive.replace(tzinfo=aware.tzinfo)


def _aware(naive: datetime, g: dict, dotted_m: bool, m_then_sign: bool) -> datetime | None:
    """dateutil's zone for the match's zone fields (``_parse``,
    ``parserinfo.validate``, ``_build_tzaware``); None where it refuses.
    ``dotted_m``: the time's ``A.M``/``P.M`` made ``M`` a zone name;
    ``m_then_sign``: an offset's sign follows that ``M`` directly."""
    name = "M" if dotted_m else None
    if g.get("zname"):
        if name is not None:  # a second zone name
            return None
        name = g["zname"]
    off = None
    if g.get("isign"):  # NAME+h: "my time +h is NAME"
        off = -_offset(g["ioff"], g["isign"])
        if name in _UTC_NAMES:
            name = None
    elif g.get("nsign"):  # NAME +h: the offset as written, none for a UTC name
        off = timedelta(0) if name in _UTC_NAMES else _offset(g["noff"], g["nsign"])
    elif g.get("sign"):
        off = _offset(g["off"], g["sign"])
        if m_then_sign:  # P.M+2 reads as the zone name M with an inverted offset
            off = -off
    elif name in _UTC_NAMES:
        off = timedelta(0)
    if (off == timedelta(0) and name is None) or name in ("Z", "z"):
        name = "UTC"
    if name is not None and name in time.tzname:
        return _local(naive, name)
    if off == timedelta(0):
        return naive.replace(tzinfo=timezone.utc)
    if off:
        tz = _far_offset(off) if abs(off) >= timedelta(hours=24) else timezone(off)
        return naive.replace(tzinfo=tz)
    return naive  # no zone, or a name dateutil does not know


def _numbers(g: dict, partial: bool) -> tuple[str, str | None] | None:
    """The numbers that dateutil takes for date fields or the time rather
    than a time and a zone: ``(n, n2)`` of the number group, or a bare
    ``HH``/``HHMM`` after a date that lacks its day or year, with a
    ``-HH``/``-HHMM`` after it (any other zone there: ``None``)."""
    if g.get("n"):
        return g["n"], g["n2"]
    if not (partial and g["Hb"]) or g["ampm3"]:
        return "", None
    if g["zname"] or (g["sign"] and (g["sign"] != "-" or len(g["off"]) not in (2, 4))):
        return None
    return g["Hb"] + (g["Mb"] or ""), g["off"]


def parse_date(raw: str, default: datetime | None = None) -> datetime | None:
    """The datetime that ``dateutil.parser.parse(raw, default=default)``
    gives on the forms above, or ``None``; ``default`` is today at midnight
    when not given."""
    s = raw.strip()
    m = _ISO.fullmatch(s) or _SLASH.fullmatch(s) or _NAMED.fullmatch(s)
    if m is None:
        return None
    g = m.groupdict()
    try:
        year, month, day = _ymd(m)
        partial = None in (year, month, day)
        numbers = _numbers(g, partial)
        if numbers is None:
            return None
        n, n2 = numbers
        hms = None
        if n and partial:  # a third date field, then the time
            ymd = _three(_fields(m) + [(int(n), "Y" if int(n) > 100 else None)])
            if ymd is None:
                return None
            (year, month, day), partial, n, n2 = ymd, False, n2, None
            g, hms = dict.fromkeys(g), (0, 0, 0, 0)
        if n:  # HH or HHMM after a whole date, then an offset
            if len(n) not in (2, 4):
                return None
            hms = int(n[:2]), int(n[2:] or 0), 0, 0
            g = dict.fromkeys(g) | {"sign": "-" if n2 else None, "off": n2}
        elif hms is None:
            hms = _hms(g, partial)
        if hms is None:
            return None
        if g["Hb"] and partial:  # a bare hour needs a whole date
            return None
        if default is None and partial:
            default = datetime.now().replace(hour=0, minute=0, second=0, microsecond=0)
        year = default.year if year is None else year
        month = default.month if month is None else month
        weekday = g.get("wd")
        written_day = day is not None
        if day is None:
            day = min(default.day, monthrange(year, month)[1])
        naive = datetime(year, month, day, *hms)
        if weekday and not written_day:  # to the weekday, on or after
            naive += timedelta(days=(_WEEKDAYS[weekday.lower()] - naive.weekday()) % 7)
        ampm = next((a for a in ("ampm", "ampm2", "ampm3") if g.get(a)), "ampm")
        text = g.get(ampm) or ""
        dotted_m = ".M" in text
        return _aware(naive, g, dotted_m, text.endswith(".M") and g.get("sign") is not None
                      and m.start("sign") == m.end(ampm))
    except (ValueError, OverflowError, OSError):
        return None
