"""Date parsing on the standard library, in place of
``dateutil.parser.parse`` (which the card's host does not have).

:func:`parse_date` follows dateutil 2.9's parser step by step, with its
default ``parserinfo`` (English month and weekday names, neither day nor
year first, not fuzzy):

- the same lexer: runs of letters and runs of digits are tokens, every
  other character is one, whitespace is ``" "``, and a dot or comma joins
  a number or a word as dateutil's lexer decides (``4:30:21.447``,
  ``Sep.20.2009``);
- the same walk over the tokens: numbers by their length and their
  neighbours (a time ``H:MM[:SS[.f]]``, ``HH``/``HHMM`` after a whole date,
  ``YYMMDD``/``HHMMSS``, ``YYYYMMDD[HHMM[SS]]``, ``N h``/``m``/``s``, date
  values joined by ``-``, ``/`` or ``.``, an hour before ``AM``/``PM``, a
  day where it can be one), month names (``June``, ``Jun``, ``Sept``, also
  ``June of 2020``), weekday names, ``AM``/``PM``, zone names of up to five
  capitals after a time (``GMT+2`` read as dateutil reads it, "this time
  plus 2 hours is GMT"), ``±H[H][MM]`` and ``±H:MM`` offsets after a time;
  the jump tokens (whitespace, ``. , ; - / '``, ``at``, ``on``, ``and``,
  ``ad``, ``m``, ``t``, ``of``, ``st``, ``nd``, ``rd``, ``th``) are
  skipped, and any other token refuses the string;
- the same resolution of up to three date values into year, month and day
  (``_ymd.resolve_ymd``), two-digit years put within 50 years of the
  current year (``parserinfo.convertyear``), and the same zone rules
  (``parserinfo.validate``, ``_build_tzaware``);
- the same fill of what is not written from ``default``, today at
  midnight when not given: a day past the month's end becomes its last
  day, and a weekday without a day moves the date to that weekday, on or
  after it.

Where dateutil raises, :func:`parse_date` gives ``None``.  An aware result
has dateutil's UTC offset, as a ``datetime.timezone``; a zone name in
``time.tzname`` gives the local zone's offset at that time, as dateutil's
``tzlocal`` does; an offset of 24 hours or more, which
``datetime.timezone`` cannot hold, a tzinfo of this module that reports
it, so that ``.timestamp()`` and a comparison with another zone raise
``ValueError`` as they do on dateutil's result.
"""

from __future__ import annotations

import functools
import string
import time
from calendar import monthrange
from datetime import datetime, timedelta, timezone, tzinfo
from decimal import Decimal

_JUMP = frozenset((" ", ".", ",", ";", "-", "/", "'", "at", "on", "and", "ad", "m", "t",
                   "of", "st", "nd", "rd", "th"))
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
_WEEKDAYS = {
    name: i
    for i, names in enumerate((
        ("mon", "monday"), ("tue", "tuesday"), ("wed", "wednesday"), ("thu", "thursday"),
        ("fri", "friday"), ("sat", "saturday"), ("sun", "sunday"),
    ))
    for name in names
}
_HMS = {"h": 0, "hour": 0, "hours": 0, "m": 1, "minute": 1, "minutes": 1,
        "s": 2, "second": 2, "seconds": 2}
_AMPM = {"am": 0, "a": 0, "pm": 1, "p": 1}
_UTC_LOWER = frozenset(("utc", "gmt", "z"))
_UTC_NAMES = ("UTC", "GMT", "Z", "z")


def _jump(tok: str) -> bool:
    return tok.lower() in _JUMP


def _month(tok: str) -> int | None:
    return _MONTHS.get(tok.lower())


def _hms(tok: str) -> int | None:
    return _HMS.get(tok.lower())


def _ampm(tok: str) -> int | None:
    return _AMPM.get(tok.lower())


def convert_year(year: int, century_specified: bool = False) -> int:
    """dateutil's ``parserinfo.convertyear``: a year below 100 written
    without its century goes to the current century, moved by 100 years to
    lie within 50 years of the current year."""
    if year < 0:
        raise ValueError(year)
    if year < 100 and not century_specified:
        now = time.localtime().tm_year
        year += now // 100 * 100
        if year >= now + 50:
            year -= 100
        elif year < now - 50:
            year += 100
    return year


def _tokens(s: str) -> list[str]:
    """dateutil's ``_timelex.split``: letters and digits in runs, a dot
    (or a comma after two digits) kept inside a number or a word where it
    may be a decimal point or a separator, then split again where it was
    not one; whitespace as ``" "``, every other character alone; NUL
    skipped."""
    chars = [c for c in s if c != "\x00"]
    out: list[str] = []
    i, n = 0, len(chars)
    while i < n:
        token = chars[i]
        i += 1
        if token.isalpha():
            state = "a"
        elif token.isdigit():
            state = "0"
        else:
            out.append(" " if token.isspace() else token)
            continue
        seen_letters = False
        while i < n:
            c = chars[i]
            if state == "a":
                seen_letters = True
                if c.isalpha():
                    token += c
                elif c == ".":
                    token += c
                    state = "a."
                else:
                    break
            elif state == "0":
                if c.isdigit():
                    token += c
                elif c == "." or (c == "," and len(token) >= 2):
                    token += c
                    state = "0."
                else:
                    break
            elif state == "a.":
                seen_letters = True
                if c == "." or c.isalpha():
                    token += c
                elif c.isdigit() and token[-1] == ".":
                    token += c
                    state = "0."
                else:
                    break
            else:  # "0."
                if c == "." or c.isdigit():
                    token += c
                elif c.isalpha() and token[-1] == ".":
                    token += c
                    state = "a."
                else:
                    break
            i += 1
        rest: list[str] = []
        if state in ("a.", "0.") and (seen_letters or token.count(".") > 1
                                      or token[-1] in ".,"):
            parts = _split_decimal(token)
            token, rest = parts[0], [p for p in parts[1:] if p]
        if state == "0." and "." not in token:
            token = token.replace(",", ".")
        out.append(token)
        out.extend(rest)
    return out


def _split_decimal(token: str) -> list[str]:
    """``re.split("([.,])", token)``."""
    parts, cur = [], ""
    for c in token:
        if c in ".,":
            parts += [cur, c]
            cur = ""
        else:
            cur += c
    return parts + [cur]


def _decimal(tok: str) -> Decimal:
    try:
        d = Decimal(tok)
    except Exception as e:
        raise ValueError(tok) from e
    if not d.is_finite():
        raise ValueError(tok)
    return d


def _parsems(value: str) -> tuple[int, int]:
    """``I[.F]`` seconds → (seconds, microseconds), the fraction cut to 6
    digits."""
    if "." not in value:
        return int(value), 0
    i, f = value.split(".")
    return int(i), int(f.ljust(6, "0")[:6])


def _min_sec(value: Decimal) -> tuple[int, int | None]:
    rem = value % 1
    return int(value), (int(60 * rem) if rem else None)


def _adjust_ampm(hour: int, ampm: int) -> int:
    if hour < 12 and ampm == 1:
        return hour + 12
    if hour == 12 and ampm == 0:
        return 0
    return hour


class _Ymd(list):
    """dateutil's ``_ymd``: up to three date values, each maybe labelled
    year (``Y``), month (``M``) or day (``D``)."""

    def __init__(self):
        super().__init__()
        self.century_specified = False
        self.at: dict[str, int] = {}

    def could_be_day(self, value) -> bool:
        if "D" in self.at:
            return False
        if "M" not in self.at:
            return 1 <= value <= 31
        month = self[self.at["M"]]
        year = self[self.at["Y"]] if "Y" in self.at else 2000
        return 1 <= value <= monthrange(year, month)[1]

    def append(self, val, label: str | None = None) -> None:
        if isinstance(val, str):
            if val.isdigit() and len(val) > 2:
                self.century_specified = True
                label = "Y"
        elif val > 100:
            self.century_specified = True
            label = "Y"
        super().append(int(val))
        if label is not None:
            if label in self.at:
                raise ValueError(f"{label} is already set")
            self.at[label] = len(self) - 1

    def resolve(self) -> tuple[int | None, int | None, int | None]:
        """(year, month, day) as ``resolve_ymd(yearfirst=False,
        dayfirst=False)`` gives them."""
        n, at = len(self), dict(self.at)
        if n == len(at) > 0 or (n == 3 and len(at) == 2):
            if n == 3 and len(at) == 2:
                (missing,) = {0, 1, 2} - set(at.values())
                (key,) = set("YMD") - set(at)
                at[key] = missing
            return tuple(self[at[k]] if k in at else None for k in "YMD")
        year = month = day = None
        mi = at.get("M")
        if n > 3:
            raise ValueError("More than three YMD values")
        if n == 1 or (mi is not None and n == 2):
            if mi is not None:
                month, other = self[mi], self[mi - 1]
            else:
                other = self[0]
            if n > 1 or mi is None:
                if other > 31:
                    year = other
                else:
                    day = other
        elif n == 2:
            a, b = self
            if a > 31:
                year, month = a, b
            elif b > 31:
                month, year = a, b
            else:
                month, day = a, b
        elif n == 3:
            a, b, c = self
            if mi == 0:
                month, year, day = (a, b, c) if b > 31 else (a, c, b)
            elif mi == 1:
                year, month, day = (a, b, c) if a > 31 else (c, b, a)
            elif mi == 2:
                day, year, month = (a, b, c) if b > 31 else (b, a, c)
            elif a > 31 or at.get("Y") == 0:
                year, month, day = a, b, c
            elif a > 12:
                day, month, year = a, b, c
            else:
                month, day, year = a, b, c
        return year, month, day


class _Result:
    __slots__ = ("year", "month", "day", "weekday", "hour", "minute", "second",
                 "microsecond", "tzname", "tzoffset", "ampm", "century_specified")

    def __init__(self):
        for name in self.__slots__:
            setattr(self, name, None)

    def empty(self) -> bool:
        return all(getattr(self, n) is None for n in self.__slots__[:-1])


def _could_be_tzname(res: _Result, tzoffset, tok: str) -> bool:
    return (res.hour is not None and res.tzname is None and tzoffset is None
            and len(tok) <= 5
            and (all(x in string.ascii_uppercase for x in tok) or tok in _UTC_NAMES))


def _find_hms_idx(i: int, tokens: list[str]) -> int | None:
    n = len(tokens)
    if i + 1 < n and _hms(tokens[i + 1]) is not None:
        return i + 1
    if i + 2 < n and tokens[i + 1] == " " and _hms(tokens[i + 2]) is not None:
        return i + 2
    if i > 0 and _hms(tokens[i - 1]) is not None:
        return i - 1
    if 1 < i == n - 1 and tokens[i - 1] == " " and _hms(tokens[i - 2]) is not None:
        return i - 2
    return None


def _numeric(tokens: list[str], i: int, ymd: _Ymd, res: _Result) -> int:
    """dateutil's ``_parse_numeric_token``: the index of the last token
    taken."""
    s = tokens[i]
    value = _decimal(s)
    n, count = len(s), len(tokens)
    if (len(ymd) == 3 and n in (2, 4) and res.hour is None
            and (i + 1 >= count or (tokens[i + 1] != ":" and _hms(tokens[i + 1]) is None))):
        res.hour = int(s[:2])  # HH or HHMM after a whole date
        if n == 4:
            res.minute = int(s[2:])
    elif n == 6 or (n > 6 and s.find(".") == 6):
        if not ymd and "." not in s:  # YYMMDD
            ymd.append(s[:2])
            ymd.append(s[2:4])
            ymd.append(s[4:])
        else:  # HHMMSS[.f]
            res.hour = int(s[:2])
            res.minute = int(s[2:4])
            res.second, res.microsecond = _parsems(s[4:])
    elif n in (8, 12, 14):  # YYYYMMDD[HHMM[SS]]
        ymd.append(s[:4], "Y")
        ymd.append(s[4:6])
        ymd.append(s[6:8])
        if n > 8:
            res.hour = int(s[8:10])
            res.minute = int(s[10:12])
            if n > 12:
                res.second = int(s[12:])
    elif (h := _find_hms_idx(i, tokens)) is not None:  # N h, N m, N s
        hms = _hms(tokens[h])
        if h > i:
            i = h
        else:
            hms += 1
        if hms == 0:
            res.hour = int(value)
            if value % 1:
                res.minute = int(60 * (value % 1))
        elif hms == 1:
            res.minute, res.second = _min_sec(value)
        elif hms == 2:  # 3 (a number after "s") assigns nothing, as in dateutil
            res.second, res.microsecond = _parsems(s)
    elif i + 2 < count and tokens[i + 1] == ":":  # H:MM[:SS[.f]]
        res.hour = int(value)
        res.minute, res.second = _min_sec(_decimal(tokens[i + 2]))
        if i + 4 < count and tokens[i + 3] == ":":
            res.second, res.microsecond = _parsems(tokens[i + 4])
            i += 2
        i += 2
    elif i + 1 < count and tokens[i + 1] in ("-", "/", "."):  # date values
        sep = tokens[i + 1]
        ymd.append(s)
        if i + 2 < count and not _jump(tokens[i + 2]):
            if tokens[i + 2].isdigit():
                ymd.append(tokens[i + 2])
            else:
                month = _month(tokens[i + 2])
                if month is None:
                    raise ValueError(tokens[i + 2])
                ymd.append(month, "M")
            if i + 3 < count and tokens[i + 3] == sep:
                month = _month(tokens[i + 4])
                if month is not None:
                    ymd.append(month, "M")
                else:
                    ymd.append(tokens[i + 4])
                i += 2
            i += 1
        i += 1
    elif i + 1 >= count or _jump(tokens[i + 1]):
        if i + 2 < count and _ampm(tokens[i + 2]) is not None:  # H AM
            res.hour = _adjust_ampm(int(value), _ampm(tokens[i + 2]))
            i += 1
        else:
            ymd.append(value)
        i += 1
    elif _ampm(tokens[i + 1]) is not None and 0 <= value < 24:  # HAM
        res.hour = _adjust_ampm(int(value), _ampm(tokens[i + 1]))
        i += 1
    elif ymd.could_be_day(value):
        ymd.append(value)
    else:
        raise ValueError(s)
    return i


def _parse(s: str) -> _Result | None:
    """dateutil's ``parser._parse`` and ``parserinfo.validate``: the fields
    written, or None where dateutil refuses the string."""
    tokens = _tokens(s)
    res, ymd = _Result(), _Ymd()
    count, i = len(tokens), 0
    try:
        while i < count:
            tok = tokens[i]
            try:
                number = float(tok)
            except ValueError:
                number = None
            if number is not None:
                i = _numeric(tokens, i, ymd, res)
            elif tok.lower() in _WEEKDAYS:
                res.weekday = _WEEKDAYS[tok.lower()]
            elif (month := _month(tok)) is not None:
                ymd.append(month, "M")
                if i + 1 < count:
                    if tokens[i + 1] in ("-", "/"):  # Jun-01[-2020]
                        sep = tokens[i + 1]
                        ymd.append(tokens[i + 2])
                        if i + 3 < count and tokens[i + 3] == sep:
                            ymd.append(tokens[i + 4])
                            i += 2
                        i += 2
                    elif (i + 4 < count and tokens[i + 1] == tokens[i + 3] == " "
                          and tokens[i + 2].lower() == "of"):  # June of 2020
                        if tokens[i + 4].isdigit():
                            ymd.append(str(convert_year(int(tokens[i + 4]))), "Y")
                        i += 4
            elif (ampm := _ampm(tok)) is not None:
                if res.hour is None or not 0 <= res.hour <= 12:
                    raise ValueError(tok)
                res.hour = _adjust_ampm(res.hour, ampm)
                res.ampm = ampm
            elif _could_be_tzname(res, res.tzoffset, tok):
                res.tzname = tok
                res.tzoffset = 0 if tok in _UTC_LOWER else None
                if i + 1 < count and tokens[i + 1] in ("+", "-"):
                    # NAME+h: "this time plus h is NAME", the sign inverted
                    tokens[i + 1] = "-" if tokens[i + 1] == "+" else "+"
                    res.tzoffset = None
                    if tok.lower() in _UTC_LOWER:
                        res.tzname = None
            elif res.hour is not None and tok in ("+", "-"):
                sign = 1 if tok == "+" else -1
                off = tokens[i + 1]
                if len(off) == 4:
                    hours, minutes = int(off[:2]), int(off[2:])
                elif i + 2 < count and tokens[i + 2] == ":":
                    hours, minutes = int(off), int(tokens[i + 3])
                    i += 2
                elif len(off) <= 2:
                    hours, minutes = int(off[:2]), 0
                else:
                    raise ValueError(off)
                res.tzoffset = sign * (hours * 3600 + minutes * 60)
                if (i + 5 < count and _jump(tokens[i + 2]) and tokens[i + 3] == "("
                        and tokens[i + 5] == ")" and 3 <= len(tokens[i + 4])
                        and _could_be_tzname(res, None, tokens[i + 4])):
                    res.tzname = tokens[i + 4]  # -0300 (BRST)
                    i += 4
                i += 1
            elif not _jump(tok):
                raise ValueError(tok)
            i += 1
        res.year, res.month, res.day = ymd.resolve()
        res.century_specified = ymd.century_specified
    except (IndexError, ValueError):
        return None
    if res.year is not None:
        res.year = convert_year(res.year, res.century_specified)
    if (res.tzoffset == 0 and not res.tzname) or res.tzname in ("Z", "z"):
        res.tzname, res.tzoffset = "UTC", 0
    elif res.tzoffset != 0 and res.tzname and res.tzname.lower() in _UTC_LOWER:
        res.tzoffset = 0
    return res


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


def _build(res: _Result, default: datetime) -> datetime:
    """dateutil's ``_build_naive`` then ``_build_tzaware`` (no
    ``tzinfos``)."""
    repl = {name: getattr(res, name)
            for name in ("year", "month", "day", "hour", "minute", "second", "microsecond")
            if getattr(res, name) is not None}
    if "day" not in repl:
        year = default.year if res.year is None else res.year
        month = default.month if res.month is None else res.month
        last = monthrange(year, month)[1]
        if default.day > last:
            repl["day"] = last
    naive = default.replace(**repl)
    if res.weekday is not None and not res.day:  # to the weekday, on or after
        naive += timedelta(days=(res.weekday - naive.weekday()) % 7)
    if res.tzname and res.tzname in time.tzname:
        return _local(naive, res.tzname)
    if res.tzoffset == 0:
        return naive.replace(tzinfo=timezone.utc)
    if res.tzoffset:
        off = timedelta(seconds=res.tzoffset)
        return naive.replace(
            tzinfo=_far_offset(off) if abs(off) >= timedelta(hours=24) else timezone(off))
    return naive  # no zone, or a name dateutil does not know


def parse_date(raw: str, default: datetime | None = None) -> datetime | None:
    """The datetime that ``dateutil.parser.parse(raw, default=default)``
    gives, or ``None`` where it raises; ``default`` is today at midnight
    when not given."""
    if default is None:
        default = datetime.now().replace(hour=0, minute=0, second=0, microsecond=0)
    res = _parse(raw)
    if res is None or res.empty():
        return None
    try:
        return _build(res, default)
    except (ValueError, OverflowError, OSError):
        return None
