"""The port's ``core/dates.py:parse_date`` held against
``dateutil.parser.parse`` (the reference's parser), and the matcher's
output row for each date form held against the reference's."""

from __future__ import annotations

import itertools
import pickle
import time
import warnings
from datetime import date, datetime, timedelta, timezone

import pytest
from dateutil import parser as dateparser

from advanced_scrapper_tpu.pipeline import matcher as ref
from advanced_scrapper_tpu_torch.core.dates import parse_date
from advanced_scrapper_tpu_torch.pipeline import matcher

#: forms the port reads: each gives dateutil's datetime (or dateutil's
#: refusal, as None)
READ = [
    # month names, full and abbreviated, either order
    "June 1, 2020", "1 Jun 2020", "Jun 1 2020", "01 June, 2020", "JUNE 1 2020",
    "Sept 3, 2020", "1 may 2020", "Monday, June 1, 2020", "Feb 29, 2020", "Feb 29, 2021",
    "June 31, 2020", "June 1, 2020 15:45:00 +0200",
    # RFC 2822
    "Mon, 01 Jun 2020 12:00:00 GMT", "Mon, 01 Jun 2020 12:00:00 +0200",
    "Tue, 01 Jun 2020 12:00:00 -0430", "Mon 01 Jun 2020 12:00:00 UTC",
    "Mon, 01 Jun 2020 12:00 GMT", "Mon,01 Jun 2020", "1 Jun 2020 00:00:00 Z",
    "MON, 01 JUN 2020 12:00:00 GMT", "1 Jun 2020 00:00:00 z",
    # a zone name in lower case, which dateutil refuses
    "Mon, 01 Jun 2020 12:00:00 utc", "June 1, 2020 3:45 pm gmt",
    # slashes, month first or year first, day first where it must be
    "06/01/2020", "2020/06/01", "13/06/2020", "06/13/2020", "2020/13/01", "06/2020/01",
    "06/01/2020 12:00:00 GMT", "2020/06/01 00:00 +05:30",
    # two-digit years, within 50 years of the current year
    "1/6/20", "1/6/75", "1/6/76", "1/6/99", "12/31/00", "45/06/01", "99/01/02",
    # AM/PM
    "2020-06-01 3:45 PM", "2020-06-01 3:45PM", "2020-06-01 12:00 AM", "2020-06-01 12:00 PM",
    "2020-06-01 0:30 AM", "2020-06-01 13:00 PM", "2020-06-01 3 PM", "2020-06-01 3:45:10.5 pm",
    "6/1/2020 3:45 PM", "June 1, 2020 3:45 PM", "2020-06-01 12:00:00 am",
    # ISO 8601 beside them
    "2020-06-01T3:45", "2020-06-01 3", "2020-06-01 03", "20200601",
    # a field missing: filled from today at midnight
    "June 2020", "June 1", "1/6", "Sept. 2020", "1st June", "6/2020", "45/1", "June 45",
    "Monday, June 2020",
    # a named zone other than UTC/GMT: naive
    "Mon, 01 Jun 2020 12:00:00 EST", "June 1, 2020 3:45 PM CEST",
    # dateutil's inverted NAME+h
    "Mon, 01 Jun 2020 12:00:00 GMT+2", "Mon, 01 Jun 2020 12:00:00 GMT-2",
    "Mon, 01 Jun 2020 12:00:00 UTC+02:00", "Mon, 01 Jun 2020 12:00:00 EST+2",
    "2020-06-01 12:00 GMT+0", "2020-06-01 3:45 P.M+05:30",
    # an offset of 24 h or more: a datetime whose offset datetime refuses
    "Mon, 01 Jun 2020 12:00:00 +2400", "Mon, 01 Jun 2020 12:00:00 -2400",
    # ordinals, a month abbreviation with a dot, A.M./P.M. with dots
    "June 1st, 2020", "Jun. 1, 2020", "2020-06-01 3:45 P.M.", "JUNE 3RD 2020", "Jun.1,2020",
    "June 22nd", "2020-06-01 3:45 a.m.", "2020-06-01 3:45 p", "2020-06-01 3:45 P.M. +0200",
    "2020-06-01 3:45 a.M. GMT", "2020-06-01 3:45 p.m. GMT",
    # a zone needs a time
    "2020-06-01 Z", "June 1, 2020 GMT",
    # a bare HH or HHMM after a whole date, and a name and an offset apart
    "06/01/2020 0330", "2020-06-01T0330", "1st June 2020 0330 P.M.", "06/01/2020 03 GMT",
    "06/01/2020 24", "2020-06-01 12:00 EST +2", "2020-06-01 12:00 GMT +0200",
    "2020-06-01 12:00 Z +2", "2020-06-01 12:00 GMT + 2",
    # jump words, a comma after the year, a time before the date, a bare
    # year, -HH:MM after a number that completes a partial date
    "June 1 03 -04:30", "Jun 1, 2020, 3:04 PM", "June 1, 2020 at 3:04 PM", "on June 1 2020",
    "1st of June 2020", "June 1 2020 and 3pm", "3:04 PM June 1 2020", "2020",
]

#: forms whose fields dateutil fills from today: the day past the month's
#: end falls back to its last day
MONTH_END = [("Feb 2021", datetime(2026, 1, 31)), ("6/2020", datetime(2024, 3, 31)),
             ("Sept. 2020", datetime(2023, 12, 31)), ("June 2020", datetime(2024, 5, 31)),
             ("Feb 2024", datetime(2023, 1, 30)), ("Monday, Feb 2021", datetime(2026, 1, 30))]

#: forms the port once left unread (ROADMAP.md, queue 3, now repaired): a
#: bare hour after a date that is not ISO 8601, a zone name and an offset apart
UNREAD = ["1st June 2020 03", "06/01/2020 03", "2020-06-01 12:00 GMT +2"]


def offset(d):
    """The zone's offset as the zone gives it (``datetime.utcoffset``
    refuses one of 24 h or more)."""
    return None if d.tzinfo is None else d.tzinfo.utcoffset(d)


def same_date(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.replace(tzinfo=None) == b.replace(tzinfo=None) and offset(a) == offset(b)


def dateutil_parse(raw, default=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # UnknownTimezoneWarning
        try:
            return dateparser.parse(raw, default=default)
        except (ValueError, OverflowError):
            return None


def on_one_day(fn):
    """``fn()``, taken again if midnight passed while it ran (the forms
    without a year or a day take them from today)."""
    while True:
        day = date.today()
        out = fn()
        if date.today() == day:
            return out


@pytest.mark.parametrize("raw", READ)
def test_parse_date_reads_as_dateutil(raw):
    got, want = on_one_day(lambda: (parse_date(raw), dateutil_parse(raw)))
    assert same_date(got, want)


@pytest.mark.parametrize("raw,default", MONTH_END)
def test_parse_date_month_end_as_dateutil(raw, default):
    want = dateutil_parse(raw, default)
    assert want is not None and want.day != default.day
    assert same_date(parse_date(raw, default), want)


@pytest.mark.parametrize("raw", UNREAD)
def test_parse_date_unread_forms_give_none(raw):
    """The forms that gave ``None`` now read as dateutil reads them (the
    test keeps its old name)."""
    want = dateutil_parse(raw)
    assert want is not None
    assert same_date(parse_date(raw), want)


#: the sweep: each date form with every time and every zone (or none),
#: 12 × 19 = 228 strings a form, under TZ=UTC
SWEEP_DATES = [
    "2020-06-01", "06/01/2020", "June 1, 2020", "1 Jun 2020", "Mon, 01 Jun 2020",
    "1st June 2020", "2020/06/01", "1/6/20", "June 2020", "June 1", "1/6", "Jun. 1 2020",
    "20200601", "6/2020", "Sept. 2020", "13/06/2020",
    # jump words, a comma after the year, a bare year, a number that
    # completes a partial date with -HH:MM after it
    "on June 1 2020", "1st of June 2020", "June 1, 2020 at", "June 1 2020 and",
    "Jun 1, 2020,", "2020", "June 1 03 -04:30",
]
SWEEP_TIMES = ["", "03", "15", "0330", "3:45", "15:45:10", "3 PM", "3:45 P.M.", "12:00 AM",
               "03:30:00.5", "15 P.M.", "0330 PM"]
SWEEP_ZONES = ["", "Z", "UTC", "GMT", "EST", "CEST", "+0200", "-0430", "+05:30", "+2",
               "GMT+2", "GMT-2", "UTC+02:00", "EST+2", "GMT +2", "EST +2", "+2400", "PST", "z"]


@pytest.mark.parametrize("form", SWEEP_DATES)
def test_parse_date_sweep_as_dateutil(form, monkeypatch):
    """Every time and zone after one date form reads as dateutil reads
    it, a number after a date that lacks its day or year included
    (``June 2020 03``, ``1/6 0330``, ``June 1 15 P.M.``)."""
    monkeypatch.setenv("TZ", "UTC")
    time.tzset()
    try:
        raws = [" ".join(x for x in (form, t, z) if x)
                for t, z in itertools.product(SWEEP_TIMES, SWEEP_ZONES)]
        got, want = on_one_day(lambda: ([parse_date(r) for r in raws],
                                        [dateutil_parse(r) for r in raws]))
        wrong = [(r, g, w) for r, g, w in zip(raws, got, want) if not same_date(g, w)]
        assert not wrong, wrong[:5]
        assert len(raws) == 228 and any(w is not None for w in want)
    finally:
        monkeypatch.undo()
        time.tzset()


#: date forms the sweep also writes after the time and zone
SWEEP_TIME_FIRST = ["June 1 2020", "on June 1, 2020", "2020-06-01", "06/01/2020", "2020"]


@pytest.mark.parametrize("form", SWEEP_TIME_FIRST)
def test_parse_date_sweep_time_first_as_dateutil(form, monkeypatch):
    """Every time and zone written before a date form (``3:04 PM June 1
    2020``) reads as dateutil reads it."""
    monkeypatch.setenv("TZ", "UTC")
    time.tzset()
    try:
        raws = [" ".join(x for x in (t, z, form) if x)
                for t, z in itertools.product(SWEEP_TIMES, SWEEP_ZONES)]
        got, want = on_one_day(lambda: ([parse_date(r) for r in raws],
                                        [dateutil_parse(r) for r in raws]))
        wrong = [(r, g, w) for r, g, w in zip(raws, got, want) if not same_date(g, w)]
        assert not wrong, wrong[:5]
        assert len(raws) == 228 and any(w is not None for w in want)
    finally:
        monkeypatch.undo()
        time.tzset()


def test_zone_names_of_the_local_zone(monkeypatch):
    """A zone name in ``time.tzname`` is the local zone, as dateutil reads
    it: EST in June is EDT's offset; EST+5 ignores its offset."""
    forms = ["Mon, 01 Jun 2020 12:00:00 EST", "Mon, 07 Dec 2020 12:00:00 EST",
             "Mon, 01 Jun 2020 12:00:00 EDT", "Mon, 01 Jun 2020 12:00:00 EST+5",
             "Mon, 01 Jun 2020 12:00:00 GMT", "Mon, 01 Jun 2020 12:00:00 PST"]
    monkeypatch.setenv("TZ", "EST5EDT,M3.2.0,M11.1.0")
    time.tzset()
    try:
        assert time.tzname == ("EST", "EDT")
        for raw in forms:
            assert same_date(parse_date(raw), dateutil_parse(raw)), raw
        assert offset(parse_date(forms[0])) == timedelta(hours=-4)
    finally:
        monkeypatch.undo()
        time.tzset()


def test_far_offset_fails_where_dateutils_fails():
    """``+2400``: dateutil's ``tzoffset`` of 24 h. ``.timestamp()`` and a
    comparison with another zone raise ``ValueError``; two such dates of
    one process compare; a pickled copy is another zone."""
    raw, later = "Mon, 01 Jun 2020 12:00:00 +2400", "Tue, 02 Jun 2020 12:00:00 +2400"
    for parse in (parse_date, dateutil_parse):
        a, b = parse(raw), parse(later)
        with pytest.raises(ValueError):
            a.timestamp()
        with pytest.raises(ValueError):
            _ = a < datetime(2020, 1, 1, tzinfo=timezone.utc)
        assert a < b
        with pytest.raises(ValueError):
            _ = pickle.loads(pickle.dumps(a)) < b


def test_date_windows_as_the_reference():
    """``is_within_period`` over the parsed forms gives the reference's
    answer, or raises where the reference raises (an article dated
    ``+2400`` beside a window in another zone)."""
    forms = [None, "June 2020", "June 1", "Mon, 01 Jun 2020 12:00:00 EST",
             "Mon, 01 Jun 2020 12:00:00 GMT+2", "Mon, 01 Jun 2020 12:00:00 +2400",
             "Tue, 02 Jun 2020 12:00:00 +2400", "June 1st, 2020", "2020-06-01 3:45 P.M."]

    def outcome(within, parse, a, s, e):
        try:
            return within(*(None if x is None else parse(x) for x in (a, s, e)))
        except ValueError:
            return ValueError

    def run():
        return [[outcome(within, parse, a, s, e)
                 for a, s, e in itertools.product(forms[1:], forms, forms)]
                for within, parse in ((matcher.is_within_period, parse_date),
                                      (ref.is_within_period, dateutil_parse))]

    got, want = on_one_day(run)
    assert got == want
    assert ValueError in want and True in want and False in want
    names = ["Tim Cook (Start: June 2011)", "A (Start: Jun. 1st, 2011) (End: 2011-06-01 3 P.M.)",
             "B (End: Mon, 01 Jun 2020 12:00:00 GMT+2)"]
    got, want = on_one_day(lambda: (matcher.extract_time_periods(names),
                                    ref.extract_time_periods(names)))
    assert list(got) == list(want)
    for k in want:
        assert all(same_date(g, w) for g, w in zip(got[k], want[k])), k


def test_append_match_writes_the_reference_row(tmp_path):
    """The matcher writes the row the reference writes (date forms the
    port once skipped), and skips the rows the reference skips."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    matches = {"text": ["Apple"], "title": []}
    forms = ["June 1, 2020", "Mon, 01 Jun 2020 12:00:00 GMT", "06/01/2020", "1/6/20",
             "2020-06-01 3:45 PM", "not a date", "June 2020", "June 1", "1/6",
             "Mon, 01 Jun 2020 12:00:00 EST", "Mon, 01 Jun 2020 12:00:00 GMT+2",
             "Mon, 01 Jun 2020 12:00:00 +2400", "June 1st, 2020", "Jun. 1, 2020",
             "2020-06-01 3:45 P.M."]

    def write():
        for side in ("port", "ref"):
            (tmp_path / side / "AAPL_match.csv").unlink(missing_ok=True)
        wrote = []
        for raw in forms:
            row = {"date_time": raw, "title": "t", "url": "u", "article_text": "Apple x"}
            wrote.append((matcher.append_match(str(tmp_path / "port"), "AAPL", matches, row),
                          ref.append_match(str(tmp_path / "ref"), "AAPL", matches, row)))
        return wrote

    wrote = on_one_day(write)
    assert all(p == r for p, r in wrote)
    skipped = [raw for raw, (p, _r) in zip(forms, wrote) if not p]
    assert skipped == ["not a date", "Mon, 01 Jun 2020 12:00:00 +2400"]
    assert (tmp_path / "port" / "AAPL_match.csv").read_bytes() == \
        (tmp_path / "ref" / "AAPL_match.csv").read_bytes()
