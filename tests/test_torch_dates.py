"""The port's ``core/dates.py:parse_date`` held against
``dateutil.parser.parse`` (the reference's parser), and the matcher's
output row for each date form held against the reference's."""

from __future__ import annotations

import warnings

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
]

#: forms dateutil reads and the port does not (logged in ROADMAP.md, queue 3)
UNREAD = [
    "June 2020", "June 1", "1/6",                      # a field missing: filled from today
    "Mon, 01 Jun 2020 12:00:00 EST",                   # a named zone other than UTC/GMT
    "Mon, 01 Jun 2020 12:00:00 GMT+2",                 # dateutil's inverted GMT+h
    "Mon, 01 Jun 2020 12:00:00 +2400",                 # an offset of 24 h
    "June 1st, 2020", "Jun. 1, 2020", "2020-06-01 3:45 P.M.",
]


def same_date(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.replace(tzinfo=None) == b.replace(tzinfo=None) and a.utcoffset() == b.utcoffset()


def dateutil_parse(raw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # UnknownTimezoneWarning
        try:
            return dateparser.parse(raw)
        except (ValueError, OverflowError):
            return None


@pytest.mark.parametrize("raw", READ)
def test_parse_date_reads_as_dateutil(raw):
    assert same_date(parse_date(raw), dateutil_parse(raw))


@pytest.mark.parametrize("raw", UNREAD)
def test_parse_date_unread_forms_give_none(raw):
    assert dateutil_parse(raw) is not None
    assert parse_date(raw) is None


def test_append_match_writes_the_reference_row(tmp_path):
    """The matcher writes the row the reference writes (date forms the
    port once skipped), and skips the rows the reference skips."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    matches = {"text": ["Apple"], "title": []}
    for raw in ["June 1, 2020", "Mon, 01 Jun 2020 12:00:00 GMT", "06/01/2020", "1/6/20",
                "2020-06-01 3:45 PM", "not a date"]:
        row = {"date_time": raw, "title": "t", "url": "u", "article_text": "Apple x"}
        assert matcher.append_match(str(tmp_path / "port"), "AAPL", matches, row) == \
            ref.append_match(str(tmp_path / "ref"), "AAPL", matches, row)
    assert (tmp_path / "port" / "AAPL_match.csv").read_bytes() == \
        (tmp_path / "ref" / "AAPL_match.csv").read_bytes()
