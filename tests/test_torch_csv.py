"""The port's CSV reader (``cpu/csvframe.py``) held against
``pandas.read_csv`` on blank, whitespace-only and malformed lines, and on
line ends of ``\r`` alone."""

from __future__ import annotations

import pandas as pd
import pytest

from advanced_scrapper_tpu_torch.cpu import csvframe

BODIES = [
    'a\n"  "\nx\n',             # quoted whitespace: a row
    'a,b\n"  "\nx,1\n',         # the same beside a second column
    'a\n" \n "\nx\n',           # quoted whitespace across a line break
    'a\n""\nx\n',               # an empty quoted field: a row of NA
    'a\n  \nx\n',               # unquoted whitespace: skipped
    'a,b\n\t\nx,1\n',
    'a,b\n\nx,1\n',             # a blank line: skipped
    'a\n "  "\nx\n',            # a space before the quote: text
    'a,b\na"b,c\nx,1\n',        # malformed quoting: a quote inside a field
    'a,b\n"a"b,c\nx,1\n',       # text after a closing quote
    'a,b\rx,1\ry,2\r',          # a lone \r ends each line
    'a,b\nx,1\ry,2\n',          # \n and \r mixed
    'a,b\rx,1\r\ry,2',          # a blank line between lone \r, no end at the end
    'a,b\nx,"1\r2"\ny,3\n',     # a lone \r inside quotes: text
    'a\r\r\rx\r',               # blank lines of \r alone
]

#: a quoted field still open at the end of the file: pandas raises
UNCLOSED = ['a,b\nx,1\n"unclosed,2\n', 'a,b\nx,1\ny,"2', 'a,b\nx,1\n"unc\nlosed',
            'a,b\rx,1\r"open\r']


@pytest.mark.parametrize("body", BODIES)
def test_read_csv_columns_matches_pandas(tmp_path, body):
    path = tmp_path / "a.csv"
    path.write_text(body)
    want = pd.read_csv(path)
    names, typed = next(csvframe.read_csv_columns(str(path)))
    assert names == list(want.columns)
    for name, (_kind, values) in zip(names, typed):
        w = want[name].tolist()
        assert len(values) == len(w), (name, values, w)
        for g, x in zip(values, w):
            assert csvframe.is_na(g) == pd.isna(x) and (pd.isna(x) or str(g) == str(x)), (g, x)


@pytest.mark.parametrize("body", UNCLOSED)
def test_read_csv_columns_raises_where_pandas_raises(tmp_path, body):
    path = tmp_path / "a.csv"
    path.write_bytes(body.encode())
    with pytest.raises(ValueError):
        pd.read_csv(path)
    with pytest.raises(ValueError, match="EOF inside a quoted field"):
        list(csvframe.read_csv_columns(str(path), 1))
