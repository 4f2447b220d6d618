"""The port's CSV reader (``cpu/csvframe.py``) held against
``pandas.read_csv`` on blank, whitespace-only and malformed lines."""

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
]


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
