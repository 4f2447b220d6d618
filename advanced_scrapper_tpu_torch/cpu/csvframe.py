"""CSV reading and writing on the standard library, as pandas does it.

The reference's matcher reads its articles with ``pd.read_csv(chunksize=)``,
appends with ``DataFrame.to_csv(mode="a")`` and sorts each output file with
a ``read_csv → sort_values → to_csv`` round trip.  The card's host has no
pandas, so this module reproduces what those calls do to the bytes and to
the values the matcher reads:

- **reading**: fields from ``csv.reader`` (utf-8, a leading BOM dropped,
  blank lines skipped; ``\n``, ``\r\n`` and a lone ``\r`` end a line; a
  quoted field still open at the end of the file raises ``ValueError``,
  as pandas' ``ParserError`` does); header names as pandas makes them (``Unnamed: i``
  for an empty one, ``name.1`` for a repeat); missing trailing fields are
  NA; each column of each chunk typed as pandas' C parser types it:
  pandas' default NA tokens (:data:`NA_VALUES`) are NA; then int64 (digits
  with an optional sign, spaces around allowed; NA anywhere makes the
  column float64 of the integers; past int64, uint64 without NA or
  negatives, else text; past uint64 (or below int64) text, NA tokens
  kept as text where an integer past uint64 comes before a non-integer),
  float64 (pandas' own ``xstrtod``,
  reproduced in :func:`xstrtod`, and ``inf``/``infinity`` in any case),
  bool (``True``/``TRUE``/``true`` and the false forms), else str;
- **writing**: ``csv.writer`` with ``lineterminator="\\n"`` and
  ``QUOTE_MINIMAL``, the dialect pandas hands to ``csv``; a value is
  written as pandas formats its column's type (``str(int)``, ``repr``-like
  floats such as ``7.0`` and ``1e+16``, ``True``/``False``, NA as empty).

A record's NA is ``float("nan")``, as ``DataFrame.to_dict("records")``
gives it.

For the harvest and the set operations, :class:`Frame` holds a table as
``read_csv`` typed it (a header-only file's columns are ``object``) and
writes ``to_csv(index=False)``'s bytes; :func:`read_delimited_text` reads
a space-delimited CDX dump as ``read_csv(header=None, usecols=...,
names=...)`` does; :func:`concat` promotes column kinds as ``pd.concat``
does.  Differences from pandas found so far are logged in ROADMAP queue 3.
"""

from __future__ import annotations

import csv
import io
import math
import sys
from collections.abc import Iterator

#: pandas' default NA tokens (``pandas._libs.parsers.STR_NA_VALUES``)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
TRUE_VALUES = frozenset({"True", "TRUE", "true"})
FALSE_VALUES = frozenset({"False", "FALSE", "false"})
INF_VALUES = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf,
              "infinity": math.inf, "+infinity": math.inf, "-infinity": -math.inf}
NAN = float("nan")
_SPACE = " \t\n\r\f\v"
_E10 = [10.0 ** i for i in range(309)]
INT64_MIN, INT64_MAX, UINT64_MAX = -(1 << 63), (1 << 63) - 1, (1 << 64) - 1


def is_na(v) -> bool:
    """A record's missing value: ``None`` or a float NaN."""
    return v is None or (isinstance(v, float) and math.isnan(v))


def parse_int(tok: str) -> int | None:
    """pandas' ``str_to_int64`` syntax: spaces, an optional sign, at least
    one ASCII digit, spaces; else None."""
    s = tok.strip(_SPACE)
    body = s[1:] if s[:1] in "+-" else s
    if not body or not (body.isascii() and body.isdigit()):
        return None
    return int(s)


def xstrtod(tok: str) -> float | None:
    """pandas' default float converter (``precise_xstrtod``, decimal
    ``.``): leading spaces, a sign, at most 17 significant digits
    accumulated as a double (later digits only move the exponent), an
    optional exponent, trailing spaces; the scale applied by one multiply
    or divide by a power of ten.  Also ``inf``/``infinity`` in any case.
    None when the token is not a number."""
    s = tok.lstrip(_SPACE)
    special = INF_VALUES.get(s.rstrip(_SPACE).lower())
    if special is not None:
        return special
    i, n = 0, len(s)
    negative = i < n and s[i] == "-"
    if i < n and s[i] in "+-":
        i += 1
    number, exponent, digits = 0.0, 0, 0
    while i < n and "0" <= s[i] <= "9":
        if digits < 17:
            number = number * 10.0 + (ord(s[i]) - 48)
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and s[i] == ".":
        i += 1
        decimals = 0
        while digits < 17 and i < n and "0" <= s[i] <= "9":
            number = number * 10.0 + (ord(s[i]) - 48)
            digits += 1
            decimals += 1
            i += 1
        while i < n and "0" <= s[i] <= "9":
            i += 1
        exponent -= decimals
    if digits == 0:
        return None
    if negative:
        number = -number
    if i < n and s[i] in "eE":
        j = i + 1
        neg_e = j < n and s[j] == "-"
        if j < n and s[j] in "+-":
            j += 1
        e_digits, e = 0, 0
        while e_digits < 17 and j < n and "0" <= s[j] <= "9":
            e = e * 10 + (ord(s[j]) - 48)
            e_digits += 1
            j += 1
        if e_digits:
            exponent += -e if neg_e else e
            i = j
    if s[i:].strip(_SPACE):
        return None
    if exponent > 308:
        return math.copysign(math.inf, number) if number else 0.0
    if exponent > 0:
        return number * _E10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0 * number
        return number / _E10[-308 - exponent] / _E10[308]
    return number / _E10[-exponent]


def infer_column(tokens: list[str | None]) -> tuple[str, list]:
    """``(kind, values)`` of one column as pandas' C parser types it;
    ``None`` is a missing field.  ``kind`` is ``int``, ``float``, ``bool``
    or ``str``; NA values are NaN."""
    na = [t is None or t in NA_VALUES for t in tokens]
    live = [t for t, missing in zip(tokens, na) if not missing]
    if not live:
        return "float", [NAN] * len(tokens)
    ints: list[int] = []
    for t in live:  # in row order, as the C parser scans
        v = parse_int(t)
        if v is None:
            break  # not an integer: try float64
        if v > UINT64_MAX and not all(parse_int(u) is not None for u in live):
            return "str", ["" if t is None else t for t in tokens]  # NA tokens stay text
        ints.append(v)
    else:
        if any(v < INT64_MIN or v > UINT64_MAX for v in ints):
            return "str", [NAN if missing else t for t, missing in zip(tokens, na)]
        if any(v > INT64_MAX for v in ints):  # uint64: only without NA or negatives
            if not any(na) and all(v >= 0 for v in ints):
                return "int", ints
            return "str", ["" if t is None else t for t in tokens]  # NA tokens stay text
        if not any(na):
            return "int", ints
        it = iter(ints)  # integers with NA: float64 of each integer
        return "float", [NAN if missing else float(next(it)) for missing in na]
    floats = [xstrtod(t) for t in live]
    if all(v is not None for v in floats):
        it = iter(floats)
        return "float", [NAN if missing else next(it) for missing in na]
    if all(t in TRUE_VALUES or t in FALSE_VALUES for t in live):
        return "bool", [NAN if missing else t in TRUE_VALUES for t, missing in zip(tokens, na)]
    return "str", [NAN if missing else t for t, missing in zip(tokens, na)]


def _header(names: list[str]) -> list[str]:
    """pandas' column names: ``Unnamed: i`` for an empty one, ``name.1``,
    ``name.2`` ... for repeats."""
    out: list[str] = []
    for i, name in enumerate(names):
        name = name or f"Unnamed: {i}"
        base, k = name, 0
        while name in out:
            k += 1
            name = f"{base}.{k}"
        out.append(name)
    return out


def _records(lines, delimiter: str = ",", source: str = "the input") -> Iterator[list[str]]:
    """Rows of ``lines`` as pandas' C tokenizer cuts them: ``csv.reader``
    with ``delimiter`` (a run of delimiters is a run of empty fields), a
    quote opening a field only at its start, blank and unquoted
    whitespace-only lines skipped."""
    csv.field_size_limit(sys.maxsize)  # articles can pass csv's 128 KiB default
    last = [""]  # the raw line that ended the record being read
    ended = [False]

    def tracked():
        for line in lines:
            last[0] = line
            yield line
        ended[0] = True

    for row in csv.reader(tracked(), delimiter=delimiter):
        if ended[0]:  # csv hands back a quoted field still open at the end
            raise ValueError(f"Error tokenizing data: EOF inside a quoted field in {source}")
        if not row or (len(row) == 1 and not row[0].strip(_SPACE) and '"' not in last[0]):
            continue  # blank and unquoted whitespace-only lines, as skip_blank_lines
        yield row


def _rows(path: str) -> Iterator[list[str]]:
    with open(path, encoding="utf-8-sig", newline="") as f:
        yield from _records(f, source=path)


def read_csv_columns(path: str, chunksize: int | None = None) -> Iterator[tuple[list[str], list[tuple[str, list]]]]:
    """``(names, [(kind, values), ...])`` per chunk of ``chunksize`` data
    rows (all rows when None), each column typed over its chunk."""
    rows = _rows(path)
    header = next(rows, None)
    if header is None:
        raise ValueError(f"No columns to parse from file {path}")
    names = _header(header)
    width = len(names)
    chunk: list[list[str]] = []

    def typed(chunk):
        for r in chunk:
            if len(r) > width:
                raise ValueError(f"Expected {width} fields, saw {len(r)}")
        cols = [[r[j] if j < len(r) else None for r in chunk] for j in range(width)]
        return names, [infer_column(c) for c in cols]

    for row in rows:
        chunk.append(row)
        if chunksize is not None and len(chunk) == chunksize:
            yield typed(chunk)
            chunk = []
    if chunk or chunksize is None:
        yield typed(chunk)


def read_csv_records(path: str, chunksize: int) -> Iterator[list[dict]]:
    """``pd.read_csv(path, chunksize=chunksize)`` chunk by chunk, each as
    ``to_dict("records")`` gives it."""
    for names, cols in read_csv_columns(path, chunksize):
        values = [v for _k, v in cols]
        yield [dict(zip(names, rec)) for rec in zip(*values)]


def format_value(v) -> str:
    """A value as pandas' ``to_csv`` writes it: NA empty, bools as
    ``True``/``False``, floats in their shortest repr (``7.0``,
    ``1e+16``, ``inf``), everything else ``str``."""
    if is_na(v):
        return ""
    if isinstance(v, float):
        return repr(v)
    return str(v)


def write_rows(path: str, rows: list[list], *, header: list[str] | None = None,
               mode: str = "w") -> None:
    """Write ``rows`` (after ``header``, where given) as ``to_csv(index=
    False)`` writes them, appending with ``mode="a"``."""
    with open(path, mode, encoding="utf-8", newline="") as f:
        w = csv.writer(f, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        if header is not None:
            w.writerow(header)
        w.writerows([format_value(v) for v in r] for r in rows)


class Frame:
    """A table as pandas holds what ``read_csv`` gave it: column names and,
    for each column, ``(kind, values)`` as :func:`infer_column` types it.
    ``kind`` is ``int``, ``float``, ``bool``, ``str`` or ``object`` (no
    rows, or columns of several kinds met in :func:`concat`, each value
    keeping its own type).  Rows are taken by index; :meth:`to_csv` writes
    ``to_csv(index=False)``'s bytes."""

    def __init__(self, names: list[str], columns: list[tuple[str, list]]):
        self.names = list(names)
        self.columns = [(k, list(v)) for k, v in columns]

    def __len__(self) -> int:
        return len(self.columns[0][1]) if self.columns else 0

    def column(self, name: str) -> tuple[str, list]:
        if name not in self.names:
            raise KeyError(name)
        return self.columns[self.names.index(name)]

    def take(self, rows) -> "Frame":
        """The rows at ``rows``, in that order; each column keeps its kind,
        as a boolean mask or ``iloc`` keeps the dtype."""
        rows = list(rows)
        return Frame(self.names, [(k, [v[i] for i in rows]) for k, v in self.columns])

    def write(self, fh) -> None:
        """``to_csv(fh, index=False)`` into an open text handle."""
        w = csv.writer(fh, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        w.writerow(self.names)
        w.writerows([format_value(v) for v in r] for r in zip(*(v for _k, v in self.columns)))

    def to_csv(self, path: str) -> None:
        with open(path, "w", encoding="utf-8", newline="") as f:
            self.write(f)


def read_frame(path: str) -> Frame:
    """``pd.read_csv(path)``: a header-only file gives ``object`` columns."""
    names, cols = next(read_csv_columns(path))
    if not cols or not cols[0][1]:
        cols = [("object", []) for _ in names]
    return Frame(names, cols)


def read_delimited_text(text: str, *, delimiter: str, usecols: list[int],
                        names: list[str]) -> Frame:
    """``pd.read_csv(io.StringIO(text), delimiter=delimiter, header=None,
    usecols=usecols, names=names)`` with the C parser.

    The row width is the first row's field count or ``len(names)``,
    whichever is larger: a field past it reads NA on every row, even on
    rows that have it, and a column that every row lacks raises, as
    pandas' out-of-bounds ``usecols`` check does.  Fields past the used
    ones are ignored; a short row reads NA."""
    rows = list(_records(io.StringIO(text, newline=""), delimiter=delimiter))
    if not rows:
        raise ValueError("No columns to parse from file")
    longest = max(len(r) for r in rows)
    missing = [j for j in usecols if j >= longest]
    if missing:
        raise ValueError(f"Defining usecols with out-of-bounds indices is not allowed. "
                         f"{missing} are out of bounds.")
    width = max(len(rows[0]), len(names))
    cols = []
    for j in usecols:
        if j >= width:
            cols.append(("object", [NAN] * len(rows)))  # an all-NA column of no type
        else:
            cols.append(infer_column([r[j] if j < len(r) else None for r in rows]))
    return Frame(names, cols)


def concat(frames: list[Frame]) -> Frame:
    """``pd.concat(frames, ignore_index=True)`` of frames with the same
    columns.  A column's kind is the common one: the same kind stays;
    ``int`` with ``float`` is ``float`` (each integer as a float, so it is
    written ``7.0``); any other mix, an ``object`` column (a header-only
    frame's) included, is ``object`` with each value as its frame had it."""
    names = frames[0].names
    for f in frames[1:]:
        if f.names != names:
            raise ValueError(f"columns differ: {f.names} against {names}")
    out = []
    for j in range(len(names)):
        kinds = {f.columns[j][0] for f in frames}
        values = [v for f in frames for v in f.columns[j][1]]
        if len(kinds) == 1:
            kind = kinds.pop()
        elif kinds == {"int", "float"}:
            kind, values = "float", [float(v) for v in values]
        else:
            kind = "object"
        out.append((kind, values))
    return Frame(names, out)
