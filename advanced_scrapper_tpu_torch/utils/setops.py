"""Dataset set-algebra utilities.

The port's copy of the reference's ``utils/setops.py`` (its CSV
maintenance trio), reading and writing with pandas' typing and formatting
through ``cpu/csvframe.py``:

- :func:`anti_join_csv` — drop urls already present in other CSVs;
- :func:`round_robin_split` — split a URL list into N worker shards
  round-robin, after pre-dropping done urls — manual multi-machine data
  parallelism;
- :func:`new_links` — write the anti-join result to a new CSV.

Membership checks are host-side set lookups over the done-URL sets
(``storage.csvio.scraped_url_set``).
"""

from __future__ import annotations

from advanced_scrapper_tpu_torch.cpu.csvframe import Frame, format_value, is_na, read_frame
from advanced_scrapper_tpu_torch.storage.csvio import scraped_url_set


def _as_str(v):
    """``Series.astype(str)`` of one value: NA of a string column stays NA,
    a float NaN reads ``nan``."""
    if isinstance(v, str):
        return v
    if is_na(v):
        return "nan" if isinstance(v, float) else v
    return format_value(v)


def anti_join_csv(input_csv: str, *done_csvs: str, column: str = "url") -> Frame:
    """Rows of ``input_csv`` whose url is in none of ``done_csvs``.

    ``repair=False``: the done CSVs arrive on the CLI and may be
    hand-maintained, so they are read leniently and never mutated (the
    torn-tail quarantine is only correct for framework-owned append
    artifacts — ``storage/csvio.py``).  A torn done row parses to a
    partial url here, which errs toward re-queueing that url: duplicate
    work on resume, never a silently dropped one.
    """
    frame = read_frame(input_csv)
    done = scraped_url_set(*done_csvs, column=column, repair=False)
    kind, values = frame.column(column)
    if kind == "str":
        keep = [i for i, v in enumerate(values) if not (isinstance(v, str) and v in done)]
    else:
        keep = [i for i, v in enumerate(values) if _as_str(v) not in done]
    return frame.take(keep)


def new_links(input_csv: str, output_csv: str, *done_csvs: str, column: str = "url") -> int:
    out = anti_join_csv(input_csv, *done_csvs, column=column)
    out.to_csv(output_csv)
    return len(out)


def round_robin_split(
    input_csv: str,
    n_parts: int,
    *done_csvs: str,
    column: str = "url",
    output_template: str = "part_{i}.csv",
) -> list[str]:
    """Round-robin shard split with pre-drop.

    Returns the written paths; shard i gets rows i, i+n, i+2n, … of the
    remaining work list, preserving order within each shard.
    """
    if n_parts < 1:
        raise ValueError("n_parts must be >= 1")
    if n_parts > 1 and output_template.format(i=0) == output_template.format(i=1):
        raise ValueError(
            f"output_template {output_template!r} has no '{{i}}' placeholder — "
            "all shards would overwrite the same file"
        )
    frame = anti_join_csv(input_csv, *done_csvs, column=column)
    paths = []
    for i in range(n_parts):
        path = output_template.format(i=i)
        frame.take(range(i, len(frame), n_parts)).to_csv(path)
        paths.append(path)
    return paths
