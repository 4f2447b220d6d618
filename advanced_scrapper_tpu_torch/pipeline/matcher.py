"""Entity→article matching, screened on the card.

The port's counterpart of the reference's ``pipeline/matcher.py``
(``match_keywords.py`` re-implemented): the same entity loading, the same
exact host rules per article, the same per-ticker CSVs, byte for byte.
What differs is below the entry points:

- **the screen** (:func:`screen_chunk`): a chunk's eligible rows
  (``title\\ntext``, utf-8) are joined into ONE pinned buffer with int64
  row offsets and the per-row lengths and flags behind them, copied to the
  card once; the q-gram screen (``match_screen``, ``csrc/match.cu``) runs
  once per chunk and, in the fused mode, the Myers bound (``myers_bound``,
  ``csrc/editdist.cu``) once more, OR-ing its prune bit into the same
  ``uint8[rows, names]`` mask, which is read back once.  No width buckets,
  padding, packed tiles or dispatcher: the reference's tile plane
  (``_packed_screen``) has nothing to do here.  ``device="cpu"`` runs the
  kernels' plain versions on the same buffer;
- **prunes** are kept only where the pair also survived the screen: the
  host rules consult them only there (``match_article``), so the outputs
  are the reference's, without walking every bit-1 pair in Python;
- **no pandas, no dateutil**: chunks are anything with
  ``.to_dict("records")`` or lists of record dicts; the articles CSV is
  read and the outputs written by ``cpu/csvframe.py``, which reproduces
  pandas' parsing and writing; dates are read by ``core/dates.py``;
- **the legacy screen** (``packed=False``, ``ASTPU_MATCH_PACKED=0``,
  :func:`_legacy_screen`): ``screen_batch`` rows at a time, one
  ``match_screen`` launch a batch over the batch's joined rows, then, with
  ``use_refine``, the reference's per-pair refine (:func:`_refine_batch`):
  the screen's fuzzy survivors among the refine names, one ``myers_pairs``
  launch (``csrc/editdist.cu``) a batch that has pairs, over the batch's
  texts joined in one buffer, and the reference's float64 prune compare
  on the host;
- **the streaming run** (:func:`run_matcher`): one screening thread feeds
  a queue of capacity 1; the caller's thread drains it, so CSV appends
  stay single-writer and in chunk order.  ``MatchConfig.prewarm`` makes a
  warm launch of each kernel first (:func:`prewarm_screen`).

Observability, the reference's series: ``astpu_matcher_articles_total``,
``astpu_matcher_matches_total`` (gated by telemetry) and
``astpu_matcher_overlong_total`` (an event counter); the stage timers
``matcher_build``, ``matcher_screen``, ``h2d`` and ``matcher_verify`` and
the ``matcher.screen`` / ``matcher.verify`` spans; one
``stages.count_dispatch("matcher")`` and one ``devprof.dispatch_span`` a
launch, one ``count_device_put`` a copy.  ``EntityIndex.dispatch_probe``,
when set, receives one record a screen launch (a chunk on the one-buffer
screen, a batch on the legacy one) with the reference's keys: ``tile``
(the launch's index), ``rows``, ``width`` (the joined text's bytes),
``h2d_bytes``, ``put_ms`` and ``dispatch_ms``.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
import time
from dataclasses import dataclass
from datetime import timezone

import numpy as np

from advanced_scrapper_tpu_torch.config import MatchConfig
from advanced_scrapper_tpu_torch.core.dates import parse_date
from advanced_scrapper_tpu_torch.cpu import native
from advanced_scrapper_tpu_torch.cpu.csvframe import (
    is_na,
    read_csv_columns,
    read_csv_records,
    write_rows,
)
from advanced_scrapper_tpu_torch.obs import devprof, stages, telemetry, trace

ATTRIBUTES = (
    "id_label",
    "ticker",
    "aliases",
    "products",
    "subsidiaries",
    "owned_entities",
    "ceos",
    "board_members",
)  # ref :76-85

OUTPUT_FIELDS = [
    "time_unix",
    "date_time",
    "text_matches",
    "title_matches",
    "title",
    "url",
    "source",
    "source_url",
    "article_text",
]  # ref :134-144


# -- reference parsing helpers ---------------------------------------------


def is_within_period(article_date, start_date, end_date) -> bool:
    """Date-window gate (ref :17-37); naive datetimes are promoted to UTC."""
    if article_date is None:
        return False
    if article_date.tzinfo is None:
        article_date = article_date.replace(tzinfo=timezone.utc)
    if start_date is not None and start_date.tzinfo is None:
        start_date = start_date.replace(tzinfo=timezone.utc)
    if end_date is not None and end_date.tzinfo is None:
        end_date = end_date.replace(tzinfo=timezone.utc)
    if start_date and end_date:
        return start_date <= article_date <= end_date
    if start_date:
        return start_date <= article_date
    if end_date:
        return article_date <= end_date
    return True


def extract_time_periods(names) -> dict[str, tuple]:
    """``"Name (Start: …) (End: …)"`` → {name: (start, end)} (ref :40-65);
    an unreadable date is None."""
    periods: dict[str, tuple] = {}
    if isinstance(names, str):
        names = [names]
    for info in names:
        parts = info.split(" (")
        name = parts[0].strip()
        start = end = None
        for part in parts[1:]:
            if "Start:" in part:
                start = parse_date(part.replace("Start:", "").replace("T00:00:00Z)", "").strip())
            elif "End:" in part:
                end = parse_date(part.replace("End:", "").replace("T00:00:00Z)", "").strip())
        periods[name] = (start, end)
    return periods


def process_json_data(json_data: list) -> dict:
    """US-company filter + per-attribute period maps (ref :68-87)."""
    result = {}
    for company in json_data:
        if (len(json_data) >= 2 and "United States" in company.get("country", [])) or len(
            json_data
        ) <= 1:
            ticker = company["ticker"]
            result[ticker] = {
                attr: extract_time_periods(company.get(attr, [])) for attr in ATTRIBUTES
            }
    return result


def read_info_dir(folder: str) -> dict:
    """Load every info JSON with the encoding fallback chain (ref :90-120)."""
    out: dict = {}
    for filename in sorted(os.listdir(folder)):
        if not filename.endswith(".json"):
            continue
        path = os.path.join(folder, filename)
        data = None
        for enc in ("utf-8", "gbk", "latin1"):
            try:
                with open(path, "r", encoding=enc) as f:
                    data = json.load(f)
                break
            except (UnicodeDecodeError, json.JSONDecodeError):
                continue
        if data is None:
            print(f"could not read {filename}")
            continue
        out.update(process_json_data(data))
    return out


# -- flattened entity index (screen-ready) ----------------------------------


@dataclass(frozen=True)
class NameEntry:
    ticker: str
    attribute: str
    name: str
    start: object
    end: object
    is_exact_upper: bool  # ALL-CAPS word-boundary path (fuzzy otherwise)


class EntityIndex:
    """Flat, screen-ready view of the processed entity data.  Its host
    tables, verify arena and automaton are built once, lazily; so are its
    tables on each device (:meth:`device_tables`), so a stream of chunks
    copies the names to the card once."""

    def __init__(self, processed: dict):
        self.processed = processed
        self.entries: list[NameEntry] = []
        for ticker, attrs in processed.items():
            for attribute, names in attrs.items():
                for name, (start, end) in names.items():
                    if not name:
                        # empty names score partial_ratio 0.0: never a match
                        continue
                    if name.isupper():
                        if len(name) > 1:
                            self.entries.append(
                                NameEntry(ticker, attribute, name, start, end, True)
                            )
                        # single-char upper names never match (ref :166)
                    elif not (name.islower() and name.replace(" ", "").isalpha()):
                        self.entries.append(
                            NameEntry(ticker, attribute, name, start, end, False)
                        )
                    # pure-lowercase-alpha names are skipped (ref :174)
        self._tables: dict | None = None
        self._refine_tables: tuple | None = None
        self._verify_arena = None
        self._upper_matcher: tuple | None = None
        self._device_tables: dict = {}
        #: the last screened chunk's stage times (``pipeline/clock.py``)
        self.last_screen_clock = None
        #: optional per-launch observer ``(dict) -> None`` of the screen:
        #: launch index, rows, text bytes, h2d bytes, put and dispatch ms
        self.dispatch_probe = None

    @classmethod
    def from_info_dir(cls, folder: str) -> "EntityIndex":
        return cls(read_info_dir(folder))

    def screen_tables(self) -> dict:
        if self._tables is None:
            from advanced_scrapper_tpu_torch.ops.match import prepare_names

            with stages.timed("matcher_build"):
                names = [e.name.encode("utf-8", "replace") for e in self.entries]
                fuzzy = np.array([not e.is_exact_upper for e in self.entries], bool)
                self._tables = prepare_names(names, fuzzy=fuzzy)
        return self._tables

    def device_tables(self, device) -> tuple[dict, tuple | None]:
        """``(screen, refine)`` on ``device``: the screen's name tensors
        (``ops.match.screen_tensors``) and the refine candidates' ``(masks
        uint32[K, 256], plens int32[K], ok bool[K], cols int64[K])``, or
        None without candidates."""
        import torch

        from advanced_scrapper_tpu_torch.ops.match import screen_tensors

        key = str(device)
        got = self._device_tables.get(key)
        if got is None:
            tables = self.screen_tables()
            with stages.timed("matcher_build"):
                screen = screen_tensors(tables, device)
                ix, _names, (masks, lens, ok) = _refine_candidates(self)
                refine = None
                if len(ix):
                    refine = (
                        torch.from_numpy(masks.view(np.int32)).to(device).view(torch.uint32),
                        torch.from_numpy(lens).to(device),
                        torch.from_numpy(ok).to(device),
                        torch.from_numpy(ix.astype(np.int64)).to(device),
                    )
            got = self._device_tables[key] = (screen, refine)
        return got

    def upper_matcher(self):
        """``(MultiPattern | None, {name: pattern_id})`` over the unique
        ASCII ALL-CAPS names — the single-pass automaton that replaces
        per-name ``\\b re.escape(name) \\b`` scans; built once per index."""
        if self._upper_matcher is None:
            with stages.timed("matcher_build"):
                names = sorted({
                    e.name for e in self.entries
                    if e.is_exact_upper and e.name.isascii()
                })
                mp = None
                if names:
                    cand = native.MultiPattern([n.encode("ascii") for n in names])
                    mp = cand if cand.available else None
                self._upper_matcher = (mp, {n: i for i, n in enumerate(names)})
        return self._upper_matcher

    def verify_arena(self):
        """Packed-needle arena over all entry names (rows = entry index)."""
        if self._verify_arena is None:
            self._verify_arena = native.CutoffArena([e.name for e in self.entries])
        return self._verify_arena


# -- matching ----------------------------------------------------------------


def _find_positions(pattern: str, text: str) -> list[int]:
    return [m.start() for m in re.finditer(pattern, text)]


# ASCII \w table (letters, digits, underscore): on ASCII text this is
# exactly Python re's Unicode \w membership, which the boundary replay
# below must reproduce.
_ASCII_WORD = bytes(
    1 if (chr(c).isalnum() or c == ord("_")) else 0 for c in range(128)
) + bytes(128)


def _upper_positions(index: EntityIndex, text: str) -> dict[str, list[int]] | None:
    """Per-name start positions of every ALL-CAPS name in ``text`` via ONE
    automaton pass — output-identical to ``re.finditer(r"\\b" +
    re.escape(name) + r"\\b", text)`` per name.  None routes the caller to
    the per-name regex path (non-ASCII text)."""
    mp, _mid_of = index.upper_matcher()
    if mp is None or not text.isascii():
        return None
    data = text.encode("ascii")
    ids, starts = mp.scan(data)
    out: dict[str, list[int]] = {}
    if not len(ids):
        return out
    n = len(data)
    last_end: dict[int, int] = {}
    names = mp.patterns
    for i, s in zip(ids.tolist(), starts.tolist()):
        nb = names[i]
        e = s + len(nb)
        # \b before: boundary between text[s-1] and name[0]
        if _ASCII_WORD[nb[0]]:
            if s > 0 and _ASCII_WORD[data[s - 1]]:
                continue
        elif s == 0 or not _ASCII_WORD[data[s - 1]]:
            continue
        # \b after: boundary between name[-1] and text[e]
        if _ASCII_WORD[nb[-1]]:
            if e < n and _ASCII_WORD[data[e]]:
                continue
        elif e >= n or not _ASCII_WORD[data[e]]:
            continue
        if s < last_end.get(i, 0):
            continue  # finditer resumes at the previous match's end
        last_end[i] = e
        out.setdefault(nb.decode("ascii"), []).append(s)
    return out


def _find_positions_literal_fallback(name: str, text: str) -> list[int]:
    try:
        return _find_positions(name, text)
    except re.error:
        return _find_positions(re.escape(name), text)


def match_article(
    text: str,
    title: str,
    article_date,
    index: EntityIndex,
    candidate_mask: np.ndarray | None = None,
    threshold: float = 95.0,
    text_pruned: set | None = None,
) -> dict:
    """Exact match rules for one article → {ticker: {'text': …, 'title': …}}
    (the reference's, unchanged).  ``candidate_mask[j]`` (the screen) prunes
    name j, None scans every name; ``text_pruned`` holds names whose
    text-side score the bound proved ≤ threshold."""
    per_ticker: dict[str, dict] = {}

    def slot(ticker: str) -> dict:
        return per_ticker.setdefault(ticker, {"text": {}, "title": {}})

    pending: list[tuple[int, object]] = []
    text_rows: list[int] = []
    title_rows: list[int] = []
    entries = index.entries
    if candidate_mask is None:
        survivors = range(len(entries))
    else:
        survivors = np.flatnonzero(candidate_mask).tolist()
    any_upper = False
    for j in survivors:
        e = entries[j]
        if not is_within_period(article_date, e.start, e.end):
            continue
        pending.append((j, e))
        if not e.is_exact_upper:
            if text_pruned is None or j not in text_pruned:
                text_rows.append(j)
            title_rows.append(j)
        else:
            any_upper = True

    arena = index.verify_arena()
    text_score = dict(zip(text_rows, arena.scores(text, text_rows, threshold)))
    title_score = dict(zip(title_rows, arena.scores(title, title_rows, threshold)))

    auto_names: dict | None = None
    text_hits = title_hits = None
    if any_upper:
        auto_names = index.upper_matcher()[1]
        text_hits = _upper_positions(index, text)
        title_hits = _upper_positions(index, title)

    for j, e in pending:
        if e.is_exact_upper:
            in_auto = auto_names is not None and e.name in auto_names
            pattern = None
            if in_auto and text_hits is not None:
                text_pos = text_hits.get(e.name, [])
            else:
                pattern = r"\b" + re.escape(e.name) + r"\b"
                text_pos = _find_positions(pattern, text)
            if in_auto and title_hits is not None:
                title_pos = title_hits.get(e.name, [])
            else:
                if pattern is None:
                    pattern = r"\b" + re.escape(e.name) + r"\b"
                title_pos = _find_positions(pattern, title)
            if text_pos:
                slot(e.ticker)["text"][e.name] = text_pos
            if title_pos:
                slot(e.ticker)["title"][e.name] = title_pos
        else:
            if text_score.get(j, 0.0) > threshold:
                slot(e.ticker)["text"][e.name] = _find_positions_literal_fallback(e.name, text)
            if title_score.get(j, 0.0) > threshold:
                slot(e.ticker)["title"][e.name] = _find_positions_literal_fallback(e.name, title)
    return {t: v for t, v in per_ticker.items() if v["text"] or v["title"]}


def _get_col(row, *candidates, default=""):
    for c in candidates:
        if c in row and not is_na(row[c]):
            return str(row[c])
    return default


def _refine_candidates(index: EntityIndex):
    """Fuzzy names the Myers bound can handle: non-exact-upper, 1..32
    bytes, pure ASCII.  ``(name_indices, names, mask_tables)``, cached on
    the index."""
    if index._refine_tables is not None:
        return index._refine_tables
    from advanced_scrapper_tpu_torch.ops.editdist import MAX_PATTERN, build_pattern_masks

    ix, names = [], []
    for j, e in enumerate(index.entries):
        nb = e.name.encode("utf-8", "replace")
        if not e.is_exact_upper and 0 < len(nb) <= MAX_PATTERN and nb.isascii():
            ix.append(j)
            names.append(nb)
    out = (np.asarray(ix, dtype=np.int64), names, build_pattern_masks(names))
    index._refine_tables = out
    return out


class RefineController:
    """Measured race for the alignment-bound stage (the reference's,
    unchanged): probe each mode once on real chunks, commit to the winner
    (refine must beat screen-only by 5%), re-race every ``PROBE_EVERY``
    chunks; per-mode cost is the MIN observed s/row within an epoch."""

    PROBE_EVERY = 16
    WIN_MARGIN = 0.95

    def __init__(self):
        self._lock = threading.Lock()
        self._best: dict[bool, float | None] = {False: None, True: None}
        self._chunks = 0
        self._default = False  # verdict carried across epoch resets

    def next_mode(self) -> bool:
        with self._lock:
            if self._best[False] is None:
                return False
            if self._best[True] is None:
                return True
            return self._verdict_locked()

    def record(self, mode: bool, seconds_per_row: float) -> None:
        with self._lock:
            self._chunks += 1
            if self._chunks % self.PROBE_EVERY == 0:
                self._default = self._verdict_locked()
                self._best = {False: None, True: None}
            prev = self._best[mode]
            if prev is None or seconds_per_row < prev:
                self._best[mode] = seconds_per_row

    def verdict(self) -> bool:
        with self._lock:
            return self._verdict_locked()

    def _verdict_locked(self) -> bool:
        off, on = self._best[False], self._best[True]
        if off is None or on is None:
            return self._default
        return on < off * self.WIN_MARGIN


# -- the screen: one buffer, one copy, one launch per kernel ------------------


def _count_overlong(n: int) -> None:
    if n:
        telemetry.event_counter(
            "astpu_matcher_overlong_total",
            "articles above screen_block routed to the full host scan",
        ).inc(n)


def join_rows(rows: list, screen_block: int, device, clock=None, timing: dict | None = None):
    """The chunk's rows of at most ``screen_block`` bytes (``title\ntext``,
    utf-8 with ``errors="replace"``) joined into ONE pinned buffer — the
    text, then int64 row offsets, then int32 lengths, text lengths, title
    lengths and flags (:data:`FLAG_REFINE_OK` where the text is non-empty
    ASCII) — and copied to ``device`` once.  Returns ``(eligible, text,
    row_off, row_len, text_len, title_len, flags)``: the row indices that
    entered, then views of the device buffer.  ``clock`` laps
    ``encode_join`` and ``copy``; ``timing`` (a dict) gets the copy's
    ``put_s`` and ``h2d_bytes``.  The join is timed into the
    ``matcher_screen`` stage, the copy into ``h2d``."""
    import torch

    from advanced_scrapper_tpu_torch.ops.match import FLAG_REFINE_OK

    t_join = time.perf_counter()
    n = len(rows)
    raw = [(title + "\n" + text).encode("utf-8", "replace") for text, title, _, _ in rows]
    lens = np.fromiter(map(len, raw), np.int64, count=n)
    title_len = np.array([len(t.encode("utf-8", "replace")) for _, t, _, _ in rows], np.int64)
    # per-char encoding: len(title\ntext) = len(title) + 1 + len(text)
    text_len = lens - title_len - 1
    flags = np.array([FLAG_REFINE_OK if (t and t.isascii()) else 0 for t, _, _, _ in rows],
                     np.int64)
    eligible = np.flatnonzero(lens <= screen_block)
    R = eligible.size
    text_bytes = int(lens[eligible].sum())
    head = -(-text_bytes // 8) * 8
    buf = torch.empty((head + 24 * R,), dtype=torch.uint8, pin_memory=device.type == "cuda")
    host = buf.numpy()
    host[:text_bytes] = np.frombuffer(b"".join([raw[i] for i in eligible]), np.uint8)
    off = np.zeros(R, np.int64)
    np.cumsum(lens[eligible][:-1], out=off[1:])
    host[head : head + 8 * R].view(np.int64)[:] = off
    host[head + 8 * R :].view(np.int32).reshape(4, R)[:] = np.stack(
        [lens[eligible], text_len[eligible], title_len[eligible], flags[eligible]])
    if clock is not None:
        clock.lap("encode_join")
    t_put = time.perf_counter()
    stages.add("matcher_screen", t_put - t_join)
    dev_buf = buf.to(device, non_blocking=True)
    ints = dev_buf[head + 8 * R :].view(torch.int32).view(4, R)
    put_s = time.perf_counter() - t_put
    stages.add("h2d", put_s)
    stages.count_device_put(buf.numel(), "matcher")
    if timing is not None:
        timing.update(put_s=put_s, h2d_bytes=buf.numel())
    if clock is not None:
        clock.lap("copy")
    return (eligible, dev_buf[:text_bytes], dev_buf[head : head + 8 * R].view(torch.int64),
            *ints)


def _read_mask(mask) -> np.ndarray:
    """The screen's ``uint8[rows, names]`` mask on the host: from the card
    through pinned memory (synchronous: it waits for the kernels)."""
    import torch

    if mask.device.type != "cuda":
        return mask.numpy()
    back = torch.empty(mask.shape, dtype=torch.uint8, pin_memory=True)
    back.copy_(mask)
    return back.numpy()


def screen_chunk(
    rows: list,
    index: EntityIndex,
    *,
    use_refine: bool,
    threshold: float,
    screen_block: int,
    device,
) -> tuple[list, list]:
    """``(masks, prunes)`` of a chunk's ``(text, title, date, record)``
    rows.  Rows longer than ``screen_block`` bytes (``title\ntext``) get
    mask None (the full host scan); the rest go to the card in one buffer
    (:func:`join_rows`), are screened by one ``match_screen`` and, with
    ``use_refine``, one ``myers_bound``; the mask is read back once.
    ``prunes[a]`` holds the names whose screen and prune bits are both set
    (None where there is none).  The stage times land in
    ``index.last_screen_clock``; ``index.dispatch_probe`` gets one record."""
    from advanced_scrapper_tpu_torch.ops.editdist import myers_bound
    from advanced_scrapper_tpu_torch.ops.match import (
        MASK_SCREEN_KEEP,
        MASK_TEXT_PRUNED,
        match_screen,
    )
    from advanced_scrapper_tpu_torch.pipeline.clock import StageClock

    clock = index.last_screen_clock = StageClock(device)
    masks: list[np.ndarray | None] = [None] * len(rows)
    prunes: list[set | None] = [None] * len(rows)
    timing: dict = {}
    eligible, text, row_off, row_len, text_len, title_len, flags = join_rows(
        rows, screen_block, device, clock, timing)
    R = eligible.size
    _count_overlong(len(rows) - R)
    if R == 0:
        return masks, prunes
    screen_t, refine_t = index.device_tables(device)
    t0 = time.perf_counter()
    with stages.timed("matcher_screen"):
        with devprof.dispatch_span("matcher_screen_chunk", rows=R, width=text.numel()) as sp:
            sp.out = mask = match_screen(text, row_off, row_len, text_len, title_len, screen_t,
                                         threshold=threshold)
        stages.count_dispatch("matcher")
        clock.lap("screen")
        if use_refine and refine_t is not None:
            with devprof.dispatch_span("matcher_bound_chunk", rows=R, width=text.numel()) as sp:
                sp.out = myers_bound(text, row_off, row_len, text_len, flags, *refine_t,
                                     threshold, mask)
            stages.count_dispatch("matcher")
            clock.lap("bound")
    probe = index.dispatch_probe
    if probe is not None:
        probe({"tile": 0, "rows": R, "width": text.numel(), "h2d_bytes": timing["h2d_bytes"],
               "put_ms": round(timing["put_s"] * 1e3, 3),
               "dispatch_ms": round((time.perf_counter() - t0) * 1e3, 3)})
    with stages.timed("matcher_screen"):
        m = _read_mask(mask)
    clock.lap("readback")
    keep = (m & MASK_SCREEN_KEEP).view(np.bool_)
    for local, a in enumerate(eligible.tolist()):
        masks[a] = keep[local]
    if use_refine:
        # both bits: survivors the bound pruned
        rr, cc = np.nonzero(m == MASK_SCREEN_KEEP | MASK_TEXT_PRUNED)
        if rr.size:
            bounds = np.searchsorted(rr, np.arange(R + 1))
            for local in np.flatnonzero(np.diff(bounds)).tolist():
                prunes[int(eligible[local])] = set(cc[bounds[local]:bounds[local + 1]].tolist())
    clock.lap("scatter")
    return masks, prunes


def _refine_pairs(batch, got, index: EntityIndex):
    """The per-pair refine's work for one legacy batch, on the host: the
    screen's survivors (``got[i]``, None for a row that was not screened)
    among the refine names that are shorter than the row's text, for rows
    whose text is non-empty ASCII.  ``(pair_row, pair_text, pair_k, tok,
    lens)``: each pair's row, its text's index in ``tok``/``lens`` (the
    rows' texts, ``text`` only, by ``encode_batch``: no text is cut) and
    its refine name (a row of the index's refine masks); None without a
    pair."""
    from advanced_scrapper_tpu_torch.core.tokenizer import encode_batch

    fuzzy_ix, _names, (_masks, name_lens, _ok) = _refine_candidates(index)  # ASCII names
    pair_row: list[int] = []
    pair_k: list[np.ndarray] = []
    for i, (text, _title, _d, _r) in enumerate(batch):
        if got[i] is None or not text or not text.isascii():
            continue
        # strictly longer only: equal lengths are never prunable
        sel = np.flatnonzero(got[i][fuzzy_ix] & (len(text) > name_lens))
        pair_row.extend([i] * sel.size)
        pair_k.append(sel)
    if not pair_row:
        return None
    row_ids = sorted(set(pair_row))
    pos = dict(zip(row_ids, range(len(row_ids))))
    tok, lens = encode_batch([batch[r][0] for r in row_ids])
    pair_text = np.array([pos[r] for r in pair_row], dtype=np.int32)
    return np.asarray(pair_row), pair_text, np.concatenate(pair_k), tok, lens


def _refine_batch(batch, got, index: EntityIndex, threshold: float, device) -> list[set | None]:
    """The reference's per-pair refine of one legacy batch: per row, the
    set of entry indices whose text-side score is proven ≤ ``threshold``
    (None where none is).  The pairs (:func:`_refine_pairs`) go to
    ``device`` with the rows' texts in one buffer; one
    :func:`semiglobal_dist` launch gives each pair's distance, read back
    once; the prune compare is the reference's float64
    ``partial_ratio_bound(d, m) <= threshold``.  No pair: no launch."""
    import torch

    from advanced_scrapper_tpu_torch.ops.editdist import bound_at_most, semiglobal_dist

    out: list[set | None] = [None] * len(batch)
    pairs = _refine_pairs(batch, got, index)
    if pairs is None:
        return out
    pair_row, pair_text, ks, tok, lens = pairs
    R, L, P = tok.shape[0], tok.shape[1], pair_row.size
    head = -(-(R * L) // 8) * 8
    buf = torch.empty((head + 12 * R + 8 * P,), dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    host[:R * L] = tok.reshape(-1)
    host[head:head + 8 * R].view(np.int64)[:] = np.arange(R, dtype=np.int64) * L
    ints = host[head + 8 * R:].view(np.int32)
    ints[:R] = lens
    ints[R:R + P] = pair_text
    ints[R + P:] = ks
    with stages.timed("h2d"):
        dev_buf = buf.to(device, non_blocking=True)
    stages.count_device_put(buf.numel(), "matcher")
    dev_ints = dev_buf[head + 8 * R:].view(torch.int32)
    _screen_t, refine_t = index.device_tables(device)
    with stages.timed("matcher_screen"):
        with devprof.dispatch_span("matcher_pairs_legacy", rows=P, width=R * L) as sp:
            sp.out = d = semiglobal_dist(refine_t[0], refine_t[1], dev_buf[:R * L],
                                         dev_buf[head:head + 8 * R].view(torch.int64),
                                         dev_ints[:R], dev_ints[R:R + P], dev_ints[R + P:])
        stages.count_dispatch("matcher")
        fuzzy_ix, _names, (_masks, name_lens, _ok) = _refine_candidates(index)
        pruned = bound_at_most(d.cpu().numpy(), name_lens[ks], threshold)
    for r, k in zip(pair_row[pruned].tolist(), fuzzy_ix[ks[pruned]].tolist()):
        if out[r] is None:
            out[r] = set()
        out[r].add(k)
    return out


def _legacy_screen(
    rows: list,
    index: EntityIndex,
    *,
    use_refine: bool,
    threshold: float,
    screen_batch: int,
    screen_block: int,
    device,
) -> tuple[list, list]:
    """The reference's legacy screen loop (``packed=False``): ``(masks,
    prunes)`` of a chunk's rows, ``screen_batch`` rows at a time.  Each
    batch's rows of at most ``screen_block`` bytes are joined and copied
    once (:func:`join_rows`), screened by one ``match_screen`` launch and
    read back; with ``use_refine`` and refine names, :func:`_refine_batch`
    then launches ``myers_pairs`` once where the batch has pairs.  Longer
    rows get mask None (the full host scan) and no prunes.
    ``index.dispatch_probe`` gets one record a ``match_screen`` launch."""
    from advanced_scrapper_tpu_torch.ops.match import MASK_SCREEN_KEEP, match_screen

    masks: list[np.ndarray | None] = [None] * len(rows)
    prunes: list[set | None] = [None] * len(rows)
    screen_t, refine_t = index.device_tables(device)
    refine = use_refine and refine_t is not None
    probe = index.dispatch_probe
    n_overlong = launches = 0
    for start in range(0, len(rows), screen_batch):
        batch = rows[start:start + screen_batch]
        timing: dict = {}
        eligible, text, row_off, row_len, text_len, title_len, _flags = join_rows(
            batch, screen_block, device, timing=timing)
        n_overlong += len(batch) - eligible.size
        if eligible.size == 0:
            continue
        t0 = time.perf_counter()
        with stages.timed("matcher_screen"):
            with devprof.dispatch_span("matcher_screen_legacy", rows=eligible.size,
                                       width=text.numel()) as sp:
                sp.out = mask = match_screen(text, row_off, row_len, text_len, title_len,
                                             screen_t, threshold=threshold)
            stages.count_dispatch("matcher")
        if probe is not None:
            probe({"tile": launches, "rows": int(eligible.size), "width": text.numel(),
                   "h2d_bytes": timing["h2d_bytes"], "put_ms": round(timing["put_s"] * 1e3, 3),
                   "dispatch_ms": round((time.perf_counter() - t0) * 1e3, 3)})
        launches += 1
        with stages.timed("matcher_screen"):
            keep = (_read_mask(mask) & MASK_SCREEN_KEEP).view(np.bool_)
            got: list[np.ndarray | None] = [None] * len(batch)
            for local, i in enumerate(eligible.tolist()):
                got[i] = masks[start + i] = keep[local]
        if refine:
            prunes[start:start + len(batch)] = _refine_batch(batch, got, index, threshold,
                                                             device)
    _count_overlong(n_overlong)
    return masks, prunes


def prewarm_screen(
    index: EntityIndex,
    *,
    use_refine: bool | None = None,
    threshold: float = 95.0,
    screen_block: int = 1 << 16,
    packed: bool | None = None,
    device=None,
) -> int:
    """One warm launch of each kernel the screen's modes use, ahead of the
    first chunk: ``match_screen``; with refine (``use_refine`` True or
    None, and refine names), ``myers_bound`` for the packed screen or
    ``myers_pairs`` for the legacy one (``packed`` None:
    ``ASTPU_MATCH_PACKED``).  Each builds its kernel at first use, and the
    index's tables go to the card.  Returns the number of launches made,
    where the reference returns the number of tile shapes it compiled:
    the port has no shape set."""
    import torch

    from advanced_scrapper_tpu_torch import resolve_device
    from advanced_scrapper_tpu_torch.ops.editdist import myers_bound, semiglobal_dist
    from advanced_scrapper_tpu_torch.ops.match import match_screen

    if not index.entries:
        return 0
    dev = resolve_device(device)
    if packed is None:
        packed = _match_cfg().packed
    screen_t, refine_t = index.device_tables(dev)
    _e, text, row_off, row_len, text_len, title_len, flags = join_rows(
        [("warm up the screen", "warm", None, None)], screen_block, dev)
    mask = match_screen(text, row_off, row_len, text_len, title_len, screen_t,
                        threshold=threshold)
    launches = 1
    if use_refine is not False and refine_t is not None:
        if packed:
            myers_bound(text, row_off, row_len, text_len, flags, *refine_t, threshold, mask)
        else:
            zero = torch.zeros((1,), dtype=torch.int32, device=dev)
            semiglobal_dist(refine_t[0], refine_t[1], text, row_off, row_len, zero, zero)
        launches += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return launches


def _match_cfg() -> MatchConfig:
    """The ``ASTPU_MATCH_*`` knobs, read on every call, for callers of
    ``match_chunk*`` that pass no explicit value."""
    from advanced_scrapper_tpu_torch.config import from_env

    return from_env(MatchConfig, "match")


def _records(chunk) -> list[dict]:
    return chunk.to_dict("records") if hasattr(chunk, "to_dict") else list(chunk)


def match_chunk_async(
    chunk,
    index: EntityIndex,
    *,
    use_screen: bool = True,
    use_refine: bool | str = "auto",
    screen_batch: int = 128,
    screen_block: int = 1 << 16,
    threshold: float = 95.0,
    pool=None,
    packed: bool | None = None,
    screen_tile_bytes: int | None = None,
    dispatch_window: int | None = None,
    screen_put_workers: int | None = None,
    device=None,
):
    """Screen + submit a chunk NOW; return a zero-arg ``collect()`` whose
    call yields :func:`match_chunk`'s result.  With a pool the verify
    slices are already in flight when this returns.  ``packed`` (None:
    ``ASTPU_MATCH_PACKED``) picks the one-buffer screen
    (:func:`screen_chunk`) or the legacy per-batch loop
    (:func:`_legacy_screen`, ``screen_batch`` rows a batch);
    ``screen_tile_bytes``, ``dispatch_window`` and ``screen_put_workers``
    are the reference's tile-plane knobs and are read by nothing here.
    ``device`` is where the screen runs: None means ``cuda``; ``"cpu"``
    runs the plain versions."""
    if not (use_refine is True or use_refine is False or use_refine == "auto"):
        raise ValueError(f"use_refine must be True/False/'auto', got {use_refine!r}")
    if use_refine is True and not use_screen:
        raise ValueError("use_refine requires use_screen (see DESIGN.md §4)")
    if use_refine == "auto":
        ctrl = getattr(index, "refine_controller", None)
        use_refine = ctrl.verdict() if ctrl is not None else False

    m_articles = telemetry.counter(
        "astpu_matcher_articles_total", "articles entering the matcher"
    )
    m_matches = telemetry.counter(
        "astpu_matcher_matches_total", "(ticker, article) matches produced"
    )
    tid = trace.new_trace_id()
    rows = []
    for row in _records(chunk):
        text = _get_col(row, "article_text", "article")
        title = _get_col(row, "title")
        raw_date = _get_col(row, "date_time", "datetime", default="")
        rows.append((text, title, parse_date(raw_date) if raw_date else None, row))

    m_articles.inc(len(rows))
    masks: list[np.ndarray | None] = [None] * len(rows)
    text_prunes: list[set | None] = [None] * len(rows)
    if use_screen and index.entries and rows:
        from advanced_scrapper_tpu_torch import resolve_device

        if packed is None:
            packed = _match_cfg().packed
        t_screen = time.perf_counter()
        if packed:
            masks, text_prunes = screen_chunk(
                rows, index, use_refine=bool(use_refine), threshold=threshold,
                screen_block=screen_block, device=resolve_device(device),
            )
        else:
            masks, text_prunes = _legacy_screen(
                rows, index, use_refine=bool(use_refine), threshold=threshold,
                screen_batch=screen_batch, screen_block=screen_block,
                device=resolve_device(device),
            )
        if trace.RECORDER.active:
            trace.record("span", "matcher.screen", trace=tid, articles=len(rows),
                         dur_ms=round((time.perf_counter() - t_screen) * 1e3, 3))

    if pool is not None and len(rows) > 1:
        # ship (text, title, date, row-INDEX); the record stays here
        light = [(t, ti, d, i) for i, (t, ti, d, _r) in enumerate(rows)]
        n_slices = min(getattr(pool, "_max_workers", 4), len(rows))
        bounds = np.linspace(0, len(rows), n_slices + 1).astype(int)
        futures = [
            pool.submit(_verify_slice, light[lo:hi], masks[lo:hi], text_prunes[lo:hi], threshold)
            for lo, hi in zip(bounds[:-1], bounds[1:])
            if hi > lo
        ]

        def collect():
            out = []
            with stages.timed("matcher_verify"), trace.span(
                "matcher.verify", trace=tid, articles=len(rows)
            ):
                for f in futures:  # slice order == row order
                    out.extend((ticker, m, rows[i][3]) for ticker, m, i in f.result())
            m_matches.inc(len(out))
            return out

        collect.futures = futures
        return collect

    def collect():
        out = []
        with stages.timed("matcher_verify"), trace.span(
            "matcher.verify", trace=tid, articles=len(rows)
        ):
            for (text, title, adate, row), mask, pruned in zip(rows, masks, text_prunes):
                matches = match_article(text, title, adate, index, mask, threshold, pruned)
                for ticker, m in matches.items():
                    out.append((ticker, m, row))
        m_matches.inc(len(out))
        return out

    return collect


def match_chunk(
    chunk,
    index: EntityIndex,
    *,
    use_screen: bool = True,
    use_refine: bool | str = "auto",
    screen_batch: int = 128,
    screen_block: int = 1 << 16,
    threshold: float = 95.0,
    pool=None,
    packed: bool | None = None,
    screen_tile_bytes: int | None = None,
    dispatch_window: int | None = None,
    screen_put_workers: int | None = None,
    device=None,
) -> list[tuple[str, dict, dict]]:
    """Match a chunk of articles → [(ticker, matches, row_record), …]
    (reference schema ``article_text``/``date_time`` or the scraper's
    ``article``/``datetime``).  ``pool`` (:func:`make_verify_pool`) fans
    the host verify out over processes; the screen always runs here."""
    return match_chunk_async(
        chunk, index, use_screen=use_screen, use_refine=use_refine,
        screen_batch=screen_batch, screen_block=screen_block, threshold=threshold,
        pool=pool, packed=packed, screen_tile_bytes=screen_tile_bytes,
        dispatch_window=dispatch_window, screen_put_workers=screen_put_workers,
        device=device,
    )()


# -- verify-stage process pool (ref match_keywords.py:231-238) ---------------

_WORKER_INDEX: EntityIndex | None = None

#: seconds a verify worker waits at start for the pool's other workers
SPAWN_TIMEOUT_S = 300.0


def _verify_worker_init(entities_path: str, started) -> None:
    """Build the worker's EntityIndex ONCE (not per slice) from the pickled
    entity data at ``entities_path``, then wait until every worker of the
    pool has started: the executor spawns a worker per submit only while
    none is idle, so without the wait the pool's warm-up starts a few and
    the first chunks pay for spawning the rest."""
    import pickle

    global _WORKER_INDEX
    with open(entities_path, "rb") as f:
        _WORKER_INDEX = EntityIndex(pickle.load(f))
    started.wait(SPAWN_TIMEOUT_S)


def _warm_noop() -> bool:
    return True


def _verify_slice(rows, masks, prunes, threshold: float):
    """The host verify rules over one row slice (no device: the masks and
    prunes came from the screen in the parent).  ``rows`` carry row
    INDICES, echoed back for the parent to re-attach the records."""
    index = _WORKER_INDEX
    out = []
    for (text, title, adate, row_ix), mask, pruned in zip(rows, masks, prunes):
        matches = match_article(text, title, adate, index, mask, threshold, pruned)
        for ticker, m in matches.items():
            out.append((ticker, m, row_ix))
    return out


def make_verify_pool(index: EntityIndex, workers: int | None = None):
    """ProcessPoolExecutor for the verify stage, or None for ≤ 1 worker
    (0/None = ``os.cpu_count()``), with all its workers started.  Start
    method forkserver: every worker forks from a fresh server interpreter
    that never touched CUDA, so no fork ever copies a device context;
    workers run host code only (the port's worker code imports no torch).
    The entity data goes to the workers in a temporary file, read once
    each: as an initializer argument it would pass through each worker's
    start pipe, which holds 64 KiB, and serialize the workers' starts."""
    import multiprocessing as mp
    import pickle
    import sys
    import tempfile
    from concurrent.futures import ProcessPoolExecutor, wait

    if workers is None or workers == 0:
        workers = os.cpu_count() or 1
    if workers <= 1:
        return None
    try:
        ctx = mp.get_context("forkserver")
    except ValueError:  # no fork at all: spawn
        ctx = mp.get_context("spawn")
    with tempfile.NamedTemporaryFile(prefix="matcher-entities-", suffix=".pkl") as f:
        pickle.dump(index.processed, f)
        f.flush()
        pool = ProcessPoolExecutor(
            max_workers=workers, mp_context=ctx,
            initializer=_verify_worker_init, initargs=(f.name, ctx.Barrier(workers)),
        )
        warm = [pool.submit(_warm_noop) for _ in range(workers)]
        wait(warm)  # every worker has read the file
    dead = next((f.exception() for f in warm if f.exception()), None)
    if dead is not None:
        # hosts that refuse worker processes verify inline
        print(f"verify pool unavailable ({type(dead).__name__}: {dead}); verifying inline",
              file=sys.stderr)
        pool.shutdown(wait=False, cancel_futures=True)
        return None
    return pool


# -- output writing (ref :128-146, :195-217) --------------------------------


def append_match(out_dir: str, ticker: str, matches: dict, row) -> bool:
    """Append one matched article to ``{ticker}_match.csv`` as the
    reference's one-row ``to_csv(mode="a")`` does (header on a new file)."""
    raw_date = _get_col(row, "date_time", "datetime")
    parsed = parse_date(raw_date)
    try:
        ts = None if parsed is None else int(parsed.timestamp())
    except (ValueError, OverflowError):  # an offset of 24 h or more
        ts = None
    if ts is None:
        print(f"skipping row with unparseable date_time: {raw_date!r}")
        return False
    record = [
        ts,
        raw_date,
        json.dumps(matches["text"]),
        json.dumps(matches["title"]),
        _get_col(row, "title"),
        _get_col(row, "url"),
        _get_col(row, "source"),
        _get_col(row, "source_url"),
        _get_col(row, "article_text", "article"),
    ]
    path = os.path.join(out_dir, f"{ticker}_match.csv")
    header = None if os.path.exists(path) else OUTPUT_FIELDS
    write_rows(path, [record], header=header, mode="a")
    return True


def sort_matched_csv(path: str) -> None:
    """Final per-file time sort (ref :195-217): the file re-read and typed
    as ``pd.read_csv`` types it, rows ordered by ``np.argsort(time_unix,
    kind="quicksort")`` as ``sort_values`` orders them, and written as
    ``to_csv(index=False)`` writes them."""
    try:
        names, cols = next(read_csv_columns(path))
        values = [v for _k, v in cols]
        if "time_unix" not in names:
            parsed = [parse_date(str(d)) for d in values[names.index("date_time")]]
            values[names.index("date_time")] = parsed
            names = [*names, "time_unix"]
            values.append([int(d.timestamp()) for d in parsed])
        t = values[names.index("time_unix")]
        order = np.argsort(np.asarray(t), kind="quicksort")
        values[names.index("time_unix")] = [int(v) for v in t]
        write_rows(path, [[col[i] for col in values] for i in order.tolist()], header=names)
    except Exception as e:
        print(f"Error processing {path}: {e}")


_DONE = object()


def run_matcher(
    cfg: MatchConfig,
    *,
    use_screen: bool | None = None,
    use_refine: bool | str = "auto",
    articles_csv: str | None = None,
    workers: int | None = None,
    device=None,
) -> int:
    """CLI entry: full matching run (ref ``__main__`` :220-246).  The
    verify stage fans out over ``workers`` processes (default
    ``cfg.verify_workers``; 0 = ``os.cpu_count()``), created before the
    screen touches the card.  One screening thread reads and screens
    chunk i+1 while this thread drains chunk i (a queue of capacity 1);
    CSV appends stay here: single writer, chunk order.  ``cfg.packed``
    picks the screen (False: the legacy per-batch loop); ``cfg.prewarm``
    makes a warm launch of each of its kernels first.  ``device`` is where
    the screen runs (None: ``cuda``)."""
    articles_csv = articles_csv or cfg.articles_csv
    if not os.path.exists(articles_csv):
        print(f"Articles CSV '{articles_csv}' not found.")
        return 1
    index = EntityIndex.from_info_dir(cfg.info_dir)
    out_dir = f"{cfg.source_name}{cfg.out_dir_suffix}"
    os.makedirs(out_dir, exist_ok=True)
    use_screen = cfg.use_tpu if use_screen is None else use_screen
    if use_refine is True and not use_screen:
        raise ValueError("use_refine requires use_screen (see DESIGN.md §4)")
    if workers is None:
        workers = cfg.verify_workers
    if cfg.prewarm and use_screen and index.entries:
        # a forced mode warms only what it can launch; "auto" warms both
        prewarm_screen(index, use_refine=None if use_refine == "auto" else bool(use_refine),
                       threshold=cfg.fuzzy_threshold, packed=cfg.packed, device=device)
    pool = make_verify_pool(index, workers)
    n_matches = 0
    controller = RefineController() if use_refine == "auto" and use_screen else None
    if controller is not None:
        index.refine_controller = controller

    def drain(item) -> None:
        nonlocal n_matches
        collect, mode, screen_s, nrows = item
        t0 = time.perf_counter()
        for ticker, matches, row in collect():
            if append_match(out_dir, ticker, matches, row):
                n_matches += 1
        if controller is not None and nrows:
            controller.record(mode, (screen_s + time.perf_counter() - t0) / nrows)

    def screen(chunk):
        mode = controller.next_mode() if controller is not None else use_refine
        t0 = time.perf_counter()
        collect = match_chunk_async(
            chunk, index, use_screen=use_screen, use_refine=mode,
            threshold=cfg.fuzzy_threshold, pool=pool, packed=cfg.packed, device=device,
        )
        return (collect, mode, time.perf_counter() - t0, len(chunk))

    chunks = read_csv_records(articles_csv, cfg.chunk_size)
    try:
        if pool is None:
            # serial: collect() is this thread's work, nothing to overlap
            for chunk in chunks:
                drain(screen(chunk))
        else:
            screened: queue.Queue = queue.Queue(maxsize=1)
            stop = threading.Event()
            failure: list[BaseException] = []

            def producer() -> None:
                try:
                    for chunk in chunks:
                        item = screen(chunk)
                        while not stop.is_set():
                            try:
                                screened.put(item, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                except BaseException as e:  # re-raised in the caller's thread
                    failure.append(e)
                finally:
                    while not stop.is_set():
                        try:
                            screened.put(_DONE, timeout=0.1)
                            break
                        except queue.Full:
                            continue

            thread = threading.Thread(target=producer, name="matcher-screen", daemon=True)
            thread.start()
            try:
                while (item := screened.get()) is not _DONE:
                    drain(item)
                if failure:
                    raise failure[0]
            finally:
                stop.set()
                thread.join(timeout=30)
    finally:
        if pool is not None:
            pool.shutdown()
        if controller is not None and getattr(index, "refine_controller", None) is controller:
            del index.refine_controller
    for f in os.listdir(out_dir):
        sort_matched_csv(os.path.join(out_dir, f))
    print(f"Matching complete: {n_matches} ticker-article matches → {out_dir}/")
    return 0
