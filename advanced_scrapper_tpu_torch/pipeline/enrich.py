"""L4: Wikidata SPARQL ticker enrichment.

The port's copy of the reference's ``pipeline/enrich.py``: its
``<SYMBOL>_info.json`` files, its progress ledger and its sleeps are the
reference's.  ``requests`` and ``urllib3`` are imported only inside
:func:`create_session`; with a ``session`` injected (any object with a
requests-shaped ``get``) neither is needed.

Re-implements both reference variants:

- the simple pass (``ticker_symbol_query.py:10-201``): three SPARQL queries
  per symbol — entity/labels/aliases/industries/countries/products (Q1),
  subsidiaries/owned entities with start/end qualifiers (Q2), CEOs/board
  members with term qualifiers (Q3) — zipped positionally into
  ``info/<dir>/<SYMBOL>_info.json``;
- the hardened pass (``ticker_symbol_query_rate_limit_protected.py``):
  retrying session (urllib3 ``Retry(total=5, backoff_factor=2,
  status_forcelist=[429,500,502,503,504])`` + browser UA, ref ``:11-31``),
  per-symbol attempt loop with 429-specific ``base·3^attempt`` escalation
  vs ``base·2^attempt`` otherwise plus jitter (ref ``:302-315``),
  inter-query 1-3 s sleeps, empty-result placeholder entries, progress
  ledger saved after every symbol with artifact-repair, and paced
  cool-downs every 3 / every 10 symbols (ref ``:417-427``).

Output text formats (``"Name (Start: …) (End: …)"`` with ``"| | |"``
separators) are load-bearing: ``match_keywords``-equivalent parsing in
``pipeline/matcher.py`` consumes them.  Clock/random/HTTP are injectable so
the whole ladder is testable offline.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Callable

from advanced_scrapper_tpu_torch.config import EnrichConfig
from advanced_scrapper_tpu_torch.storage.progress import ProgressLedger

SEP = "| | |"

# SPARQL property map (same entity graph the reference walks):
#   P414/P249  listed-on-exchange ticker   P452 industry     P17  country
#   P1056 products                         P355 subsidiaries P1830 owner-of
#   P169 CEO (+P580/P582 terms)            P3320 board member (+terms)


def build_queries(symbol: str) -> tuple[str, str, str]:
    sym = symbol.upper().replace("'", "")  # defensive: symbol goes into SPARQL
    ticker_clause = f"""
        ?id wdt:P414 ?exchange .
        ?id p:P414 ?exchangesub .
        ?exchangesub pq:P249 ?ticker . FILTER(UCASE(STR(?ticker)) = '{sym}') .
    """
    q1 = f"""
    SELECT ?ticker ?id
        (GROUP_CONCAT(DISTINCT ?idLabel;separator="{SEP}") AS ?idLabels)
        (GROUP_CONCAT(DISTINCT ?altLabel; separator = "{SEP}") AS ?aliases)
        (GROUP_CONCAT(DISTINCT ?industryLabel; separator = "{SEP}") AS ?industries)
        (GROUP_CONCAT(DISTINCT ?countryLabel; separator = "{SEP}") AS ?countries)
        (GROUP_CONCAT(DISTINCT ?productLabel; separator = "{SEP}") AS ?products)
    WHERE {{
        {{ {ticker_clause}
           OPTIONAL {{ ?id rdfs:label ?idLabel . FILTER (LANG(?idLabel) = "en") }} }}
        OPTIONAL {{ ?id skos:altLabel ?altLabel . FILTER (LANG(?altLabel) = "en") }}
        OPTIONAL {{ ?id wdt:P452 ?industry .
                    ?industry rdfs:label ?industryLabel .
                    FILTER (LANG(?industryLabel) = "en") }}
        OPTIONAL {{ ?id wdt:P17 ?country .
                    ?country rdfs:label ?countryLabel .
                    FILTER (LANG(?countryLabel) = "en") }}
        OPTIONAL {{ ?id wdt:P1056 ?product .
                    ?product rdfs:label ?productLabel .
                    FILTER (LANG(?productLabel) = "en") }}
        SERVICE wikibase:label {{ bd:serviceParam wikibase:language "[AUTO_LANGUAGE],en". }}
    }}
    GROUP BY ?ticker ?id
    """
    q2 = f"""
    SELECT ?ticker ?id
        (GROUP_CONCAT(DISTINCT ?idLabel;separator="{SEP}") AS ?idLabels)
        (GROUP_CONCAT(DISTINCT CONCAT(?subsidiaryLabel,
            IF(BOUND(?start_time), CONCAT(" (Start: ", STR(?start_time), ")"), ""),
            IF(BOUND(?end_time), CONCAT(" (End: ", STR(?end_time), ")"), "")
        );separator="{SEP}") AS ?subsidiaries)
        (GROUP_CONCAT(DISTINCT CONCAT(?ownerOfLabel,
            IF(BOUND(?start_time_owner), CONCAT(" (Start: ", STR(?start_time_owner), ")"), ""),
            IF(BOUND(?end_time_owner), CONCAT(" (End: ", STR(?end_time_owner), ")"), "")
        );separator="{SEP}") AS ?ownedEntities)
    WHERE {{
        {{ {ticker_clause}
           OPTIONAL {{ ?id rdfs:label ?idLabel . FILTER (LANG(?idLabel) = "en") }} }}
        OPTIONAL {{ ?id wdt:P355 ?subsidiary .
                    ?subsidiary rdfs:label ?subsidiaryLabel .
                    FILTER (LANG(?subsidiaryLabel) = "en")
                    OPTIONAL {{ ?id p:P355 [ps:P355 ?subsidiary; pq:P580 ?start_time; pq:P582 ?end_time] }} }}
        OPTIONAL {{ ?id wdt:P1830 ?ownerOf .
                    ?ownerOf rdfs:label ?ownerOfLabel .
                    FILTER (LANG(?ownerOfLabel) = "en")
                    OPTIONAL {{ ?id p:P1830 [ps:P1830 ?ownerOf; pq:P580 ?start_time_owner; pq:P582 ?end_time_owner] }} }}
        SERVICE wikibase:label {{ bd:serviceParam wikibase:language "[AUTO_LANGUAGE],en". }}
    }}
    GROUP BY ?ticker ?id
    """
    q3 = f"""
    SELECT ?ticker ?id
        (GROUP_CONCAT(DISTINCT CONCAT(?ceoLabel,
            IF(BOUND(?ceoStart), CONCAT(" (Start: ", STR(?ceoStart), ")"), ""),
            IF(BOUND(?ceoEnd), CONCAT(" (End: ", STR(?ceoEnd), ")"), "")
        );separator="{SEP}") AS ?ceosWithTerms)
        (GROUP_CONCAT(DISTINCT CONCAT(?boardMemberLabel,
            IF(BOUND(?boardMemberStart), CONCAT(" (Start: ", STR(?boardMemberStart), ")"), ""),
            IF(BOUND(?boardMemberEnd), CONCAT(" (End: ", STR(?boardMemberEnd), ")"), "")
        );separator="{SEP}") AS ?boardMembersWithTerms)
    WHERE {{
        {{ {ticker_clause} }}
        OPTIONAL {{ ?id p:P169 ?ceoStatement .
                    ?ceoStatement ps:P169 ?ceo .
                    ?ceo rdfs:label ?ceoLabel .
                    FILTER (LANG(?ceoLabel) = "en")
                    OPTIONAL {{ ?ceoStatement pq:P580 ?ceoStart }}
                    OPTIONAL {{ ?ceoStatement pq:P582 ?ceoEnd }} }}
        OPTIONAL {{ ?id p:P3320 ?boardMemberStatement .
                    ?boardMemberStatement ps:P3320 ?boardMember .
                    ?boardMember rdfs:label ?boardMemberLabel .
                    FILTER (LANG(?boardMemberLabel) = "en")
                    OPTIONAL {{ ?boardMemberStatement pq:P580 ?boardMemberStart }}
                    OPTIONAL {{ ?boardMemberStatement pq:P582 ?boardMemberEnd }} }}
        SERVICE wikibase:label {{ bd:serviceParam wikibase:language "[AUTO_LANGUAGE],en". }}
    }}
    GROUP BY ?ticker ?id
    """
    return q1, q2, q3


def _split(binding: dict, field: str) -> list[str]:
    value = binding.get(field, {}).get("value", "")
    if not value:
        return []
    return [part for part in value.split(SEP) if part.strip()]


def empty_entry(symbol: str) -> dict:
    return {
        "id_label": "",
        "ticker": symbol,
        "country": [],
        "industry": [],
        "aliases": [],
        "products": [],
        "subsidiaries": [],
        "owned_entities": [],
        "ceos": [],
        "board_members": [],
    }


def zip_results(data_1: dict, data_2: dict, data_3: dict, symbol: str) -> list[dict]:
    """Positionally zip the three result sets (hardened semantics: pad the
    shorter sets, drop empty strings, placeholder when nothing matched;
    ref protected ``:213-271``)."""
    b1 = data_1["results"]["bindings"]
    b2 = data_2["results"]["bindings"]
    b3 = data_3["results"]["bindings"]
    out = []
    for i in range(max(len(b1), len(b2), len(b3))):
        r1 = b1[i] if i < len(b1) else {}
        r2 = b2[i] if i < len(b2) else {}
        r3 = b3[i] if i < len(b3) else {}
        out.append(
            {
                "id_label": r1.get("idLabels", {}).get("value", ""),
                "ticker": r1.get("ticker", {}).get("value", symbol),
                "country": _split(r1, "countries"),
                "industry": _split(r1, "industries"),
                "aliases": _split(r1, "aliases"),
                "products": _split(r1, "products"),
                "subsidiaries": _split(r2, "subsidiaries"),
                "owned_entities": _split(r2, "ownedEntities"),
                "ceos": _split(r3, "ceosWithTerms"),
                "board_members": _split(r3, "boardMembersWithTerms"),
            }
        )
    if not out:
        out.append(empty_entry(symbol))
    return out


def create_session(hardened: bool = True):
    """Requests session: retry-hardened (ref protected ``:11-31``) or, for
    the simple flow, a bare session with no transport-level retries (the
    un-hardened script used plain ``requests.get``)."""
    import requests

    session = requests.Session()
    if not hardened:
        return session
    from requests.adapters import HTTPAdapter
    from urllib3.util.retry import Retry

    retry = Retry(
        total=5,
        backoff_factor=2,
        status_forcelist=[429, 500, 502, 503, 504],
        allowed_methods=["GET"],
    )
    adapter = HTTPAdapter(max_retries=retry)
    session.mount("https://", adapter)
    session.mount("http://", adapter)
    session.headers.update(
        {
            "User-Agent": (
                "Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 "
                "(KHTML, like Gecko) Chrome/120.0.0.0 Safari/537.36"
            )
        }
    )
    return session


class EnrichClient:
    """Per-symbol query ladder with the hardened retry/backoff policy."""

    def __init__(
        self,
        cfg: EnrichConfig,
        *,
        session=None,
        sleep: Callable[[float], None] = time.sleep,
        rng: random.Random | None = None,
    ):
        self.cfg = cfg
        self.session = (
            session if session is not None else create_session(cfg.hardened)
        )
        self.sleep = sleep
        self.rng = rng or random.Random()

    def _get(self, query: str):
        return self.session.get(
            self.cfg.endpoint,
            params={"query": query, "format": "json"},
            timeout=(self.cfg.connect_timeout, self.cfg.read_timeout),
        )

    def query_symbol(self, symbol: str) -> bool:
        """Fetch + persist one symbol; True on success (ref protected :176-335).

        With ``cfg.hardened`` False this is the simple script's single pass
        — one attempt, no inter-query jitter, no politeness sleep, no
        backoff ladder (ref ``ticker_symbol_query.py``'s plain flow)."""
        q1, q2, q3 = build_queries(symbol)
        base = self.cfg.base_delay
        hardened = self.cfg.hardened
        attempts = self.cfg.max_retries if hardened else 1
        for attempt in range(attempts):
            try:
                r1 = self._get(q1)
                if hardened:
                    self.sleep(self.rng.uniform(1, 3))
                r2 = self._get(q2)
                if hardened:
                    self.sleep(self.rng.uniform(1, 3))
                r3 = self._get(q3)
                if r1.ok and r2.ok and r3.ok:
                    entries = zip_results(r1.json(), r2.json(), r3.json(), symbol)
                    os.makedirs(self.cfg.out_dir, exist_ok=True)
                    path = os.path.join(self.cfg.out_dir, f"{symbol}_info.json")
                    with open(path, "w", encoding="utf-8") as f:
                        json.dump(entries, f, indent=4, ensure_ascii=False)
                    if hardened:
                        self.sleep(self.rng.uniform(5, 10))  # politeness (ref :287)
                    return True
                # 429 escalates faster than other failures (ref :302-315)
                if any(r.status_code == 429 for r in (r1, r2, r3)):
                    if attempt < attempts - 1:
                        self.sleep(base * (3**attempt) + self.rng.uniform(10, 20))
                    else:
                        return False
                elif attempt < attempts - 1:
                    self.sleep(base * (2**attempt) + self.rng.uniform(2, 8))
            except Exception:
                if attempt < attempts - 1:
                    self.sleep(base * (2**attempt) + self.rng.uniform(5, 15))
                else:
                    return False
        return False

    def artifact_path(self, symbol: str) -> str:
        return os.path.join(self.cfg.out_dir, f"{symbol}_info.json")


def run_enrich(
    cfg: EnrichConfig,
    *,
    session=None,
    sleep: Callable[[float], None] = time.sleep,
    rng: random.Random | None = None,
    symbols: list[str] | None = None,
) -> int:
    """CLI entry: enrich every symbol with ledger resume + paced cool-downs."""
    import csv

    rng = rng or random.Random()
    client = EnrichClient(cfg, session=session, sleep=sleep, rng=rng)

    if symbols is None:
        if not os.path.exists(cfg.symbols_csv):
            print(f"Symbols CSV '{cfg.symbols_csv}' not found.")
            return 1
        with open(cfg.symbols_csv, newline="", encoding="utf-8") as f:
            symbols = [row["Symbol"] for row in csv.DictReader(f) if row.get("Symbol")]

    ledger = ProgressLedger(cfg.progress_file) if cfg.hardened else None
    done = 0
    for idx, symbol in enumerate(symbols):
        if ledger is not None and ledger.should_skip(
            symbol, lambda s=symbol: os.path.exists(client.artifact_path(s))
        ):
            continue
        ok = client.query_symbol(symbol)
        if ledger is not None:
            (ledger.mark_processed if ok else ledger.mark_failed)(symbol)
        done += 1
        if cfg.hardened:
            # paced cool-downs (ref protected :417-427)
            if done % 10 == 0:
                sleep(rng.uniform(*cfg.cooldown_every10))
            elif done % 3 == 0:
                sleep(rng.uniform(*cfg.cooldown_every3))
    print(f"Enrichment finished: {done} symbols attempted.")
    return 0


def run_crypto_enrich(
    cfg: EnrichConfig,
    *,
    symbols: list[str] | None = None,
    **kw,
) -> int:
    """Crypto-symbol enrichment: the same Wikidata Q1/Q2/Q3 flow routed to
    the crypto artifact tree.

    The reference keeps ``info/crypto/*.json`` beside ``info/ticker/*.json``
    (SURVEY.md §L4 artifact map; the commented legacy flow at
    ``ticker_symbol_query.py:205-265`` wrote ``info/<symbol>_info.json``).
    Here the crypto list rides the hardened client unchanged — only the
    symbol source (``crypto_symbols_csv``), output dir, and progress ledger
    are swapped, so retries/cool-downs/resume behave identically to the
    ticker flow.
    """
    import dataclasses

    crypto_cfg = dataclasses.replace(
        cfg,
        symbols_csv=cfg.crypto_symbols_csv,
        out_dir=cfg.crypto_out_dir,
        progress_file=cfg.crypto_progress_file,
    )
    os.makedirs(crypto_cfg.out_dir, exist_ok=True)
    return run_enrich(crypto_cfg, symbols=symbols, **kw)
