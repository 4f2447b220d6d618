"""Host persistence (stdlib only): the fs seam and torn-write-safe commit
(``fsio``), the torn-tail-safe append CSV (``csvio``), the link and
article stores over sqlite or Postgres (``stores``, ``backends``), the
progress ledger (``progress``) and a psycopg2-shaped Postgres fake on
sqlite (``pgfake``)."""
