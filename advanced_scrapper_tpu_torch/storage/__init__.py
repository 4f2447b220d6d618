"""Host persistence (stdlib only): the fs seam and torn-write-safe commit
(``fsio``), the torn-tail-safe append CSV (``csvio``), and the link and
article stores over sqlite or Postgres (``stores``, ``backends``)."""
