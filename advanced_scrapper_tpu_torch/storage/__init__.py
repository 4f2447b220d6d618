"""Host persistence: the torn-write-safe file commit (stdlib only)."""
