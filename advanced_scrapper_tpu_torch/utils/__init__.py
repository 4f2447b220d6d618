"""Host utilities: the bounded-memory Bloom stream index (numpy only)."""
