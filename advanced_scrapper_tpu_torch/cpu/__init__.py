"""Host-side batch encoding (numpy only)."""
