"""Host-side hashing parameters and the byte tokenizer (numpy only)."""
