"""Per-request work functions, one file an entry."""
