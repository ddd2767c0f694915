"""Dbmart ingest and synthetic cohort generators (host-side numpy)."""
