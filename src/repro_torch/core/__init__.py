"""Core mining algorithms (encoding, mining, screening, queries)."""
