"""Data & storage layer (parity: sky/data/)."""
