"""Client layer: REST SDK + CLI (parity: sky/client/)."""
