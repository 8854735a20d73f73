"""Cloud SDK adaptors (parity: sky/adaptors/ — lazy-import shims so a
missing provider SDK fails at first USE with a clear message, never at
import time, and provider-wide state like credential caches lives in
one place instead of per-client copies)."""
