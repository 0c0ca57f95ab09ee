"""Serving runtime of the port: split execution and prefill/decode
steps. Counterpart of ``repro.runtime`` (the streaming server and the
fleet are not ported yet)."""
