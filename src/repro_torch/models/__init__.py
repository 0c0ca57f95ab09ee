"""Model execution layer of the port: the dense-attention decoder stack.
Counterpart of ``repro.models`` (only the modules it needs so far)."""
