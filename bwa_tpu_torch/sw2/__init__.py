"""BWA-SW host modules of the port: the hit types and the native index
views that the backtrack driver and the native entry points use (bwasw
itself is not ported yet)."""
