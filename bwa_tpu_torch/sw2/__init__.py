"""BWA-SW pipeline (reference: bwtsw2_*.c) — long-query Smith-Waterman
alignment through a read-BWT x genome-BWT dynamic program.

The DAG-traversal core runs in the native extension (native/bsw2.cpp);
chaining, extension, pairing and SAM emission live here, on the host.
Output is byte-identical with `bwa bwasw`.  The hit types and native
index views (types.py, core.py) also serve the backtrack driver.
"""
