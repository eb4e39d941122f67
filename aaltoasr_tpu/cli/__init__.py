"""Command-line tools mirroring the reference aku/decoder binaries.

Each tool is runnable as ``python -m aaltoasr_tpu.cli.<tool>`` and keeps
the reference's long-option names (including ``-B/-I`` batch sharding) so
existing recipes drive them unchanged.  Importing the package turns on
the persistent compile cache (`utils/compile_cache.py`).
"""

from aaltoasr_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()
