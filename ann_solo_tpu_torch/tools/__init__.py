"""Diagnostics that read a QUALITY workdir (the port of the repo's
`tools/bf_profile.py`, `tools/probe_diag.py` and
`tools/fdr_leak_diag.py`)."""
