"""Serving drivers of the PyTorch port: the open-loop load generator CLI
(``serve_loadgen.py``) and the SIGKILL durability harness
(``durability_smoke.py``)."""
