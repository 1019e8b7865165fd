"""The benchmark of d3fields_tpu_torch (run it with ``python3 port_bench/run.py``)."""
