"""Command-line interface of the port (``python -m tpulab_torch``)."""
