"""Observability of the port: so far the roofline accounting of the
bench rows (the counterpart of part of ``tpulab.obs``)."""
