"""Roofline and report tables: the H100's roofline model with the
model-flops counts and the kernel tile costs (``roofline``), and the
markdown tables over dry-run records (``report``)."""
