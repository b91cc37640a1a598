"""Launchers: the serving driver (``serve``) and the index builder
(``build_index``)."""
