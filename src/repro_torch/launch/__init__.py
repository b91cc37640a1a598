"""Launchers: the serving driver (``serve``), the index builder
(``build_index``) and the recsys trainer (``train``)."""
