"""Model substrate of the port: the recsys serving path (``recsys.py``)
over ``embedding_bag.py`` and ``layers.py``."""
