from .brute_force import BruteForceIndex
from .knng import build_knng, nn_descent
from .random_regular import random_regular_graph, random_regular_index
from .nsw import NSWIndex

__all__ = [
    "BruteForceIndex", "build_knng", "nn_descent",
    "random_regular_graph", "random_regular_index", "NSWIndex",
]
