"""Inputs of the Chamfer backward (nnd_bwd) that reach the branches generic
clouds miss. tests/test_torch_nnd_bwd_onepass.py pins on the CPU what they
hold; tests/test_torch_cuda.py runs the kernel on them.

No JAX here: the card's tests import this module too.
"""

import numpy as np

COPIES = 300     # points of y set to x_0 by copies_clouds


def hub_clouds(b: int, n: int, seed: int = 0):
    """A tight cloud, 0.01 N(0, 1), against a spread one, N(0, 1): a
    collapsed generated cloud against a real shape. The spread cloud's
    points find their neighbours on the tight cloud's edge, and nearly all
    of the tight cloud's points find the spread point nearest to it: inverse
    lists of 9 to 32 members and of more than 32 (the fix-up's)."""
    rng = np.random.default_rng(seed)
    x = (0.01 * rng.normal(size=(b, n, 3))).astype(np.float32)
    return x, rng.normal(size=(b, n, 3)).astype(np.float32)


def copies_clouds(b: int, n: int, seed: int = 1):
    """Random clouds, 0.5 N(0, 1), with y's first COPIES points set to x_0:
    x_0's count is COPIES (a tie), so the pair takes the fix-up, which takes
    every copy it hits: more than 256 points (a warp each)."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.normal(size=(b, n, 3))).astype(np.float32)
    y = (0.5 * rng.normal(size=(b, n, 3))).astype(np.float32)
    y[:, :COPIES] = x[:, :1]
    return x, y
