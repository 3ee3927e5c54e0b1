"""Shared Huffman-coding core.

The port's copy of `deeplearning4j_tpu/util/huffman.py`, which is host code
(Python and numpy) and computes the same.

One heap-based builder serving both hierarchical-softmax users: word2vec's
frequency-keyed tree (reference: `models/word2vec/wordstore/Huffman.java`,
MAX_CODE_LENGTH 40) and DeepWalk's vertex-degree-keyed tree (reference:
`graph/models/deepwalk/GraphHuffman.java`, codes packed in a 64-bit long).
"""

from __future__ import annotations

import heapq
import itertools
from typing import List, Sequence, Tuple


def huffman_codes(freqs: Sequence[float], max_code_length: int = 64
                  ) -> Tuple[List[List[int]], List[List[int]], int]:
    """Build Huffman codes/points over arbitrary frequencies.

    Returns (codes, points, n_inner): codes[i] is leaf i's bit path from
    the root, points[i] the inner-node indices along it (0-based into the
    syn1 table), n_inner the number of inner nodes (>= 1).
    """
    n = len(freqs)
    if n == 0:
        return [], [], 0
    if n == 1:
        return [[0]], [[0]], 1
    counter = itertools.count()
    heap = [(float(f), next(counter), i) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    parent = {}
    next_inner = n
    while len(heap) > 1:
        f1, _, n1 = heapq.heappop(heap)
        f2, _, n2 = heapq.heappop(heap)
        inner = next_inner
        next_inner += 1
        parent[n1] = (inner, 0)
        parent[n2] = (inner, 1)
        heapq.heappush(heap, (f1 + f2, next(counter), inner))
    root = heap[0][2]
    codes, points = [], []
    for i in range(n):
        c, p = [], []
        node = i
        while node != root:
            par, bit = parent[node]
            c.append(bit)
            p.append(par - n)
            node = par
        c.reverse()
        p.reverse()
        codes.append(c[:max_code_length])
        points.append(p[:max_code_length])
    return codes, points, max(next_inner - n, 1)
