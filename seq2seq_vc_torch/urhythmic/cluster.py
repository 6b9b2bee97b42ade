"""Ward agglomerative clustering with no connectivity constraint: what the
JAX segmenter takes from ``sklearn.cluster.AgglomerativeClustering``
(seq2seq_vc_tpu/urhythmic/segmenter.py:21,82), which the card's machine
does not have.

With no connectivity, sklearn's ``ward_tree`` is ``scipy.cluster.hierarchy.
ward(X)[:, :2]`` and the full tree is always built; the labels come from
cutting it into ``n_clusters`` with sklearn's ``_hc_cut`` heap walk, copied
here. The fitted attributes are sklearn's names, the ones that
``Segmenter.state_dict`` stores.
"""

from __future__ import annotations

from heapq import heappush, heappushpop
from typing import List

import numpy as np
from scipy.cluster import hierarchy


def _descendants(node: int, children: np.ndarray, n_leaves: int) -> List[int]:
    """The leaves under ``node`` (sklearn's ``_hc_get_descendent``)."""
    if node < n_leaves:
        return [node]
    stack, leaves = [node], []
    while stack:
        i = stack.pop()
        if i < n_leaves:
            leaves.append(i)
        else:
            stack.extend(children[i - n_leaves])
    return leaves


def hc_cut(n_clusters: int, children: np.ndarray, n_leaves: int) -> np.ndarray:
    """Labels of the ``n_leaves`` leaves when the merge tree ``children``
    is cut into ``n_clusters`` (sklearn's ``_hc_cut``): the largest node is
    split first, and cluster ``i`` is the ``i``-th node of the final heap."""
    if n_clusters > n_leaves:
        raise ValueError(
            f"Cannot extract more clusters than samples: {n_clusters} clusters were given "
            f"for a tree with {n_leaves} leaves.")
    # a heap of negated node ids: nodes[0] is the largest node
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(n_clusters - 1):
        these_children = children[-nodes[0] - n_leaves]
        heappush(nodes, -these_children[0])
        heappushpop(nodes, -these_children[1])
    labels = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        labels[_descendants(-node, children, n_leaves)] = i
    return labels


class AgglomerativeClustering:
    """Ward linkage over euclidean distances, the full tree, cut into
    ``n_clusters``."""

    def __init__(self, n_clusters: int = 2):
        self.n_clusters = n_clusters

    def fit(self, X) -> "AgglomerativeClustering":
        X = np.require(np.asarray(X), requirements="W")
        if X.ndim != 2 or len(X) < 2:
            raise ValueError(f"expected a (n_samples >= 2, n_features) array, got {X.shape}")
        self.n_features_in_ = X.shape[1]
        self.n_leaves_ = len(X)
        self.children_ = hierarchy.ward(X)[:, :2].astype(np.intp)
        self.n_clusters_ = self.n_clusters
        self.labels_ = hc_cut(self.n_clusters_, self.children_, self.n_leaves_)
        return self
