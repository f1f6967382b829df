"""Offline cluster-quality evaluation (component C17 in SURVEY.md).

Self-contained reimplementations of the metrics the reference computes with
sklearn (scripts/compute_cluster_quality.py:122-191): V-measure,
homogeneity, completeness, adjusted Rand index — plus the cluster size
statistics (N50, E-size, quartiles; :260-356).  Unclustered reads are
appended as fresh singleton clusters before scoring, matching the
reference's convention (:136-142).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple


def _entropy(counts: Sequence[int], n: float) -> float:
    h = 0.0
    for c in counts:
        if c > 0:
            h -= (c / n) * math.log(c / n)
    return h


def homogeneity_completeness_v(
    labels_true: Sequence[int], labels_pred: Sequence[int]
) -> Tuple[float, float, float]:
    """Shannon-entropy based clustering scores (sklearn-compatible)."""
    n = len(labels_true)
    if n == 0:
        return 1.0, 1.0, 1.0
    classes = Counter(labels_true)
    clusters = Counter(labels_pred)
    joint: Dict[Tuple[int, int], int] = Counter(zip(labels_true, labels_pred))
    h_c = _entropy(list(classes.values()), n)
    h_k = _entropy(list(clusters.values()), n)
    # conditional entropies
    h_c_given_k = 0.0
    h_k_given_c = 0.0
    for (c, k), cnt in joint.items():
        h_c_given_k -= (cnt / n) * math.log(cnt / clusters[k])
        h_k_given_c -= (cnt / n) * math.log(cnt / classes[c])
    homogeneity = 1.0 if h_c == 0.0 else 1.0 - h_c_given_k / h_c
    completeness = 1.0 if h_k == 0.0 else 1.0 - h_k_given_c / h_k
    if homogeneity + completeness == 0.0:
        v = 0.0
    else:
        v = 2.0 * homogeneity * completeness / (homogeneity + completeness)
    return homogeneity, completeness, v


def adjusted_rand_index(
    labels_true: Sequence[int], labels_pred: Sequence[int]
) -> float:
    n = len(labels_true)
    if n == 0:
        return 1.0
    joint: Dict[Tuple[int, int], int] = Counter(zip(labels_true, labels_pred))
    classes = Counter(labels_true)
    clusters = Counter(labels_pred)

    def comb2(x: int) -> float:
        return x * (x - 1) / 2.0

    sum_comb = sum(comb2(c) for c in joint.values())
    sum_a = sum(comb2(c) for c in classes.values())
    sum_b = sum(comb2(c) for c in clusters.values())
    total = comb2(n)
    expected = sum_a * sum_b / total if total else 0.0
    max_index = (sum_a + sum_b) / 2.0
    if max_index == expected:
        return 1.0
    return (sum_comb - expected) / (max_index - expected)


def with_singleton_fill(
    classes: Dict[str, int], clusters: Dict[str, int]
) -> Tuple[List[int], List[int]]:
    """Align truth/prediction label lists; reads missing from ``clusters``
    become fresh singleton clusters (reference convention, :136-142)."""
    labels_true: List[int] = []
    labels_pred: List[int] = []
    next_singleton = max(clusters.values(), default=0) + 1
    for acc, cls in classes.items():
        labels_true.append(cls)
        if acc in clusters:
            labels_pred.append(clusters[acc])
        else:
            labels_pred.append(next_singleton)
            next_singleton += 1
    return labels_true, labels_pred


def cluster_size_stats(sizes: Sequence[int]) -> Dict[str, float]:
    """N50 / E-size / quartile statistics (reference :260-356)."""
    sizes = sorted(sizes, reverse=True)
    total = sum(sizes)
    if not sizes or total == 0:
        return {"n_clusters": 0, "total": 0, "n50": 0, "e_size": 0.0,
                "max": 0, "median": 0, "min": 0}
    cum = 0
    n50 = sizes[-1]
    for s in sizes:
        cum += s
        if cum >= total / 2.0:
            n50 = s
            break
    e_size = sum(s * s for s in sizes) / total
    return {
        "n_clusters": len(sizes),
        "total": total,
        "n50": n50,
        "e_size": e_size,
        "max": sizes[0],
        "median": sizes[len(sizes) // 2],
        "min": sizes[-1],
    }


def read_clusters_tsv(path: str) -> Dict[str, int]:
    """final_clusters.tsv -> {accession: cluster_id}."""
    out: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            items = line.strip().split("\t")
            if len(items) >= 2:
                out[items[1].split()[0]] = int(items[0])
    return out


def evaluate(
    classes: Dict[str, int], clusters: Dict[str, int],
    min_class_size: int = 0,
) -> Dict[str, float]:
    """Full metric set; ``min_class_size`` reproduces the reference's
    non-singleton-classes variant (classes >= 5 reads, :156-191)."""
    if min_class_size > 1:
        class_sizes = Counter(classes.values())
        classes = {a: c for a, c in classes.items()
                   if class_sizes[c] >= min_class_size}
    lt, lp = with_singleton_fill(classes, clusters)
    hom, com, v = homogeneity_completeness_v(lt, lp)
    ari = adjusted_rand_index(lt, lp)
    stats = cluster_size_stats(list(Counter(lp).values()))
    return {"homogeneity": hom, "completeness": com, "v_measure": v,
            "ari": ari, **stats}
