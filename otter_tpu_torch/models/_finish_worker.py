"""Worker-process entry for the host half of assemble (the finish pool).

Counterpart of ``otter_tpu/models/_finish_worker.py``. The reference runs
whole regions on threads (BS_thread_pool, assemble.cpp:43). Here the main
process batches all distance work, and with ``OTTER_TPU_FINISH_POOL=1``
and -t > 1 on the CPU engine (the setting raises on the card) the rest of
each region (float64 KDE and hclust, reassignment, consensus) goes to
spawned worker processes through this module. A worker takes the host DP
for the reassignment distances and the native affine ladder with the
python POA for the consensus, as the JAX package's workers do; the output
is the same bytes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..ops.cluster import ClusteringStatus
from ..ops.consensus import (consensus_apply_batched,
                             reassignment_distances_batched)
from ..ops.distmat import DistMatrix
from ..seqs.model import AnAllele
from .assemble import cluster_finish, cluster_labels


def finish_region_worker(args) -> Tuple[ClusteringStatus, List[AnAllele]]:
    """(params, work, condensed_values) -> (clustmsg, alleles)."""
    params, work, values = args
    distmatrix = DistMatrix(len(work.valid_indeces))
    if values is not None:
        distmatrix.values = np.asarray(values, dtype=np.float64)
    clustmsg, labels = cluster_labels(params, work, distmatrix)
    pre = (reassignment_distances_batched(work.reads, labels, engine=None)
           if work.invalid_indeces else None)
    alleles, tasks = cluster_finish(params, work, distmatrix, clustmsg,
                                    labels, pre)
    consensus_apply_batched(tasks)
    return clustmsg, alleles
