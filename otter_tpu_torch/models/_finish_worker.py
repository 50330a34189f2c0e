"""Worker-process entry for the host half of assemble (the finish pool).

Counterpart of ``otter_tpu/models/_finish_worker.py``. The reference runs
whole regions on threads (BS_thread_pool, assemble.cpp:43). Here the main
process batches all distance work, and with ``OTTER_TPU_FINISH_POOL=1``
and -t > 1 the rest of each region (hclust, reassignment, consensus) goes
to spawned worker processes through this module. A worker touches no
card: it takes the region's distances, its reassignment distances and,
where the main process's K8 gave them, its certified KDE densities (else
it computes the float64 KDE), and the native affine ladder with the
python POA for the consensus, as the JAX package's workers do; the output
is the same bytes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..ops.cluster import ClusteringStatus
from ..ops.consensus import consensus_apply_batched
from ..ops.distmat import DistMatrix
from ..seqs.model import AnAllele
from .assemble import cluster_finish, cluster_labels


def finish_region_worker(args) -> Tuple[ClusteringStatus, List[AnAllele]]:
    """(params, work, condensed_values, densities or None, reassignment
    distances or None) -> (clustmsg, alleles)."""
    params, work, values, densities, pre = args
    distmatrix = DistMatrix(len(work.valid_indeces))
    if values is not None:
        distmatrix.values = np.asarray(values, dtype=np.float64)
    clustmsg, labels = cluster_labels(params, work, distmatrix,
                                      densities=densities)
    alleles, tasks = cluster_finish(params, work, distmatrix, clustmsg,
                                    labels, pre)
    consensus_apply_batched(tasks)
    return clustmsg, alleles
