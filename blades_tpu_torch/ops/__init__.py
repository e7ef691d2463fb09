"""Array primitives (counterpart: ``blades_tpu/ops/``): the flat parameter
layout, the trimmed-mean kernel with its plain version, pairwise distances,
complete-linkage clustering, the masked (participation-aware) reductions
and the streaming round's running reductions (``streaming.py``)."""
