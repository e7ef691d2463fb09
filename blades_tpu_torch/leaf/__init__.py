"""LEAF-style offline data utilities.

Reference: ``src/blades/models/utils/`` (~717 LoC of standalone argparse
tools over LEAF-format federated JSON data: non-IID sampling, train/test
split, stats, user pruning — SURVEY.md C11). Same JSON schema
(``{"users": [...], "num_samples": [...], "user_data": {u: {"x": [...],
"y": [...]}}}``), same CLI entry points, re-implemented compactly:

    python -m blades_tpu_torch.leaf.sample --data-dir D --out-file F --fraction 0.1
    python -m blades_tpu_torch.leaf.split_data --data-dir D --out-dir O --frac 0.9
    python -m blades_tpu_torch.leaf.stats --data-dir D
    python -m blades_tpu_torch.leaf.remove_users --data-dir D --out-file F --min-samples 10
    python -m blades_tpu_torch.leaf.preprocess --data-dir D --out-dir O -s niid \
        --sf 0.1 -k 10 -t sample --tf 0.9   # the preprocess.sh pipeline

The reference's GDrive fetcher (``download_util.py``) is ported as
:mod:`blades_tpu_torch.leaf.download` — offline-gated (``BLADES_TPU_OFFLINE=1``
raises with manual-placement instructions instead of touching the network).

Counterpart: ``blades_tpu/leaf/__init__.py``, copied line for line (the
port imports nothing of the JAX package), so that Python's seeded
``random`` gives the same users, splits and bytes. No torch.
"""

from blades_tpu_torch.leaf.download import (
    download_and_extract,
    download_file_from_google_drive,
)
from blades_tpu_torch.leaf.util import iid_divide, read_leaf_dir, write_leaf_json

DATASETS = ["sent140", "femnist", "shakespeare", "celeba", "synthetic", "reddit"]

__all__ = ["DATASETS", "iid_divide", "read_leaf_dir", "write_leaf_json"]
