"""Shared LEAF JSON helpers (reference: ``models/utils/util.py``).

Counterpart: ``blades_tpu/leaf/util.py``, copied line for line (the port
imports nothing of the JAX package), so that Python's seeded ``random``
gives the same users, splits and bytes. No torch.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List


def iid_divide(lst: List, g: int) -> List[List]:
    """Divide a list into g groups as evenly as possible (reference
    ``util.py`` ``iid_divide``)."""
    num_elems = len(lst)
    group_size = num_elems // g
    num_big = num_elems - group_size * g
    glist = []
    for i in range(num_big):
        glist.append(lst[i * (group_size + 1) : (i + 1) * (group_size + 1)])
    bi = num_big * (group_size + 1)
    for i in range(g - num_big):
        glist.append(lst[bi + group_size * i : bi + group_size * (i + 1)])
    return glist


def read_leaf_dir(data_dir: str) -> Dict:
    """Merge every ``.json`` in a LEAF data dir into one dataset dict."""
    data = {"users": [], "num_samples": [], "user_data": {}}
    for fname in sorted(os.listdir(data_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(data_dir, fname)) as f:
            part = json.load(f)
        data["users"].extend(part["users"])
        data["num_samples"].extend(part["num_samples"])
        data["user_data"].update(part["user_data"])
    return data


def write_leaf_json(data: Dict, out_path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(data, f)
