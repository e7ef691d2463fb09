"""Device-mesh parallelism namespace: the re-exports of
``blades_tpu/parallel/__init__.py:6-13`` (reference counterpart: none; the
reference parallelizes with Ray actors; see ``mesh.py`` and
``distributed.py`` here for the per-module citations)."""

from blades_tpu_torch.parallel.mesh import (  # noqa: F401
    CLIENTS_AXIS,
    MODEL_AXIS,
    Mesh,
    ShardingPlan,
    auto_mesh_shape,
    make_mesh,
    make_plan,
)
from blades_tpu_torch.parallel import distributed  # noqa: F401
