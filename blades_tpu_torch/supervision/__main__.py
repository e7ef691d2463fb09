"""``python -m blades_tpu_torch.supervision [opts] -- workload argv...``

Counterpart: ``blades_tpu/supervision/__main__.py``; see
:func:`blades_tpu_torch.supervision.supervisor.main`.
"""

import sys

from blades_tpu_torch.supervision.supervisor import main

if __name__ == "__main__":
    sys.exit(main())
