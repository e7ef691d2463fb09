"""Test config: force an 8-device virtual CPU mesh before JAX backend init.

Multi-chip sharding logic is validated on fake XLA CPU devices (the strategy
the reference could not have: it has no tests at all — SURVEY.md section 4).
The flag recipe lives in ``blades_tpu.utils.platform`` (single owner);
importing it pulls in jax, which is safe — only the first *backend touch*
freezes the platform, and ``force_virtual_cpu`` runs before that.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Run-provenance hygiene: hundreds of tests construct Simulators (and
# subprocess children inherit this env), and their ledger records must
# land in a throwaway per-session file — never the repo's committed
# results/ledger.jsonl. Tests that assert ledger behavior pass their own
# explicit path (or override BLADES_LEDGER themselves).
if "BLADES_LEDGER" not in os.environ:
    import tempfile

    os.environ["BLADES_LEDGER"] = os.path.join(
        tempfile.mkdtemp(prefix="blades_test_ledger_"), "ledger.jsonl"
    )

from blades_tpu.utils.platform import force_virtual_cpu  # noqa: E402

force_virtual_cpu(8)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_report_header(config):
    return f"jax {jax.__version__}, devices: {jax.device_count()} ({jax.devices()[0].platform})"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy end-to-end scenarios (full chaos sweep, supervised "
        "subprocess runs) excluded from tier-1 via -m 'not slow'",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's hand-written kernels); skips "
        "where torch.cuda.is_available() is False",
    )
