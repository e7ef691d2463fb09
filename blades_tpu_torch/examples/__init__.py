"""Runnable examples of the port (``python -m blades_tpu_torch.examples.<name>``).

Counterpart: the JAX package's ``examples/`` directory, one module each
under the same name (``examples/mini_example.py`` and the rest), and the
drivers of ``scripts/`` the port has ported (``scripts/certify.py``,
``scripts/chaos.py``, ``scripts/serve.py``, ``scripts/args.py``,
``scripts/cifar10.py``, ``scripts/main.py``).
"""
