"""Reference-path alias: ``blades.models.mnist`` -> here.

Counterpart: ``blades_tpu/models/mnist.py``, which re-exports the MNIST
model as the reference exposes it (``from blades.models.mnist import MLP``,
``src/blades/models/mnist/dnn.py``); migrating code keeps working with the
package name swapped.
"""

from blades_tpu_torch.models.mlp import MLP, create_mnist_model as create_model

__all__ = ["MLP", "create_model"]
