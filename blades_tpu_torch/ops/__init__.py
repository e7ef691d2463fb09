"""Array primitives (counterpart: ``blades_tpu/ops/``): the flat parameter
layout and the trimmed-mean kernel with its plain version."""
