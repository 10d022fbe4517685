"""analytics_zoo_tpu_torch — the PyTorch and CUDA port of analytics_zoo_tpu.

The same public module paths and names as ``analytics_zoo_tpu``, written in
PyTorch for one NVIDIA H100. Plain tensor code is PyTorch; every Pallas
kernel of the JAX package becomes a kernel written by hand for Hopper
(``ops/csrc``), built on first use. The package imports no jax, flax or
optax and nothing of ``analytics_zoo_tpu``.

Entry points (``InferenceModel``, ``ClusterServing``, model ``predict``)
run on ``cuda`` unless the caller passes ``device="cpu"``; without CUDA
and without an explicit CPU device they raise.

Subpackages ported so far (the NCF serving slice):

- ``common``    — device resolution, the batch-bucket ladder
- ``ops``       — the fused embedding lookup kernel and its build
- ``keras``     — graph engine, the layers NCF uses, ``Model``/``Sequential``
- ``models``    — ``ZooModel`` and ``NeuralCF``
- ``inference`` — ``InferenceModel``
- ``serving``   — broker, wire schema, ``InputQueue``/``OutputQueue``,
  ``ClusterServing``
- ``convert``   — flax parameter trees to torch state dicts
"""

from analytics_zoo_tpu_torch.version import __version__  # noqa: F401
