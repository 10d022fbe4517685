"""analytics_zoo_tpu_torch — the PyTorch and CUDA port of analytics_zoo_tpu.

The same public module paths and names as ``analytics_zoo_tpu``, written in
PyTorch for one NVIDIA H100. Plain tensor code is PyTorch; every Pallas
kernel of the JAX package becomes a kernel written by hand for Hopper
(``ops/csrc``), built on first use. The package imports no jax, flax or
optax and nothing of ``analytics_zoo_tpu``.

Entry points (``InferenceModel``, ``ClusterServing``, model ``predict``,
keras ``compile``/``fit``, ``Estimator.from_torch``) run on ``cuda``
unless the caller passes ``device="cpu"``; without CUDA and without an
explicit CPU device they raise.

Subpackages ported so far (the NCF, BERT and Seq2Seq decode serving
slices, BERT fine-tuning, NCF training, checkpoints, the keras training
surface, the zoo models whose layers exist, the context and data layer,
and Zouwu's forecasters):

- ``common``    — ``init_orca_context`` / ``OrcaContext`` (devices,
  precision, the data knobs), device resolution, the batch-bucket ladder,
  the flax layers the models build on (``flax_compat``), the TensorBoard
  event writer (``summary``), fault plans
- ``parallel``  — the device mesh the context builds (``mesh``)
- ``ops``       — the fused embedding lookup, the multi-hot bag and their
  scatter-add backward, the flash-attention forward and backward, the
  paged gather and paged decode attention kernels and their build,
  attention
- ``data``      — fixed-shape minibatches in the JAX package's order,
  the streaming feed over ``DISK_n`` stores, XShards (tiers, the data
  pool), the pandas readers, TFRecord, Elasticsearch and image parquet
- ``learn``     — ``Estimator.from_torch``, losses, metrics, optimizers,
  checkpoints and triggers, the training summaries, ``GANEstimator``
- ``keras``     — graph engine, the layers NCF, BERT, Seq2Seq and the
  zoo models use, ``Embedding``, the weight regularizers,
  ``Model``/``Sequential`` with ``compile``/``fit``/``evaluate``/
  ``predict``/``summary``/``set_tensorboard``
- ``models``    — ``ZooModel``, ``NeuralCF``, ``WideAndDeep``,
  ``SessionRecommender``, ``AnomalyDetector`` and ``Seq2Seq``
- ``text``      — BERT, the GPT-style transformer, the task heads,
  ``BERTClassifier``, the HuggingFace weight import
- ``inference`` — ``InferenceModel`` (predict and decode), generation,
  the step-level ``DecodeScheduler`` over a paged KV pool, KV int8
- ``serving``   — broker, wire schema, ``InputQueue``/``OutputQueue``,
  ``ClusterServing`` (predict and generate records)
- ``zouwu``     — the TCN, LSTM and Seq2Seq forecasters
- ``automl``    — the metrics ``Evaluator``
- ``convert``   — flax parameter trees to torch state dicts and back,
  and JAX's ``torch_to_jax`` names of a foreign module
- ``net``       — ``TorchNet`` (a foreign module on the port's attention
  core), ONNX and OpenVINO IR graphs run op by op
- ``keras2``, ``nnframes`` — Keras-2 spellings, ML-pipeline stages over
  DataFrames
"""

from analytics_zoo_tpu_torch.version import __version__  # noqa: F401
from analytics_zoo_tpu_torch.common.context import (  # noqa: F401
    OrcaContext, init_orca_context, stop_orca_context,
)
