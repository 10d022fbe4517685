"""TimeSequencePipeline — the reference's name for the fitted AutoTS
artifact (ref ``pyzoo/zoo/zouwu/pipeline/time_sequence.py:27``
TimeSequencePipeline + ``:211`` load_ts_pipeline). Here the pipeline
class lives in ``zouwu.autots`` as ``TSPipeline``; this module keeps the
reference import path working (the port's copy of
``analytics_zoo_tpu/zouwu/pipeline.py``)."""

from __future__ import annotations

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.zouwu.autots.forecast import TSPipeline

__all__ = ["TimeSequencePipeline", "load_ts_pipeline"]

TimeSequencePipeline = TSPipeline


def load_ts_pipeline(file: str, device: DeviceLike = None) -> TSPipeline:
    """(ref time_sequence.py:211 — restore a saved pipeline directory)"""
    return TSPipeline.load(file, device=device)
