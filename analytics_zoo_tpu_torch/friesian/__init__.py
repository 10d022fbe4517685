"""Friesian: recsys feature engineering on the port's sharded data layer
(the port's copy of ``analytics_zoo_tpu/friesian``; ref
``pyzoo/zoo/friesian/``)."""
